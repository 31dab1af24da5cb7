// Paged decode attention for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py :: paged_attention (_paged_kernel)
// and computes the same function: for every request b and query head h,
// one query position attends over the first lengths[b] tokens of the
// request's context, which lives in a pool of fixed-size blocks
// [N, bs, Hkv, D] addressed through block_tables[b, :].  Scale 1/sqrt(D),
// online softmax in float32, GQA (H/Hkv query heads share one KV head),
// a length-0 row gives zeros, and no block at or past the length is read.
//
// What bounds it on an H100: device-memory bytes.  Each query reads its
// request's K and V once, about
//   sum_b ceil(len_b / bs) * bs * Hkv * D * 2 * sizeof(T)
// bytes, against 4 * H * D operations per token; at bf16 that is about
// one operation per byte, far below the ~295 operations per byte at which
// the tensor cores would become the limit.
//
// Design (a first kernel: simple and right; split-KV flash-decoding, TMA
// loads and wgmma are later work):
//  * one thread block per (KV head, request); the GQA group's
//    group x D queries sit in shared memory, pre-scaled, in float32;
//  * a loop inside the block walks the request's logical blocks in tiles
//    of up to kTileTokens tokens (several pool blocks per tile when bs is
//    small), reading block_tables itself: this loop replaces the TPU
//    grid's sequential M axis and its scalar prefetch;
//  * K and V of a tile are copied into shared memory with 16-byte
//    asynchronous copies (cp.async), neighbouring threads on neighbouring
//    addresses, all copies of a tile in flight before the wait;
//  * scores: one warp per (query, token) pair, lanes split D and reduce
//    with shuffles; online softmax: one warp per query row; the float32
//    accumulator lives in shared memory, one element per thread;
//  * the running max starts at -inf, which is the guard for a fully
//    masked row; masked probabilities are exact zeros and the V rows past
//    the length are never touched;
//  * the TPU kernel's 128-lane padding of its max/denominator scratch is a
//    TPU layout artefact and has no counterpart here.
//
// Limits (checked by the Python wrapper): T is float or bf16, D is a
// multiple of 8 up to 256, bs <= 64, and the shared memory of one block,
// paged_attention_smem_bytes(), fits the device's opt-in maximum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* out) { *out = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

// 16-byte asynchronous copy global -> shared (sm_80+): no register
// staging, so every copy of a tile is in flight before the first wait.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__host__ __device__ __forceinline__ int tile_blocks(int bs) {
  return bs >= kTileTokens ? 1 : kTileTokens / bs;
}

size_t smem_bytes(size_t elem, int group, int d, int bs) {
  const size_t tile = (size_t)tile_blocks(bs) * bs;
  return 2 * tile * d * elem                    // K and V tile
         + 2 * (size_t)group * d * sizeof(float)  // queries, accumulator
         + (size_t)group * tile * sizeof(float)   // scores / probabilities
         + 3 * (size_t)group * sizeof(float);     // max, denominator, rescale
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,             // [B, H, D]
                       const T* __restrict__ k_pages,       // [N, bs, Hkv, D]
                       const T* __restrict__ v_pages,       // [N, bs, Hkv, D]
                       const int* __restrict__ block_tables,  // [B, M]
                       const int* __restrict__ lengths,       // [B]
                       T* __restrict__ out,                 // [B, H, D]
                       int H, int Hkv, int D, int bs, int M, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int group = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tb = tile_blocks(bs);
  const int tile = tb * bs;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                   // [tile, D]
  T* v_s = k_s + (size_t)tile * D;                       // [tile, D]
  float* q_s = reinterpret_cast<float*>(v_s + (size_t)tile * D);  // [g, D]
  float* acc_s = q_s + group * D;                        // [group, D]
  float* p_s = acc_s + group * D;                        // [group, tile]
  float* m_s = p_s + group * tile;                       // [group]
  float* l_s = m_s + group;                              // [group]
  float* c_s = l_s + group;                              // [group]

  const int h0 = kvh * group;  // first query head served by this KV head
  const T* q_b = q + ((size_t)b * H + h0) * D;
  for (int e = tid; e < group * D; e += kThreads) {
    q_s[e] = to_float(q_b[e]) * scale;
    acc_s[e] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  const int len = lengths[b];
  const int n_blocks = len > 0 ? min((len + bs - 1) / bs, M) : 0;
  const int n_tokens = min(len, n_blocks * bs);
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int vec_per_row = D / kVec;
  const size_t tok_stride = (size_t)Hkv * D;  // between tokens of a block
  const int* table = block_tables + (size_t)b * M;
  __syncthreads();

  for (int t0 = 0; t0 < n_tokens; t0 += tile) {
    const int valid = min(tile, n_tokens - t0);
    // ---- load the tile's K and V rows (only blocks below the length) ----
    const int first_blk = t0 / bs;
    const int tile_blks = min(tb, n_blocks - first_blk);
    const int n_vec = tile_blks * bs * vec_per_row;
    for (int v = tid; v < n_vec; v += kThreads) {
      const int r = v / vec_per_row;  // token within the tile
      const int c = (v - r * vec_per_row) * kVec;
      const int phys = table[first_blk + r / bs];
      const size_t src =
          ((size_t)phys * bs + (r % bs)) * tok_stride + (size_t)kvh * D + c;
      cp_async16(k_s + (size_t)r * D + c, k_pages + src);
      cp_async16(v_s + (size_t)r * D + c, v_pages + src);
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- scores: one warp per (query, token) pair ----
    for (int pair = warp; pair < group * tile; pair += kWarps) {
      const int g = pair / tile;
      const int r = pair - g * tile;
      float s = -INFINITY;
      if (r < valid) {  // uniform across the warp
        float part = 0.f;
        for (int d = lane; d < D; d += 32)
          part += q_s[g * D + d] * to_float(k_s[(size_t)r * D + d]);
        s = warp_sum(part);
      }
      if (lane == 0) p_s[pair] = s;
    }
    __syncthreads();

    // ---- online softmax: one warp per query row ----
    for (int g = warp; g < group; g += kWarps) {
      float* p = p_s + g * tile;
      float mx = -INFINITY;
      for (int r = lane; r < tile; r += 32) mx = fmaxf(mx, p[r]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float safe_m = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int r = lane; r < tile; r += 32) {
        const float e = p[r] == -INFINITY ? 0.f : expf(p[r] - safe_m);
        p[r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = m_prev == -INFINITY ? 0.f : expf(m_prev - safe_m);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // ---- acc = acc * corr + p @ V, one accumulator element per thread ----
    for (int e = tid; e < group * D; e += kThreads) {
      const int g = e / D;
      const int d = e - g * D;
      const float* p = p_s + g * tile;
      float a = acc_s[e] * c_s[g];
      for (int r = 0; r < valid; ++r)
        a += p[r] * to_float(v_s[(size_t)r * D + d]);
      acc_s[e] = a;
    }
    __syncthreads();
  }

  T* o_b = out + ((size_t)b * H + h0) * D;
  for (int e = tid; e < group * D; e += kThreads) {
    const float l = l_s[e / D];
    store(l == 0.f ? 0.f : acc_s[e] / l, o_b + e);
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* lengths, void* out, int B,
           int H, int Hkv, int D, int bs, int M, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(T), H / Hkv, D, bs);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(Hkv, B);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, D, bs,
      M, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one thread block needs, in bytes.
long long paged_attention_smem_bytes(int elem_bytes, int group, int d,
                                     int bs) {
  return (long long)smem_bytes((size_t)elem_bytes, group, d, bs);
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int paged_attention(int dtype, const void* q, const void* k_pages,
                    const void* v_pages, const void* block_tables,
                    const void* lengths, void* out, int B, int H, int Hkv,
                    int D, int bs, int M, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, block_tables, lengths, out, B,
                         H, Hkv, D, bs, M, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths,
                                 out, B, H, Hkv, D, bs, M, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
