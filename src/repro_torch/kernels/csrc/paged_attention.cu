// Paged decode attention for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py :: paged_attention (_paged_kernel)
// and computes the same function: for every request b and query head h,
// one query position attends over the first lengths[b] tokens of the
// request's context, which lives in a pool of fixed-size blocks
// [N, bs, Hkv, D] addressed through block_tables[b, :].  Scale 1/sqrt(D),
// online softmax in float32, GQA (H/Hkv query heads share one KV head),
// a length-0 row gives zeros, and no slot at or past the length is read.
//
// What bounds it on an H100: device-memory bytes.  A call reads each
// request's K and V once, about sum_b len_b * Hkv * D * 2 * sizeof(T)
// bytes, against 4 * H * D operations a token: at bf16 about one
// operation a byte (group 1) to seven (yi-34b's group 7), far below the
// ~295 operations a byte at which the tensor cores would become the
// limit.  So the design is about keeping enough bytes in flight on every
// SM, and about not letting the longest request set the time.
//
// Design:
//  * Split-KV (flash-decoding).  The grid is (split, KV head x query
//    chunk, request).  A split covers `split_blocks` consecutive logical
//    blocks of one request; the Python wrapper picks that number from
//    host integers only (M, bs, B, Hkv and the blocks the card holds at
//    once: SMs x resident blocks an SM; never from `lengths`, which lives
//    on the card), aiming at one wave of full rows, at most 1024 tokens a
//    split and at least 64.  A split that starts at or past
//    the length exits at once.  A request whose live tokens fit one split
//    writes its output directly.  Otherwise each split writes its
//    partial (running max m in log2 units, denominator l, the unnormalised
//    float32 accumulator) to scratch, bumps an integer counter, and the
//    split that arrives last merges the partials in split order and
//    resets the counter.  No float atomics: the sums run in a fixed order,
//    so two calls on the same inputs give bitwise equal outputs.
//  * Pipelined page loads.  A split's block-table entries are read once
//    into shared memory.  K and V move through a ring of kStages = 2
//    stages of `tile` tokens in shared memory with 16-byte cp.async
//    copies (commit_group / wait_group<kStages - 2>): while a stage is
//    computed, the next one is in flight, and the other blocks on the SM
//    keep theirs in flight through the waits.  Slots at or past the length
//    are never read; their rows in the last stage are zero-filled.  Bytes
//    in flight (Little's law asks ~26 KB an SM: 3.35 TB/s x ~1 us / 132):
//    group 1 at D 64 bf16 has 16 KB stages (K + V of 64 tokens) and 6
//    blocks an SM: 96-192 KB; the mma kernel at D 128 has 32 KB stages
//    and 3 blocks an SM: 96-192 KB.  Three stages (4 and 2 blocks an SM)
//    and 32- or 128-token stages measured slower on an H100 (PERF.md):
//    the SM's other blocks, not a deeper ring, hide the latency.
//  * Work in registers.  Group 1 and all float32 work (`paged_simt`):
//    LPR lanes share one token row (LPR = D / 8 rounded up to a power of
//    two; 8 lanes x 16 bytes for a D 64 bf16 row), each lane holds its
//    8-element slice of the pre-scaled queries and of the accumulators in
//    registers, dot products reduce over the LPR lanes with log2(LPR)
//    shuffles, and each lane group keeps its own online softmax (one
//    exponential a token and query: the larger of the old max and the new
//    score is kept, the other term is exp2 of minus the gap).  The lane
//    groups' states merge once a split, by a shuffle butterfly and then
//    across the four warps in shared memory, in a fixed order.
//    bf16 GQA groups at the configs' head dims (`paged_mma`, D 16, 32,
//    64, 96, 128, 160; paged_simt takes any other D): mma.sync
//    m16n8k16 with the group's query rows padded to 16: S = Q K^T and
//    P V per 16-token sub-tile, fragments from ldmatrix on rows padded to
//    D + 8 elements (conflict-free), P split into bf16 hi + lo parts so
//    that P V keeps float32 accuracy, one sub-tile a warp per stage, the
//    four warps' states merged in shared memory.  Not wgmma: it needs
//    64-row tiles and decode has at most a group of query rows; at about
//    one to seven operations a byte the tensor cores are idle either way,
//    and mma.sync only cuts the issue slots that the SIMT dot products
//    of a group of 7 would spend: paged_simt<bf16, 16, 8> takes 242
//    registers, 2 blocks an SM, and 0.1865 ms at yi-34b's long-context
//    step against paged_mma's 0.0800 on an H100 (PERF.md).
//
// Limits (checked by the Python wrapper): T is float or bf16, D is a
// multiple of 8 up to 256, bs <= 64, at most kMaxSplits splits and
// kMaxSplitBlocks blocks a split, and the shared memory of one block,
// paged_attention_smem_bytes(), fits the device's opt-in maximum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kMmaTile = 64;      // tokens a stage in paged_mma (16 a warp)
constexpr int kMmaRows = 16;      // query rows of one mma tile
constexpr int kSimtRows = 8;      // most query heads a paged_simt block holds
constexpr int kStageBytes = 8192; // K bytes a stage in paged_simt (V too)
constexpr int kMaxSplits = 128;
constexpr int kMaxSplitBlocks = 4096;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;            // [B, H, D]
  const void* k;            // [N, bs, Hkv, D]
  const void* v;            // [N, bs, Hkv, D]
  const int* tables;        // [B, M]
  const int* lengths;       // [B]
  void* out;                // [B, H, D]
  float* part_acc;          // [B, H, n_split, D] (n_split > 1)
  float* part_ml;           // [B, H, n_split, 2]
  int* counters;            // [B * Hkv * qchunks], zero between calls
  int H, Hkv, D, bs, M;
  int group;                // H / Hkv
  int qrows;                // query heads a block holds at most
  int qchunks;              // ceil(group / qrows)
  int split_blocks, n_split;
  int tile;                 // tokens a stage
  float scale_log2;         // log2(e) / sqrt(D)
};

// One block's share: request b, KV head kvh, query chunk qc, split.
struct Work {
  int b, kvh, qc, split;
  int h0, gq;               // first query head, query heads held
  int n_live;               // splits of the request that hold a token
  int t0, t1;               // the split's tokens [t0, t1)
};

// The block's request, KV head, query chunk and split.
__device__ __forceinline__ void locate(const Args& a, Work& w) {
  w.split = blockIdx.x;
  w.kvh = blockIdx.y / a.qchunks;
  w.qc = blockIdx.y - w.kvh * a.qchunks;
  w.b = blockIdx.z;
  w.h0 = w.kvh * a.group + w.qc * a.qrows;
  w.gq = min(a.qrows, a.group - w.qc * a.qrows);
}

// The split's tokens for a request of `len` tokens; false when it holds
// none.
__device__ __forceinline__ bool measure(const Args& a, int len, Work& w) {
  len = max(len, 0);
  const int n_blocks = min((len + a.bs - 1) / a.bs, a.M);
  const int tokens = min(len, n_blocks * a.bs);
  w.n_live = (n_blocks + a.split_blocks - 1) / a.split_blocks;
  w.t0 = w.split * a.split_blocks * a.bs;
  w.t1 = min(tokens, w.t0 + a.split_blocks * a.bs);
  return w.split < w.n_live;
}

template <typename T>
__device__ __forceinline__ void store(T* p, float v);
template <>
__device__ __forceinline__ void store<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store<bf16>(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// A length-0 request: zeros, written by split 0 alone.
template <typename T>
__device__ void write_zeros(const Args& a, const Work& w) {
  T* o = static_cast<T*>(a.out) + ((size_t)w.b * a.H + w.h0) * a.D;
  for (int e = threadIdx.x; e < w.gq * a.D; e += kThreads)
    store<T>(o + e, 0.f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 consecutive elements as float (16 or 32 bytes, aligned)
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  const float4 v = *reinterpret_cast<const float4*>(p + 4);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  x[4] = v.x; x[5] = v.y; x[6] = v.z; x[7] = v.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__host__ __device__ __forceinline__ int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// The split's block-table entries, once, into shared memory: all of its
// columns, read while the request's length is on its way (entries past
// the length are never followed).
__device__ __forceinline__ void load_table(const Args& a, const Work& w,
                                           int* tbl_s) {
  const int first = w.split * a.split_blocks;
  const int n = min(a.split_blocks, a.M - first);
  const int* src = a.tables + (size_t)w.b * a.M + first;
  for (int i = threadIdx.x; i < n; i += kThreads) tbl_s[i] = src[i];
}

// Issue the copies of one stage: tokens [t, t + tile) of the split into
// K and V rows of `pitch` elements; rows at or past t1 are zero-filled
// (their slots are never read).
template <typename T>
__device__ __forceinline__ void load_stage(const Args& a, const Work& w,
                                           const int* tbl_s, T* k_s, T* v_s,
                                           int pitch, int t) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = a.D / kVec;
  const size_t tok_stride = (size_t)a.Hkv * a.D;
  const T* kb = static_cast<const T*>(a.k) + (size_t)w.kvh * a.D;
  const T* vb = static_cast<const T*>(a.v) + (size_t)w.kvh * a.D;
  const int first = w.split * a.split_blocks;
  for (int i = threadIdx.x; i < a.tile * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i - r * vpr) * kVec;
    const int tok = t + r;
    T* kd = k_s + r * pitch + c;
    T* vd = v_s + r * pitch + c;
    if (tok < w.t1) {
      const int blk = tok / a.bs;
      const size_t off =
          ((size_t)tbl_s[blk - first] * a.bs + (tok - blk * a.bs)) *
              tok_stride + c;
      cp_async16(kd, kb + off);
      cp_async16(vd, vb + off);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
    }
  }
}

// The split's tokens through the ring: compute(k_s, v_s, valid) for each
// stage in order.  Ends with the block synchronised and the ring free.
template <typename T, typename Compute>
__device__ __forceinline__ void run_pipeline(const Args& a, const Work& w,
                                             const int* tbl_s, T* ring,
                                             int pitch, Compute&& compute) {
  const int stage_elems = a.tile * pitch;
  const int n_tok = w.t1 - w.t0;
  const int n_tiles = (n_tok + a.tile - 1) / a.tile;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      load_stage<T>(a, w, tbl_s, ring + 2 * s * stage_elems,
                    ring + (2 * s + 1) * stage_elems, pitch,
                    w.t0 + s * a.tile);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage i landed; stage i - 1 is free again
    const int nxt = i + kStages - 1;
    if (nxt < n_tiles) {
      const int s = nxt % kStages;
      load_stage<T>(a, w, tbl_s, ring + 2 * s * stage_elems,
                    ring + (2 * s + 1) * stage_elems, pitch,
                    w.t0 + nxt * a.tile);
    }
    cp_async_commit();
    const int s = i % kStages;
    compute(ring + 2 * s * stage_elems, ring + (2 * s + 1) * stage_elems,
            min(a.tile, n_tok - i * a.tile));
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Shared memory that aliases the ring once the split's tokens are done:
// the warps' states red_m / red_l [kWarps][rows], red_acc
// [kWarps][rows][D], then the combine's weights [rows][n_split] and
// denominators [rows].
__host__ __device__ __forceinline__ int red_bytes(int rows, int d,
                                                  int n_split) {
  const int merge = kWarps * rows * (2 + d) * 4;
  const int combine = rows * (n_split + 1) * 4;
  return merge > combine ? merge : combine;
}

// Merge the warps' states (fixed order), then write the output (one live
// split) or this split's partial; the split that arrives last merges the
// partials in split order and writes the output.
template <typename T>
__device__ void finish_split(const Args& a, const Work& w, float* red,
                             int rows, int* s_last) {
  const float* red_m = red;
  const float* red_l = red + kWarps * rows;
  const float* red_acc = red + 2 * kWarps * rows;
  T* o = static_cast<T*>(a.out) + ((size_t)w.b * a.H + w.h0) * a.D;
  const bool direct = w.n_live == 1;
  for (int e = threadIdx.x; e < w.gq * a.D; e += kThreads) {
    const int g = e / a.D;
    const int d = e - g * a.D;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) mx = fmaxf(mx, red_m[i * rows + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const float mi = red_m[i * rows + g];
      const float wt = mi == -INFINITY ? 0.f : exp2f(mi - mx);
      L += red_l[i * rows + g] * wt;
      A += red_acc[(i * rows + g) * a.D + d] * wt;
    }
    if (direct) {
      store<T>(o + e, L == 0.f ? 0.f : A / L);
    } else {
      const size_t p =
          ((size_t)w.b * a.H + w.h0 + g) * a.n_split + w.split;
      a.part_acc[p * a.D + d] = A;
      if (d == 0) {
        a.part_ml[2 * p] = mx;
        a.part_ml[2 * p + 1] = L;
      }
    }
  }
  if (direct) return;

  __threadfence();
  __syncthreads();
  int* counter =
      a.counters + ((size_t)w.b * a.Hkv + w.kvh) * a.qchunks + w.qc;
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(counter, 1);
    *s_last = prev == w.n_live - 1;
    if (*s_last) *counter = 0;   // zero again for the next call
  }
  __syncthreads();
  if (!*s_last) return;
  __threadfence();

  float* wts = red;                        // [rows][n_live]
  float* den = red + rows * w.n_live;      // [rows]
  for (int g = threadIdx.x; g < w.gq; g += kThreads) {
    const float* ml = a.part_ml + ((size_t)w.b * a.H + w.h0 + g) *
                                      a.n_split * 2;
    float mx = -INFINITY;
    for (int s = 0; s < w.n_live; ++s) mx = fmaxf(mx, __ldcg(ml + 2 * s));
    float L = 0.f;
    for (int s = 0; s < w.n_live; ++s) {
      const float ms = __ldcg(ml + 2 * s);
      const float wt = ms == -INFINITY ? 0.f : exp2f(ms - mx);
      wts[g * w.n_live + s] = wt;
      L += __ldcg(ml + 2 * s + 1) * wt;
    }
    den[g] = L;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < w.gq * a.D; e += kThreads) {
    const int g = e / a.D;
    const int d = e - g * a.D;
    const float* acc =
        a.part_acc + ((size_t)w.b * a.H + w.h0 + g) * a.n_split * a.D + d;
    float A = 0.f;
    for (int s = 0; s < w.n_live; ++s)
      A += __ldcg(acc + (size_t)s * a.D) * wts[g * w.n_live + s];
    const float L = den[g];
    store<T>(o + e, L == 0.f ? 0.f : A / L);
  }
}

// ------------------------- group 1 and float32 --------------------------
// LPR lanes a token row, 8 elements a lane; G query heads a block.
template <typename T, int LPR, int G>
__global__ void __launch_bounds__(kThreads) paged_simt(Args a) {
  constexpr int RPW = 32 / LPR;   // tokens a warp takes at once
  constexpr int NR = kWarps * RPW;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  Work w;
  locate(a, w);
  const int len = a.lengths[w.b];   // in flight with the table and queries
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane % LPR;
  const bool dl = sub * 8 < a.D;   // this lane holds part of the row
  int* tbl_s = reinterpret_cast<int*>(smem);
  T* ring = reinterpret_cast<T*>(smem + align16(a.split_blocks * 4));
  load_table(a, w, tbl_s);

  float qf[G][8], acc[G][8], m[G], l[G];
  const T* qb = static_cast<const T*>(a.q) +
                ((size_t)w.b * a.H + w.h0) * a.D + sub * 8;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < w.gq && dl) {
      load8(qb + (size_t)g * a.D, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qf[g][e] *= a.scale_log2;
      acc[g][e] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  if (!measure(a, len, w)) {
    if (w.split == 0 && w.n_live == 0) write_zeros<T>(a, w);
    return;
  }
  __syncthreads();   // the table slice

  const int pitch = a.D;
  run_pipeline<T>(a, w, tbl_s, ring, pitch,
                  [&](const T* k_s, const T* v_s, int valid) {
    for (int j0 = warp * RPW; j0 < valid; j0 += NR) {   // warp-uniform
      const int j = j0 + lane / LPR;
      const bool ok = j < valid;
      float kf[8];
      if (ok && dl) {
        load8(k_s + j * pitch + sub * 8, kf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = 0.f;
      }
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) x = fmaf(qf[g][e], kf[e], x);
        s[g] = x;
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
      }
      if (ok) {
        float vf[8];
        if (dl) {
          load8(v_s + j * pitch + sub * 8, vf);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) vf[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          // one exponential: the larger of m and s stays the max
          const float gap = s[g] - m[g];            // +inf while m = -inf
          const float e = exp2f(-fabsf(gap));
          const bool up = gap > 0.f;
          const float corr = up ? e : 1.f;
          const float p = up ? 1.f : e;
          m[g] = up ? s[g] : m[g];
          l[g] = fmaf(l[g], corr, p);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[g][i] = fmaf(acc[g][i], corr, p * vf[i]);
        }
      }
    }
  });

  // the warp's lane groups, by a butterfly (both partners get equal sums)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float ws = m[g] == -INFINITY ? 0.f : exp2f(m[g] - mn);
      const float wo = mo == -INFINITY ? 0.f : exp2f(mo - mn);
      l[g] = l[g] * ws + lo * wo;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[g][i] = acc[g][i] * ws +
                    __shfl_xor_sync(0xffffffffu, acc[g][i], off) * wo;
      m[g] = mn;
    }
  }
  float* red = reinterpret_cast<float*>(ring);
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < w.gq) {
        if (lane == 0) {
          red[warp * G + g] = m[g];
          red[kWarps * G + warp * G + g] = l[g];
        }
        if (dl) {
          float* dst = red + 2 * kWarps * G + (warp * G + g) * a.D + sub * 8;
#pragma unroll
          for (int i = 0; i < 8; ++i) dst[i] = acc[g][i];
        }
      }
    }
  }
  __syncthreads();
  finish_split<T>(a, w, red, G, &s_last);
}

// ------------------------- bf16 GQA: mma.sync ---------------------------
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// c += a b: m16n8k16, A row-major (4 x b32), B column-major (2 x b32)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 b16 matrices: lane i gives the address of row (i % 8) of
// matrix (i / 8)
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

template <int D>
__global__ void __launch_bounds__(kThreads) paged_mma(Args a) {
  constexpr int KD = D / 16;    // k-steps of Q K^T, n-tile pairs of P V
  constexpr int P = D + 8;      // row pitch in shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  Work w;
  locate(a, w);
  const int len = a.lengths[w.b];   // in flight with the table and queries
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* tbl_s = reinterpret_cast<int*>(smem);
  bf16* q_s = reinterpret_cast<bf16*>(smem + align16(a.split_blocks * 4));
  bf16* ring = q_s + kMmaRows * P;
  load_table(a, w, tbl_s);
  const bf16* qb =
      static_cast<const bf16*>(a.q) + ((size_t)w.b * a.H + w.h0) * D;
  for (int i = tid; i < kMmaRows * (D / 8); i += kThreads) {
    const int r = i / (D / 8);
    const int c = (i - r * (D / 8)) * 8;
    *reinterpret_cast<uint4*>(q_s + r * P + c) =
        r < w.gq ? *reinterpret_cast<const uint4*>(qb + r * D + c)
                 : make_uint4(0, 0, 0, 0);
  }
  if (!measure(a, len, w)) {
    if (w.split == 0 && w.n_live == 0) write_zeros<bf16>(a, w);
    return;
  }
  __syncthreads();   // the table slice and the queries

  // rows lane / 4 and lane / 4 + 8; columns 2 (lane % 4) + {0, 1}
  float acc[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int quad_col = 2 * (lane & 3);

  run_pipeline<bf16>(a, w, tbl_s, ring, P,
                     [&](const bf16* k_s, const bf16* v_s, int valid) {
    const int tok0 = warp * 16;   // this warp's 16 tokens of the stage
    if (tok0 >= valid) return;    // warp-uniform
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      uint32_t qa[4], kb[4];
      ldmatrix_x4(qa, q_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * P +
                          ks * 16 + (lane >> 4) * 8);
      ldmatrix_x4(kb, k_s + (tok0 + (lane & 7) + (lane >> 4) * 8) * P +
                          ks * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(sc[0], qa, kb[0], kb[1]);
      mma_bf16(sc[1], qa, kb[2], kb[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sc[n][c] = tok0 + n * 8 + quad_col + (c & 1) < valid
                       ? sc[n][c] * a.scale_log2
                       : -INFINITY;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mx = quad_max(fmaxf(fmaxf(sc[0][2 * r], sc[0][2 * r + 1]),
                                      fmaxf(sc[1][2 * r], sc[1][2 * r + 1])));
      const float mn = fmaxf(m[r], mx);      // finite: token tok0 is valid
      const float corr = exp2f(m[r] - mn);   // 0 while m = -inf
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(sc[n][2 * r + c] - mn);
          sc[n][2 * r + c] = p;
          sum += p;
        }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int n = 0; n < 2 * KD; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }
    // P as the A fragment of one k-step (16 tokens), bf16 hi + lo
    uint32_t phi[4], plo[4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = sc[n][2 * r], p1 = sc[n][2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
        phi[2 * n + r] = bf16x2_bits(hi);
        plo[2 * n + r] = bf16x2_bits(lo);
      }
#pragma unroll
    for (int dp = 0; dp < KD; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, v_s + (tok0 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * P +
                                dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], phi, vb[0], vb[1]);
      mma_bf16(acc[2 * dp], plo, vb[0], vb[1]);
      mma_bf16(acc[2 * dp + 1], phi, vb[2], vb[3]);
      mma_bf16(acc[2 * dp + 1], plo, vb[2], vb[3]);
    }
  });

  float* red = reinterpret_cast<float*>(ring);
  constexpr int R = kMmaRows;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = (lane >> 2) + 8 * r;
    const float lr = quad_sum(l[r]);
    if (row < w.gq) {
      if ((lane & 3) == 0) {
        red[warp * R + row] = m[r];
        red[kWarps * R + warp * R + row] = lr;
      }
      float* dst = red + 2 * kWarps * R + (warp * R + row) * D + quad_col;
#pragma unroll
      for (int n = 0; n < 2 * KD; ++n) {
        dst[n * 8] = acc[n][2 * r];
        dst[n * 8 + 1] = acc[n][2 * r + 1];
      }
    }
  }
  __syncthreads();
  finish_split<bf16>(a, w, red, R, &s_last);
}

// ------------------------------- launch ---------------------------------
int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// How a call runs: the kernel, its query heads a block and tokens a
// stage, and its dynamic shared memory.
struct Config {
  const void* kernel;
  bool mma;
  int qrows, tile, smem;
};

template <typename T, int LPR>
const void* simt_kernel(int g) {
  switch (g) {
    case 1: return reinterpret_cast<const void*>(paged_simt<T, LPR, 1>);
    case 2: return reinterpret_cast<const void*>(paged_simt<T, LPR, 2>);
    case 4: return reinterpret_cast<const void*>(paged_simt<T, LPR, 4>);
    default: return reinterpret_cast<const void*>(paged_simt<T, LPR, 8>);
  }
}

template <typename T>
const void* simt_kernel(int lpr, int g) {
  switch (lpr) {
    case 1: return simt_kernel<T, 1>(g);
    case 2: return simt_kernel<T, 2>(g);
    case 4: return simt_kernel<T, 4>(g);
    case 8: return simt_kernel<T, 8>(g);
    case 16: return simt_kernel<T, 16>(g);
    default: return simt_kernel<T, 32>(g);
  }
}

// paged_mma is built at the configs' head dims only (the flash kernel's
// HEAD_DIMS); bf16 GQA at any other D takes paged_simt.
const void* mma_kernel(int d) {
  switch (d) {
    case 16: return reinterpret_cast<const void*>(paged_mma<16>);
    case 32: return reinterpret_cast<const void*>(paged_mma<32>);
    case 64: return reinterpret_cast<const void*>(paged_mma<64>);
    case 96: return reinterpret_cast<const void*>(paged_mma<96>);
    case 128: return reinterpret_cast<const void*>(paged_mma<128>);
    case 160: return reinterpret_cast<const void*>(paged_mma<160>);
    default: return nullptr;
  }
}

// dtype: 0 = float32, 1 = bfloat16.  False on what the kernels do not take.
bool configure(int dtype, int group, int d, int split_blocks, int n_split,
               Config* c) {
  if ((dtype != 0 && dtype != 1) || group < 1 || d < 8 || d > 256 ||
      d % 8 || split_blocks < 1 || split_blocks > kMaxSplitBlocks ||
      n_split < 1 || n_split > kMaxSplits)
    return false;
  const int esize = dtype == 0 ? 4 : 2;
  int queries, ring;   // bytes: the mma kernel's queries, the ring
  if (dtype == 1 && group > 1 && mma_kernel(d) != nullptr) {
    c->mma = true;
    c->kernel = mma_kernel(d);
    c->qrows = kMmaRows;
    c->tile = kMmaTile;
    queries = kMmaRows * (d + 8) * esize;
    ring = kStages * 2 * kMmaTile * (d + 8) * esize;
  } else {
    c->mma = false;
    const int g = pow2_at_least(group < kSimtRows ? group : kSimtRows);
    const int lpr = pow2_at_least(d / 8);
    c->kernel = dtype == 0 ? simt_kernel<float>(lpr, g)
                           : simt_kernel<bf16>(lpr, g);
    c->qrows = g;
    int tile = kStageBytes / (d * esize);
    tile = tile < 16 ? 16 : (tile > 128 ? 128 : tile);
    c->tile = tile;
    queries = 0;
    ring = kStages * 2 * tile * d * esize;
  }
  // table slice | queries | ring, which the merge buffers alias later
  const int red = red_bytes(c->qrows, d, n_split);
  c->smem = align16(split_blocks * 4) + queries + (ring > red ? ring : red);
  return c->kernel != nullptr;
}

cudaError_t set_smem(const void* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes (-1: not supported).
long long paged_attention_smem_bytes(int dtype, int group, int d,
                                     int split_blocks, int n_split) {
  Config c;
  if (!configure(dtype, group, d, split_blocks, n_split, &c)) return -1;
  return c.smem;
}

// How one call runs on the current card: registers and spilled bytes a
// thread, threads and dynamic shared memory a block, resident blocks per
// SM (the occupancy API), query heads a block, tokens a stage and the
// kernel (0 paged_simt, 1 paged_mma), into out[0..7].  Returns a
// cudaError_t.
int paged_attention_describe(int dtype, int group, int d, int split_blocks,
                             int n_split, int* out) {
  Config c;
  if (!configure(dtype, group, d, split_blocks, n_split, &c))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = set_smem(c.kernel, c.smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, c.kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c.kernel,
                                                        kThreads, c.smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = kThreads;
  out[3] = c.smem;
  out[4] = blocks;
  out[5] = c.qrows;
  out[6] = c.tile;
  out[7] = c.mma ? 1 : 0;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  part_acc [B, H, n_split, D] and
// part_ml [B, H, n_split, 2] float32 are scratch (unused when n_split is
// 1); counters [B * H] int32 must be zero and are zero again when the
// kernel ends.  Returns a cudaError_t (0 = success).
int paged_attention(int dtype, const void* q, const void* k_pages,
                    const void* v_pages, const void* block_tables,
                    const void* lengths, void* out, void* part_acc,
                    void* part_ml, void* counters, int B, int H, int Hkv,
                    int D, int bs, int M, int split_blocks, int n_split,
                    float scale, void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv || bs < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  Config c;
  if (!configure(dtype, H / Hkv, D, split_blocks, n_split, &c))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k_pages;
  a.v = v_pages;
  a.tables = static_cast<const int*>(block_tables);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.counters = static_cast<int*>(counters);
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.bs = bs;
  a.M = M;
  a.group = H / Hkv;
  a.qrows = c.qrows;
  a.qchunks = (a.group + c.qrows - 1) / c.qrows;
  a.split_blocks = split_blocks;
  a.n_split = n_split;
  a.tile = c.tile;
  a.scale_log2 = scale * kLog2e;
  const cudaError_t err = set_smem(c.kernel, c.smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&a};
  const dim3 grid(n_split, Hkv * a.qchunks, B);
  return (int)cudaLaunchKernel(c.kernel, grid, dim3(kThreads), params,
                               (size_t)c.smem,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
