// Flash attention forward for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py :: flash_attention (_flash_kernel)
// and computes the same function: o = softmax(scale * q k^T + mask) v for
// q [B, H, S, D] and k, v [B, Hkv, S, D], with scale = 1/sqrt(D), GQA
// (query head h reads KV head h / (H / Hkv), no repeated K/V copy), an
// optional causal mask and an optional sliding window (key k is kept for
// query i when k <= i and k > i - window).  The online softmax walks the
// KV tiles with a running max m, denominator l and float32 accumulator;
// KV tiles wholly outside the mask are never visited
// (flash_attention.py:45-50); a row with no key left gives output 0 (the
// l == 0 guard of _finalize, :80-86).  It also writes the float32 row
// log-sum-exp lse = m + log(l) of the scaled logits (-inf for such a
// row), which the backward needs.
//
// What bounds it on an H100: operations.  Causal attention at the
// minicpm-2b train shape (B 2, H 36, S 4096, D 64) does 2 S^2 D FLOPs per
// (batch, head), 154.6 GFLOP, 0.156 ms at the tensor cores' 989 TFLOP/s,
// against 151 MB of inputs and outputs (45 us at 3.35 TB/s).
//
// Design (a first kernel: simple and right; wgmma, TMA and a persistent
// schedule are later work):
//  * one thread block per (query tile of 64 rows, batch x head); a loop
//    inside the block walks the needed KV tiles (the TPU grid's sequential
//    KV axis); the causal tiles with the most work are launched first;
//  * bfloat16 inputs (flash_fwd_bf16): 4 warps, 16 query rows each.  K and
//    V tiles of 64 keys are double-buffered in shared memory by cp.async
//    (16-byte copies), so the next tile's loads overlap this tile's
//    products.  Q K^T runs on the tensor cores (mma.sync m16n8k16, bf16
//    inputs, float32 accumulators: products of bf16 are exact in float32,
//    so this is the reference's float32 dot up to the order of the adds).
//    The scale multiplies the float32 dot (the reference scales the
//    float32 q first: the two differ by float32 rounding, ~1e-7 relative).
//    P V must not round P to bf16 (that is the attn_probs_bf16 lever,
//    a different function): P is split into P_hi = bf16(P) and P_lo =
//    bf16(P - P_hi), and P_hi V + P_lo V run as two bf16 MMAs with float32
//    accumulators.  The split keeps 16 of P's 24 mantissa bits (error
//    ~2^-17 of P, far below the bf16 output's 2^-9 rounding) and keeps
//    P V on the tensor cores at twice the MMA count; float32 on the SIMT
//    units would cap it at 67 TFLOP/s.  The score fragments become the
//    next MMA's A operand in registers; V's B fragments come from shared
//    memory through ldmatrix.trans;
//  * float32 inputs (flash_fwd_f32): the reference's full float32 on the
//    SIMT units (FMA, not TF32): q is cast and scaled first, as the
//    reference does; 4 x 4 scores and 4 x D/8 outputs per thread over KV
//    tiles of 32 keys, P staged in shared memory;
//  * exponentials are exp2f of (s - m) * log2(e); masked scores are -inf
//    and give exact zeros; a row whose running max is still -inf uses 0 in
//    its place, as the reference's safe_m does.
//
// Limits (checked by the Python wrapper): T is float or bf16, D is 16, 32,
// 64 or 128, S a multiple of 64 (flash_attention_tile()), the last dimension
// of every tensor contiguous and, for bf16, 16-byte aligned rows.
// Plain C interface (loaded with ctypes); returns the cudaError_t of the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // 4 warps
constexpr int kBlockQ = 64;     // query rows per block
constexpr int kBlockK = 64;     // keys per KV tile, bf16 kernel
constexpr int kBlockKF = 32;    // keys per KV tile, float32 kernel
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int h, hkv, s;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int causal, has_window, window;
  float scale;
};

// The KV tiles [lo, hi) with any key a query of rows [q0, q0 + kBlockQ)
// keeps: the Pallas kernel's `needed` test, as a range.
__device__ __forceinline__ void kv_range(const Args& a, int q0, int tile,
                                         int* lo, int* hi) {
  const int nkt = a.s / tile;
  *hi = a.causal ? min(nkt, (q0 + kBlockQ - 1) / tile + 1) : nkt;
  *lo = 0;
  if (a.has_window) {
    // needed: kt * tile + tile - 1 > q0 - window
    const long long first = (long long)q0 - a.window - tile + 2;
    if (first > 0)
      *lo = (int)min((first + tile - 1) / tile, (long long)nkt);
  }
}

// Whether every (query, key) pair of the tile is kept (no mask needed).
__device__ __forceinline__ bool tile_full(const Args& a, int q0, int k0,
                                          int tile) {
  const bool causal_ok = !a.causal || k0 + tile - 1 <= q0;
  const bool window_ok =
      !a.has_window || (long long)k0 > (long long)q0 + kBlockQ - 1 - a.window;
  return causal_ok && window_ok;
}

__device__ __forceinline__ bool kept(const Args& a, int row, int col) {
  bool ok = true;
  if (a.causal) ok = ok && col <= row;
  if (a.has_window) ok = ok && (long long)col > (long long)row - a.window;
  return ok;
}

__device__ __forceinline__ float group_max4(float x) {   // 4 lanes of a quad
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float group_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Running max update of one row: returns the correction factor of the
// old accumulator and leaves the new max in *m; *safe is the max to
// subtract (0 while the row has seen no key).
__device__ __forceinline__ float online_update(float* m, float tile_max,
                                               float* safe) {
  const float m_new = fmaxf(*m, tile_max);
  *safe = (m_new == -INFINITY) ? 0.f : m_new;
  const float corr =
      (*m == -INFINITY) ? 0.f : exp2f((*m - *safe) * kLog2e);
  *m = m_new;
  return corr;
}

// ------------------------------- bfloat16 -------------------------------
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

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
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

// four 8 x 8 b16 matrices, transposed: lane i gives the address of row
// (i % 8) of matrix (i / 8)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const bf16* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// rows [0, 64) of a [*, D] tile at `src` (row stride `ss`) into shared
// memory with row pitch D + 8 elements (16-byte rows, conflict-free
// fragment loads)
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ss) {
  constexpr int kChunks = D / 8;          // 16-byte chunks per row
  constexpr int P = D + 8;
  for (int c = threadIdx.x; c < 64 * kChunks; c += kThreads) {
    const int row = c / kChunks, col = (c % kChunks) * 8;
    cp_async16(dst + row * P + col, src + row * ss + col);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Args a) {
  constexpr int P = D + 8;
  constexpr int KS = D / 16;    // k-steps of Q K^T
  constexpr int NT = D / 8;     // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);      // [64][P]
  bf16* ks = qs + kBlockQ * P;                       // [2][64][P]
  bf16* vs = ks + 2 * kBlockK * P;                   // [2][64][P]

  const int qt = gridDim.x - 1 - blockIdx.x;         // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.h, h = bh % a.h;
  const int hk = h / (a.h / a.hkv);
  const int q0 = qt * kBlockQ;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh +
                   (long long)q0 * a.qss;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ksb + hk * a.ksh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vsb + hk * a.vsh;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;               // and row0 + 8

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};                           // this lane's part
  uint32_t qf[KS][4];

  int kt_lo, kt_hi;
  kv_range(a, q0, kBlockK, &kt_lo, &kt_hi);
  if (kt_lo < kt_hi) {
    load_tile<D>(qs, qg, a.qss);
    load_tile<D>(ks, kg + (long long)kt_lo * kBlockK * a.kss, a.kss);
    load_tile<D>(vs, vg + (long long)kt_lo * kBlockK * a.vss, a.vss);
    cp_async_commit();
  }
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {
      const long long k1 = (long long)(kt + 1) * kBlockK;
      load_tile<D>(ks + (buf ^ 1) * kBlockK * P, kg + k1 * a.kss, a.kss);
      load_tile<D>(vs + (buf ^ 1) * kBlockK * P, vg + k1 * a.vss, a.vss);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == kt_lo) {
      const bf16* qw = qs + warp * 16 * P;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qf[kk][0] = lds32(qw + g * P + kk * 16 + 2 * t4);
        qf[kk][1] = lds32(qw + (g + 8) * P + kk * 16 + 2 * t4);
        qf[kk][2] = lds32(qw + g * P + kk * 16 + 8 + 2 * t4);
        qf[kk][3] = lds32(qw + (g + 8) * P + kk * 16 + 8 + 2 * t4);
      }
    }
    const bf16* kb = ks + buf * kBlockK * P;
    const bf16* vb = vs + buf * kBlockK * P;

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      const bf16* krow = kb + (nt * 8 + g) * P + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_bf16(sc[nt], qf[kk], lds32(krow + kk * 16),
                 lds32(krow + kk * 16 + 8));
    }

    // scale, mask, row max (rows g and g + 8 of the warp's 16)
    const int k0 = kt * kBlockK;
    const bool full = tile_full(a, q0, k0, kBlockK);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[nt][e] * a.scale;
        if (!full && !kept(a, row0 + (e >> 1) * 8,
                           k0 + nt * 8 + 2 * t4 + (e & 1)))
          s = -INFINITY;
        sc[nt][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    }
    float corr[2], safe[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      corr[i] = online_update(&m[i], group_max4(mx[i]), &safe[i]);
      l[i] *= corr[i];
    }

    // P = exp(S - m) as A fragments (k-step kk = keys 16 kk .. 16 kk + 15
    // = n-tiles 2 kk and 2 kk + 1), split into bf16 hi + lo parts
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      bf16 hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((sc[nt][e] - safe[e >> 1]) * kLog2e);
        l[e >> 1] += p;
        hi[e] = __float2bfloat16_rn(p);
        lo[e] = __float2bfloat16_rn(p - __bfloat162float(hi[e]));
      }
      const int kk = nt >> 1, half = (nt & 1) * 2;
      phi[kk][half] = pack_bf16(hi[0], hi[1]);
      phi[kk][half + 1] = pack_bf16(hi[2], hi[3]);
      plo[kk][half] = pack_bf16(lo[0], lo[1]);
      plo[kk][half + 1] = pack_bf16(lo[2], lo[3]);
    }

#pragma unroll
    for (int i = 0; i < NT; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }
    // O += P V: V [64 keys][D] row-major; B fragments through ldmatrix
    const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vb + (kk * 16 + (mi & 1) * 8 + ri) * P +
                                  dp * 16 + (mi >> 1) * 8);
        mma_bf16(acc[2 * dp], phi[kk], vf[0], vf[1]);
        mma_bf16(acc[2 * dp], plo[kk], vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], phi[kk], vf[2], vf[3]);
        mma_bf16(acc[2 * dp + 1], plo[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();      // every warp is done with `buf` before its refill
  }

  // o = acc / l (l == 0 -> 1: zeros), lse = m + log(l)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = group_sum4(l[i]);
    const float inv = (li == 0.f) ? 1.f : 1.f / li;
    const int row = row0 + i * 8;
    bf16* orow = static_cast<bf16*>(a.o) + b * a.osb + h * a.osh +
                 (long long)row * a.oss + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<uint32_t*>(orow + nt * 8) =
          pack_bf16(__float2bfloat16_rn(acc[nt][2 * i] * inv),
                    __float2bfloat16_rn(acc[nt][2 * i + 1] * inv));
    if (t4 == 0)
      a.lse[(long long)bh * a.s + row] =
          (li == 0.f) ? -INFINITY : m[i] + logf(li);
  }
}

// ------------------------------- float32 --------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(Args a) {
  constexpr int P = D + 1;          // odd pitch: conflict-free columns
  constexpr int PP = kBlockKF + 1;
  constexpr int NC = D / 8;         // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [64][P], q * scale
  float* ks = qs + kBlockQ * P;                     // [32][P]
  float* vs = ks + kBlockKF * P;                    // [32][P]
  float* ps = vs + kBlockKF * P;                    // [64][PP]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.h, h = bh % a.h;
  const int hk = h / (a.h / a.hkv);
  const int q0 = qt * kBlockQ;
  const float* qg = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh +
                    (long long)q0 * a.qss;
  const float* kg = static_cast<const float*>(a.k) + b * a.ksb + hk * a.ksh;
  const float* vg = static_cast<const float*>(a.v) + b * a.vsb + hk * a.vsh;

  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;   // rows 4 ty + i; keys tx + 8 j
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  int kt_lo, kt_hi;
  kv_range(a, q0, kBlockKF, &kt_lo, &kt_hi);
  for (int e = tid; e < kBlockQ * D; e += kThreads)
    qs[(e / D) * P + e % D] = qg[(e / D) * a.qss + e % D] * a.scale;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBlockKF;
    __syncthreads();      // q stored; the last tile's K, V, P consumed
    for (int e = tid; e < kBlockKF * D; e += kThreads) {
      const int row = e / D, col = e % D;
      ks[row * P + col] = kg[(long long)(k0 + row) * a.kss + col];
      vs[row * P + col] = vg[(long long)(k0 + row) * a.vss + col];
    }
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 8 * j) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
    const bool full = tile_full(a, q0, k0, kBlockKF);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!full && !kept(a, row, k0 + tx + 8 * j)) sc[i][j] = -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
      // the 8 lanes of one row are consecutive
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      float safe;
      const float corr = online_update(&m[i], mx, &safe);
      l[i] *= corr;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f((sc[i][j] - safe) * kLog2e);
        l[i] += p;
        ps[(4 * ty + i) * PP + tx + 8 * j] = p;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBlockKF; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[kk * P + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int row = q0 + 4 * ty + i;
    float* orow = static_cast<float*>(a.o) + b * a.osb + h * a.osh +
                  (long long)row * a.oss;
    const float div = (li == 0.f) ? 1.f : li;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 8 * c] = acc[i][c] / div;
    if (tx == 0)
      a.lse[(long long)bh * a.s + row] =
          (li == 0.f) ? -INFINITY : m[i] + logf(li);
  }
}

template <int D>
size_t smem_bytes(int dtype) {
  if (dtype == 1) return (size_t)(kBlockQ + 4 * kBlockK) * (D + 8) * 2;
  return ((size_t)(kBlockQ + 2 * kBlockKF) * (D + 1) +
          (size_t)kBlockQ * (kBlockKF + 1)) * 4;
}

template <int D>
int launch(int dtype, const Args& a, int b, cudaStream_t stream) {
  const dim3 grid(a.s / kBlockQ, b * a.h);
  const size_t smem = smem_bytes<D>(dtype);
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_bf16<D><<<grid, kThreads, smem, stream>>>(a);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The sequence tile: S must be a multiple of it.
extern "C" int flash_attention_tile() { return kBlockQ; }

// dtype: 0 float32, 1 bfloat16.  q [b, h, s, d], k/v [b, hkv, s, d] and
// o [b, h, s, d] given by element strides (batch, head, row; the last
// dimension contiguous); lse [b, h, s] contiguous float32.  causal and
// has_window are 0/1.  s % flash_attention_tile() == 0, d in {16, 32,
// 64, 128} (the wrapper checks).
extern "C" int flash_attention_fwd(
    int dtype, int d, const void* q, const void* k, const void* v, void* o,
    float* lse, int b, int h, int hkv, int s, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, int causal, int has_window, int window,
    float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (b <= 0 || s <= 0) return 0;
  const Args a{q,   k,   v,   o,   lse, h,   hkv,    s,
               qsb, qsh, qss, ksb, ksh, kss, vsb,    vsh,
               vss, osb, osh, oss, causal, has_window, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(dtype, a, b, st);
    case 32: return launch<32>(dtype, a, b, st);
    case 64: return launch<64>(dtype, a, b, st);
    case 128: return launch<128>(dtype, a, b, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
