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
// Design: one thread block per (query tile, batch x head); a loop inside
// the block walks the needed KV tiles (the TPU grid's sequential KV axis);
// the causal tiles with the most work are launched first.  Three
// variants, chosen by the caller:
//  * wgmma (bfloat16, D 64 or 128; flash_fwd_wgmma), after FlashAttention-3:
//    128-row query tiles and KV tiles of 64 keys, warp-specialised.  A
//    producer warpgroup gives up its registers (setmaxnreg) and one of its
//    threads loads Q once, then K and V tiles by TMA (rank-4 tensor maps
//    (D, S, H, B) over the given strides, so strided [B, S, H, D] views
//    need no copy) into a ring of 6 shared-memory stages guarded by
//    mbarriers (112 KB at D 64, 224 KB at D 128).  Two consumer
//    warpgroups take 64 query rows each: S = Q K^T by wgmma m64n64k16
//    with both operands in shared memory (K-major, 128-byte swizzle),
//    float32 accumulators in registers; the online softmax below on those
//    fragments; then O += P V by wgmma m64nDk16 with P from registers
//    (the accumulator's layout is the A operand's) and V from shared
//    memory (row-major, so MN-major: the transpose-B bit).  P keeps the
//    split below: two wgmmas, bf16(P) and bf16(P - bf16(P)), into the
//    same accumulators.  Each consumer issues tile j's Q K^T together
//    with tile j - 1's P V and runs the softmax of tile j while P V is on
//    the tensor cores; the two consumers take turns to issue, so that
//    one's softmax overlaps the other's products.  S a multiple of 64 but
//    not of 128: the last query tile's rows past S are computed on zeros
//    (TMA fills outside the tensor) and not stored;
//  * mma_sync (bfloat16, any D; flash_fwd_bf16), the pre-Hopper kernel:
//    64-row query tiles, 4 warps, 16 query rows each.  K and
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
//  * simt_f32 (float32 inputs; flash_fwd_f32): the reference's full
//    float32 on the SIMT units (FMA, not TF32): q is cast and scaled
//    first, as the reference does; 4 x 4 scores and 4 x D/8 outputs per
//    thread over KV tiles of 32 keys, P staged in shared memory;
//  * exponentials are exp2f of (s - m) * log2(e) (the wgmma variant folds
//    the scale: exp2f(s_raw * scale * log2(e) - m * log2(e)), one FMA);
//    masked scores are -inf and give exact zeros; a row whose running max
//    is still -inf uses 0 in its place, as the reference's safe_m does.
//
// Head dims 96 (phi3-mini-3.8b), 160 (mistral-nemo-12b) and 256
// (recurrentgemma-9b's local attention, MQA 16/1) take the two templated
// kernels, mma_sync and simt_f32: a row is 12, 20 or 32 16-byte cp.async
// chunks (the copy loop divides by a constant, no power of two needed);
// the bf16 row pitch (D + 8) * 2 = 208, 336 or 528 bytes is an odd
// multiple of 16 bytes, so fragment loads and ldmatrix stay conflict-free.
// At D 160 the mma_sync kernel's 64-key tiles spilled (255 registers: 80
// accumulators, Q's 40 fragment registers, S and P's halves), so D 160
// and 256 take 32-key KV tiles (block_k_bf16).  At D 256 the output alone
// is 128 float32 accumulators a thread, and Q's fragments would add 64:
// there each warp reads its Q fragments from shared memory at every
// k-step of Q K^T (q_in_registers), and simt_f32 walks P V one V column
// at a time, so that no row of V is held in registers beside the 128
// outputs.  Shared memory is 66,560 / 64,512 / 101,376 bytes (bf16) and
// 58,112 / 90,880 / 140,032 (float32), above 48 KB, so each launch sets
// the dynamic-size attribute.
//
// Limits (checked by the Python wrapper): T is float or bf16, D is 16, 32,
// 64, 96, 128, 160 or 256, S a multiple of 64 (flash_attention_tile()), the last dimension
// of every tensor contiguous and, for bf16, 16-byte aligned rows (and so
// strides that are multiples of 16 bytes, as TMA needs).
// Plain C interface (loaded with ctypes); returns the cudaError_t of the
// launch, or hopper::kEncodeError + the CUresult if a tensor map cannot be
// encoded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // 4 warps
constexpr int kBlockQ = 64;     // query rows per block
constexpr int kBlockK = 64;     // keys per KV tile, bf16 kernel
// ... except at D 160, where 64-key tiles (S, P's halves and 80 float32
// accumulators live together) spill: 32 keys there
template <int D>
__host__ __device__ constexpr int block_k_bf16() { return D > 128 ? 32 : kBlockK; }
// whether the bf16 kernel keeps a warp's Q fragments in registers for
// the whole KV loop (D / 4 registers a thread); above D 160 they are read
// from shared memory at each k-step instead
template <int D>
__host__ __device__ constexpr bool q_in_registers() { return D <= 160; }
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

// rows [0, ROWS) of a [*, D] tile at `src` (row stride `ss`) into shared
// memory with row pitch D + 8 elements (16-byte rows, conflict-free
// fragment loads)
template <int D, int ROWS = 64>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ss) {
  constexpr int kChunks = D / 8;          // 16-byte chunks per row
  constexpr int P = D + 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int row = c / kChunks, col = (c % kChunks) * 8;
    cp_async16(dst + row * P + col, src + row * ss + col);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Args a) {
  constexpr int P = D + 8;
  constexpr int KS = D / 16;    // k-steps of Q K^T
  constexpr int NT = D / 8;     // n-tiles of the output
  constexpr int BK = block_k_bf16<D>();   // keys per KV tile
  constexpr int KK = BK / 16;   // k-steps of P V
  constexpr bool kQRegs = q_in_registers<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);      // [64][P]
  bf16* ks = qs + kBlockQ * P;                       // [2][BK][P]
  bf16* vs = ks + 2 * BK * P;                        // [2][BK][P]

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
  uint32_t qf[kQRegs ? KS : 1][4];

  int kt_lo, kt_hi;
  kv_range(a, q0, BK, &kt_lo, &kt_hi);
  if (kt_lo < kt_hi) {
    load_tile<D>(qs, qg, a.qss);
    load_tile<D, BK>(ks, kg + (long long)kt_lo * BK * a.kss, a.kss);
    load_tile<D, BK>(vs, vg + (long long)kt_lo * BK * a.vss, a.vss);
    cp_async_commit();
  }
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {
      const long long k1 = (long long)(kt + 1) * BK;
      load_tile<D, BK>(ks + (buf ^ 1) * BK * P, kg + k1 * a.kss, a.kss);
      load_tile<D, BK>(vs + (buf ^ 1) * BK * P, vg + k1 * a.vss, a.vss);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qw = qs + warp * 16 * P;
    if constexpr (kQRegs) {
      if (kt == kt_lo) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          qf[kk][0] = lds32(qw + g * P + kk * 16 + 2 * t4);
          qf[kk][1] = lds32(qw + (g + 8) * P + kk * 16 + 2 * t4);
          qf[kk][2] = lds32(qw + g * P + kk * 16 + 8 + 2 * t4);
          qf[kk][3] = lds32(qw + (g + 8) * P + kk * 16 + 8 + 2 * t4);
        }
      }
    }
    const bf16* kb = ks + buf * BK * P;
    const bf16* vb = vs + buf * BK * P;

    // S = Q K^T for this warp's 16 rows x BK keys (n-tiles of 8 keys)
    float sc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
    if constexpr (kQRegs) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const bf16* krow = kb + (nt * 8 + g) * P + 2 * t4;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          mma_bf16(sc[nt], qf[kk], lds32(krow + kk * 16),
                   lds32(krow + kk * 16 + 8));
      }
    } else {
      // k-step outer: one k-step's Q fragment (4 registers) serves every
      // n-tile of keys
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qk[4];
        qk[0] = lds32(qw + g * P + kk * 16 + 2 * t4);
        qk[1] = lds32(qw + (g + 8) * P + kk * 16 + 2 * t4);
        qk[2] = lds32(qw + g * P + kk * 16 + 8 + 2 * t4);
        qk[3] = lds32(qw + (g + 8) * P + kk * 16 + 8 + 2 * t4);
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
          const bf16* krow = kb + (nt * 8 + g) * P + 2 * t4;
          mma_bf16(sc[nt], qk, lds32(krow + kk * 16),
                   lds32(krow + kk * 16 + 8));
        }
      }
    }

    // scale, mask, row max (rows g and g + 8 of the warp's 16)
    const int k0 = kt * BK;
    const bool full = tile_full(a, q0, k0, BK);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
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
    uint32_t phi[KK][4], plo[KK][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
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
    // O += P V: V [BK keys][D] row-major; B fragments through ldmatrix
    const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
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
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * PP + kk];
      if constexpr (NC <= 20) {
        float vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = vs[kk * P + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      } else {
        // D 256: 128 outputs a thread; one V value live at a time
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vc = vs[kk * P + tx + 8 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vc, acc[i][c]);
        }
      }
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

// ---------------------------- bfloat16, wgmma ----------------------------
namespace fa3 {

constexpr int kBQ = 128;          // query rows per block
// keys per KV tile.  S (kBKV / 2 floats a thread), the two bf16 halves of
// the previous tile's P (kBKV / 4 registers) and O (D / 2) are live
// together while P V runs; ptxas fits the consumers into the 168
// registers that 384 threads leave each thread (setmaxnreg's larger
// budget does not reach its allocation), and 128-key tiles spilled.
constexpr int kBKV = 64;
constexpr int kConsumers = 2;     // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kStages = 6;        // K and V stages in flight
constexpr int kQBox = kBQ * 128;  // a Q box: 128 rows x 64 bf16 columns
constexpr int kKVBox = kBKV * 128;  // a K or V box: 64 rows x 64 columns

template <int D>
struct Cfg {
  static constexpr int kBoxes = D / 64;             // 64-column boxes
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;  // a K or V tile
  // Q, the K and V stages, 1 + 2 kStages barriers, room to align
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes +
                               (1 + 2 * kStages) * 8 + 1024;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// kv_range and tile_full above for kBQ-row query tiles and kBKV-key
// tiles.  Kept apart: a block-size argument to the 64-row kernels' helpers
// made the mma_sync kernel's code 4 % slower.
__device__ __forceinline__ void kv_range(const Args& a, int q0, int* lo,
                                         int* hi) {
  const int nkt = a.s / kBKV;
  *hi = a.causal ? min(nkt, (q0 + kBQ - 1) / kBKV + 1) : nkt;
  *lo = 0;
  if (a.has_window) {
    const long long first = (long long)q0 - a.window - kBKV + 2;
    if (first > 0)
      *lo = (int)min((first + kBKV - 1) / kBKV, (long long)nkt);
  }
}

__device__ __forceinline__ bool tile_full(const Args& a, int q0, int k0) {
  const bool causal_ok = !a.causal || k0 + kBKV - 1 <= q0;
  const bool window_ok =
      !a.has_window || (long long)k0 > (long long)q0 + kBQ - 1 - a.window;
  return causal_ok && window_ok;
}

template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The two consumer warpgroups take turns to issue their products: group
// g waits on named barrier 1 + g, and when it has issued lets the other
// group go.  256 threads: the 128 that wait and the 128 that arrive.
__device__ __forceinline__ void turn_begin(int group) {
  hopper::named_bar_sync(1 + group, 256);
}
__device__ __forceinline__ void turn_end(int group) {
  hopper::named_bar_arrive(1 + (group ^ 1), 256);
}

// S = Q K^T for this group's 64 rows and the tile's kBKV keys: D / 16
// k-steps, 4 per 64-column box; committed as one group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBKV / 2],
                                         const unsigned char* qw,
                                         const unsigned char* kb) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;
    hopper::wgmma_ss<kBKV, 0>(
        sc, hopper::desc_sw128(qw + box * kQBox + off, 16, 1024),
        hopper::desc_sw128(kb + box * kKVBox + off, 16, 1024),
        kk > 0);
  }
  hopper::wgmma_commit();
}

// O += P_hi V + P_lo V: V [kBKV keys][D] MN-major, k-step kk = key rows
// 16 kk .., D / 64 blocks of 64 columns one box apart; one group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&phi)[kBKV / 16][4],
                                         const uint32_t (&plo)[kBKV / 16][4],
                                         const unsigned char* vb) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBKV / 16; ++kk) {
    const uint64_t dv =
        hopper::desc_sw128(vb + kk * 16 * 128, kKVBox, 1024);
    hopper::wgmma_rs<D, 1>(acc, phi[kk], dv, 1);
    hopper::wgmma_rs<D, 1>(acc, plo[kk], dv, 1);
  }
  hopper::wgmma_commit();
}

// P (float, in sc) as the A fragments of k-step kk (keys 16 kk .. 16 kk +
// 15 = n-tiles 2 kk and 2 kk + 1), split into bf16 hi and lo parts.
__device__ __forceinline__ void split_p(const float (&sc)[kBKV / 2],
                                        uint32_t (&phi)[kBKV / 16][4],
                                        uint32_t (&plo)[kBKV / 16][4]) {
#pragma unroll
  for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {           // rows g and g + 8
      const float p0 = sc[4 * j + 2 * r], p1 = sc[4 * j + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
      phi[j >> 1][(j & 1) * 2 + r] = *reinterpret_cast<const uint32_t*>(&hi);
      plo[j >> 1][(j & 1) * 2 + r] = *reinterpret_cast<const uint32_t*>(&lo);
    }
  }
}

// The online softmax of one thread's two rows (row0, row0 + 8): running
// max m (of the scaled logits), this lane's part of the denominator l,
// and the factor the accumulator still owes the last update.
struct Softmax {
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float corr[2] = {1.f, 1.f};
  int lo_col[2], hi_col[2];   // the keys each row keeps

  __device__ __forceinline__ Softmax(const Args& a, int row0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      lo_col[i] = a.has_window ? max(row - a.window + 1, 0) : 0;
      hi_col[i] = a.causal ? min(row, a.s - 1) : a.s - 1;
    }
  }

  // sc: raw Q K^T of keys k0 .. k0 + kBKV - 1 -> P = exp(scale sc - m),
  // in place; masked keys give exact zeros.
  __device__ __forceinline__ void step(const Args& a, float (&sc)[kBKV / 2],
                                       int q0, int k0, int lane) {
    const int c0 = k0 + 2 * (lane & 3);
    if (!tile_full(a, q0, k0)) {
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + (e & 1);
          if (col < lo_col[e >> 1] || col > hi_col[e >> 1])
            sc[4 * j + e] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    const float scale_log2 = a.scale * kLog2e;
    float neg[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float safe;
      corr[i] = online_update(&m[i], group_max4(mx[i]) * a.scale, &safe);
      l[i] *= corr[i];
      neg[i] = -safe * kLog2e;
    }
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[4 * j + e], scale_log2, neg[e >> 1]));
        l[e >> 1] += p;
        sc[4 * j + e] = p;
      }
  }

  // acc *= the last step's correction (rows g: e 0, 1; g + 8: e 2, 3)
  template <int R>
  __device__ __forceinline__ void rescale(float (&acc)[R]) {
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      acc[4 * j] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, Args a) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;                              // [D / 64] boxes
  unsigned char* ks = qs + C::kQBytes;                   // [stages] tiles
  unsigned char* vs = ks + kStages * C::kKVBytes;        // [stages] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * C::kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;             // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.h, h = bh % a.h;
  const int hk = h / (a.h / a.hkv);
  const int q0 = qt * kBQ;
  int kt_lo, kt_hi;
  kv_range(a, q0, &kt_lo, &kt_hi);
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (group == kConsumers) {
    // producer: one thread loads Q, then K and V tile by tile
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128 && kt_lo < kt_hi) {
      hopper::mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c)
        hopper::tma_load_4d(qs + c * kQBox, &map_q, q_full, 64 * c, q0,
                            h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt_lo; kt < kt_hi; ++kt) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        hopper::mbar_arrive_expect_tx(&full[stage], 2 * C::kKVBytes);
        unsigned char* kb = ks + stage * C::kKVBytes;
        unsigned char* vb = vs + stage * C::kKVBytes;
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c) {
          hopper::tma_load_4d(kb + c * kKVBox, &map_k, &full[stage],
                              64 * c, kt * kBKV, hk, b);
          hopper::tma_load_4d(vb + c * kKVBox, &map_v, &full[stage],
                              64 * c, kt * kBKV, hk, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumers: warpgroup g owns query rows [q0 + 64 g, q0 + 64 g + 64)
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row0 = q0 + group * 64 + warp * 16 + (lane >> 2);
    Softmax sm(a, row0);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[kBKV / 2];
    uint32_t phi[kBKV / 16][4], plo[kBKV / 16][4];
    const unsigned char* qw = qs + group * 64 * 128;     // this group's rows
    if (group == 1) turn_end(group);                     // group 0 first
    if (kt_lo < kt_hi) {
      hopper::mbar_wait(q_full, 0);
      int stage = 0;
      uint32_t phase = 0;
      hopper::mbar_wait(&full[0], 0);
      turn_begin(group);
      issue_qk<D>(sc, qw, ks);
      turn_end(group);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      sm.step(a, sc, q0, kt_lo * kBKV, lane);
      split_p(sc, phi, plo);
      int prev = 0;
      for (int kt = kt_lo + 1; kt < kt_hi; ++kt) {
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
        hopper::mbar_wait(&full[stage], phase);
        turn_begin(group);
        issue_qk<D>(sc, qw, ks + stage * C::kKVBytes);
        sm.rescale(acc);
        issue_pv<D>(acc, phi, plo, vs + prev * C::kKVBytes);
        turn_end(group);
        hopper::wgmma_wait<1>();                         // S landed
        hopper::fence_regs(sc);
        sm.step(a, sc, q0, kt * kBKV, lane);
        hopper::wgmma_wait<0>();                         // P V landed
        hopper::fence_regs(acc);
        fence_u32(phi);
        fence_u32(plo);
        if (threadIdx.x % 128 == 0) hopper::mbar_arrive(&empty[prev]);
        split_p(sc, phi, plo);
        prev = stage;
      }
      turn_begin(group);
      sm.rescale(acc);
      issue_pv<D>(acc, phi, plo, vs + prev * C::kKVBytes);
      turn_end(group);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      fence_u32(phi);
      fence_u32(plo);
      if (threadIdx.x % 128 == 0) hopper::mbar_arrive(&empty[prev]);
    }
    if (group == 0) turn_begin(0);    // group 1's last turn_end

    // o = acc / l (l == 0 -> 1: zeros), lse = m + log(l); rows past S
    // (the last tile when S % 128 == 64) are not stored
    const int t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float li = group_sum4(sm.l[i]);
      const float inv = (li == 0.f) ? 1.f : 1.f / li;
      const int row = row0 + i * 8;
      if (row >= a.s) continue;
      bf16* orow = static_cast<bf16*>(a.o) + b * a.osb + h * a.osh +
                   (long long)row * a.oss + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv,
                                  acc[4 * j + 2 * i + 1] * inv);
      if (t4 == 0)
        a.lse[(long long)bh * a.s + row] =
            (li == 0.f) ? -INFINITY : sm.m[i] + logf(li);
    }
  }
}

// One rank-4 map (D, S, heads, B) over element strides (row, head, batch)
// with boxes of 64 columns x `rows` rows.
inline int encode_bshd(CUtensorMap* map, const void* base, int d, int s,
                       int heads, int b, long long ss, long long sh,
                       long long sb, int rows) {
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)s, (uint64_t)heads,
                            (uint64_t)b};
  const uint64_t strides[3] = {(uint64_t)ss * 2, (uint64_t)sh * 2,
                               (uint64_t)sb * 2};
  const uint32_t box[4] = {64, (uint32_t)rows, 1, 1};
  return hopper::encode_bf16(map, base, 4, dims, strides, box);
}

template <int D>
int launch(const Args& a, int b, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  int err =
      encode_bshd(&map_q, a.q, D, a.s, a.h, b, a.qss, a.qsh, a.qsb, kBQ);
  if (!err)
    err = encode_bshd(&map_k, a.k, D, a.s, a.hkv, b, a.kss, a.ksh, a.ksb,
                      kBKV);
  if (!err)
    err = encode_bshd(&map_v, a.v, D, a.s, a.hkv, b, a.vss, a.vsh, a.vsb,
                      kBKV);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<D>::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.s + kBQ - 1) / kBQ, b * a.h);
  flash_fwd_wgmma<D><<<grid, kThreads, Cfg<D>::kSmem, stream>>>(
      map_q, map_k, map_v, a);
  return (int)cudaGetLastError();
}

}  // namespace fa3

template <int D>
size_t smem_bytes(int dtype) {
  if (dtype == 1)
    return (size_t)(kBlockQ + 4 * block_k_bf16<D>()) * (D + 8) * 2;
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

// dtype: 0 float32, 1 bfloat16; variant: 0 simt_f32 (float32), 1 mma_sync
// (bfloat16), 2 wgmma (bfloat16, d 64 or 128).  q [b, h, s, d], k/v
// [b, hkv, s, d] and o [b, h, s, d] given by element strides (batch, head,
// row; the last dimension contiguous); lse [b, h, s] contiguous float32.
// causal and has_window are 0/1.  s % flash_attention_tile() == 0, d in
// {16, 32, 64, 96, 128, 160, 256} (the wrapper picks the variant and
// checks).
extern "C" int flash_attention_fwd(
    int dtype, int variant, int d, const void* q, const void* k,
    const void* v, void* o, float* lse, int b, int h, int hkv, int s,
    long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, int causal,
    int has_window, int window, float scale, void* stream) {
  if (variant != dtype && !(variant == 2 && dtype == 1))
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || s <= 0) return 0;
  const Args a{q,   k,   v,   o,   lse, h,   hkv,    s,
               qsb, qsh, qss, ksb, ksh, kss, vsb,    vsh,
               vss, osb, osh, oss, causal, has_window, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 2) {
    if (d == 64) return fa3::launch<64>(a, b, st);
    if (d == 128) return fa3::launch<128>(a, b, st);
    return (int)cudaErrorInvalidValue;
  }
  switch (d) {
    case 16: return launch<16>(dtype, a, b, st);
    case 32: return launch<32>(dtype, a, b, st);
    case 64: return launch<64>(dtype, a, b, st);
    case 96: return launch<96>(dtype, a, b, st);
    case 128: return launch<128>(dtype, a, b, st);
    case 160: return launch<160>(dtype, a, b, st);
    case 256: return launch<256>(dtype, a, b, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
