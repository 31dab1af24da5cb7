// Tiled matrix product for Hopper (sm_90a): C[M, N] = A[M, K] @ B[K, N],
// float32 accumulation, C in the inputs' type.
//
// Port of the Pallas kernel repro/kernels/fused_matmul_rs.py::
// _matmul_kernel (the block GEMM of the fused matmul + ring
// reduce-scatter, reached through matmul_tiled).  All three arrays are
// contiguous row-major; M, N and K may be ragged (any size).
//
// What bounds it: operations.  At the ring step of the TP-8 yi-34b
// down-projection ([1024, 2560] @ [2560, 7168]) a bf16 call does 3.8e10
// FLOPs over 57 MB: ~38 us at the tensor cores' 989 TFLOP/s against
// ~17 us for the bytes.  Design, a simple right kernel first:
//
// * bfloat16: the tensor cores through WMMA (m16n16k16, bf16 inputs,
//   float32 accumulator).  Products of bf16 values are exact in float32,
//   so this is the reference's arithmetic (jnp.dot of the inputs cast to
//   float32) up to the order of the adds.  A 256-thread block owns a
//   128 x 128 tile of C (8 warps, 64 x 32 each, 4 x 2 fragments) and
//   walks K in steps of 32.  When K and N are multiples of 8 (rows
//   16-byte aligned) the A and B tiles arrive by cp.async, 16 bytes a
//   thread, double-buffered so the next step's loads overlap this step's
//   products; out-of-range chunks are zero-filled by the copy itself.
//   Otherwise the tiles are loaded element by element with the ragged
//   edges masked.  The epilogue stages each fragment through shared
//   memory and writes only the in-range elements.
// * float32: full float32 on the SIMT units (FMA), not TF32, because the
//   reference computes in full float32: a 128 x 128 tile per 256-thread
//   block, 8 x 8 outputs per thread, K in steps of 8 through shared
//   memory, ragged edges masked on load and store.
//
// wgmma, TMA and a persistent schedule are later work.
//
// Plain C interface (loaded with ctypes); returns the cudaError_t of the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

// ----------------------------- bfloat16 ---------------------------------
constexpr int BM = 128, BN = 128, BK = 32, kThreads = 256;
constexpr int LDA = BK + 8;     // shared row pitch, elements (80 bytes)
constexpr int LDB = BN + 8;     // 272 bytes: 16-byte rows, fewer conflicts

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;     // 0: fill the 16 bytes with 0
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One K step's A [BM, BK] and B [BK, BN] tiles into buffer `buf`.
template <bool VEC>
__device__ __forceinline__ void load_tiles(const bf16* __restrict__ a,
                                           const bf16* __restrict__ b,
                                           bf16* as, bf16* bs, int m, int n,
                                           int k, int bm, int bn, int k0) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    // 512 16-byte chunks per tile, two per thread; K % 8 == 0 and
    // N % 8 == 0, so a chunk is wholly in range or wholly out
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 2, col = (c & 3) * 8;          // A: 128 x 4
      const bool ok = (bm + row < m) && (k0 + col < k);
      const bf16* src = ok ? a + (size_t)(bm + row) * k + k0 + col : a;
      cp_async16(as + row * LDA + col, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 4, col = (c & 15) * 8;         // B: 32 x 16
      const bool ok = (k0 + row < k) && (bn + col < n);
      const bf16* src = ok ? b + (size_t)(k0 + row) * n + bn + col : b;
      cp_async16(bs + row * LDB + col, src, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int row = e / BK, col = e % BK;
      const bool ok = (bm + row < m) && (k0 + col < k);
      as[row * LDA + col] = ok ? a[(size_t)(bm + row) * k + k0 + col] : zero;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int row = e / BN, col = e % BN;
      const bool ok = (k0 + row < k) && (bn + col < n);
      bs[row * LDB + col] = ok ? b[(size_t)(k0 + row) * n + bn + col] : zero;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
matmul_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                   bf16* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(128) bf16 as[2][BM * LDA];
  __shared__ __align__(128) bf16 bs[2][BK * LDB];
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;     // 2 x 4 warps, 64 x 32 each

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int ktiles = (k + BK - 1) / BK;
  if constexpr (VEC) {
    if (ktiles > 0) {
      load_tiles<true>(a, b, as[0], bs[0], m, n, k, bm, bn, 0);
      cp_async_commit();
    }
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    if constexpr (VEC) {
      if (kt + 1 < ktiles) {
        load_tiles<true>(a, b, as[buf ^ 1], bs[buf ^ 1], m, n, k, bm, bn,
                         (kt + 1) * BK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      load_tiles<false>(a, b, as[buf], bs[buf], m, n, k, bm, bn, kt * BK);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], as[buf] + (wm * 64 + i * 16) * LDA + kk,
                               LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], bs[buf] + kk * LDB + wn * 32 + j * 16,
                               LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16 x 16 float fragment at a time in
  // its own 1 KB of the (now idle) A buffer, then writes what is in range
  float* stage = reinterpret_cast<float*>(&as[0][0]) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = bm + wm * 64 + i * 16, c0 = bn + wn * 32 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = r0 + e / 16, col = c0 + e % 16;
        if (r < m && col < n)
          c[(size_t)r * n + col] = __float2bfloat16_rn(stage[e]);
      }
      __syncwarp();
    }
  }
}

// ----------------------------- float32 ----------------------------------
constexpr int FBM = 128, FBN = 128, FBK = 8, TM = 8, TN = 8;

__global__ void __launch_bounds__(kThreads)
matmul_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float as[FBK][FBM + 4];   // A tile, transposed
  __shared__ __align__(16) float bs[FBK][FBN + 4];
  const int bm = blockIdx.y * FBM, bn = blockIdx.x * FBN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;     // 16 x 16 threads, 8 x 8 each

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += FBK) {
#pragma unroll
    for (int i = 0; i < (FBM * FBK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int row = e / FBK, col = e % FBK;
      const bool ok = (bm + row < m) && (k0 + col < k);
      as[col][row] = ok ? a[(size_t)(bm + row) * k + k0 + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (FBK * FBN) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int row = e / FBN, col = e % FBN;
      const bool ok = (k0 + row < k) && (bn + col < n);
      bs[row][col] = ok ? b[(size_t)(k0 + row) * n + bn + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = bm + ty * TM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = bn + tx * TN + j;
      if (col < n) c[(size_t)r * n + col] = acc[i][j];
    }
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  a: [m, k], b: [k, n], c: [m, n], all
// contiguous.  vectorized != 0 (bfloat16 only) requires k % 8 == 0,
// n % 8 == 0 and 16-byte aligned a and b (the wrapper checks).
extern "C" int matmul_tiled(int dtype, const void* a, const void* b, void* c,
                            int m, int n, int k, int vectorized,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return 0;
  if (dtype == 0) {
    const dim3 grid((n + FBN - 1) / FBN, (m + FBM - 1) / FBM);
    matmul_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), m, n, k);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 1) {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    const bf16* pa = static_cast<const bf16*>(a);
    const bf16* pb = static_cast<const bf16*>(b);
    bf16* pc = static_cast<bf16*>(c);
    if (vectorized)
      matmul_bf16_kernel<true><<<grid, kThreads, 0, s>>>(pa, pb, pc, m, n, k);
    else
      matmul_bf16_kernel<false><<<grid, kThreads, 0, s>>>(pa, pb, pc, m, n,
                                                          k);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
