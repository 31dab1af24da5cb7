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
// ~17 us for the bytes.  Three variants, chosen by the caller:
//
// * wgmma (bfloat16, K and N multiples of 8, 16-byte aligned A and B:
//   every row a multiple of 16 bytes, TMA's rule): a persistent,
//   warp-specialised kernel.  One block per SM walks 128 x 256 output
//   tiles, M fastest, so neighbouring blocks share B's columns in L2 (128
//   x 128 tiles, 3.4 waves at the ring step against 1.7, were slower).
//   A producer warpgroup gives up its registers (setmaxnreg) and one of
//   its threads keeps TMA loads of A [128 x 64] (K-major) and B [64 x
//   256] (row-major, so MN-major for wgmma: the transpose-B bit, no
//   transpose pass) in flight through a ring of 4 shared-memory stages,
//   each guarded by a "full" mbarrier (TMA bytes landed) and an "empty"
//   one (both consumers done).  Two consumer warpgroups take 64 rows each
//   and issue wgmma m64n256k16 from shared memory into float32
//   accumulators held in registers (128 a thread).  Products of bf16
//   values are exact in float32, so this is the reference's arithmetic
//   (jnp.dot of the inputs cast to float32) up to the order of the adds.
//   TMA fills the part of a box outside the tensor with zeros, so ragged
//   M, N and K need no masks on the loads; the epilogue rounds to bf16 in
//   registers, stages 64 x 64 boxes in shared memory (stmatrix) and
//   writes them with TMA stores, which clip at the edges, while the
//   producer already loads the block's next tile.  K == 0 writes zeros.
// * wmma_masked (bfloat16, any shape): the pre-Hopper kernel, tensor cores
//   through WMMA (m16n16k16): a 256-thread block owns a 128 x 128 tile of
//   C (8 warps, 64 x 32 each) and walks K in steps of 32.  Tiles are
//   loaded element by element with the ragged edges masked; when rows
//   are 16-byte aligned (only when the caller forces this variant on a
//   call the wgmma variant takes, to time the two side by side) they
//   arrive by cp.async, double-buffered.  The epilogue stages each
//   fragment through shared memory and writes what is in range.
// * simt_f32 (float32): full float32 on the SIMT units (FMA), not TF32,
//   because the reference computes in full float32: a 128 x 128 tile per
//   256-thread block, 8 x 8 outputs per thread, K in steps of 8 through
//   shared memory, ragged edges masked on load and store.
//
// Plain C interface (loaded with ctypes); returns the cudaError_t of the
// launch, or hopper::kEncodeError + the CUresult if a tensor map cannot be
// encoded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

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

// -------------------------- bfloat16, wgmma -----------------------------
namespace wg {

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int kConsumers = 2;                   // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kStages = 4;
constexpr int kABytes = BM * BK * 2;            // 16 KB
constexpr int kBBytes = BK * BN * 2;            // 4 boxes of 8 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kCBox = 64 * 128;                 // 64 rows x 64 bf16 columns
// the stages, two C boxes per consumer, 2 barriers a stage, and room to
// align to 1024 bytes
constexpr int kSmem = kStages * kStageBytes + 2 * kConsumers * kCBox +
                      kStages * 16 + 1024;
static_assert(kSmem <= 232448, "shared memory of one block");

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        const __grid_constant__ CUtensorMap map_c, int m,
                        int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* cboxes = smem + kStages * kStageBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(cboxes + 2 * kConsumers * kCBox);
  uint64_t* empty = full + kStages;
  const int tiles_m = (m + BM - 1) / BM;
  const int tiles = tiles_m * ((n + BN - 1) / BN);
  const int ktiles = (k + BK - 1) / BK;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (group == kConsumers) {
    // producer: one thread issues every load of the block
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int row0 = (t % tiles_m) * BM, col0 = (t / tiles_m) * BN;
        for (int kt = 0; kt < ktiles; ++kt) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* sa = smem + stage * kStageBytes;
          unsigned char* sb = sa + kABytes;
          hopper::mbar_arrive_expect_tx(&full[stage], kStageBytes);
          hopper::tma_load_2d(sa, &map_a, &full[stage], kt * BK, row0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            hopper::tma_load_2d(sb + j * BK * 128, &map_b, &full[stage],
                                col0 + 64 * j, kt * BK);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup g owns rows [64 g, 64 g + 64) of each tile
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;
    unsigned char* cbox = cboxes + group * 2 * kCBox;
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int row0 = (t % tiles_m) * BM, col0 = (t / tiles_m) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      // one k-step's products stay in flight while the next stage is
      // awaited; a stage is released once its products are done
      int prev = -1;
      for (int kt = 0; kt < ktiles; ++kt) {
        hopper::mbar_wait(&full[stage], phase);
        const unsigned char* sa = smem + stage * kStageBytes;
        const unsigned char* sb = sa + kABytes;
        sa += group * 64 * 128;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          hopper::wgmma_ss<BN, 1>(
              acc, hopper::desc_sw128(sa + 32 * kk, 16, 1024),
              hopper::desc_sw128(sb + kk * 16 * 128, BK * 128, 1024), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        if (prev >= 0 && leader) hopper::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (prev >= 0 && leader) hopper::mbar_arrive(&empty[prev]);
      // epilogue: the warpgroup's 64 x 256 block, rounded to bf16 in
      // registers, goes out in four 64 x 64 boxes, each staged in shared
      // memory by stmatrix (128-byte swizzle, as the map) and written by a
      // TMA store, which clips at the tensor's edges.  The warpgroup
      // alternates between its two boxes, so that filling one overlaps
      // the store from the other, and the producer already loads the next
      // tile.  acc[4 j + e] is row 16 warp + lane / 4 + 8 (e / 2), column
      // 8 j + 2 (lane % 4) + e % 2: stmatrix i of box c takes columns
      // 8 j .. 8 j + 15, j = 8 c + 2 i, as four 8 x 8 matrices (rows + 0 /
      // + 8, columns + 0 / + 8); lane l gives row l % 8 of matrix l / 8.
      const int mi = lane / 8, lr = lane % 8;
      const int srow = warp * 16 + (mi & 1) * 8 + lr;
      const int rows = row0 + group * 64;
#pragma unroll
      for (int c = 0; c < BN / 64; ++c) {
        unsigned char* box = cbox + (c & 1) * kCBox;
        if (leader) hopper::tma_store_wait<1>();   // box's last store read
        hopper::named_bar_sync(1 + group, 128);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 8 * c + 2 * i;
          const uint32_t r[4] = {pack_bf16x2(acc[4 * j], acc[4 * j + 1]),
                                 pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]),
                                 pack_bf16x2(acc[4 * j + 4], acc[4 * j + 5]),
                                 pack_bf16x2(acc[4 * j + 6], acc[4 * j + 7])};
          const int chunk = 2 * i + mi / 2;
          hopper::stmatrix_x4(box + srow * 128 + ((chunk ^ lr) << 4), r);
        }
        hopper::fence_async_shared();
        hopper::named_bar_sync(1 + group, 128);
        if (leader && rows < m) {
          hopper::tma_store_2d(&map_c, box, col0 + 64 * c, rows);
          hopper::tma_store_commit();
        }
      }
    }
    if (leader) hopper::tma_store_wait<0>();   // before shared memory goes
  }
}

// A [m, k] K-major in boxes of [128 rows, 64 K]; B [k, n] in boxes of
// [64 K rows, 64 columns]; C [m, n] in boxes of [64 rows, 64 columns]; a
// persistent grid of min(tiles, SMs) blocks.
int launch(const bf16* a, const bf16* b, bf16* c, int m, int n, int k,
           cudaStream_t stream) {
  CUtensorMap map_a{}, map_b{}, map_c{};
  if (k > 0) {      // K == 0: no load is issued, the maps stay unused
    const uint64_t dims_a[2] = {(uint64_t)k, (uint64_t)m};
    const uint64_t stride_a[1] = {(uint64_t)k * 2};
    const uint32_t box_a[2] = {BK, BM};
    const uint64_t dims_b[2] = {(uint64_t)n, (uint64_t)k};
    const uint64_t stride_b[1] = {(uint64_t)n * 2};
    const uint32_t box_b[2] = {64, BK};
    int err = hopper::encode_bf16(&map_a, a, 2, dims_a, stride_a, box_a);
    if (err) return err;
    err = hopper::encode_bf16(&map_b, b, 2, dims_b, stride_b, box_b);
    if (err) return err;
  }
  const uint64_t dims_c[2] = {(uint64_t)n, (uint64_t)m};
  const uint64_t stride_c[1] = {(uint64_t)n * 2};
  const uint32_t box_c[2] = {64, 64};
  int err = hopper::encode_bf16(&map_c, c, 2, dims_c, stride_c, box_c);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int sms = hopper::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = tiles < sms ? tiles : sms;
  matmul_wgmma_kernel<<<grid, kThreads, kSmem, stream>>>(map_a, map_b,
                                                         map_c, m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 float32, 1 bfloat16.  a: [m, k], b: [k, n], c: [m, n], all
// contiguous.  variant: 0 simt_f32 (float32), 1 wmma_masked (bfloat16),
// 2 wgmma (bfloat16; k % 8 == 0, n % 8 == 0, a, b and c 16-byte
// aligned).  The wrapper picks the variant and checks what it needs.
extern "C" int matmul_tiled(int dtype, const void* a, const void* b, void* c,
                            int m, int n, int k, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return 0;
  if (dtype == 0 && variant == 0) {
    const dim3 grid((n + FBN - 1) / FBN, (m + FBM - 1) / FBM);
    matmul_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), m, n, k);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pb = static_cast<const bf16*>(b);
  bf16* pc = static_cast<bf16*>(c);
  if (variant == 2) return wg::launch(pa, pb, pc, m, n, k, s);
  if (variant != 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const bool aligned = k % 8 == 0 && n % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (aligned)
    matmul_bf16_kernel<true><<<grid, kThreads, 0, s>>>(pa, pb, pc, m, n, k);
  else
    matmul_bf16_kernel<false><<<grid, kThreads, 0, s>>>(pa, pb, pc, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
