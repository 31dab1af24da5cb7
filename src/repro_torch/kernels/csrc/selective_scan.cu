// Mamba-1 selective scan for NVIDIA Hopper (sm_90a), hand-written CUDA C++:
// the forward (with and without chunk checkpoints) and its backward.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/selective_scan.py:
//   selective_scan  (_scan_kernel)           -> scan_fwd_kernel<T, N, false>
//   _fwd_with_ckpt  (_scan_fwd_ckpt_kernel)  -> scan_fwd_kernel<T, N, true>
//   _bwd_call       (_scan_bwd_kernel)       -> scan_bwd_kernel<N>
// and computes the same functions: for batch b, channel d and state n,
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t     (float32)
//   y_t = sum_n h_t * C_t
// with dt, x: [B, S, D], B, C: [B, S, N], A: [D, N], h0: [B, D, N]; y in
// the inputs' type, h_final float32.  The backward runs the reverse adjoint
//   dh_t  = dy_t C_t + a_{t+1} dh_{t+1},   a_t = exp(dt_t A)
//   ddt_t = sum_n dh_t h_{t-1} a_t A + x_t sum_n dh_t B_t
//   dx_t  = dt_t sum_n dh_t B_t
//   dB_t  = sum_d dh_t dt_t x_t,   dC_t = sum_d h_t dy_t
//   dA    = sum_{b,t} dh_t h_{t-1} a_t dt_t,   dh0 = a_1 dh_1
//
// What bounds it on an H100.  At the training layer of falcon-mamba-7b
// (B 2, S 4096, D 8192, N 16) the forward reads dt and x and writes y,
// about 805 MB (0.24 ms at 3.35 TB/s), and takes B*S*D*N = 1.07e9
// exponentials on the special-function units (16 per SM per clock, about
// 0.26 ms at 1.98 GHz over 132 SMs).  The backward moves dt, x, dy in and
// ddt, dx out (about 1.34 GB, 0.40 ms) and is bound by bytes on paper; in
// practice by the instruction slots of its ~12 float32 operations a state and
// step and of the sums over channels that dB and dC need.
//
// Design (a redesign of the first kernels, which ran one thread per
// (batch, channel, state) and so spent 4 shuffles and 4 scalar shared
// loads of every step on each state: the MIO pipe, not the exponentials,
// set their pace):
//  * states in registers, several to a thread: a thread holds kSpt =
//    min(N, 8) states of one channel, so a channel takes N / kSpt lanes
//    (2 at N 16).  y_t's sum over N is 7 register adds and one shuffle;
//    B_t and C_t come as 16-byte shared loads (2 a step for 8 float32
//    states, broadcast to the warp); dt_t and x_t are one load each for 8
//    states.  What keeps the card busy with 4x fewer threads than before is
//    the 8 independent state chains of each thread (ILP), not a split of
//    the sequence: the associative combine would add a second pass over
//    every step's states, and the exponentials, which set the bound, do
//    not shrink with it;
//  * staging overlapped with compute: a chunk of kChunk = 32 steps of dt,
//    x (, dy) and B, C is copied into shared memory by 16-byte cp.async
//    (zero-filled past S and D) into one of two buffers while the other
//    chunk computes, in the inputs' type; y (ddt, dx) go out from a shared
//    tile as 16-byte stores.  Inputs that are not 16-byte aligned (odd D
//    or S * N) take plain element copies into the same buffers;
//  * forward: 32 channels a block (64 threads at N 16), one checkpoint
//    hck [B, ceil(S / kChunk), D, N] float32 (the state entering every
//    chunk; the port's own layout) per chunk.  At the training shape 512
//    blocks of 64 threads, ~4 an SM of the 7 that fit: one wave, spread
//    evenly (64-channel blocks, 2 an SM, measured 3.7 % slower);
//  * backward: 128 channels a block (256 threads at N 16, one block an SM:
//    128 blocks, one wave), so up to 255 registers a thread.  Each chunk
//    walks forward from hck once, keeping the state at the start of each
//    kSub = 8-step sub-chunk in shared memory, then takes the sub-chunks
//    last to first: it recomputes the sub-chunk's 8 states and decay
//    factors a_t into registers (the exponential computed once in that
//    pass and reused by the adjoint, not recomputed) and runs the reverse
//    adjoint over them.  The last sub-chunk of the walk is recomputed too,
//    so a step costs 1.75 exponentials on average: keeping more history
//    would take a finer hck (twice the bytes for 1.5) or more registers;
//  * sums over N (ddt, dx) are register adds and one shuffle each; sums
//    over channels (dB, dC) are a reduce-scatter across the warp's 16
//    channels (15 shuffles for a lane's 16 values, each lane ending with
//    one of the warp's 32 sums), then a fixed-order sum over the block's
//    8 warps in shared memory per chunk, written as one partial per block
//    [B, G, S, N] with G = ceil(D / 128) (64 at D 8192, 4x fewer than
//    before) that the wrapper sums with torch.sum; dA is written per batch
//    [B, D, N] and summed the same way.  No atomics: the result is the
//    same from run to run;
//  * exponentials are ex2.approx of dt * (A log2 e), the same instruction
//    __expf uses, with the scale folded into A once;
//  * any S and D: the last chunk is short, and lanes past D compute on
//    zeros (which contribute exact zeros to every sum) and write nothing.
//
// Limits (checked by the Python wrapper): N in {1, 2, 4, 8, 16}; the
// forward takes float or bf16 dt, x, B, C (one type) and float32 A, h0;
// the backward takes float32 throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 32;     // steps per staged tile and per checkpoint
constexpr int kSub = 8;        // backward: steps whose history is in registers
constexpr int kSubs = kChunk / kSub;
constexpr int kFwdChannels = 32;
constexpr int kBwdChannels = 128;
constexpr int kMaxState = 16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A channel's N states over kLanes lanes of kSpt states each.
template <int N>
struct Layout {
  static constexpr int kSpt = N < 8 ? N : 8;
  static constexpr int kLanes = N / kSpt;
  static constexpr int kFwdThreads = kFwdChannels * kLanes;
  static constexpr int kBwdThreads = kBwdChannels * kLanes;
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, bf16* p) {
  *p = __float2bfloat16(v);
}

// 16 bytes of T at p (16-byte aligned) from the floats at src (16-byte
// aligned shared memory).
__device__ __forceinline__ void store16(float* p, const float* src) {
  *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void store16(bf16* p, const float* src) {
  const float4 lo = reinterpret_cast<const float4*>(src)[0];
  const float4 hi = reinterpret_cast<const float4*>(src)[1];
  __nv_bfloat162 v[4] = {__floats2bfloat162_rn(lo.x, lo.y),
                         __floats2bfloat162_rn(lo.z, lo.w),
                         __floats2bfloat162_rn(hi.x, hi.y),
                         __floats2bfloat162_rn(hi.z, hi.w)};
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
}

// kSpt states of one step from shared memory, as float.
template <int kSpt>
__device__ __forceinline__ void load_states(const float* p, float* out) {
  if constexpr (kSpt % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kSpt / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x;
      out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z;
      out[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kSpt; ++i) out[i] = p[i];
  }
}
template <int kSpt>
__device__ __forceinline__ void load_states(const bf16* p, float* out) {
  if constexpr (kSpt == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kSpt; ++i) out[i] = __bfloat162float(p[i]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [row0, row0 + valid) x channels [d0, d0 + CH) of a [rows, D] tensor
// into tile[kChunk][CH], zeros elsewhere.  vec: 16-byte cp.async copies
// (D * sizeof(T) and the base 16-byte aligned), else element copies.
template <typename T, int CH, int kThreads>
__device__ __forceinline__ void stage_channels(T* tile, const T* src,
                                               size_t row0, int valid,
                                               int d0, int D, bool vec) {
  if (vec) {
    constexpr int W = 16 / sizeof(T);
    constexpr int kPerRow = CH / W;
    for (int c = threadIdx.x; c < kChunk * kPerRow; c += kThreads) {
      const int t = c / kPerRow, col = (c % kPerRow) * W;
      const bool in = t < valid && d0 + col < D;
      cp_async16(tile + t * CH + col,
                 in ? src + (row0 + t) * D + d0 + col : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kChunk * CH; e += kThreads) {
      const int t = e / CH, col = e % CH;
      tile[e] = (t < valid && d0 + col < D) ? src[(row0 + t) * D + d0 + col]
                                            : zero<T>();
    }
  }
}

// Rows [row0, row0 + valid) of a [rows, N] tensor into tile[kChunk][N].
template <typename T, int N, int kThreads>
__device__ __forceinline__ void stage_states(T* tile, const T* src,
                                             size_t row0, int valid,
                                             bool vec) {
  const T* base = src + row0 * N;
  const int count = valid * N;
  if (vec) {
    constexpr int W = 16 / sizeof(T);
    for (int c = threadIdx.x; c < kChunk * N / W; c += kThreads) {
      const int e = c * W;
      const int n = min(W, max(0, count - e));
      cp_async16(tile + e, n ? base + e : src, n * (int)sizeof(T));
    }
  } else {
    for (int e = threadIdx.x; e < kChunk * N; e += kThreads)
      tile[e] = e < count ? base[e] : zero<T>();
  }
}

// tile[kChunk][CH] (float) -> rows [row0, row0 + valid) x channels
// [d0, d0 + CH) of a [rows, D] tensor of T.
template <typename T, int CH, int kThreads>
__device__ __forceinline__ void write_channels(T* dst, const float* tile,
                                               size_t row0, int valid,
                                               int d0, int D, bool vec) {
  if (vec) {
    constexpr int W = 16 / sizeof(T);
    constexpr int kPerRow = CH / W;
    for (int c = threadIdx.x; c < valid * kPerRow; c += kThreads) {
      const int t = c / kPerRow, col = (c % kPerRow) * W;
      if (d0 + col < D)
        store16(dst + (row0 + t) * D + d0 + col, tile + t * CH + col);
    }
  } else {
    for (int e = threadIdx.x; e < valid * CH; e += kThreads) {
      const int t = e / CH, col = e % CH;
      if (d0 + col < D) store(tile[e], dst + (row0 + t) * D + d0 + col);
    }
  }
}

// ------------------------------- forward --------------------------------
template <typename T, int N>
__host__ __device__ constexpr size_t fwd_stage_elems() {
  return 2 * (size_t)kChunk * kFwdChannels + 2 * (size_t)kChunk * N;
}
template <typename T, int N>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return 2 * fwd_stage_elems<T, N>() * sizeof(T) +
         (size_t)kChunk * kFwdChannels * sizeof(float);
}

template <typename T, int N, bool kCkpt>
__global__ void __launch_bounds__(Layout<N>::kFwdThreads)
scan_fwd_kernel(const T* __restrict__ dt,        // [B, S, D]
                const T* __restrict__ x,         // [B, S, D]
                const T* __restrict__ bm,        // [B, S, N]
                const T* __restrict__ cm,        // [B, S, N]
                const float* __restrict__ a,     // [D, N]
                const float* __restrict__ h0,    // [B, D, N]
                T* __restrict__ y,               // [B, S, D]
                float* __restrict__ h_final,     // [B, D, N]
                float* __restrict__ hck,         // [B, K, D, N] (kCkpt)
                int S, int D, int vec_in) {
  constexpr int kSpt = Layout<N>::kSpt, kLanes = Layout<N>::kLanes;
  constexpr int kThreads = Layout<N>::kFwdThreads, CH = kFwdChannels;
  constexpr size_t kStage = fwd_stage_elems<T, N>();
  const bool vec = vec_in != 0;
  const int tid = threadIdx.x;
  const int cl = tid / kLanes;
  const int half = tid % kLanes;
  const int n0 = half * kSpt;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + cl;
  const int bi = blockIdx.y;
  const bool live = d < D;

  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);                // [2][kStage]
  float* y_s = reinterpret_cast<float*>(smem + 2 * kStage * sizeof(T));

  float a2[kSpt], h[kSpt];
#pragma unroll
  for (int j = 0; j < kSpt; ++j) {
    a2[j] = live ? a[(size_t)d * N + n0 + j] * kLog2e : 0.f;
    h[j] = live ? h0[((size_t)bi * D + d) * N + n0 + j] : 0.f;
  }
  const int n_chunks = (S + kChunk - 1) / kChunk;

  auto stage_chunk = [&](int k) {
    T* buf = stage + (k & 1) * kStage;
    const int t0 = k * kChunk;
    const int valid = min(kChunk, S - t0);
    const size_t row0 = (size_t)bi * S + t0;
    stage_channels<T, CH, kThreads>(buf, dt, row0, valid, d0, D, vec);
    stage_channels<T, CH, kThreads>(buf + kChunk * CH, x, row0, valid, d0,
                                    D, vec);
    stage_states<T, N, kThreads>(buf + 2 * kChunk * CH, bm, row0, valid,
                                 vec);
    stage_states<T, N, kThreads>(buf + 2 * kChunk * CH + kChunk * N, cm,
                                 row0, valid, vec);
  };

  stage_chunk(0);
  cp_async_commit();
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * kChunk;
    const int valid = min(kChunk, S - t0);
    const size_t row0 = (size_t)bi * S + t0;
    if (kCkpt && live) {
      float* dst = hck + (((size_t)bi * n_chunks + k) * D + d) * N + n0;
#pragma unroll
      for (int j = 0; j < kSpt; ++j) dst[j] = h[j];
    }
    if (k + 1 < n_chunks) stage_chunk(k + 1);
    cp_async_commit();          // possibly empty: wait_group 1 stays exact
    cp_async_wait1();
    __syncthreads();
    const T* buf = stage + (k & 1) * kStage;
    const T* dt_s = buf;
    const T* x_s = buf + kChunk * CH;
    const T* b_s = buf + 2 * kChunk * CH;
    const T* c_s = b_s + kChunk * N;
#pragma unroll 4
    for (int t = 0; t < valid; ++t) {
      const float dtv = to_float(dt_s[t * CH + cl]);
      const float dtx = dtv * to_float(x_s[t * CH + cl]);
      float bv[kSpt], cv[kSpt];
      load_states<kSpt>(b_s + t * N + n0, bv);
      load_states<kSpt>(c_s + t * N + n0, cv);
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int j = 0; j < kSpt; ++j) {
        h[j] = fmaf(ex2(dtv * a2[j]), h[j], dtx * bv[j]);
        if (j & 1)
          acc1 = fmaf(h[j], cv[j], acc1);
        else
          acc0 = fmaf(h[j], cv[j], acc0);
      }
      float acc = acc0 + acc1;
      if (kLanes == 2) acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) y_s[t * CH + cl] = acc;
    }
    __syncthreads();
    write_channels<T, CH, kThreads>(y, y_s, row0, valid, d0, D, vec);
    // the next chunk refills this chunk's buffer (last read before the
    // barrier above) and writes y_s only after its own barrier
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kSpt; ++j)
      h_final[((size_t)bi * D + d) * N + n0 + j] = h[j];
  }
}

// ------------------------------- backward -------------------------------
// Sums over the warp's channels of a lane's V values (its kSpt states' dB
// then dC), as a reduce-scatter over the channel bits of the lane index
// (kMask down to kLowMask): each level keeps half of the values and adds
// the partner's copy of them.  At the end each lane's vals[0] is the sum of
// value `idx`; levels past the last halving are plain butterflies.
template <int kMask, int kCnt, int kLowMask>
__device__ __forceinline__ void reduce_channels(float* vals, int lane,
                                                int& idx) {
  if constexpr (kMask >= kLowMask) {
    if constexpr (kCnt > 1) {
      constexpr int H = kCnt / 2;
      const bool upper = (lane & kMask) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = upper ? vals[i] : vals[i + H];
        const float keep = upper ? vals[i + H] : vals[i];
        vals[i] = keep + __shfl_xor_sync(0xffffffffu, send, kMask);
      }
      if (upper) idx += H;
      reduce_channels<kMask / 2, H, kLowMask>(vals, lane, idx);
    } else {
      vals[0] += __shfl_xor_sync(0xffffffffu, vals[0], kMask);
      reduce_channels<kMask / 2, 1, kLowMask>(vals, lane, idx);
    }
  }
}

template <int N>
__host__ __device__ constexpr size_t bwd_stage_floats() {
  return 3 * (size_t)kChunk * kBwdChannels + 2 * (size_t)kChunk * N;
}
template <int N>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  constexpr int kThreads = Layout<N>::kBwdThreads;
  return (2 * bwd_stage_floats<N>() +                 // dt, x, dy, B, C x 2
          2 * (size_t)kChunk * kBwdChannels +         // ddt, dx tiles
          (size_t)kChunk * (kThreads / 32) * 2 * N +  // dB / dC per warp
          (size_t)kSubs * Layout<N>::kSpt * kThreads  // sub-chunk starts
          ) * sizeof(float);
}

template <int N>
__global__ void __launch_bounds__(Layout<N>::kBwdThreads, 1)
scan_bwd_kernel(const float* __restrict__ dt,      // [B, S, D]
                const float* __restrict__ x,       // [B, S, D]
                const float* __restrict__ bm,      // [B, S, N]
                const float* __restrict__ cm,      // [B, S, N]
                const float* __restrict__ a,       // [D, N]
                const float* __restrict__ hck,     // [B, K, D, N]
                const float* __restrict__ dy,      // [B, S, D]
                const float* __restrict__ dh_final,  // [B, D, N]
                float* __restrict__ ddt,           // [B, S, D]
                float* __restrict__ dx,            // [B, S, D]
                float* __restrict__ db_part,       // [B, G, S, N]
                float* __restrict__ dc_part,       // [B, G, S, N]
                float* __restrict__ da_part,       // [B, D, N]
                float* __restrict__ dh0,           // [B, D, N]
                int S, int D, int vec_in) {
  constexpr int kSpt = Layout<N>::kSpt, kLanes = Layout<N>::kLanes;
  constexpr int kThreads = Layout<N>::kBwdThreads, CH = kBwdChannels;
  constexpr int kWarps = kThreads / 32;
  constexpr int kSlots = 2 * N;          // a step's dB and dC sums
  constexpr int kVals = 2 * kSpt;        // a lane's share of them
  constexpr size_t kStage = bwd_stage_floats<N>();
  // lanes that end the reduce-scatter with a copy of another lane's sum
  constexpr int kPlainBits = ((32 / kVals) - 1) & ~(kLanes - 1);
  const bool vec = vec_in != 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cl = tid / kLanes;
  const int half = tid % kLanes;
  const int n0 = half * kSpt;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int d0 = g * CH;
  const int d = d0 + cl;
  const int bi = blockIdx.y;
  const bool live = d < D;

  extern __shared__ __align__(16) float smem_f[];
  float* stage = smem_f;                         // [2][kStage]
  float* ddt_s = stage + 2 * kStage;             // [kChunk][CH]
  float* dx_s = ddt_s + kChunk * CH;             // [kChunk][CH]
  float* red_s = dx_s + kChunk * CH;             // [kChunk][kWarps][kSlots]
  float* hs_s = red_s + kChunk * kWarps * kSlots;  // [kSubs][kSpt][kThreads]

  float a2[kSpt], dh[kSpt], da[kSpt];
#pragma unroll
  for (int j = 0; j < kSpt; ++j) {
    a2[j] = live ? a[(size_t)d * N + n0 + j] * kLog2e : 0.f;
    dh[j] = live ? dh_final[((size_t)bi * D + d) * N + n0 + j] : 0.f;
    da[j] = 0.f;
  }
  const int n_chunks = (S + kChunk - 1) / kChunk;

  auto stage_chunk = [&](int k, int buf_i) {
    float* buf = stage + buf_i * kStage;
    const int t0 = k * kChunk;
    const int valid = min(kChunk, S - t0);
    const size_t row0 = (size_t)bi * S + t0;
    stage_channels<float, CH, kThreads>(buf, dt, row0, valid, d0, D, vec);
    stage_channels<float, CH, kThreads>(buf + kChunk * CH, x, row0, valid,
                                        d0, D, vec);
    stage_channels<float, CH, kThreads>(buf + 2 * kChunk * CH, dy, row0,
                                        valid, d0, D, vec);
    stage_states<float, N, kThreads>(buf + 3 * kChunk * CH, bm, row0, valid,
                                     vec);
    stage_states<float, N, kThreads>(buf + 3 * kChunk * CH + kChunk * N, cm,
                                     row0, valid, vec);
  };

  stage_chunk(n_chunks - 1, 0);
  cp_async_commit();
  for (int k = n_chunks - 1, it = 0; k >= 0; --k, ++it) {
    const int t0 = k * kChunk;
    const int valid = min(kChunk, S - t0);
    const size_t row0 = (size_t)bi * S + t0;
    if (k > 0) stage_chunk(k - 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* buf = stage + (it & 1) * kStage;
    const float* dt_s = buf;
    const float* x_s = buf + kChunk * CH;
    const float* dy_s = buf + 2 * kChunk * CH;
    const float* b_s = buf + 3 * kChunk * CH;
    const float* c_s = b_s + kChunk * N;

    // walk the chunk forward from its checkpoint once, keeping the state
    // entering each sub-chunk (this thread's column of hs_s)
    {
      float h[kSpt];
      const float* src = hck + (((size_t)bi * n_chunks + k) * D + d) * N + n0;
#pragma unroll
      for (int j = 0; j < kSpt; ++j) {
        h[j] = live ? src[j] : 0.f;
        hs_s[j * kThreads + tid] = h[j];
      }
#pragma unroll 1
      for (int s = 1; s < kSubs && s * kSub < valid; ++s) {
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int t = (s - 1) * kSub + i;
          const float dtv = dt_s[t * CH + cl];
          const float dtx = dtv * x_s[t * CH + cl];
          float bv[kSpt];
          load_states<kSpt>(b_s + t * N + n0, bv);
#pragma unroll
          for (int j = 0; j < kSpt; ++j)
            h[j] = fmaf(ex2(dtv * a2[j]), h[j], dtx * bv[j]);
        }
#pragma unroll
        for (int j = 0; j < kSpt; ++j)
          hs_s[(s * kSpt + j) * kThreads + tid] = h[j];
      }
    }

    // sub-chunks last to first: recompute the 8 states and decay factors
    // into registers, then run the reverse adjoint over them
#pragma unroll 1
    for (int s = (valid - 1) / kSub; s >= 0; --s) {
      float hist[kSub + 1][kSpt], ahist[kSub][kSpt];
#pragma unroll
      for (int j = 0; j < kSpt; ++j)
        hist[0][j] = hs_s[(s * kSpt + j) * kThreads + tid];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int t = s * kSub + i;
        const float dtv = dt_s[t * CH + cl];    // zeros past valid
        const float dtx = dtv * x_s[t * CH + cl];
        float bv[kSpt];
        load_states<kSpt>(b_s + t * N + n0, bv);
#pragma unroll
        for (int j = 0; j < kSpt; ++j) {
          ahist[i][j] = ex2(dtv * a2[j]);
          hist[i + 1][j] = fmaf(ahist[i][j], hist[i][j], dtx * bv[j]);
        }
      }
#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        const int t = s * kSub + i;
        if (t >= valid) continue;               // uniform over the block
        const float dtv = dt_s[t * CH + cl];
        const float xv = x_s[t * CH + cl];
        const float dyv = dy_s[t * CH + cl];
        const float dtx = dtv * xv;
        float bv[kSpt], cv[kSpt], vals[kVals];
        load_states<kSpt>(b_s + t * N + n0, bv);
        load_states<kSpt>(c_s + t * N + n0, cv);
        float u = 0.f, v = 0.f;
#pragma unroll
        for (int j = 0; j < kSpt; ++j) {
          const float dht = fmaf(dyv, cv[j], dh[j]);
          const float ga = dht * (ahist[i][j] * hist[i][j]);
          u = fmaf(ga, a2[j], u);
          da[j] = fmaf(ga, dtv, da[j]);
          v = fmaf(dht, bv[j], v);
          vals[j] = dht * dtx;
          vals[kSpt + j] = hist[i + 1][j] * dyv;
          dh[j] = ahist[i][j] * dht;
        }
        if (kLanes == 2) {
          u += __shfl_xor_sync(0xffffffffu, u, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 1);
        }
        if (half == 0) {
          ddt_s[t * CH + cl] = fmaf(u, kLn2, v * xv);  // u * ln 2: A2 -> A
          dx_s[t * CH + cl] = v * dtv;
        }
        int idx = 0;
        reduce_channels<16, kVals, kLanes>(vals, lane, idx);
        if ((lane & kPlainBits) == 0) {
          const int slot = idx < kSpt ? n0 + idx : N + n0 + idx - kSpt;
          red_s[(t * kWarps + warp) * kSlots + slot] = vals[0];
        }
      }
    }
    __syncthreads();

    write_channels<float, CH, kThreads>(ddt, ddt_s, row0, valid, d0, D,
                                        vec);
    write_channels<float, CH, kThreads>(dx, dx_s, row0, valid, d0, D, vec);
    for (int e = tid; e < valid * kSlots; e += kThreads) {
      const int t = e / kSlots, slot = e % kSlots;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        sum += red_s[(t * kWarps + w) * kSlots + slot];
      float* dst = slot < N ? db_part : dc_part;
      dst[(((size_t)bi * G + g) * S + t0 + t) * N + slot % N] = sum;
    }
    // the next chunk refills this chunk's stage buffer and rewrites hs_s,
    // ddt_s, dx_s and red_s only after its own barrier
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kSpt; ++j) {
      const size_t state = ((size_t)bi * D + d) * N + n0 + j;
      dh0[state] = dh[j];
      da_part[state] = da[j];
    }
  }
}

// ------------------------------- launches -------------------------------
cudaError_t set_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Whether the 16-byte copies can take every row of dt, x (, dy, y) and
// every chunk of B, C: aligned bases, rows of D and batches of S * N
// elements in whole 16-byte units.
bool vec_ok(int esize, int B, int S, int D, int N,
            std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return ((size_t)D * esize) % 16 == 0 &&
         (B == 1 || ((size_t)S * N * esize) % 16 == 0);
}

template <typename T, int N, bool kCkpt>
const void* fwd_kernel() {
  return reinterpret_cast<const void*>(scan_fwd_kernel<T, N, kCkpt>);
}

template <typename T, int N, bool kCkpt>
int launch_fwd(const void* dt, const void* x, const void* b, const void* c,
               const void* a, const void* h0, void* y, void* h_final,
               void* hck, int B, int S, int D, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<T, N>();
  const cudaError_t err = set_smem(fwd_kernel<T, N, kCkpt>(), smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = vec_ok(sizeof(T), B, S, D, N, {dt, x, b, c, y});
  const dim3 grid((D + kFwdChannels - 1) / kFwdChannels, B);
  scan_fwd_kernel<T, N, kCkpt><<<grid, Layout<N>::kFwdThreads, smem,
                                 stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_final),
      static_cast<float*>(hck), S, D, vec);
  return (int)cudaGetLastError();
}

template <int N>
int launch_bwd(const void* dt, const void* x, const void* b, const void* c,
               const void* a, const void* hck, const void* dy,
               const void* dh_final, void* ddt, void* dx, void* db_part,
               void* dc_part, void* da_part, void* dh0, int B, int S, int D,
               cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<N>();
  const cudaError_t err =
      set_smem(reinterpret_cast<const void*>(scan_bwd_kernel<N>), smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = vec_ok(4, B, S, D, N, {dt, x, b, c, dy, ddt, dx});
  const dim3 grid((D + kBwdChannels - 1) / kBwdChannels, B);
  scan_bwd_kernel<N><<<grid, Layout<N>::kBwdThreads, smem, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(x),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(a), static_cast<const float*>(hck),
      static_cast<const float*>(dy), static_cast<const float*>(dh_final),
      static_cast<float*>(ddt), static_cast<float*>(dx),
      static_cast<float*>(db_part), static_cast<float*>(dc_part),
      static_cast<float*>(da_part), static_cast<float*>(dh0), S, D, vec);
  return (int)cudaGetLastError();
}

template <typename T, bool kCkpt>
int dispatch_fwd(const void* dt, const void* x, const void* b,
                 const void* c, const void* a, const void* h0, void* y,
                 void* h_final, void* hck, int B, int S, int D, int N,
                 cudaStream_t s) {
  switch (N) {
    case 1: return launch_fwd<T, 1, kCkpt>(dt, x, b, c, a, h0, y, h_final,
                                           hck, B, S, D, s);
    case 2: return launch_fwd<T, 2, kCkpt>(dt, x, b, c, a, h0, y, h_final,
                                           hck, B, S, D, s);
    case 4: return launch_fwd<T, 4, kCkpt>(dt, x, b, c, a, h0, y, h_final,
                                           hck, B, S, D, s);
    case 8: return launch_fwd<T, 8, kCkpt>(dt, x, b, c, a, h0, y, h_final,
                                           hck, B, S, D, s);
    case 16: return launch_fwd<T, 16, kCkpt>(dt, x, b, c, a, h0, y, h_final,
                                             hck, B, S, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_fwd(int ckpt, const void* dt, const void* x, const void* b,
                 const void* c, const void* a, const void* h0, void* y,
                 void* h_final, void* hck, int B, int S, int D, int N,
                 cudaStream_t s) {
  if (ckpt)
    return dispatch_fwd<T, true>(dt, x, b, c, a, h0, y, h_final, hck, B, S,
                                 D, N, s);
  return dispatch_fwd<T, false>(dt, x, b, c, a, h0, y, h_final, hck, B, S,
                                D, N, s);
}

// Registers, spilled bytes, threads, dynamic shared memory, resident
// blocks per SM and channels of one block of a kernel (out[0..5]).
int describe(const void* kernel, int threads, size_t smem, int channels,
             int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = set_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = threads;
  out[3] = (int)smem;
  out[4] = blocks;
  out[5] = channels;
  return 0;
}

template <int N>
int describe_n(int kind, int dtype, int* out) {
  if (kind == 2)
    return describe(reinterpret_cast<const void*>(scan_bwd_kernel<N>),
                    Layout<N>::kBwdThreads, bwd_smem_bytes<N>(),
                    kBwdChannels, out);
  const int threads = Layout<N>::kFwdThreads;
  if (dtype == 0)
    return describe(kind ? fwd_kernel<float, N, true>()
                         : fwd_kernel<float, N, false>(),
                    threads, fwd_smem_bytes<float, N>(), kFwdChannels, out);
  return describe(kind ? fwd_kernel<bf16, N, true>()
                       : fwd_kernel<bf16, N, false>(),
                  threads, fwd_smem_bytes<bf16, N>(), kFwdChannels, out);
}

bool valid_state(int N) {
  return N >= 1 && N <= kMaxState && (N & (N - 1)) == 0;
}

}  // namespace

extern "C" {

// Steps per checkpoint (hck's second axis is ceil(S / chunk)) and the
// backward's channels per block (the dB / dC partials' second axis is
// ceil(D / channels)).
int selective_scan_chunk() { return kChunk; }
int selective_scan_channels() { return kBwdChannels; }

// kind: 0 forward, 1 checkpointing forward, 2 backward; dtype as below
// (the backward is float32).  Writes registers a thread, spilled bytes a
// thread, threads a block, dynamic shared memory a block, resident blocks
// per SM and channels a block to out[0..5].  Returns a cudaError_t.
int selective_scan_describe(int kind, int dtype, int N, int* out) {
  switch (N) {
    case 1: return describe_n<1>(kind, dtype, out);
    case 2: return describe_n<2>(kind, dtype, out);
    case 4: return describe_n<4>(kind, dtype, out);
    case 8: return describe_n<8>(kind, dtype, out);
    case 16: return describe_n<16>(kind, dtype, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16 (dt, x, B, C and y); ckpt != 0 also
// writes hck.  Returns a cudaError_t (0 = success).
int selective_scan_fwd(int dtype, int ckpt, const void* dt, const void* x,
                       const void* b, const void* c, const void* a,
                       const void* h0, void* y, void* h_final, void* hck,
                       int B, int S, int D, int N, void* stream) {
  if (!valid_state(N) || B < 1 || S < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_fwd<float>(ckpt, dt, x, b, c, a, h0, y, h_final, hck, B,
                               S, D, N, s);
  if (dtype == 1)
    return dispatch_fwd<bf16>(ckpt, dt, x, b, c, a, h0, y, h_final, hck, B,
                              S, D, N, s);
  return (int)cudaErrorInvalidValue;
}

// All float32.  Returns a cudaError_t (0 = success).
int selective_scan_bwd(const void* dt, const void* x, const void* b,
                       const void* c, const void* a, const void* hck,
                       const void* dy, const void* dh_final, void* ddt,
                       void* dx, void* db_part, void* dc_part, void* da_part,
                       void* dh0, int B, int S, int D, int N, void* stream) {
  if (!valid_state(N) || B < 1 || S < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch_bwd<1>(dt, x, b, c, a, hck, dy, dh_final, ddt, dx,
                                 db_part, dc_part, da_part, dh0, B, S, D, s);
    case 2: return launch_bwd<2>(dt, x, b, c, a, hck, dy, dh_final, ddt, dx,
                                 db_part, dc_part, da_part, dh0, B, S, D, s);
    case 4: return launch_bwd<4>(dt, x, b, c, a, hck, dy, dh_final, ddt, dx,
                                 db_part, dc_part, da_part, dh0, B, S, D, s);
    case 8: return launch_bwd<8>(dt, x, b, c, a, hck, dy, dh_final, ddt, dx,
                                 db_part, dc_part, da_part, dh0, B, S, D, s);
    case 16: return launch_bwd<16>(dt, x, b, c, a, hck, dy, dh_final, ddt,
                                   dx, db_part, dc_part, da_part, dh0, B, S,
                                   D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
