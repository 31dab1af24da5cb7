// Mamba-1 selective scan for NVIDIA Hopper (sm_90a), hand-written CUDA C++:
// the forward (with and without chunk checkpoints) and its backward.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/selective_scan.py:
//   selective_scan  (_scan_kernel)           -> scan_fwd_kernel<T, false>
//   _fwd_with_ckpt  (_scan_fwd_ckpt_kernel)  -> scan_fwd_kernel<T, true>
//   _bwd_call       (_scan_bwd_kernel)       -> scan_bwd_kernel
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
// 0.26 ms at 1.98 GHz over 132 SMs): the two are close, exponentials
// slightly ahead.  The backward moves dt, x, dy in and ddt, dx out (about
// 1.34 GB) and is bound by bytes.  The [B, S, D, N] state expansion the
// plain route writes to device memory (~4.3 GB per layer per tensor at that
// shape) never leaves registers here.
//
// Design (a first kernel: simple and right; overlapping the staging with
// compute, and a backward that fits one wave, are later work):
//  * one thread per (batch, channel, state); a block holds kChannels = 32
//    channels x N states (N a power of two up to 16, so a channel's states
//    are an aligned group of N lanes of one warp).  At the training shape
//    that is 2 x 8192 x 16 = 262,144 threads in 512 blocks of 512;
//  * the sequence is walked inside the thread (the TPU grid's sequential
//    axis becomes a loop).  Each chunk of kChunk = 64 steps is staged into
//    shared memory first, neighbouring threads on neighbouring addresses,
//    as float32 whatever the input type; y is gathered in shared memory and
//    written back per chunk, so global accesses stay coalesced;
//  * y_t's sum over N is a shuffle reduction inside the channel's lanes.
//    One thread per (batch, channel) with its N states in registers needs
//    no shuffles, but measured twice as slow at the training shape: its
//    2 x 8192 threads are too few warps to hide the exponentials' latency;
//  * the checkpointing forward writes the state entering every chunk,
//    hck [B, ceil(S / kChunk), D, N] float32 (the port's own layout);
//  * the backward walks the chunks in reverse from hck.  The Pallas kernel
//    keeps the chunk's whole state history in VMEM; that does not fit
//    shared memory at this block size, so the history is recomputed in
//    registers instead: pass 1 walks the chunk forward and keeps the state
//    at the start of each kSub = 8-step sub-chunk (8 registers); pass 2 takes
//    the sub-chunks last to first, recomputes their 8 states and decay
//    factors into registers (fully unrolled loops, static indices) and runs
//    the reverse adjoint over them.  Each step costs two exponentials
//    instead of one, and the register arrays are why the backward is
//    held to 64 registers (two blocks per SM, a small spill);
//  * sums over N (ddt, dx) are shuffles; sums over channels (dB, dC) are a
//    shuffle across the warp's channels, then a fixed-order sum over the
//    block's warps in shared memory, written as one partial per block
//    [B, G, S, N] that the wrapper sums with torch.sum; dA is written per
//    batch [B, D, N] and summed the same way.  No atomics: the result is
//    the same from run to run;
//  * any S and D: the last chunk is short, and lanes past D compute on
//    zeros (which contribute exact zeros to every sum) and write nothing.
//
// Limits (checked by the Python wrapper): N in {1, 2, 4, 8, 16}; the
// forward takes float or bf16 dt, x, B, C (one type) and float32 A, h0;
// the backward takes float32 throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;     // steps per staged tile and per checkpoint
constexpr int kSub = 8;        // backward: steps recomputed in registers
constexpr int kChannels = 32;  // channels per block
constexpr int kMaxState = 16;
constexpr int kMaxThreads = kChannels * kMaxState;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// Sum over the N lanes of one channel (an aligned group of N lanes).
__device__ __forceinline__ float sum_states(float v, int N) {
  for (int o = N >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the channels of one warp, lane by lane of the state index.
__device__ __forceinline__ float sum_warp_channels(float v, int N) {
  for (int o = N; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t fwd_smem_bytes(int N) {
  return (3 * (size_t)kChunk * kChannels + 2 * (size_t)kChunk * N) *
         sizeof(float);
}

size_t bwd_smem_bytes(int N) {
  const int warps = (kChannels * N + 31) / 32;
  return (5 * (size_t)kChunk * kChannels + 2 * (size_t)kChunk * N +
          2 * (size_t)kSub * warps * N) *
         sizeof(float);
}

// Stage rows [t0, t0 + valid) of a [B*S, D] tensor's channels
// [d0, d0 + kChannels) as float32 into tile[kChunk][kChannels] (zeros
// outside).
template <typename T>
__device__ __forceinline__ void stage_channels(const T* __restrict__ src,
                                               float* tile, size_t row0,
                                               int valid, int d0, int D) {
  for (int e = threadIdx.x; e < kChunk * kChannels; e += blockDim.x) {
    const int t = e / kChannels;
    const int d = d0 + (e - t * kChannels);
    tile[e] = (t < valid && d < D) ? to_float(src[(row0 + t) * D + d]) : 0.f;
  }
}

// Stage rows [t0, t0 + valid) of a [B*S, N] tensor into tile[kChunk][N].
template <typename T>
__device__ __forceinline__ void stage_states(const T* __restrict__ src,
                                             float* tile, size_t row0,
                                             int valid, int N) {
  for (int e = threadIdx.x; e < kChunk * N; e += blockDim.x)
    tile[e] = (e / N < valid) ? to_float(src[row0 * N + e]) : 0.f;
}

// At most 32 registers: four 512-thread blocks per SM, so the 512 blocks
// of the training shape run in one wave.
template <typename T, bool kCkpt>
__global__ void __launch_bounds__(kMaxThreads, 4)
scan_fwd_kernel(const T* __restrict__ dt,        // [B, S, D]
                const T* __restrict__ x,         // [B, S, D]
                const T* __restrict__ bm,        // [B, S, N]
                const T* __restrict__ cm,        // [B, S, N]
                const float* __restrict__ a,     // [D, N]
                const float* __restrict__ h0,    // [B, D, N]
                T* __restrict__ y,               // [B, S, D]
                float* __restrict__ h_final,     // [B, D, N]
                float* __restrict__ hck,         // [B, K, D, N] (kCkpt)
                int S, int D, int N) {
  const int tid = threadIdx.x;
  const int n = tid & (N - 1);
  const int cl = tid / N;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + cl;
  const int bi = blockIdx.y;
  const bool live = d < D;

  extern __shared__ __align__(16) float smem[];
  float* dt_s = smem;                        // [kChunk][kChannels]
  float* x_s = dt_s + kChunk * kChannels;    // [kChunk][kChannels]
  float* y_s = x_s + kChunk * kChannels;     // [kChunk][kChannels]
  float* b_s = y_s + kChunk * kChannels;     // [kChunk][N]
  float* c_s = b_s + kChunk * N;             // [kChunk][N]

  const size_t state = ((size_t)bi * D + d) * N + n;
  const float A = live ? a[(size_t)d * N + n] : 0.f;
  float h = live ? h0[state] : 0.f;
  const int n_chunks = (S + kChunk - 1) / kChunk;

  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * kChunk;
    const int valid = min(kChunk, S - t0);
    const size_t row0 = (size_t)bi * S + t0;
    if (kCkpt && live)
      hck[(((size_t)bi * n_chunks + k) * D + d) * N + n] = h;
    stage_channels(dt, dt_s, row0, valid, d0, D);
    stage_channels(x, x_s, row0, valid, d0, D);
    stage_states(bm, b_s, row0, valid, N);
    stage_states(cm, c_s, row0, valid, N);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < valid; ++t) {
      const float dtv = dt_s[t * kChannels + cl];
      const float bb = (dtv * x_s[t * kChannels + cl]) * b_s[t * N + n];
      h = __expf(dtv * A) * h + bb;
      const float yv = sum_states(h * c_s[t * N + n], N);
      if (n == 0) y_s[t * kChannels + cl] = yv;
    }
    __syncthreads();
    for (int e = tid; e < valid * kChannels; e += blockDim.x) {
      const int t = e / kChannels;
      const int dd = d0 + (e - t * kChannels);
      if (dd < D) store(y_s[e], y + (row0 + t) * D + dd);
    }
    // the next chunk stages dt/x/B/C (last read before the barrier above)
    // and writes y_s only after its own barrier, which follows these reads
  }
  if (live) h_final[state] = h;
}

// At most 64 registers: two 512-thread blocks per SM (left to itself the
// compiler takes 90, which leaves one and made the kernel 1.6x slower).
__global__ void __launch_bounds__(kMaxThreads, 2)
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
                int S, int D, int N) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  const int n = tid & (N - 1);
  const int cl = tid / N;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int d0 = g * kChannels;
  const int d = d0 + cl;
  const int bi = blockIdx.y;
  const bool live = d < D;

  extern __shared__ __align__(16) float smem[];
  float* dt_s = smem;                         // [kChunk][kChannels]
  float* x_s = dt_s + kChunk * kChannels;     // [kChunk][kChannels]
  float* dy_s = x_s + kChunk * kChannels;     // [kChunk][kChannels]
  float* ddt_s = dy_s + kChunk * kChannels;   // [kChunk][kChannels]
  float* dx_s = ddt_s + kChunk * kChannels;   // [kChunk][kChannels]
  float* b_s = dx_s + kChunk * kChannels;     // [kChunk][N]
  float* c_s = b_s + kChunk * N;              // [kChunk][N]
  float* red_s = c_s + kChunk * N;            // [2][kSub][warps][N]

  const size_t state = ((size_t)bi * D + d) * N + n;
  const float A = live ? a[(size_t)d * N + n] : 0.f;
  float dh = live ? dh_final[state] : 0.f;
  float da = 0.f;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  constexpr int kSubs = kChunk / kSub;

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int valid = min(kChunk, S - t0);
    const size_t row0 = (size_t)bi * S + t0;
    __syncthreads();  // the previous chunk's ddt_s / dx_s are written out
    stage_channels(dt, dt_s, row0, valid, d0, D);
    stage_channels(x, x_s, row0, valid, d0, D);
    stage_channels(dy, dy_s, row0, valid, d0, D);
    stage_states(bm, b_s, row0, valid, N);
    stage_states(cm, c_s, row0, valid, N);
    __syncthreads();

    // pass 1: the state entering each sub-chunk
    float hs[kSubs];
    float h = live ? hck[(((size_t)bi * n_chunks + k) * D + d) * N + n] : 0.f;
#pragma unroll
    for (int s = 0; s < kSubs; ++s) {
      hs[s] = h;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int t = s * kSub + j;
        if (t < valid) {
          const float dtv = dt_s[t * kChannels + cl];
          h = __expf(dtv * A) * h +
              (dtv * x_s[t * kChannels + cl]) * b_s[t * N + n];
        }
      }
    }

    // pass 2: sub-chunks last to first, reverse adjoint within each
#pragma unroll
    for (int s = kSubs - 1; s >= 0; --s) {
      if (s * kSub >= valid) continue;  // uniform over the block
      float hp[kSub], ap[kSub];
      float hh = hs[s];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int t = s * kSub + j;
        hp[j] = hh;
        ap[j] = 0.f;
        if (t < valid) {
          const float dtv = dt_s[t * kChannels + cl];
          ap[j] = __expf(dtv * A);
          hh = ap[j] * hh + (dtv * x_s[t * kChannels + cl]) * b_s[t * N + n];
        }
      }
#pragma unroll
      for (int j = kSub - 1; j >= 0; --j) {
        const int t = s * kSub + j;
        float dbv = 0.f, dcv = 0.f;
        if (t < valid) {  // uniform over the block
          const float dtv = dt_s[t * kChannels + cl];
          const float xv = x_s[t * kChannels + cl];
          const float dyv = dy_s[t * kChannels + cl];
          const float bv = b_s[t * N + n];
          const float cv = c_s[t * N + n];
          const float h_prev = hp[j];
          const float a_t = ap[j];
          const float dtx = dtv * xv;
          const float h_t = a_t * h_prev + dtx * bv;
          const float dh_t = dyv * cv + dh;
          const float g_a = dh_t * h_prev * a_t;
          const float u = sum_states(g_a * A, N);
          const float v = sum_states(dh_t * bv, N);
          if (n == 0) {
            ddt_s[t * kChannels + cl] = u + v * xv;
            dx_s[t * kChannels + cl] = v * dtv;
          }
          dbv = dh_t * dtx;
          dcv = h_t * dyv;
          da += g_a * dtv;
          dh = a_t * dh_t;
        }
        dbv = sum_warp_channels(dbv, N);
        dcv = sum_warp_channels(dcv, N);
        if (lane < N) {
          red_s[((0 * kSub + j) * warps + warp) * N + lane] = dbv;
          red_s[((1 * kSub + j) * warps + warp) * N + lane] = dcv;
        }
      }
      __syncthreads();
      for (int e = tid; e < 2 * kSub * N; e += blockDim.x) {
        const int which = e / (kSub * N);       // 0: dB, 1: dC
        const int j = (e / N) % kSub;
        const int nn = e % N;
        const int t = s * kSub + j;
        if (t < valid) {
          float sum = 0.f;
          for (int w = 0; w < warps; ++w)
            sum += red_s[((which * kSub + j) * warps + w) * N + nn];
          const size_t off =
              (((size_t)bi * G + g) * S + t0 + t) * (size_t)N + nn;
          (which == 0 ? db_part : dc_part)[off] = sum;
        }
      }
      __syncthreads();
    }

    for (int e = tid; e < valid * kChannels; e += blockDim.x) {
      const int t = e / kChannels;
      const int dd = d0 + (e - t * kChannels);
      if (dd < D) {
        ddt[(row0 + t) * D + dd] = ddt_s[e];
        dx[(row0 + t) * D + dd] = dx_s[e];
      }
    }
  }
  if (live) {
    dh0[state] = dh;
    da_part[state] = da;
  }
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, bool kCkpt>
int launch_fwd(const void* dt, const void* x, const void* b, const void* c,
               const void* a, const void* h0, void* y, void* h_final,
               void* hck, int B, int S, int D, int N, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(N);
  const cudaError_t err =
      set_smem(reinterpret_cast<const void*>(scan_fwd_kernel<T, kCkpt>), smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D + kChannels - 1) / kChannels, B);
  scan_fwd_kernel<T, kCkpt><<<grid, kChannels * N, smem, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_final),
      static_cast<float*>(hck), S, D, N);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(int ckpt, const void* dt, const void* x, const void* b,
                 const void* c, const void* a, const void* h0, void* y,
                 void* h_final, void* hck, int B, int S, int D, int N,
                 cudaStream_t stream) {
  if (ckpt)
    return launch_fwd<T, true>(dt, x, b, c, a, h0, y, h_final, hck, B, S, D,
                               N, stream);
  return launch_fwd<T, false>(dt, x, b, c, a, h0, y, h_final, hck, B, S, D,
                              N, stream);
}

bool valid_state(int N) {
  return N >= 1 && N <= kMaxState && (N & (N - 1)) == 0;
}

}  // namespace

extern "C" {

// Steps per checkpoint (hck's second axis is ceil(S / chunk)) and channels
// per block (the dB / dC partials' second axis is ceil(D / channels)).
int selective_scan_chunk() { return kChunk; }
int selective_scan_channels() { return kChannels; }

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
    return dispatch_fwd<__nv_bfloat16>(ckpt, dt, x, b, c, a, h0, y, h_final,
                                       hck, B, S, D, N, s);
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
  const size_t smem = bwd_smem_bytes(N);
  const cudaError_t err =
      set_smem(reinterpret_cast<const void*>(scan_bwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D + kChannels - 1) / kChannels, B);
  scan_bwd_kernel<<<grid, kChannels * N, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dt), static_cast<const float*>(x),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(a), static_cast<const float*>(hck),
      static_cast<const float*>(dy), static_cast<const float*>(dh_final),
      static_cast<float*>(ddt), static_cast<float*>(dx),
      static_cast<float*>(db_part), static_cast<float*>(dc_part),
      static_cast<float*>(da_part), static_cast<float*>(dh0), S, D, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
