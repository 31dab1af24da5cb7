// K-way fused accumulate for Hopper (sm_90a): out[n] = sum_k x[k, n].
//
// Port of the Pallas kernel repro/kernels/multi_add.py::_multi_add_kernel
// (the reduce endpoint's accumulate of K partial vectors).  The sum runs
// in float32, k = 0, 1, ..., K-1 in that order, and is stored in the
// input type (float32 or bfloat16, rounded to nearest even).
//
// What bounds it: bytes.  One pass reads K*N elements and writes N, no
// operand is reused, so the least time is (K+1)*N*esize over the card's
// memory rate.  Design: each thread owns 16 bytes of the output (4 fp32
// or 8 bf16 lanes) and walks the K rows with one 16-byte load per row,
// so a warp reads 512 contiguous bytes per row; the loop over K is
// unrolled so that several rows' loads are in flight before the adds
// (which stay in order).  A grid-stride loop over the vectors fills the
// card at any N.  When the rows are not 16-byte aligned (N not a
// multiple of the vector width, e.g. N = 1,000,003), the same mapping
// runs on one element per thread with the ragged tail masked in the
// kernel: there is no padding, as the TPU kernel needed.
//
// Plain C interface (loaded with ctypes); returns the cudaError_t of the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// VEC lanes per thread: 16 bytes (VEC = 16 / sizeof(T)) with 16-byte
// loads, or 1 lane with element loads (any alignment, masked tail).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
multi_add_kernel(const T* __restrict__ x, T* __restrict__ out, int k,
                 long long n) {
  const long long units = n / VEC;      // VEC > 1: n % VEC == 0
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < units; u += stride) {
    float acc[VEC];
    if constexpr (VEC == 1) {
      acc[0] = to_f32(x[u]);
#pragma unroll 8
      for (int r = 1; r < k; ++r) acc[0] += to_f32(x[(long long)r * n + u]);
      from_f32(acc[0], out + u);
    } else {
      const uint4* rows = reinterpret_cast<const uint4*>(x);
      uint4 p = __ldg(rows + u);
      const T* e = reinterpret_cast<const T*>(&p);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = to_f32(e[i]);
#pragma unroll 4
      for (int r = 1; r < k; ++r) {
        uint4 q = __ldg(rows + (long long)r * units + u);
        const T* f = reinterpret_cast<const T*>(&q);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += to_f32(f[i]);
      }
      uint4 o;
      T* g = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int i = 0; i < VEC; ++i) from_f32(acc[i], &g[i]);
      reinterpret_cast<uint4*>(out)[u] = o;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* out, int k, long long n,
                   cudaStream_t stream) {
  const long long units = n / VEC;
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (units + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 16;    // grid-stride beyond this
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  multi_add_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), k, n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  x: [k, n] contiguous; out: [n].
// vectorized != 0 requires n % (16 / sizeof(T)) == 0 and 16-byte aligned
// x and out (the wrapper checks).
extern "C" int multi_add(int dtype, const void* x, void* out, int k,
                         long long n, int vectorized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0) return 0;
  if (dtype == 0)
    return vectorized ? launch<float, 4>(x, out, k, n, s)
                      : launch<float, 1>(x, out, k, n, s);
  if (dtype == 1)
    return vectorized ? launch<__nv_bfloat16, 8>(x, out, k, n, s)
                      : launch<__nv_bfloat16, 1>(x, out, k, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
