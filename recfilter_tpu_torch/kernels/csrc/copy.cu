// copy: the streaming pass y = 1.0001f * x over a float32 array — the
// bandwidth probe of the headline benchmark (recfilter_tpu_torch/bench.py).
//
// Replaces bench.py::_copy (Pallas kernel _copy_kernel, its pallas_call at
// bench.py:162), which calibrates the TPU's roofline. The multiply keeps
// the pass from being a plain memcpy that a runtime could route through a
// copy engine; it is one fp32 rounding, so the output equals PyTorch's
// x * 1.0001 bit for bit.
//
// What bounds it: it reads 4 B and writes 4 B an element with one multiply,
// so device memory bounds it: 2 * 64 MiB / 3.35 TB/s = 0.040 ms at
// 4096^2. The design: 16-byte loads and stores (float4), consecutive
// threads on consecutive vectors, four vectors a thread loaded before any
// is stored, so that enough loads are in flight to cover the memory
// latency, and one pass: a grid of as many 256-thread blocks as the four
// vectors a thread need; streaming cache hints (__ldcs, __stcs: the data
// is touched once). The tail of fewer than four elements runs scalar.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // vectors a thread has in flight

__device__ __forceinline__ float4 scaled(float4 v) {
  v.x *= 1.0001f;
  v.y *= 1.0001f;
  v.z *= 1.0001f;
  v.w *= 1.0001f;
  return v;
}

__global__ void __launch_bounds__(THREADS)
copy_kernel(const float* __restrict__ x, float* __restrict__ y, long n) {
  const long n4 = n / 4;
  const long stride = (long)gridDim.x * THREADS;
  const long i0 = (long)blockIdx.x * THREADS + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (long i = i0; i < n4; i += UNROLL * stride) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i + u * stride < n4) v[u] = __ldcs(x4 + i + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i + u * stride < n4) __stcs(y4 + i + u * stride, scaled(v[u]));
  }
  for (long k = 4 * n4 + i0; k < n; k += stride) y[k] = x[k] * 1.0001f;
}

}  // namespace

// x and y 16-byte aligned, n >= 0 elements
extern "C" int copy_launch(const float* x, float* y, int n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long want = ((long)n / 4 + THREADS * UNROLL - 1) /
                    (THREADS * UNROLL);
  const int blocks = want < 1 ? 1 : (int)want;
  copy_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(x, y, (long)n);
  return (int)cudaGetLastError();
}

extern "C" const char* copy_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
