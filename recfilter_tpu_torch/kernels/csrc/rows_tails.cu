// rows_tails: raw tails of a scan along a non-last axis — the rows pass's
// first read of the array.
//
// Replaces recfilter_tpu/kernels/final2d.py::rows_tails_px (Pallas kernel
// _rows_tails_kernel). The array is tiled as x (p, n, T, W): the scanned
// axis cut into n tiles of T = 128 rows, everything after it flattened into
// W lanes, everything before it into p. Per 128 x 128 tile (block (l, a, p)),
// with v(a) the tile's matrix variant along the scanned axis (interior,
// first or last — clamp edges):
//
//   b[p,a,k, l*T+w] = sum_s G_v(a)[k,s] * x[p,a,s, l*T+w]        k < K
//
// and explicit zeros in the pad slots K..7: the carry solve multiplies them
// by zero columns, and an uninitialised NaN there would poison the result.
// This is the dim-A half of moments2d.cu, with no dim-B half.
//
// What bounds it: it reads 4 B per element and writes 32 B per 128 (one
// slot column per lane per tile), and does K MACs per element, so on an
// H100 it is bound by device-memory bandwidth. The design reads each x tile
// from device memory once, with float4 loads, into shared memory (row
// stride 132 floats: float4 row writes and column reads by consecutive
// threads are both free of bank conflicts); two threads per lane column
// then read it for slots {kg, kg+2, kg+4, kg+6} — x is never re-read from
// device memory per slot group.
//
// The sums accumulate in fp64 (fp32 loads and stores), as in moments2d.cu
// and tails.cu: these tails seed the carries, whose solve amplifies their
// rounding about thirtyfold for the sigma=5 Gaussian, and fp32 tail sums
// miss the 2e-6 px6 bound there. The TPU kernel's bf16 chunk splitting
// emulates fp32 products on the TPU matrix unit and has no counterpart here.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int T = 128;        // tile edge: rows of the scanned axis, lanes
constexpr int SLOTS = 8;      // carry rows per slot
constexpr int THREADS = 256;  // two threads per lane column
constexpr int XS = T + 4;     // padded shared row stride of the x tile
constexpr int SMEM_BYTES = (T * XS + SLOTS * T) * sizeof(float);

using rf::variant;

__global__ void __launch_bounds__(THREADS)
rows_tails_kernel(const float* __restrict__ x,  // (p, n, T, W)
                  const float* __restrict__ G,  // (nv, 8, T)
                  float* __restrict__ b,        // (p, n, 8, W)
                  int n, int nl, int K, int nv) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // T rows x XS
  float* g = xs + T * XS;                       // 8 x T

  const int l = blockIdx.x, a = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x;
  const long W = (long)nl * T;
  const long pa = (long)p * n + a;

  const float* xt = x + pa * T * W + (long)l * T;
  for (int i = tid; i < T * (T / 4); i += THREADS) {
    const int r = i / (T / 4), c4 = i % (T / 4);
    reinterpret_cast<float4*>(xs + r * XS)[c4] =
        reinterpret_cast<const float4*>(xt + r * W)[c4];
  }
  const float* gv = G + (long)variant(nv, a, n) * SLOTS * T;
  for (int i = tid; i < SLOTS * T; i += THREADS) g[i] = gv[i];
  __syncthreads();

  const int col = tid % T;  // lane w of the tile
  const int kg = tid / T;   // this thread's slots: kg, kg+2, kg+4, kg+6
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int s = 0; s < T; ++s) {
    const double xv = xs[s * XS + col];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] = fma((double)g[(kg + 2 * j) * T + s], xv, acc[j]);
  }
  float* bt = b + pa * SLOTS * W + (long)l * T + col;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = kg + 2 * j;
    bt[k * W] = k < K ? (float)acc[j] : 0.f;
  }
}

}  // namespace

extern "C" int rows_tails_launch(const float* x, const float* G, float* b,
                                 int p, int n, int nl, int K, int nv,
                                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rows_tails_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nl, n, p);
  rows_tails_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, G, b, n, nl, K, nv);
  return (int)cudaGetLastError();
}

extern "C" const char* rows_tails_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
