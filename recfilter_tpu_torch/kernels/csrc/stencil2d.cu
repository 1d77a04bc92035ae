// stencil2d: C channel banks of 2-D shifted taps over an (H, W) image,
// every channel from one staged read of the input.
//
// Replaces recfilter_tpu/kernels/stencil2d.py::stencil2d_pass (Pallas
// kernel _stencil2d_kernel). For channel c with taps (dy, dx, coeff):
//
//   out[c, s, o] = sum_taps coeff * v(s + dy, o + dx)
//   v(r, k) = 0                               r < 0 or k < 0
//           = y[min(r, H - 1), min(k, W - 1)]  otherwise
//
// Positive offsets clamp at the far edges (an integral image holds real
// totals there), negative offsets read zero (the zeroed margin of the box
// and DoG apps). That is the JAX package's twin, stencil2d_ref: the row
// shift, then the column shift of the row-shifted array. Input float32 or
// int8/16/32 (a summed-area table), output float32, as stencil2d_ref
// returns (the TPU kernel writes the input type, which truncates an
// integer table's differenced output).
//
// bf16 storage (stencil2d_bf16: a bank after a bf16 filter, whose output
// the JAX package's _st_fallback hands stencil2d_pass in its own dtype):
// y read as bf16 and widened (exact), the fp32 products and sums of the
// float32 entry in its order, each channel rounded once to bf16 (2 B read
// and 2*C B written per pixel: the bound halves).
//
// What bounds it: 4 B read (int32 or float) and 4*C B written per pixel
// against 2 * taps FLOP, so on an H100 it is bound by device-memory
// bandwidth (67 MB read + 134 MB written at 4096^2 and C = 2). The design:
// a block owns TH rows x 128 columns of the output; it stages that tile
// plus its halo (the taps' reach each side, the border rule applied while
// staging) in shared memory with coalesced loads, then every thread
// accumulates all C channels for its pixels from the staged tile and
// writes 128-float rows. Where the halo is too wide to stage (a reach past
// about 100 pixels each side), the same kernel reads each tap from device
// memory directly (through L1 and L2) instead.

#include "common.cuh"

namespace {

constexpr int TW = 128;       // output columns per block
constexpr int THREADS = 256;
constexpr int SMEM_CAP = 200 * 1024;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int v) { return (float)v; }
__device__ __forceinline__ float widen(short v) { return (float)v; }
__device__ __forceinline__ float widen(signed char v) { return (float)v; }
__device__ __forceinline__ float widen(rf::bf16 v) {
  return __bfloat162float(v);
}

template <typename In>
__device__ __forceinline__ float load(const In* y, int H, int W, int r,
                                      int k) {
  if (r < 0 || k < 0) return 0.f;
  return widen(y[(long)min(r, H - 1) * W + min(k, W - 1)]);
}

// In: y's type; Out: the output's, float or (for a bf16 y) bf16
template <typename In, typename Out, bool STAGED>
__global__ void __launch_bounds__(THREADS)
stencil2d_kernel(const In* __restrict__ y,        // (H, W)
                 const float* __restrict__ taps,  // (ntaps, 3): dy, dx, c
                 const int* __restrict__ toff,    // (C + 1) tap offsets
                 Out* __restrict__ out,           // (C, H, W)
                 int H, int W, int C, int TH, int hp, int hn, int dxl,
                 int dxr) {
  extern __shared__ float smem[];
  const int c0 = blockIdx.x * TW, r0 = blockIdx.y * TH;
  const int tid = threadIdx.x;
  const int SW = dxl + TW + dxr;  // staged row width
  const int SR = hp + TH + hn;    // staged rows
  if (STAGED) {
    for (int i = tid; i < SR * SW; i += THREADS) {
      const int r = i / SW, k = i % SW;
      smem[i] = load(y, H, W, r0 - hp + r, c0 - dxl + k);
    }
    __syncthreads();
  }
  const long plane = (long)H * W;
  for (int i = tid; i < TH * TW; i += THREADS) {
    const int s = i / TW, o = i % TW;
    const int gs = r0 + s, go = c0 + o;
    if (gs >= H || go >= W) continue;
    for (int c = 0; c < C; ++c) {
      float acc = 0.f;
      for (int k = toff[c]; k < toff[c + 1]; ++k) {
        const int dy = (int)taps[3 * k], dx = (int)taps[3 * k + 1];
        const float v =
            STAGED ? smem[(hp + s + dy) * SW + dxl + o + dx]
                   : load(y, H, W, gs + dy, go + dx);
        // product, then sum, each rounded: the twin's order (no FMA)
        const float t = __fmul_rn(taps[3 * k + 2], v);
        acc = k == toff[c] ? t : __fadd_rn(acc, t);
      }
      rf::store1(out + c * plane + (long)gs * W + go, acc);
    }
  }
}

template <typename In, typename Out = float>
int launch(const void* y, const float* taps, const int* toff, void* o,
           int H, int W, int C, int hp, int hn, int dxl, int dxr,
           cudaStream_t stream) {
  const In* yi = static_cast<const In*>(y);
  Out* out = static_cast<Out*>(o);
  const int SW = dxl + TW + dxr;
  int TH = 32;
  while (TH > 4 && (long)(hp + TH + hn) * SW * 4 > SMEM_CAP) TH /= 2;
  const long smem = (long)(hp + TH + hn) * SW * 4;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (smem <= SMEM_CAP) {
    cudaError_t err = cudaFuncSetAttribute(
        stencil2d_kernel<In, Out, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
    if (err != cudaSuccess) return (int)err;
    stencil2d_kernel<In, Out, true><<<grid, THREADS, smem, stream>>>(
        yi, taps, toff, out, H, W, C, TH, hp, hn, dxl, dxr);
  } else {
    stencil2d_kernel<In, Out, false><<<grid, THREADS, 0, stream>>>(
        yi, taps, toff, out, H, W, C, TH, hp, hn, dxl, dxr);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 int32, 2 int16, 3 int8.
extern "C" int stencil2d_launch(const void* y, const float* taps,
                                const int* toff, float* out, int H, int W,
                                int C, int hp, int hn, int dxl, int dxr,
                                int dtype, void* stream) {
  if (H < 1 || W < 1 || C < 1 || hp < 0 || hn < 0 || dxl < 0 || dxr < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(y, taps, toff, out, H, W, C, hp, hn, dxl, dxr, s);
    case 1: return launch<int>(y, taps, toff, out, H, W, C, hp, hn, dxl, dxr, s);
    case 2: return launch<short>(y, taps, toff, out, H, W, C, hp, hn, dxl, dxr, s);
    case 3: return launch<signed char>(y, taps, toff, out, H, W, C, hp, hn, dxl, dxr, s);
  }
  return (int)cudaErrorInvalidValue;
}

// y (H, W) and out (C, H, W) bf16; the rest as stencil2d_launch
extern "C" int stencil2d_bf16_launch(const void* y, const float* taps,
                                     const int* toff, void* out, int H,
                                     int W, int C, int hp, int hn, int dxl,
                                     int dxr, void* stream) {
  if (H < 1 || W < 1 || C < 1 || hp < 0 || hn < 0 || dxl < 0 || dxr < 0)
    return (int)cudaErrorInvalidValue;
  return launch<rf::bf16, rf::bf16>(y, taps, toff, out, H, W, C, hp, hn,
                                    dxl, dxr, (cudaStream_t)stream);
}

extern "C" const char* stencil2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
