// fir_band: a zero-padded FIR bank along the last axis of float32 lines —
// one pass of the separable box and difference-of-Gaussians filters.
//
// Replaces recfilter_tpu/kernels/fir_band.py::fir_band_pass (Pallas kernel
// _fir_kernel). For lines x (q, L) — or (Cin, q, L) when the channels are
// summed — and taps (Cout * Cin, Kpad), zero past each channel's K taps,
// with P the left half-width:
//
//   y[co, l, o] = sum_ci sum_t taps[co*Cin + ci][t] * x[ci, l, o + t - P]
//
// where x reads zero outside [0, L) (zero-padded, full-convolution
// semantics: no clamped neighbour at either end). Three structures ride the
// one kernel: a plain pass (Cin = Cout = 1), a bank (1 -> Cout channels,
// DoG's dual radius) and a signed contraction (Cin -> 1, the signs folded
// into the taps: DoG's difference). ``rot`` emits y transposed, (L, q) per
// channel, so the next pass finds the other image axis last.
//
// Design. The TPU kernel forms the banded Toeplitz operator as tile GEMMs
// on its matrix unit (about 2 * (128 + 16 + 16) FLOP per output). Here the
// taps are a short list, so the kernel sums them directly: 2 * Kpad FLOP
// per output and channel pair (62 for the box^3 of radius 5). A block takes
// 32 lines x 128 output positions. It stages each input channel's window —
// positions [p0 - P, p0 + 128 + Kpad - P), zeros outside the line — in
// shared memory transposed: a warp reads four lines' windows along the line
// (coalesced, the four loads in flight together) into columns of a table
// with row stride 33, one line per bank, so both those writes and the
// compute's reads (one line per lane) are free of bank conflicts. Each
// thread owns one line and two runs of R = 8 consecutive outputs and slides a
// register window along its line: per tap, one broadcast tap read and one
// window value feed 2 R FMAs. The outputs go back through shared memory and
// leave as whole rows: along the line for the flat emit, along the lines
// for the rotated one, so both stores are coalesced.
//
// What bounds it: one read of x and one write of y, 8 B per output and
// channel, against 2 * Kpad FLOP — bound by device-memory bandwidth on an
// H100 for every support the apps use. fp32 FMA sums, as the plain twin's
// fp32 einsum.

#include <cuda_runtime.h>

namespace {

constexpr int LINES = 32;     // lines per block, one per lane
constexpr int SPAN = 128;     // output positions per block
constexpr int R = 8;          // consecutive outputs per register run
constexpr int THREADS = 256;  // 8 warps x 2 runs of R positions
constexpr int WARPS = THREADS / 32;
constexpr int XS = LINES + 1; // shared row stride (one line per bank)
constexpr int MAX_KPAD = 264; // K <= 257 taps: P, Q <= 128 (the one-tile band)
constexpr int MAX_TAPS = 4096;
constexpr int MAX_SMEM =
    ((SPAN + MAX_KPAD) + SPAN) * XS * (int)sizeof(float) +
    MAX_TAPS * (int)sizeof(float);

__global__ void __launch_bounds__(THREADS)
fir_band_kernel(const float* __restrict__ x,     // (Cin, q, L)
                const float* __restrict__ taps,  // (Cout * Cin, Kpad)
                float* __restrict__ y,           // (Cout, q, L) or (Cout, L, q)
                int q, int L, int Cin, int Cout, int Kpad, int P, int rot) {
  extern __shared__ float smem[];
  const int rows = SPAN + Kpad;      // staged window positions
  float* xs = smem;                  // rows x XS: xs[s][l] = x[l, p0 - P + s]
  float* os = xs + rows * XS;        // SPAN x XS: os[r][l] = y[l, p0 + r]
  float* ts = os + SPAN * XS;        // the taps

  const int l0 = blockIdx.x * LINES;
  const int p0 = blockIdx.y * SPAN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long qL = (long)q * L;

  for (int i = tid; i < Cout * Cin * Kpad; i += THREADS) ts[i] = taps[i];

  for (int co = 0; co < Cout; ++co) {
    float acc[2][R];
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[g][j] = 0.f;

    for (int ci = 0; ci < Cin; ++ci) {
      if (Cin > 1 || co == 0) {  // a bank stages its one input once
        __syncthreads();
        const float* xc = x + ci * qL;
        // warp w reads lines w, w + 8, w + 16, w + 24 along the window,
        // their four loads in flight together
        for (int s0 = 0; s0 < rows; s0 += 32) {
          const int s = s0 + lane, g = p0 - P + s;
          float v[LINES / WARPS];
#pragma unroll
          for (int k = 0; k < LINES / WARPS; ++k) {
            const int line = l0 + warp + k * WARPS;
            v[k] = (s < rows && line < q && g >= 0 && g < L)
                       ? xc[(long)line * L + g] : 0.f;
          }
          if (s < rows) {
#pragma unroll
            for (int k = 0; k < LINES / WARPS; ++k)
              xs[s * XS + warp + k * WARPS] = v[k];
          }
        }
        __syncthreads();
      }
      const float* tp = ts + (co * Cin + ci) * Kpad;
      // run g of this warp covers outputs r0(g) .. r0(g) + R - 1
      const float* xw0 = xs + (warp * 2 * R) * XS + lane;
      const float* xw1 = xw0 + R * XS;
      float w[2][R], w2[2][R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        w[0][j] = xw0[j * XS];
        w[1][j] = xw1[j * XS];
      }
      for (int tb = 0; tb < Kpad; tb += R) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          w2[0][j] = xw0[(tb + R + j) * XS];
          w2[1][j] = xw1[(tb + R + j) * XS];
        }
#pragma unroll
        for (int tt = 0; tt < R; ++tt) {
          const float tap = tp[tb + tt];
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const int k = j + tt;  // window offset: output r0 + j, tap tb + tt
            acc[0][j] = fmaf(tap, k < R ? w[0][k] : w2[0][k - R], acc[0][j]);
            acc[1][j] = fmaf(tap, k < R ? w[1][k] : w2[1][k - R], acc[1][j]);
          }
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          w[0][j] = w2[0][j];
          w[1][j] = w2[1][j];
        }
      }
    }

#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int j = 0; j < R; ++j)
        os[(warp * 2 * R + g * R + j) * XS + lane] = acc[g][j];
    __syncthreads();
    float* yc = y + co * qL;
    if (rot) {  // (L, q): a row per position, the block's 32 lines contiguous
      for (int i = tid; i < SPAN * LINES; i += THREADS) {
        const int r = i / LINES, l = i % LINES;
        if (p0 + r < L && l0 + l < q)
          yc[(long)(p0 + r) * q + l0 + l] = os[r * XS + l];
      }
    } else {    // (q, L): a row per line, the block's 128 positions contiguous
      for (int i = tid; i < SPAN * LINES; i += THREADS) {
        const int l = i / SPAN, r = i % SPAN;
        if (p0 + r < L && l0 + l < q)
          yc[(long)(l0 + l) * L + p0 + r] = os[r * XS + l];
      }
    }
    __syncthreads();  // os is rewritten by the next channel
  }
}

}  // namespace

extern "C" int fir_band_launch(const float* x, const float* taps, float* y,
                               int q, int L, int Cin, int Cout, int Kpad,
                               int P, int rot, void* stream) {
  if (q < 1 || L < 1 || Cin < 1 || Cout < 1 || Kpad < R || Kpad % R ||
      Kpad > MAX_KPAD || Cin * Cout * Kpad > MAX_TAPS || P < 0 || P >= Kpad ||
      (L + SPAN - 1) / SPAN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fir_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int smem = ((SPAN + Kpad) + SPAN) * XS * (int)sizeof(float) +
                   Cin * Cout * Kpad * (int)sizeof(float);
  const dim3 grid((q + LINES - 1) / LINES, (L + SPAN - 1) / SPAN);
  fir_band_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, taps, y, q, L, Cin, Cout, Kpad, P, rot);
  return (int)cudaGetLastError();
}

extern "C" const char* fir_band_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
