// tails: the local tails of every tile of a 1-D last-axis pass, read from
// the signal once, in the carry solve's slot-padded transposed layout.
//
// Replaces recfilter_tpu/kernels/completion.py::tails_pass (Pallas kernel
// _tails_kernel). For x (q lines, n tiles, 128) and the per-tile tail rows
// G (nv variants, sl rows, 128) — S real rows, sl = 8*ceil(S/8) — with v(t)
// the tile's variant (interior, first or last):
//
//   out[t, s, l] = sum_tau G_v(t)[s, tau] * x[l, t, tau]     s < S
//   out[t, s, l] = 0                                          S <= s < sl
//
// The pad rows are written as explicit zeros: the solve multiplies them by
// zero columns, and an uninitialised NaN there would poison the result.
//
// With He extra rows (tails_pass's extra_rows: a stencil consumer's halo
// base rows, the first and last rows of each tile's Btot) the constant G
// holds them below the slot rows, (nv, sl + He, 128), and the output grows
// to (n, sl + He, q): rows sl.. carry E_v(t) * x[l, t, :], summed in fp64
// like the tails.
//
// A third entry, tails_traced_launch, runs tails_kernel on a runtime
// (S, 128) matrix (the learnable executor's; see the entry).
//
// What bounds it: it reads 4 B per sample and writes 4*sl/128 B, with S
// MACs per sample, so on an H100 it is bound by device-memory bandwidth
// (40 MB at 10M samples). The design: one block per (tile, 64 lines);
// each line's 512-byte row is read once, coalesced, into shared memory
// (row stride 132 floats, so the float4 row reads of consecutive lines are
// free of bank conflicts); the tile's G variant sits in shared memory and
// is read as warp-wide broadcasts. Four slot groups of 64 threads share the
// lines; each thread keeps up to 14 slot sums in registers. Writes are
// coalesced along the line axis. With extra rows a second kernel,
// tails_extra_kernel (entry tails_extra_launch), stages the rows 56 at a
// time in the accumulator's type (fp64: no conversion per product) and
// keeps the slot layout.
//
// The sums accumulate in fp64 from fp32 loads, as moments2d.cu's do: these
// tails seed the carries, whose solve amplifies their rounding (PERF.md).
// At S MACs per sample the H100's fp64 rate keeps the kernel near its
// bandwidth bound. The fp32-accumulating instantiation exists to measure
// that choice. The TPU kernel's bf16 chunk splitting works around the TPU
// matrix unit and has no counterpart here.

#include "common.cuh"

namespace {

constexpr int T = 128;          // tile width
constexpr int LINES = 64;       // lines per block
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / LINES;  // slot groups: slots g, g+4, ...
constexpr int XS = T + 4;       // padded shared row stride of the x rows
constexpr int MAX_SL = 56;      // carry rows the layout takes
constexpr int MAX_HE = 256;     // extra rows: a reach of 128 each way
constexpr int PER = MAX_SL / GROUPS;     // row sums per thread and pass
constexpr int ROWS = GROUPS * PER;       // rows per pass

__device__ __forceinline__ float madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename Acc>
__global__ void __launch_bounds__(THREADS)
tails_kernel(const float* __restrict__ x,  // (q, n, T)
             const float* __restrict__ G,  // (nv, sl, T)
             float* __restrict__ out,      // (n, sl, q)
             int q, int n, int S, int sl, int nv) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // LINES x XS
  float* gs = xs + LINES * XS;                  // S x T

  const int t = blockIdx.x;
  const int l0 = blockIdx.y * LINES;
  const int tid = threadIdx.x;
  const int v = rf::variant(nv, t, n);

  for (int i = tid; i < LINES * (T / 4); i += THREADS) {
    const int r = i / (T / 4), c4 = i % (T / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (l0 + r < q)
      val = reinterpret_cast<const float4*>(
          x + ((long)(l0 + r) * n + t) * T)[c4];
    reinterpret_cast<float4*>(xs + r * XS)[c4] = val;
  }
  const float4* gv = reinterpret_cast<const float4*>(G + (long)v * sl * T);
  for (int i = tid; i < S * (T / 4); i += THREADS)
    reinterpret_cast<float4*>(gs)[i] = gv[i];
  __syncthreads();

  const int r = tid % LINES;  // this thread's line
  const int g = tid / LINES;  // its slot group (uniform across a warp)
  Acc acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = Acc(0);
  const float* xr = xs + r * XS;
  for (int tau = 0; tau < T; tau += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(xr + tau);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int s = g + GROUPS * j;
      if (s < S) {
        const float4 gw = *reinterpret_cast<const float4*>(gs + s * T + tau);
        acc[j] = madd(Acc(gw.x), Acc(xv.x), acc[j]);
        acc[j] = madd(Acc(gw.y), Acc(xv.y), acc[j]);
        acc[j] = madd(Acc(gw.z), Acc(xv.z), acc[j]);
        acc[j] = madd(Acc(gw.w), Acc(xv.w), acc[j]);
      }
    }
  }

  if (l0 + r < q) {
    float* o = out + (long)t * sl * q + l0 + r;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int s = g + GROUPS * j;
      if (s < sl) o[(long)s * q] = s < S ? float(acc[j]) : 0.f;
    }
  }
}

template <typename Acc>
__global__ void __launch_bounds__(THREADS)
tails_extra_kernel(const float* __restrict__ x,  // (q, n, T)
             const float* __restrict__ G,  // (nv, R, T), R = sl + He
             float* __restrict__ out,      // (n, R, q)
             int q, int n, int S, int sl, int R, int nv) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);        // LINES x XS
  Acc* gs = reinterpret_cast<Acc*>(xs + LINES * XS);  // ROWS x T, one pass

  const int t = blockIdx.x;
  const int l0 = blockIdx.y * LINES;
  const int tid = threadIdx.x;
  const int v = rf::variant(nv, t, n);

  for (int i = tid; i < LINES * (T / 4); i += THREADS) {
    const int r = i / (T / 4), c4 = i % (T / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (l0 + r < q)
      val = reinterpret_cast<const float4*>(
          x + ((long)(l0 + r) * n + t) * T)[c4];
    reinterpret_cast<float4*>(xs + r * XS)[c4] = val;
  }
  const float* gv = G + (long)v * R * T;

  const int r = tid % LINES;  // this thread's line
  const int g = tid / LINES;  // its row group (uniform across a warp)
  const float* xr = xs + r * XS;
  float* o = out + (long)t * R * q + l0 + r;
  // rows g, g + 4, ... in passes of ROWS rows, each pass's G rows staged in
  // the accumulator's type (no conversion per product: the extra rows
  // multiply the fp64 work); the slot pad rows [S, sl) are zeros
  for (int base = 0; base < R; base += ROWS) {
    const int rows = min(ROWS, R - base);
    if (base) __syncthreads();  // the previous pass has read its rows
    for (int i = tid; i < rows * T; i += THREADS)
      gs[i] = Acc(gv[(long)base * T + i]);
    __syncthreads();
    Acc acc[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) acc[j] = Acc(0);
    for (int tau = 0; tau < T; tau += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + tau);
      const Acc x0 = Acc(xv.x), x1 = Acc(xv.y), x2 = Acc(xv.z),
                x3 = Acc(xv.w);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int s = base + g + GROUPS * j;
        if (s < R && (s < S || s >= sl)) {
          const Acc* gw = gs + (g + GROUPS * j) * T + tau;
          acc[j] = madd(gw[0], x0, acc[j]);
          acc[j] = madd(gw[1], x1, acc[j]);
          acc[j] = madd(gw[2], x2, acc[j]);
          acc[j] = madd(gw[3], x3, acc[j]);
        }
      }
    }
    if (l0 + r < q) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int s = base + g + GROUPS * j;
        if (s < R) o[(long)s * q] = (s < S || s >= sl) ? float(acc[j]) : 0.f;
      }
    }
  }
}

template <typename Acc>
int launch(const float* x, const float* G, float* out, int q, int n, int S,
           int sl, int He, int nv, cudaStream_t stream) {
  const dim3 grid(n, (q + LINES - 1) / LINES);
  if (He == 0) {
    const int smem = (LINES * XS + S * T) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        tails_kernel<Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (LINES * XS + MAX_SL * T) * sizeof(float));
    if (err != cudaSuccess) return (int)err;
    tails_kernel<Acc><<<grid, THREADS, smem, stream>>>(x, G, out, q, n, S,
                                                       sl, nv);
    return (int)cudaGetLastError();
  }
  const int R = sl + He, rows = R < ROWS ? R : ROWS;
  const int smem = LINES * XS * sizeof(float) + rows * T * sizeof(Acc);
  cudaError_t err = cudaFuncSetAttribute(
      tails_extra_kernel<Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      LINES * XS * sizeof(float) + ROWS * T * sizeof(Acc));
  if (err != cudaSuccess) return (int)err;
  tails_extra_kernel<Acc><<<grid, THREADS, smem, stream>>>(x, G, out, q, n,
                                                           S, sl, R, nv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tails_launch(const float* x, const float* G, float* out,
                            int q, int n, int S, int sl, int He, int nv,
                            int fp64, void* stream) {
  if (S < 1 || sl > MAX_SL || S > sl || sl % 8 || He != 0)
    return (int)cudaErrorInvalidValue;
  return fp64 ? launch<double>(x, G, out, q, n, S, sl, 0, nv,
                               (cudaStream_t)stream)
              : launch<float>(x, G, out, q, n, S, sl, 0, nv,
                              (cudaStream_t)stream);
}

// tails_traced: the learnable executor's tails, G a runtime (S, 128)
// matrix built from trainable coefficients (S <= 8), unpadded. Replaces
// recfilter_tpu/kernels/completion.py::tails_pass_traced (the same Pallas
// kernel on in-graph chunk splits). tails_kernel reads only the S real rows
// of a one-variant stack and writes zeros on the slot rows up to 8, so the
// (S, 128) matrix is taken as it is and the caller pads nothing. The
// output is the (n, 8, q) layout of tails; fp64 sums, as tails.
extern "C" int tails_traced_launch(const float* x, const float* G, float* out,
                                   int q, int n, int S, void* stream) {
  if (S < 1 || S > 8) return (int)cudaErrorInvalidValue;
  return launch<double>(x, G, out, q, n, S, 8, 0, 1, (cudaStream_t)stream);
}

// the same tails with He extra rows below the sl slot rows: a kernel of
// its own (tails_extra_kernel), so its launches count apart
extern "C" int tails_extra_launch(const float* x, const float* G, float* out,
                                  int q, int n, int S, int sl, int He, int nv,
                                  int fp64, void* stream) {
  if (S < 1 || sl > MAX_SL || S > sl || sl % 8 || He < 1 || He > MAX_HE)
    return (int)cudaErrorInvalidValue;
  return fp64 ? launch<double>(x, G, out, q, n, S, sl, He, nv,
                               (cudaStream_t)stream)
              : launch<float>(x, G, out, q, n, S, sl, He, nv,
                              (cudaStream_t)stream);
}

extern "C" const char* tails_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
