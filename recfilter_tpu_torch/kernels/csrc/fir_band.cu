// fir_band: a zero-padded FIR bank along the last axis of float32 lines —
// one pass of the separable box and difference-of-Gaussians filters — at
// every precision grade of the JAX package's band kernel.
//
// Replaces recfilter_tpu/kernels/fir_band.py::fir_band_pass (Pallas kernel
// _fir_kernel) at nprod 6 (px6, f32x6), 4 (px4, f32x4), 3 (px3, f32x3) and
// 1 (default). For lines x (q, L) — or (Cin, q, L) when the channels are
// summed — and taps (Cout * Cin channels), zero past each channel's K taps,
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
// The grades. At NPROD 6 the taps are float32 and each channel's sum is
// one fp32 FMA chain (taps in order, the contraction's channels continuing
// the chain). At NPROD 1, 3 and 4 the sum is the JAX kernel's split-bf16
// arithmetic: channel c takes its chunk pairs (i, j) — split.cuh's pairs
// of NPROD, or, for a channel whose taps the host scaled to exact bf16
// integers (tap_scale), the pairs (0, j) — and sums
//
//   sub_c = sum_(i,j) sum_t tapchunk_i[t] * xchunk_j[. + t - P]
//
// pair by pair (smallest level first), taps in order, in fp32 FMAs: a bf16
// x bf16 product is exact in fp32, so each FMA adds the exact chunk product
// as the TPU's matrix unit does. Then y += sub_c * inv_s[c] (1 unless
// scaled). x's chunks are split on chip as the window is staged
// (split.cuh's split, the residual exact); the taps' chunks come split from
// the host (kernels/fir_band.py), one row per (channel, pair). Pairs that
// share a tap chunk are not folded into one FMA: the two x chunks' sum
// spans 17 significant bits, times a tap chunk's 8 is 25, past fp32's 24,
// so the folded product would not be the chunk products' exact sum.
//
// Design. The TPU kernel forms the banded Toeplitz operator as tile GEMMs
// on its matrix unit (about 2 * (128 + 16 + 16) FLOP per output). Here the
// taps are a short list, so the kernel sums them directly: 2 * Kpad FLOP
// per output, channel pair and chunk pair (62 for the box^3 of radius 5).
// A block takes 32 lines x 128 output positions. It stages each input
// channel's window — positions [p0 - P, p0 + 128 + Kpad - P), zeros
// outside the line — in shared memory transposed, one table per x chunk: a
// warp reads four lines' windows along the line (coalesced, the four loads
// in flight together) into columns of a table with row stride 33, one line
// per bank, so both those writes and the compute's reads (one line per
// lane) are free of bank conflicts. Each thread owns one line and two runs
// of R = 8 consecutive outputs and slides a register window along its
// line: per tap, one broadcast tap read and one window value feed 2 R
// FMAs. The outputs go back through shared memory and leave as whole rows:
// along the line for the flat emit, along the lines for the rotated one,
// so both stores are coalesced.
//
// What bounds it: one read of x and one write of y, 8 B per output and
// channel, against 2 * Kpad FLOP per chunk pair — by device-memory
// bandwidth on an H100 at px6 and where few pairs run; at px3 and px4
// without tap_scale (3 and 4 pairs) the fp32 FMAs may bound it instead
// (chip_smoke.py prints both bounds).
//
// fir_band_bf16: the band on a bf16 image at NPROD 1 — replaces the same
// Pallas kernel on a bf16 x (its one x chunk is x itself; the JAX package
// runs every bf16 band at one product, and writes y in x's dtype). x is
// read as bf16, eight values per 16-byte load where the lines are 16-byte
// aligned (L a multiple of 8: a 16-byte word of the window is then wholly
// inside the line or wholly outside it), one value per load otherwise; a
// warp reads 128 contiguous bytes of each of four lines, and the values go
// widened, exactly, to the float table. The taps are the one bf16 chunk
// (NPROD 1's), the sums the float32 entry's fp32 FMAs, and each output is
// rounded once to bf16 from its fp32 sum (common.cuh's store1). 4 B per
// output and channel: half the float32 entry's traffic, the same FLOP.

#include "common.cuh"
#include "split.cuh"

namespace {

constexpr int LINES = 32;     // lines per block, one per lane
constexpr int SPAN = 128;     // output positions per block
constexpr int R = 8;          // consecutive outputs per register run
constexpr int THREADS = 256;  // 8 warps x 2 runs of R positions
constexpr int WARPS = THREADS / 32;
constexpr int XS = LINES + 1; // shared row stride (one line per bank)
constexpr int MAX_KPAD = 264; // K <= 257 taps: P, Q <= 128 (the one-tile band)
constexpr int MAX_TAPS = 4096;
constexpr int NPAIR = 4;      // the most chunk pairs a channel takes (px4)
constexpr int MAX_CH = 64;    // channels (Cin * Cout) whose pairs are staged

// x chunks staged per window (the float32 x itself at NPROD 6)
__host__ __device__ constexpr int x_chunks(int nprod) {
  return nprod == 6 ? 1 : rfs::nchunks(nprod);
}
__host__ __device__ constexpr int smem_bytes(int nprod, int kpad,
                                             int taps) {
  return (x_chunks(nprod) * (SPAN + kpad) + SPAN) * XS * (int)sizeof(float) +
         taps * (int)sizeof(float);
}

// acc[g][j] += sum_t tp[t] * window(run g, output j, tap t): the register
// window slides along the thread's line (xw0, xw1: the two runs' first
// rows in the staged table), the taps outermost.
__device__ __forceinline__ void tap_run(float (&acc)[2][R], const float* tp,
                                        const float* xw0, const float* xw1,
                                        int Kpad) {
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

// Stage the window [g0, g0 + rows) of lines l0.. of the bf16 x (one
// channel, L positions a line) into the float table xs (row stride XS),
// zeros outside the lines (fir_band_bf16's loads, the file comment).
__device__ __forceinline__ void stage_bf16(float* xs, const rf::bf16* xc,
                                           int l0, int g0, int rows, int q,
                                           int L, int tid) {
  if (L % 8 == 0) {
    const int a0 = g0 >= 0 ? g0 / 8 * 8 : -((7 - g0) / 8 * 8);  // floor 8
    const int off = g0 - a0, words = (off + rows + 7) / 8;
    // i runs over the words padded to eight a line: lane i % 8 of each
    // group of eight reads word 8 (i / (8 LINES)) + i % 8 of one line
    for (int i = tid; i < LINES * ((words + 7) / 8 * 8); i += THREADS) {
      const int line = (i / 8) % LINES;
      const int word = i / (8 * LINES) * 8 + i % 8;
      if (word >= words) continue;
      const int g = a0 + 8 * word, l = l0 + line;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (l < q && g >= 0 && g < L)
        rf::widen8(*reinterpret_cast<const uint4*>(xc + (long)l * L + g), lo,
                   hi);
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = 8 * word + j - off;
        if (s >= 0 && s < rows) xs[s * XS + line] = v[j];
      }
    }
    return;
  }
  for (int i = tid; i < LINES * rows; i += THREADS) {
    const int line = i / rows, s = i % rows, g = g0 + s, l = l0 + line;
    xs[s * XS + line] = (l < q && g >= 0 && g < L)
                            ? __bfloat162float(xc[(long)l * L + g]) : 0.f;
  }
}

// TX: x's and y's type — float, or bf16 at NPROD 1 (fir_band_bf16)
template <int NPROD, typename TX>
__global__ void __launch_bounds__(THREADS)
fir_band_kernel(const TX* __restrict__ x,        // (Cin, q, L)
                const float* __restrict__ taps,  // (Cout * Cin, TR, Kpad)
                const int* __restrict__ meta,    // (Cout * Cin, 1 + NPAIR)
                const float* __restrict__ scale, // (Cout * Cin)
                TX* __restrict__ y,              // (Cout, q, L) or (Cout, L, q)
                int q, int L, int Cin, int Cout, int Kpad, int P, int rot,
                int TR) {            // tap rows a channel: its most pairs
  constexpr bool BF16 = std::is_same<TX, rf::bf16>::value;
  static_assert(!BF16 || NPROD == 1, "a bf16 x runs one product");
  constexpr int NC = x_chunks(NPROD);
  extern __shared__ float smem[];
  __shared__ int pm[NPROD == 6 ? 1 : MAX_CH * (1 + NPAIR)];
  __shared__ float ps[NPROD == 6 ? 1 : MAX_CH];
  const int rows = SPAN + Kpad;      // staged window positions
  const long cstride = (long)rows * XS;
  float* xs = smem;                  // NC x rows x XS: xs[c][s][l] = chunk c
                                     //   of x[l, p0 - P + s]
  float* os = xs + NC * cstride;     // SPAN x XS: os[r][l] = y[l, p0 + r]
  float* ts = os + SPAN * XS;        // the taps

  const int l0 = blockIdx.x * LINES;
  const int p0 = blockIdx.y * SPAN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long qL = (long)q * L;

  for (int i = tid; i < Cout * Cin * TR * Kpad; i += THREADS) ts[i] = taps[i];
  if constexpr (NPROD != 6) {
    for (int i = tid; i < Cout * Cin * (1 + NPAIR); i += THREADS)
      pm[i] = meta[i];
    for (int i = tid; i < Cout * Cin; i += THREADS) ps[i] = scale[i];
  }

  for (int co = 0; co < Cout; ++co) {
    float acc[2][R];
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[g][j] = 0.f;

    for (int ci = 0; ci < Cin; ++ci) {
      if (Cin > 1 || co == 0) {  // a bank stages its one input once
        __syncthreads();
        if constexpr (BF16) {
          stage_bf16(xs, x + ci * qL, l0, p0 - P, rows, q, L, tid);
        } else {
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
              for (int k = 0; k < LINES / WARPS; ++k) {
                float* dst = xs + s * XS + warp + k * WARPS;
                if constexpr (NPROD == 6) {
                  *dst = v[k];
                } else {  // the JAX kernel's _split_vmem, on chip
                  rfs::bf16 c[NC];
                  rfs::split<NC>(v[k], c);
#pragma unroll
                  for (int h = 0; h < NC; ++h)
                    dst[h * cstride] = __bfloat162float(c[h]);
                }
              }
            }
          }
        }
        __syncthreads();
      }
      const int ch = co * Cin + ci;
      // run g of this warp covers outputs r0(g) .. r0(g) + R - 1
      const float* xw0 = xs + (warp * 2 * R) * XS + lane;
      const float* xw1 = xw0 + R * XS;
      if constexpr (NPROD == 6) {
        tap_run(acc, ts + ch * Kpad, xw0, xw1, Kpad);
      } else {
        float sub[2][R];
#pragma unroll
        for (int g = 0; g < 2; ++g)
#pragma unroll
          for (int j = 0; j < R; ++j) sub[g][j] = 0.f;
        const int* m = pm + ch * (1 + NPAIR);
        for (int p = 0; p < m[0]; ++p) {
          const long off = m[1 + p] * cstride;
          tap_run(sub, ts + (ch * TR + p) * Kpad, xw0 + off, xw1 + off,
                  Kpad);
        }
        const float s = ps[ch];
#pragma unroll
        for (int g = 0; g < 2; ++g)
#pragma unroll
          for (int j = 0; j < R; ++j)
            acc[g][j] = __fadd_rn(acc[g][j], __fmul_rn(sub[g][j], s));
      }
    }

#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int j = 0; j < R; ++j)
        os[(warp * 2 * R + g * R + j) * XS + lane] = acc[g][j];
    __syncthreads();
    TX* yc = y + co * qL;
    if (rot) {  // (L, q): a row per position, the block's 32 lines contiguous
      for (int i = tid; i < SPAN * LINES; i += THREADS) {
        const int r = i / LINES, l = i % LINES;
        if (p0 + r < L && l0 + l < q)
          rf::store1(yc + (long)(p0 + r) * q + l0 + l, os[r * XS + l]);
      }
    } else {    // (q, L): a row per line, the block's 128 positions contiguous
      for (int i = tid; i < SPAN * LINES; i += THREADS) {
        const int l = i / SPAN, r = i % SPAN;
        if (p0 + r < L && l0 + l < q)
          rf::store1(yc + (long)(l0 + l) * L + p0 + r, os[r * XS + l]);
      }
    }
    __syncthreads();  // os is rewritten by the next channel
  }
}

template <int NPROD, typename TX = float>
int launch(const TX* x, const float* taps, const int* meta,
           const float* scale, TX* y, int q, int L, int Cin, int Cout,
           int Kpad, int P, int rot, int npair, cudaStream_t stream) {
  const int ntaps = Cin * Cout * npair * Kpad;
  if (ntaps > MAX_TAPS || (NPROD == 6 && npair != 1) ||
      (NPROD != 6 && (meta == nullptr || scale == nullptr ||
                      Cin * Cout > MAX_CH)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fir_band_kernel<NPROD, TX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(NPROD, MAX_KPAD, MAX_TAPS));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((q + LINES - 1) / LINES, (L + SPAN - 1) / SPAN);
  fir_band_kernel<NPROD, TX>
      <<<grid, THREADS, smem_bytes(NPROD, Kpad, ntaps), stream>>>(
          x, taps, meta, scale, y, q, L, Cin, Cout, Kpad, P, rot, npair);
  return (int)cudaGetLastError();
}

// The arguments' checks of both entries.
bool args_ok(int q, int L, int Cin, int Cout, int Kpad, int P, int npair) {
  return !(q < 1 || L < 1 || Cin < 1 || Cout < 1 || Kpad < R || Kpad % R ||
           npair < 1 || npair > NPAIR || Kpad > MAX_KPAD || P < 0 ||
           P >= Kpad || (L + SPAN - 1) / SPAN > 65535);
}

}  // namespace

// nprod 6: taps (Cout * Cin, Kpad) float32 (npair 1), meta and scale
// unread; nprod 1, 3, 4: taps (Cout * Cin, npair, Kpad) tap chunks per pair
// slot (npair the most pairs a channel takes), meta (Cout * Cin, 5) =
// [pair count, x chunk of each pair], scale (Cout * Cin) the inverse tap
// scales (kernels/fir_band.py's FirBand). The staged taps (Cout * Cin *
// npair * Kpad <= MAX_TAPS) and channels (<= MAX_CH below px6) bound the
// banks it takes: FirBand.fits.
extern "C" int fir_band_launch(const float* x, const float* taps,
                               const int* meta, const float* scale, float* y,
                               int q, int L, int Cin, int Cout, int Kpad,
                               int P, int rot, int nprod, int npair,
                               void* stream) {
  if (!args_ok(q, L, Cin, Cout, Kpad, P, npair))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nprod) {
    case 1:
      return launch<1>(x, taps, meta, scale, y, q, L, Cin, Cout, Kpad, P,
                       rot, npair, s);
    case 3:
      return launch<3>(x, taps, meta, scale, y, q, L, Cin, Cout, Kpad, P,
                       rot, npair, s);
    case 4:
      return launch<4>(x, taps, meta, scale, y, q, L, Cin, Cout, Kpad, P,
                       rot, npair, s);
    case 6:
      return launch<6>(x, taps, meta, scale, y, q, L, Cin, Cout, Kpad, P,
                       rot, npair, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// nprod 1 on a bf16 x and y: the float32 entry's operands at nprod 1
extern "C" int fir_band_bf16_launch(const rf::bf16* x, const float* taps,
                                    const int* meta, const float* scale,
                                    rf::bf16* y, int q, int L, int Cin,
                                    int Cout, int Kpad, int P, int rot,
                                    int npair, void* stream) {
  if (!args_ok(q, L, Cin, Cout, Kpad, P, npair))
    return (int)cudaErrorInvalidValue;
  return launch<1, rf::bf16>(x, taps, meta, scale, y, q, L, Cin, Cout, Kpad,
                             P, rot, npair, (cudaStream_t)stream);
}

extern "C" const char* fir_band_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
