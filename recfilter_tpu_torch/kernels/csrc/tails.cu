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
// The sums accumulate in fp64 from the fp32 values, one fma per tau in
// ascending order from 0.0, stored as float(acc), as moments2d.cu's do:
// these tails seed the carries, whose solve amplifies their rounding
// (PERF.md). An fp32 x fp32 product is exact in fp64, so each step rounds
// once, and kernels/completion.py's tails_ordered_plain (a float64 loop
// over tau) gives the same bits. The fp32-accumulating instantiation
// (fp64 = 0) is a probe of what the fp64 sums cost, on no path.
//
// With He extra rows (tails_pass's extra_rows: a stencil consumer's halo
// base rows, the first and last rows of each tile's Btot) the constant G
// holds them below the slot rows, (nv, sl + He, 128), and the output grows
// to (n, sl + He, q): rows sl.. carry E_v(t) * x[l, t, :], summed in fp64
// like the tails — a kernel of its own, tails_extra_kernel (entry
// tails_extra_launch: one block per (tile, 64 lines), the rows staged 56
// at a time in the accumulator's type).
//
// A third entry, tails_traced_launch, runs tails_kernel on a runtime
// (S, 128) matrix (the learnable executor's; see the entry).
//
// What bounds it: it reads 4 B per sample and writes 4*sl/128 B, so on the
// H100 device-memory bandwidth: 0.0127 ms at A (10M samples), 0.0213 ms at
// L1's x pass (4096 lines, 32 tiles). The fp64 work is S fma per sample
// (0.1 G at L1, 6 us at the CUDA cores' 16.7 T fma/s) plus one
// float-to-double conversion per sample: so each sample is converted
// once, and the loads overlap the sums:
//   * persistent blocks, one per SM, of 128 threads walking the (tile,
//     128-line block) items (pipeline.cuh's walk), one thread per line
//     holding all S sums (the slot loop unrolled to the real sl, a
//     template), so each sample is converted once;
//   * G_v's S rows staged once per variant in the accumulator's type: no
//     conversion per product;
//   * a ring of nst (3 where it fits, else 2) stages of the 128 line rows
//     (512 B each, row stride 132 floats: a warp's float4 row reads
//     take the least wavefronts), filled by cp.async nst - 1 items ahead;
//   * stores coalesced along the line axis, zeros on the pad slots.
// The launcher takes three stages where they fit beside G's rows in the
// 227 KB a block may have, else two (always room: S <= 56).
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 0.0410 ms of
// device time at L1 (51.9 % of the bound; one torch.matmul emitting the
// same (n, S, q) layout 0.0622, the flat x (q n, 128) by G^T 0.0387) and
// 0.0286 at A (44.4 %). The fp32-accumulating probe: 0.0339 and 0.0236,
// so the fp64 sums cost ~20 %.
// Bulk copies (cp.async.bulk, a 512-byte row each, counted on an
// mbarrier) in place of the cp.async ring measured slower (0.056 ms at
// L1), and two threads a line splitting the slots no faster (0.040).
//
// bf16 storage (tails_bf16: tails_pass on a bf16 x, which the JAX
// package's bf16 mode gives it): the ring holds bf16 rows (256 B, row
// stride 136 elements: the same banks as the fp32 rows' 132 floats), each
// thread reads eight values a 16-byte word and widens them (exact), so the
// fp64 sums are the fp32 entry's on the same values, bit for bit; G stays
// fp32. 2 B per sample read: the bound halves. tails_extra_bf16 (the extra
// rows of a stencil consumer on a bf16 x) does the same in
// tails_extra_kernel: its 64-line stage holds bf16 rows (136 elements),
// read a 16-byte word (eight values) at a time through word16, the fp64
// sums in the fp32 entry's order.

#include "common.cuh"
#include "pipeline.cuh"

namespace {

constexpr int T = 128;          // tile width
// The ring's row stride in elements of x's type TX (one row a thread, read
// 16 bytes at a time): 16 bytes past the row, so that a quarter warp's
// reads fall 4 banks apart and each row stays 16-byte aligned for cp.async.
template <typename TX>
__host__ __device__ constexpr int padded_row() {
  return T + 16 / (int)sizeof(TX);
}
constexpr int MAX_SL = 56;      // carry rows the layout takes
constexpr long MAX_SMEM = 232448;  // shared memory a block may take
constexpr int MAX_HE = 256;     // extra rows: a reach of 128 each way
// tails_extra_kernel's blocks: 64 lines, four row groups of 64 threads
constexpr int LINES = 64;       // lines per block
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / LINES;  // row groups: rows g, g+4, ...
constexpr int PER = MAX_SL / GROUPS;     // row sums per thread and pass
constexpr int ROWS = GROUPS * PER;       // rows per pass

__device__ __forceinline__ float madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return fma(a, b, c);
}

__device__ __forceinline__ void load4(const double* p, double (&g)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  g[0] = a.x;
  g[1] = a.y;
  g[2] = b.x;
  g[3] = b.y;
}
__device__ __forceinline__ void load4(const float* p, float (&g)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  g[0] = a.x;
  g[1] = a.y;
  g[2] = a.z;
  g[3] = a.w;
}

constexpr int TL = rfp::GT;  // lines per item, and threads per block

// The values of one 16-byte word of a ring row, as floats: one load a
// thread, so that a quarter warp's reads of rows 4 banks apart are free of
// conflicts.
__device__ __forceinline__ void word16(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void word16(const rf::bf16* p, float (&v)[8]) {
  float4 lo, hi;
  rf::widen8(*reinterpret_cast<const uint4*>(p), lo, hi);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// SL: the slot rows (sl), S <= SL of them real; nst: the ring's stages; TX:
// x's type, float or bf16 (the ring's rows, padded_row<TX>() elements)
template <typename Acc, int SL, typename TX>
__global__ void __launch_bounds__(TL, 1)
tails_kernel(const TX* __restrict__ x,     // (q, n, T)
             const float* __restrict__ G,  // (nv, SL, T)
             float* __restrict__ out,      // (n, SL, q)
             int q, int n, int S, int nv, int nst) {
  constexpr int V = 16 / (int)sizeof(TX);  // elements a 16-byte word
  constexpr int RS = padded_row<TX>();
  extern __shared__ float4 smem4[];
  Acc* gs = reinterpret_cast<Acc*>(smem4);       // S x T
  TX* ring = reinterpret_cast<TX*>(gs + S * T);  // nst x TL x RS

  const int tid = threadIdx.x;
  const int nb = (q + TL - 1) / TL, items = n * nb;
  auto load = [&](int it, TX* st) {
    int t, b;
    rfp::item(it, n, nb, nv, t, b);
    const int l0 = b * TL;
    for (int i = tid; i < TL * (T / V); i += TL) {
      const int r = i / (T / V), c = V * (i % (T / V));
      const bool ok = l0 + r < q;
      rfp::cp16(st + r * RS + c,
                ok ? x + ((long)(l0 + r) * n + t) * T + c : x, ok);
    }
  };

  for (int p = 0; p + 1 < nst; ++p) {  // the ring's first items
    const int it = blockIdx.x + p * gridDim.x;
    if (it < items) load(it, ring + p * TL * RS);
    rfp::commit();
  }
  int cur_v = -1, idx = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++idx) {
    const int ahead = it + (nst - 1) * gridDim.x;
    if (ahead < items) load(ahead, ring + (idx + nst - 1) % nst * TL * RS);
    rfp::commit();
    int t, b;
    rfp::item(it, n, nb, nv, t, b);
    const int v = rf::variant(nv, t, n);
    if (v != cur_v) {  // every thread is past the last sums (loop end)
      const float* gv = G + (long)v * SL * T;
      for (int i = tid; i < S * T; i += TL) gs[i] = Acc(gv[i]);
      cur_v = v;
    }
    rfp::wait_pending(nst - 1);  // this item's rows landed
    __syncthreads();

    const TX* xr = ring + idx % nst * TL * RS + tid * RS;
    Acc acc[SL];
#pragma unroll
    for (int s = 0; s < SL; ++s) acc[s] = Acc(0);
    // eight samples an iteration at either type (two words of fp32, one
    // of bf16), each group of four summed into every slot in turn
#pragma unroll(8 / V)
    for (int tau = 0; tau < T; tau += V) {
      float xf[V];  // the V values of one 16-byte word, in order
      word16(xr + tau, xf);
#pragma unroll
      for (int u = 0; u < V; u += 4) {
        const Acc x0 = Acc(xf[u]), x1 = Acc(xf[u + 1]), x2 = Acc(xf[u + 2]),
                  x3 = Acc(xf[u + 3]);
#pragma unroll
        for (int s = 0; s < SL; ++s) {
          if (s < S) {
            Acc g[4];
            load4(gs + s * T + tau + u, g);
            acc[s] = madd(g[0], x0, acc[s]);
            acc[s] = madd(g[1], x1, acc[s]);
            acc[s] = madd(g[2], x2, acc[s]);
            acc[s] = madd(g[3], x3, acc[s]);
          }
        }
      }
    }
    const int l = b * TL + tid;
    if (l < q) {
      float* o = out + (long)t * SL * q + l;
#pragma unroll
      for (int s = 0; s < SL; ++s)
        o[(long)s * q] = s < S ? float(acc[s]) : 0.f;
    }
    __syncthreads();  // the stage and G are read: they may be refilled
  }
}

// TX: x's type, float or bf16 (the stage's rows, padded_row<TX>()
// elements)
template <typename Acc, typename TX>
__global__ void __launch_bounds__(THREADS)
tails_extra_kernel(const TX* __restrict__ x,     // (q, n, T)
             const float* __restrict__ G,  // (nv, R, T), R = sl + He
             float* __restrict__ out,      // (n, R, q)
             int q, int n, int S, int sl, int R, int nv) {
  constexpr int V = 16 / (int)sizeof(TX);  // elements a 16-byte word
  constexpr int RS = padded_row<TX>();
  extern __shared__ float4 smem4[];
  TX* xs = reinterpret_cast<TX*>(smem4);  // LINES x RS
  Acc* gs = reinterpret_cast<Acc*>(smem4 + LINES * RS * sizeof(TX) / 16);
                                          // ROWS x T, one pass

  const int t = blockIdx.x;
  const int l0 = blockIdx.y * LINES;
  const int tid = threadIdx.x;
  const int v = rf::variant(nv, t, n);

  for (int i = tid; i < LINES * (T / V); i += THREADS) {
    const int r = i / (T / V), c = i % (T / V);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (l0 + r < q)
      val = reinterpret_cast<const uint4*>(
          x + ((long)(l0 + r) * n + t) * T)[c];
    reinterpret_cast<uint4*>(xs + r * RS)[c] = val;
  }
  const float* gv = G + (long)v * R * T;

  const int r = tid % LINES;  // this thread's line
  const int g = tid / LINES;  // its row group (uniform across a warp)
  const TX* xr = xs + r * RS;
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
    for (int tau = 0; tau < T; tau += V) {
      float xf[V];  // the V values of one 16-byte word, in order
      word16(xr + tau, xf);
#pragma unroll
      for (int u = 0; u < V; u += 4) {
        const Acc x0 = Acc(xf[u]), x1 = Acc(xf[u + 1]), x2 = Acc(xf[u + 2]),
                  x3 = Acc(xf[u + 3]);
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int s = base + g + GROUPS * j;
          if (s < R && (s < S || s >= sl)) {
            const Acc* gw = gs + (g + GROUPS * j) * T + tau + u;
            acc[j] = madd(gw[0], x0, acc[j]);
            acc[j] = madd(gw[1], x1, acc[j]);
            acc[j] = madd(gw[2], x2, acc[j]);
            acc[j] = madd(gw[3], x3, acc[j]);
          }
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

// Shared memory of tails_kernel (bytes): G's S rows in the accumulator's
// type, nst stages of TL rows of x's type.
template <typename TX>
long tails_smem(int S, int acc_bytes, int nst) {
  return (long)S * T * acc_bytes +
         (long)nst * TL * padded_row<TX>() * (long)sizeof(TX);
}

template <typename Acc, int SL, typename TX>
int tails_go(const TX* x, const float* G, float* out, int q, int n, int S,
             int nv, cudaStream_t stream) {
  const int nst = tails_smem<TX>(S, sizeof(Acc), 3) <= MAX_SMEM ? 3 : 2;
  const long smem = tails_smem<TX>(S, sizeof(Acc), nst);
  if (smem > MAX_SMEM) return (int)cudaErrorLaunchOutOfResources;
  cudaError_t err = cudaFuncSetAttribute(
      tails_kernel<Acc, SL, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = rfp::persistent_grid((long)n * ((q + TL - 1) / TL));
  tails_kernel<Acc, SL, TX><<<grid, TL, (int)smem, stream>>>(
      x, G, out, q, n, S, nv, nst);
  return (int)cudaGetLastError();
}

template <typename Acc, typename TX>
int tails_sl(const TX* x, const float* G, float* out, int q, int n, int S,
             int sl, int nv, cudaStream_t stream) {
  if (S < 1 || S > sl || q < 1 || n < 1 || (nv != 1 && nv != 3))
    return (int)cudaErrorInvalidValue;
  switch (sl) {
    case 8: return tails_go<Acc, 8>(x, G, out, q, n, S, nv, stream);
    case 16: return tails_go<Acc, 16>(x, G, out, q, n, S, nv, stream);
    case 24: return tails_go<Acc, 24>(x, G, out, q, n, S, nv, stream);
    case 32: return tails_go<Acc, 32>(x, G, out, q, n, S, nv, stream);
    case 40: return tails_go<Acc, 40>(x, G, out, q, n, S, nv, stream);
    case 48: return tails_go<Acc, 48>(x, G, out, q, n, S, nv, stream);
    case 56: return tails_go<Acc, 56>(x, G, out, q, n, S, nv, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Acc, typename TX>
int extra_launch(const TX* x, const float* G, float* out, int q, int n,
                 int S, int sl, int He, int nv, cudaStream_t stream) {
  const dim3 grid(n, (q + LINES - 1) / LINES);
  const int R = sl + He, rows = R < ROWS ? R : ROWS;
  const int xs = LINES * padded_row<TX>() * (int)sizeof(TX);
  const int smem = xs + rows * T * sizeof(Acc);
  cudaError_t err = cudaFuncSetAttribute(
      tails_extra_kernel<Acc, TX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      xs + ROWS * T * sizeof(Acc));
  if (err != cudaSuccess) return (int)err;
  tails_extra_kernel<Acc, TX><<<grid, THREADS, smem, stream>>>(
      x, G, out, q, n, S, sl, R, nv);
  return (int)cudaGetLastError();
}

bool extra_args_ok(int S, int sl, int He) {
  return !(S < 1 || sl > MAX_SL || S > sl || sl % 8 || He < 1 ||
           He > MAX_HE);
}

}  // namespace

extern "C" int tails_launch(const float* x, const float* G, float* out,
                            int q, int n, int S, int sl, int He, int nv,
                            int fp64, void* stream) {
  if (sl > MAX_SL || sl % 8 || He != 0) return (int)cudaErrorInvalidValue;
  return fp64 ? tails_sl<double>(x, G, out, q, n, S, sl, nv,
                                 (cudaStream_t)stream)
              : tails_sl<float>(x, G, out, q, n, S, sl, nv,
                                (cudaStream_t)stream);
}

// x (q, n, 128) bf16; the rest as tails_launch, fp64 sums only (fp64 1)
extern "C" int tails_bf16_launch(const void* x, const float* G, float* out,
                                 int q, int n, int S, int sl, int He, int nv,
                                 int fp64, void* stream) {
  if (sl > MAX_SL || sl % 8 || He != 0 || !fp64)
    return (int)cudaErrorInvalidValue;
  return tails_sl<double>(static_cast<const rf::bf16*>(x), G, out, q, n, S,
                          sl, nv, (cudaStream_t)stream);
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
  return tails_sl<double>(x, G, out, q, n, S, 8, 1, (cudaStream_t)stream);
}

// the same tails with He extra rows below the sl slot rows: a kernel of
// its own (tails_extra_kernel), so its launches count apart
extern "C" int tails_extra_launch(const float* x, const float* G, float* out,
                                  int q, int n, int S, int sl, int He, int nv,
                                  int fp64, void* stream) {
  if (!extra_args_ok(S, sl, He)) return (int)cudaErrorInvalidValue;
  return fp64 ? extra_launch<double>(x, G, out, q, n, S, sl, He, nv,
                                     (cudaStream_t)stream)
              : extra_launch<float>(x, G, out, q, n, S, sl, He, nv,
                                    (cudaStream_t)stream);
}

// x (q, n, 128) bf16; the rest as tails_extra_launch, fp64 sums only
extern "C" int tails_extra_bf16_launch(const void* x, const float* G,
                                       float* out, int q, int n, int S,
                                       int sl, int He, int nv, int fp64,
                                       void* stream) {
  if (!extra_args_ok(S, sl, He) || !fp64) return (int)cudaErrorInvalidValue;
  return extra_launch<double>(static_cast<const rf::bf16*>(x), G, out, q, n,
                              S, sl, He, nv, (cudaStream_t)stream);
}

extern "C" const char* tails_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
