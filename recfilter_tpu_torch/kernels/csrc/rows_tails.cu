// rows_tails: raw tails of a scan along a non-last axis — the rows pass's
// first read of the array.
//
// Replaces recfilter_tpu/kernels/final2d.py::rows_tails_px (Pallas kernel
// _rows_tails_kernel). The array is tiled as x (p, n, T, W): the scanned
// axis cut into n tiles of T = 128 rows, everything after it flattened into
// W lanes, everything before it into p. Per 128 x 128 tile (p, a, l), with
// v(a) the tile's matrix variant along the scanned axis (interior, first or
// last — clamp edges):
//
//   b[p,a,k, l*T+w] = sum_s G_v(a)[k,s] * x[p,a,s, l*T+w]        k < K
//
// and explicit zeros in the pad slots K..7: the carry solve multiplies them
// by zero columns, and an uninitialised NaN there would poison the result.
// This is the dim-A half of moments2d.cu, with no dim-B half.
//
// The sums accumulate in fp64 from fp32 loads of x, with G in fp64, as in
// tails.cu: these tails seed the carries, whose solve amplifies their
// rounding about thirtyfold for the sigma=5 Gaussian, and fp32 tail sums
// miss the 2e-6 px6 bound there. The TPU kernel's bf16 chunk splitting
// emulates fp32 products on the TPU matrix unit and has no counterpart here.
//
// What bounds it: it reads 4 B per element and writes 4K B per 128, and
// does K fp64 MACs per element (K <= 8), so on an H100 it is bound by
// device-memory bandwidth. The design keeps the loads in flight:
//   * persistent blocks, one per SM, walking the tiles (lane block
//     fastest, so the blocks in flight read neighbouring 512-byte row
//     segments), fed by a two-stage cp.async ring of whole 64 KB tiles
//     (pipeline.cuh): the next tile but one is requested as soon as a tile's
//     stage is consumed, so the copies run under the MACs, the reduction
//     and the stores;
//   * thread (warp wp, lane t) of 256 owns lanes 4t..4t+3 and rows
//     16wp..16wp+15 of the tile, read from the stage as float4 (a warp's
//     row one 512-byte run: no bank conflicts), each sample converted to
//     double once and met only by the K real slot rows (K a template
//     parameter): 4K fp64 accumulators a thread, summed over its 16 rows
//     in ascending order from 0;
//   * the eight warps' partial sums meet in shared memory and add up in a
//     fixed order, warp 0 first (kernels/final2d.py's RowsTails.grouped is
//     its float64 model), one thread an output; the pad slots are stored
//     as zeros in the same pass;
//   * G's K rows of every variant (at most 3 x 8 x 128 doubles) stay in
//     shared memory, read as broadcasts.
// bf16 storage (rows_tails_bf16: rows_tails_px on a bf16 x, which the JAX
// package's bf16 mode gives it): the ring holds bf16 tiles (32 KB a stage,
// a row 16 copies of 16 bytes), each thread's four lanes read as one
// 8-byte word and widened (exact), so the sums are the fp32 entry's on the
// same values, bit for bit; b stays fp32. 2 B per element read.
//
// Picked over two designs that stream x into registers — per-tile blocks
// with sixteen float4 loads a thread, two an SM (128 registers, spills
// from K = 6), and those blocks walking the tiles — by timing all three
// on an H100 at the rows passes of a 256^3 and a 512^3 volume: the ring
// was the fastest on both, and all three gave the same bits.

#include <cuda_runtime.h>

#include "common.cuh"
#include "pipeline.cuh"

namespace {

constexpr int T = 128;         // tile edge: rows of the scanned axis, lanes
constexpr int SLOTS = 8;       // carry rows per slot
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RW = T / WARPS;  // rows a warp sums
constexpr int STAGES = 2;      // tiles in the ring

// G x 3 variants, the partials, the ring of tiles of elements of `bytes`
constexpr int smem_bytes(int K, int bytes) {
  return (3 * K * T + WARPS * K * T) * (int)sizeof(double) +
         STAGES * T * T * bytes;
}
static_assert(smem_bytes(SLOTS, 4) <= 232448, "rows_tails outgrows an SM");

using rf::variant;

// TX: x's type, float or bf16
template <int K, typename TX>
__global__ void __launch_bounds__(THREADS, 1)
rows_tails_kernel(const TX* __restrict__ x,      // (p, n, T, W)
                  const double* __restrict__ G,  // (nv, 8, T)
                  float* __restrict__ b,         // (p, n, 8, W)
                  int n, int nl, int nv, int tiles) {
  extern __shared__ double smem[];
  double* g = smem;              // nv x K x T
  double* part = g + 3 * K * T;  // WARPS x K x T
  TX* ring = reinterpret_cast<TX*>(part + WARPS * K * T);
  constexpr int V = 16 / (int)sizeof(TX);  // elements a 16-byte copy

  const int tid = threadIdx.x, wp = tid / 32, t = tid % 32;
  const long W = (long)nl * T;

  // tile `tile` (lane block fastest, then a, then p) into stage st,
  // asynchronously; nothing past the last tile
  auto load = [&](int tile, int st) {
    if (tile >= tiles) return;
    const long pa = tile / nl;
    const TX* xt = x + pa * T * W + (long)(tile - pa * nl) * T;
    TX* dst = ring + st * T * T;
    for (int i = tid; i < T * T / V; i += THREADS) {
      const int r = i / (T / V), c = V * (i % (T / V));
      rfp::cp16(dst + r * T + c, xt + r * W + c, true);
    }
  };

  for (int i = tid; i < nv * K * T; i += THREADS)
    g[i] = G[(i / (K * T)) * SLOTS * T + i % (K * T)];
  load(blockIdx.x, 0);
  rfp::commit();
  load(blockIdx.x + gridDim.x, 1);
  rfp::commit();

  int st = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, st ^= 1) {
    rfp::wait_pending(1);  // this tile's stage (the next may be in flight)
    __syncthreads();
    const long pa = tile / nl;
    const int l = tile - pa * nl;
    const double* gv = g + variant(nv, pa % n, n) * K * T;
    const TX* xs = ring + st * T * T + 4 * t;

    double acc[K][4];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = 0.0;
#pragma unroll 4
    for (int i = 0; i < RW; ++i) {
      const int s = wp * RW + i;
      float4 v;
      if constexpr (std::is_same<TX, float>::value)
        v = *reinterpret_cast<const float4*>(xs + s * T);
      else
        v = rf::widen4(*reinterpret_cast<const uint2*>(xs + s * T));
      const double x0 = v.x, x1 = v.y, x2 = v.z, x3 = v.w;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const double gk = gv[k * T + s];
        acc[k][0] = fma(gk, x0, acc[k][0]);
        acc[k][1] = fma(gk, x1, acc[k][1]);
        acc[k][2] = fma(gk, x2, acc[k][2]);
        acc[k][3] = fma(gk, x3, acc[k][3]);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      double2* dst =
          reinterpret_cast<double2*>(part + (wp * K + k) * T + 4 * t);
      dst[0] = make_double2(acc[k][0], acc[k][1]);
      dst[1] = make_double2(acc[k][2], acc[k][3]);
    }
    __syncthreads();  // the stage consumed, the partials written
    load(tile + 2 * gridDim.x, st);
    rfp::commit();

    float* bt = b + pa * SLOTS * W + (long)l * T;
    for (int i = tid; i < SLOTS * T; i += THREADS) {
      const int k = i / T, c = i % T;
      float out = 0.f;
      if (k < K) {
        double sum = part[k * T + c];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) sum += part[(w * K + k) * T + c];
        out = (float)sum;
      }
      bt[k * W + c] = out;
    }
  }
}

template <int K, typename TX>
int launch(const TX* x, const double* G, float* b, int p, int n, int nl,
           int nv, cudaStream_t stream) {
  constexpr int smem = smem_bytes(K, (int)sizeof(TX));
  const cudaError_t err = cudaFuncSetAttribute(
      rows_tails_kernel<K, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (long)nl * n * p;
  rows_tails_kernel<K, TX>
      <<<rfp::persistent_grid(tiles), THREADS, smem, stream>>>(
          x, G, b, n, nl, nv, (int)tiles);
  return (int)cudaGetLastError();
}

template <typename TX>
int by_k(const TX* x, const double* G, float* b, int p, int n, int nl, int K,
         int nv, cudaStream_t s) {
  if (p < 1 || n < 1 || nl < 1 || (nv != 1 && nv != 3) ||
      (long)nl * n * p >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  switch (K) {
    case 1: return launch<1>(x, G, b, p, n, nl, nv, s);
    case 2: return launch<2>(x, G, b, p, n, nl, nv, s);
    case 3: return launch<3>(x, G, b, p, n, nl, nv, s);
    case 4: return launch<4>(x, G, b, p, n, nl, nv, s);
    case 5: return launch<5>(x, G, b, p, n, nl, nv, s);
    case 6: return launch<6>(x, G, b, p, n, nl, nv, s);
    case 7: return launch<7>(x, G, b, p, n, nl, nv, s);
    case 8: return launch<8>(x, G, b, p, n, nl, nv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// G: kernels/final2d.py's RowsTails.G_v64, (nv, 8, T) float64
extern "C" int rows_tails_launch(const float* x, const double* G, float* b,
                                 int p, int n, int nl, int K, int nv,
                                 void* stream) {
  return by_k(x, G, b, p, n, nl, K, nv, (cudaStream_t)stream);
}

// x (p, n, T, W) bf16; the rest as rows_tails_launch
extern "C" int rows_tails_bf16_launch(const void* x, const double* G,
                                      float* b, int p, int n, int nl, int K,
                                      int nv, void* stream) {
  return by_k(static_cast<const rf::bf16*>(x), G, b, p, n, nl, K, nv,
              (cudaStream_t)stream);
}

extern "C" const char* rows_tails_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
