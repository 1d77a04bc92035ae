// rows_final: completion of a scan along a non-last axis — the rows pass's
// second read of the array, and its only write.
//
// Replaces recfilter_tpu/kernels/final2d.py::rows_final_px (Pallas kernel
// _rows_final_kernel) at nprod 6 (px6), 4 (px4), 3 (px3) and 1 (default).
// Per 128 x 128 tile of x (p, n, T, W),
// with v(a) the tile's matrix variant along the scanned axis (interior,
// first or last):
//
//   y[p,a,:, tile] = Btot_v(a) * x[p,a,:, tile] + Rhat_v(a)[:, :8] * N[p,a,:, tile]
//
// with N (p, n, 8, W) the solved, slot-padded carries — computed as the JAX
// package computes it at grade NPROD: x and N split into bf16 chunks on
// chip (_split_vmem), the constant [Btot | Rhat | 0] from float64 on the
// host (_split_const_np), and the chunk products of split.py's prods
// summed in fp32, smallest level first: the 8 carry rows (one k16 step,
// padded with zeros) at carry_nprod(NPROD) products — at least three: the
// carry terms cancel (kernels/split.py), where the JAX package takes one
// at nprod 1 — then the 128 rows of x at NPROD. At px6 that is six and
// six on three chunks a side; at px3, px4 three or four on two; at
// default one on one chunk of x and three on two of N (B has two chunks
// at every reduced grade). A bf16 x bf16 product is exact in fp32, so the
// arithmetic is the TPU kernel's; the sums round at other places (the
// tensor cores' accumulation).
//
// It is completion.cu's tensor-core product with the tile transposed:
// there y (lines x 128) = [x, N^T] . [Btot^T; R^T]; here y^T (lanes x 128)
// = [x; N]^T . [Btot^T; R^T]. So the B operand is the same host-packed
// constant (kernels/completion.py's core_pack of [Btot | Rhat | 0], KP =
// 144), and wgmma's M runs over the lanes of a tile: the A operand is read
// down the columns of the fp32 stage.
//
// What bounds it: 12 B of traffic per element (x read, y written; the
// carries 1/16 of that) against at most 6 * 2 * 144 bf16 operations (px6)
// — at the H100's peaks (3.35 TB/s, 989 TFLOP/s dense bf16) the bytes at
// every grade. The design,
// that of completion_tc_kernel (wgmma.cuh's split_products, stage_b;
// pipeline.cuh's Walk):
//   * work items of 64 lanes of one tile (one wgmma M) — the 136 rows of
//     x and N at those lanes — as pipeline.cuh's (tile a, line block)
//     items, the line blocks running over p and the lanes: a block meets
//     each matrix variant once;
//   * persistent blocks, one per SM, of two warpgroups, each with its own
//     item and a fp32 stage (136 x 64) filled by cp.async, refilled with
//     the next item as soon as the split has the stage in registers, so
//     one warpgroup's loads, split and stores run under the other's
//     products; B (3 x 128 x 144 bf16, 110.6 KB, at px6; two chunks,
//     73.7 KB, at the reduced grades) staged once a variant;
//   * the stage's rows of 64 lanes with their 8-lane groups XOR-swizzled
//     by (row / 4) % 4 (stage_off): a thread's fragment reads — rows 16s +
//     4qd + e (kperm), lanes r and r + 8 — fall in 32 distinct banks, and
//     the 16-byte cp.async groups stay whole;
//   * the output stored from the accumulators: a warp's store covers four
//     output rows, eight consecutive lanes each (four 32-byte sectors).
// Shared memory: 110,592 B of B at px6 (73,728 B at the reduced grades)
// and 2 x 34,816 B of stages.
//
// bf16 storage (rows_final_bf16: rows_final_px on a bf16 x at nprod 1,
// which the JAX package's bf16 mode runs, writing y in x's dtype): x's 128
// rows staged as bf16 (16 KB a warpgroup, a 16-byte copy 8 lanes) in the
// same swizzled layout, N's 8 rows in a fp32 stage of their own (2 KB),
// both by cp.async. A bf16 row of 64 lanes is 128 bytes, one pass over
// the 32 banks; the swizzle puts a warp's fragment reads — rows 4qd + e
// of a k16 step, lanes r and r + 8 — on 16 distinct words, each read by
// the two threads of a lane pair (a broadcast): free of bank conflicts,
// as the fp32 stage is, at half its bytes (kernels/final2d.py's
// _stage_off models both). The samples widen to fp32 as they are read (a
// bf16 value is its own chunk), the products are nprod 1's on fp32 x, and
// each fp32 output rounds once to bf16, to nearest even: 4 B of traffic
// per element in place of 8 (70.3 MB at 256^3).

#include "common.cuh"
#include "pipeline.cuh"
#include "wgmma.cuh"

namespace {

constexpr int T = 128;              // tile edge
constexpr int SLOTS = 8;            // carry rows per slot
constexpr int KP = T + 16;          // the contraction: 128 + 8 carries + 8 0
constexpr int CH = T * KP;          // elements of a chunk of B
constexpr int ROWS = T + SLOTS;     // rows of a stage: x's, then N's
constexpr int LANES = rfw::TM;      // lanes of an item (wgmma M)
constexpr int STAGE = ROWS * LANES;  // floats of a stage
constexpr int NWG = 2;              // warpgroups a block
// a warpgroup's stage: fp32 x and N rows, or bf16 x rows then fp32 N rows
template <typename TX>
__host__ __device__ constexpr long stage_bytes() {
  return std::is_same<TX, float>::value
             ? 4L * STAGE
             : 2L * T * LANES + 4L * SLOTS * LANES;
}
template <typename TX>
constexpr long smem(int nprod) {
  return rfw::b_chunks(nprod) * CH * 2L + NWG * stage_bytes<TX>();
}

// (row s, lane w) of a stage: rows of 64 lanes, the 8-lane groups of row s
// XOR-swizzled by (s / 4) % 4 (the header; kernels/final2d.py's
// _stage_off is its model)
__device__ __forceinline__ int stage_off(int s, int w) {
  return s * LANES + (w ^ (8 * ((s >> 2) & 3)));
}

// TX: x's and y's type, float or bf16
template <int NPROD, typename TX>
__global__ void __launch_bounds__(NWG * rfw::WG, 1)
rows_final_kernel(const TX* __restrict__ x,          // (p, n, T, W)
                  const float* __restrict__ N,       // (p, n, 8, W)
                  const rfs::bf16* __restrict__ Bc,  // (nv, NCB, T * KP)
                  TX* __restrict__ y,                // (p, n, T, W)
                  int n, int nl, int nb, int nv) {
  constexpr int NCB = rfw::b_chunks(NPROD);
  extern __shared__ uint4 smem16[];
  rfs::bf16* Bs = reinterpret_cast<rfs::bf16*>(smem16);

  const int wg = threadIdx.x / rfw::WG, tid = threadIdx.x % rfw::WG;
  const int lane = tid % 32, qd = lane % 4;
  const int r = 16 * (tid / 32) + lane / 4;  // fragment rows r, r + 8
  const long W = (long)nl * T;
  const int lb = W / LANES;  // lane blocks of one (p, a)
  // this warpgroup's stage: x's rows (Xs), then N's (Ns; at fp32 x the
  // stage's rows T.. as before)
  constexpr long SB = stage_bytes<TX>();
  char* stage = reinterpret_cast<char*>(Bs + NCB * CH) + wg * SB;
  TX* Xs = reinterpret_cast<TX*>(stage);
  float* Ns = reinterpret_cast<float*>(stage + T * LANES * sizeof(TX));
  const rfp::Walk walk(n, nb, nv, NWG);

  // item it -> the first element of its (p, a) slab and its first lane
  auto where = [&](int it, long& pa, int& l0) {
    int a, b;
    rfp::item(it, n, nb, nv, a, b);
    const int p = b / lb;
    pa = (long)p * n + a;
    l0 = (b - p * lb) * LANES;
  };

  // this warpgroup's item of group g into its stage, asynchronously;
  // false if it has none
  auto load = [&](int g) {
    int end;
    const int it = walk.first(g, NWG, end) + wg;
    if (g >= walk.gs[3] || it >= end) return false;
    long pa;
    int l0;
    where(it, pa, l0);
    const TX* xt = x + pa * T * W + l0;
    const float* Nt = N + pa * SLOTS * W + l0;
    if constexpr (std::is_same<TX, float>::value) {
      for (int i = tid; i < ROWS * (LANES / 4); i += rfw::WG) {
        const int s = i >> 4, c = 4 * (i & 15);
        rfp::cp16(Xs + stage_off(s, c),
                  s < T ? xt + s * W + c : Nt + (s - T) * W + c, true);
      }
    } else {
      for (int i = tid; i < T * (LANES / 8); i += rfw::WG) {
        const int s = i >> 3, c = 8 * (i & 7);
        rfp::cp16(Xs + stage_off(s, c), xt + s * W + c, true);
      }
      for (int i = tid; i < SLOTS * (LANES / 4); i += rfw::WG) {
        const int s = i >> 4, c = 4 * (i & 15);
        rfp::cp16(Ns + stage_off(s, c), Nt + s * W + c, true);
      }
    }
    return true;
  };

  bool have = load(blockIdx.x);
  rfp::commit();
  int cur_v = -1;
  for (int g = blockIdx.x; g < walk.gs[3]; g += gridDim.x) {
    int end;
    const int it = walk.first(g, NWG, end) + wg;
    int a0, b0;
    rfp::item(it - wg, n, nb, nv, a0, b0);
    const int v = rf::variant(nv, a0, n);
    if (v != cur_v) {
      rfw::stage_b<NCB>(smem16, Bc, v, CH);
      cur_v = v;
    }
    if (!have) {  // none in this group (its range's odd last item): the
      have = load(g + gridDim.x);  // stage is free for the next
      rfp::commit();
      continue;
    }
    rfp::wait_pending(0);  // this item's stage
    rfw::wg_sync(wg);

    // the transposed fragment: samples k0 + 4qd + e are stage rows, the
    // fragment rows r, r + 8 lanes; carry rows past the 8 slots are zeros
    float d[64];
    rfw::split_products<NPROD, 1>(
        d, Bs, CH, KP,
        [&](int k0, float (&u)[4], float (&w)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) u[e] = w[e] = 0.f;
          if constexpr (std::is_same<TX, float>::value) {
            if (k0 < T || 4 * qd < SLOTS) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                u[e] = Xs[stage_off(k0 + 4 * qd + e, r)];
                w[e] = Xs[stage_off(k0 + 4 * qd + e, r + 8)];
              }
            }
          } else if (k0 < T) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              u[e] = __bfloat162float(Xs[stage_off(k0 + 4 * qd + e, r)]);
              w[e] = __bfloat162float(Xs[stage_off(k0 + 4 * qd + e, r + 8)]);
            }
          } else if (4 * qd < SLOTS) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              u[e] = Ns[stage_off(k0 - T + 4 * qd + e, r)];
              w[e] = Ns[stage_off(k0 - T + 4 * qd + e, r + 8)];
            }
          }
        },
        [&] {
          rfw::wg_sync(wg);
          have = load(g + gridDim.x);
          rfp::commit();
        });

    // d[4j + 2h + e]: lane l0 + r + 8h, output row 8j + 2qd + e
    long pa;
    int l0;
    where(it, pa, l0);
    TX* yt = y + pa * T * W + l0 + r;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        TX* yr = yt + (long)(8 * j + 2 * qd + e) * W;
        rf::store1(yr, d[4 * j + e]);
        rf::store1(yr + 8, d[4 * j + 2 + e]);
      }
  }
}

template <int NPROD, typename TX>
int launch(const TX* x, const float* N, const rfs::bf16* Bc, TX* y, int n,
           int nl, long nb, int nv, cudaStream_t stream) {
  constexpr int smem_b = (int)smem<TX>(NPROD);
  const cudaError_t err = cudaFuncSetAttribute(
      rows_final_kernel<NPROD, TX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
  if (err != cudaSuccess) return (int)err;
  const int grid = rfp::persistent_grid(rfp::walk_groups(n, nb, nv, NWG));
  rows_final_kernel<NPROD, TX><<<grid, NWG * rfw::WG, smem_b, stream>>>(
      x, N, Bc, y, n, nl, (int)nb, nv);
  return (int)cudaGetLastError();
}

bool bad_shape(int p, int n, int nl, int nv) {
  const long nb = 2L * p * nl;  // 64-lane blocks of a tile index
  return p < 1 || n < 1 || nl < 1 || (nv != 1 && nv != 3) ||
         n * nb >= (1L << 31);
}

}  // namespace

// Bc: kernels/final2d.py's RowsFinal.Bc_k, (nv, NCB, 128 * 144) bf16 with
// NCB = 3 at nprod 6, 2 at nprod 1, 3, 4
extern "C" int rows_final_launch(const float* x, const float* N,
                                 const void* Bc, float* y, int p, int n,
                                 int nl, int nv, int nprod, void* stream) {
  if (bad_shape(p, n, nl, nv)) return (int)cudaErrorInvalidValue;
  const long nb = 2L * p * nl;
  const rfs::bf16* B = static_cast<const rfs::bf16*>(Bc);
  cudaStream_t s = (cudaStream_t)stream;
  switch (nprod) {
    case 1: return launch<1>(x, N, B, y, n, nl, nb, nv, s);
    case 3: return launch<3>(x, N, B, y, n, nl, nb, nv, s);
    case 4: return launch<4>(x, N, B, y, n, nl, nb, nv, s);
    case 6: return launch<6>(x, N, B, y, n, nl, nb, nv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, y (p, n, T, W) bf16, nprod 1 (bf16 storage); the rest as
// rows_final_launch
extern "C" int rows_final_bf16_launch(const void* x, const float* N,
                                      const void* Bc, void* y, int p, int n,
                                      int nl, int nv, int nprod,
                                      void* stream) {
  if (nprod != 1 || bad_shape(p, n, nl, nv))
    return (int)cudaErrorInvalidValue;
  return launch<1>(static_cast<const rfs::bf16*>(x), N,
                   static_cast<const rfs::bf16*>(Bc),
                   static_cast<rfs::bf16*>(y), n, nl, 2L * p * nl, nv,
                   (cudaStream_t)stream);
}

extern "C" const char* rows_final_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
