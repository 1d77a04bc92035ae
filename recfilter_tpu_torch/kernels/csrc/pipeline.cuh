// pipeline.cuh: the pieces of the persistent, cp.async-pipelined kernels —
// completion.cu's rotated emit (completion_rot, completion_rot_epi) and
// tensor-core completion (completion, completion_epi, completion_traced),
// rows_final.cu's, and tails.cu's tails (tails, tails_traced): asynchronous
// copies into shared memory, the walk of a persistent block over (tile,
// line block) work items (and of a block's warpgroups in groups of items,
// Walk), and the line-major fp32 GEMM core of the rotated emit.
//
// The GEMM core computes, for one tile t and 128 lines l, the completion's
//
//   C[l][o] = sum_{kk < 128} X[l][kk] * B[o][kk]
//           + sum_{s < sl}   N[s][l]  * B[o][128 + s]
//
// with one fmaf per contraction row, in ascending order, from 0.f: the
// x rows, then the carry rows — the order of common.cuh's gemm_tile, so
// its outputs are bit for bit those of the kernels that run gemm_tile
// (final2d, completion_rot_tails). Both operands are read
// contiguous in the contraction: the x tile as it arrives (a line's 128
// samples are one 512-byte row, copied by cp.async without a transpose)
// and B = [Btot | Rcat] with its outputs as rows, prepared on the host.
// Thread (ty, tx) of 256 owns lines line_of(i, ty) — four consecutive
// lines at ty*4 and four at 64 + ty*4 — and outputs out_of(j, tx) =
// tx + 16 j. With row strides of 4 mod 8 floats (LDX = 132, ldb = 132 +
// sl), its float4 reads along the contraction are free of bank conflicts:
// a warp reads two x rows (one wavefront) and sixteen consecutive B rows
// (two wavefronts, the least for 256 bytes).
#pragma once

#include <cuda_runtime.h>

namespace rfp {

constexpr int GT = 128;       // tile edge: lines per item, outputs per tile
constexpr int LDX = GT + 4;   // row stride of a staged x tile (floats)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared without a register round trip; zeros
// where !valid (the source is then not read, and src may be any address
// of the array).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` of this thread's groups are in flight
// (0, 1 or 2: the rings here are at most three deep)
__device__ __forceinline__ void wait_pending(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Work item `it` of n tiles x nb line blocks -> (t, b), the items of one
// matrix variant contiguous. One variant: tile-minor, so the blocks in
// flight read neighbouring 512-byte rows of the same lines (x is (q, n,
// 128): a line's tiles are contiguous). Three (n > 2): the interior tiles
// first, tile-minor, then tile 0, then tile n-1; two tiles of three
// variants: tile-major. A persistent block takes items blockIdx.x, +
// gridDim.x, ... in ascending order, so it meets each variant once: at
// most three stagings of the tile's operand.
__device__ __forceinline__ void item(int it, int n, int nb, int nv, int& t,
                                     int& b) {
  if (nv == 1) {
    b = it / n;
    t = it - b * n;
    return;
  }
  if (n <= 2) {
    t = it / nb;
    b = it - t * nb;
    return;
  }
  const int ni = (n - 2) * nb;
  if (it < ni) {
    b = it / (n - 2);
    t = 1 + it - b * (n - 2);
    return;
  }
  it -= ni;
  t = it < nb ? 0 : n - 1;
  b = it < nb ? it : it - nb;
}

// The walk of a block's nwg warpgroups (the tensor-core kernels:
// completion.cu's completion_tc_kernel, rows_final.cu): the items of each
// matrix variant (in item()'s order, a contiguous range [bd[r], bd[r + 1]),
// r < 3) in groups of nwg, one item a warpgroup, so the warpgroups of a
// block always share the variant's operand. Group g's first item, its
// range's end in `end`.
struct Walk {
  int bd[4], gs[4];  // range bounds; first group of each range, total
  __device__ Walk(int n, int nb, int nv, int nwg) {
    const int items = n * nb;
    bd[0] = 0;
    bd[1] = bd[2] = bd[3] = items;
    if (nv == 3) {  // item(): interior tiles, tile 0, tile n - 1
      bd[1] = n > 2 ? (n - 2) * nb : 0;
      bd[2] = n > 2 ? (n - 1) * nb : nb;
    }
    gs[0] = 0;
    for (int r = 0; r < 3; ++r)
      gs[r + 1] = gs[r] + (bd[r + 1] - bd[r] + nwg - 1) / nwg;
  }
  __device__ int first(int g, int nwg, int& end) const {
    const int r = g < gs[1] ? 0 : (g < gs[2] ? 1 : 2);
    end = bd[r + 1];
    return bd[r] + (g - gs[r]) * nwg;
  }
};

// The number of Walk's groups (on the host): per variant range, rounded up.
inline long walk_groups(long n, long nb, int nv, int nwg) {
  return nv == 1 || n == 1
             ? (n * nb + nwg - 1) / nwg
             : (n > 2 ? ((n - 2) * nb + nwg - 1) / nwg : 0) +
                   2 * ((nb + nwg - 1) / nwg);
}

// The persistent grid: one block per SM (every kernel here takes more than
// half an SM's shared memory), no more blocks than items.
inline int persistent_grid(long items) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)(items < sms ? items : sms);
}

__device__ __forceinline__ int line_of(int i, int ty) {
  return (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
}
__device__ __forceinline__ int out_of(int j, int tx) { return tx + 16 * j; }

__device__ __forceinline__ float lane(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// A k-step of the x rows: four contraction rows at k for the thread's
// eight lines and eight outputs.
__device__ __forceinline__ void load_step(const float* __restrict__ Xs,
                                          const float* __restrict__ Bs,
                                          int ldb, int k, float4 (&a)[8],
                                          float4 (&b)[8], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a[i] = *reinterpret_cast<const float4*>(Xs + line_of(i, ty) * LDX + k);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    b[j] = *reinterpret_cast<const float4*>(Bs + out_of(j, tx) * ldb + k);
}

// the step's four contraction rows in order, each an outer product of 64
// independent fmaf
__device__ __forceinline__ void fma_step(const float4 (&a)[8],
                                         const float4 (&b)[8],
                                         float (&c)[8][8]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        c[i][j] = fmaf(lane(a[i], u), lane(b[j], u), c[i][j]);
}

// C = the tile's completion (above): Xs (GT x LDX, lines as rows), Ns
// (sl x GT, carry rows as rows), Bs (GT x ldb, outputs as rows), all in
// shared memory; sl a multiple of 4. The x rows run in k-steps of four
// contraction rows (eight float4 of x, eight of B, 256 fmaf); two warps
// on each scheduler cover the loads' latency (a second register set, the
// next step's fragments loading under this step's products, measured no
// faster on the H100 and took the registers the emit needs).
__device__ __forceinline__ void gemm_lines(const float* __restrict__ Xs,
                                           const float* __restrict__ Ns,
                                           const float* __restrict__ Bs,
                                           int ldb, int sl, float (&c)[8][8],
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
#pragma unroll 1
  for (int k = 0; k < GT; k += 4) {
    float4 a[8], b[8];
    load_step(Xs, Bs, ldb, k, a, b, ty, tx);
    fma_step(a, b, c);
  }
#pragma unroll 1
  for (int s = 0; s < sl; s += 4) {
    float4 a[8], b[8];  // carry rows s..s+3: a[u], a[4 + u] at the lines
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = *reinterpret_cast<const float4*>(Ns + (s + u) * GT + ty * 4);
      a[4 + u] =
          *reinterpret_cast<const float4*>(Ns + (s + u) * GT + 64 + ty * 4);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bs + out_of(j, tx) * ldb + GT +
                                              s);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          c[i][j] = fmaf(lane(a[(i & 4) + u], i & 3), lane(b[j], u), c[i][j]);
  }
}

}  // namespace rfp
