// pipeline.cuh: the pieces of the persistent, cp.async-pipelined kernels —
// the tensor-core completions (completion_tc.cuh, completion_rot.cuh),
// rows_final.cu's, rows_tails.cu's and tails.cu's (tails, tails_traced):
// asynchronous copies into shared memory and the walk of a persistent
// block over (tile, line block) work items (and of a block's warpgroups in
// groups of items, Walk).
#pragma once

#include <cuda_runtime.h>

namespace rfp {

constexpr int GT = 128;  // tile edge: lines per item, outputs per tile

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

}  // namespace rfp
