// common.cuh: device helpers shared by the port's kernels — the tile's
// matrix variant, row staging into shared memory, and the register-tiled
// fp32 SIMT GEMM that final2d.cu and completion.cu both run.
#pragma once

#include <cuda_runtime.h>

namespace rf {

constexpr int GT = 128;            // GEMM tile edge: C is GT x GT
constexpr int GEMM_THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each

// The matrix variant of tile i of n: 0 interior, 1 first, 2 last (a
// uniform stack, nv == 1, has only variant 0).
__device__ __forceinline__ int variant(int nv, int i, int n) {
  if (nv == 1) return 0;
  return i == 0 ? 1 : (i == n - 1 ? 2 : 0);
}

// Copy `rows` rows of GT floats (source row stride `stride`) to shared.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows, long stride, int tid) {
  for (int i = tid; i < rows * (GT / 4); i += GEMM_THREADS) {
    const int r = i / (GT / 4), c4 = i % (GT / 4);
    reinterpret_cast<float4*>(dst + r * GT)[c4] =
        reinterpret_cast<const float4*>(src + r * stride)[c4];
  }
}

// C[m][n] = sum_{kk < depth} A[kk][m] * B[kk][n], A and B in shared memory
// with row stride GT. Thread (ty, tx) owns rows {ty*4+i, 64+ty*4+i} and
// columns {tx*4+j, 64+tx*4+j}, i, j < 4; its float4 fragment reads are
// free of bank conflicts. fp32 FMA.
__device__ __forceinline__ void gemm_tile(const float* A, const float* B,
                                          float c[8][8], int ty, int tx,
                                          int depth) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < depth; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + kk * GT + ty * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(A + kk * GT + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(B + kk * GT + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(B + kk * GT + 64 + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
  }
}

// Row (or column) of C held in slot i of a thread's 8 x 8 block.
__device__ __forceinline__ int row_of(int i, int t) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

}  // namespace rf
