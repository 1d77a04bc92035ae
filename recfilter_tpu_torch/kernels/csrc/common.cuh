// common.cuh: device helpers shared by the port's kernels — the tile's
// matrix variant, row staging into shared memory, the register-tiled
// fp32 SIMT GEMM that final2d.cu, final2d_stencil.cu and split_mm.cu run,
// and the loads and stores of bf16 images (bf16 storage: the image in
// bf16 between passes, every sum in fp32 or fp64).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace rf {

using bf16 = __nv_bfloat16;

// The four floats of four bf16 values loaded as one 8-byte word, and the
// eight of one 16-byte word: exact (a bf16 value is a float).
__device__ __forceinline__ float4 widen4(uint2 v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void widen8(uint4 v, float4& lo, float4& hi) {
  lo = widen4(make_uint2(v.x, v.y));
  hi = widen4(make_uint2(v.z, v.w));
}

// Four consecutive values at p (16- or 8-byte aligned) as floats.
__device__ __forceinline__ float4 load4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4f(const bf16* p) {
  return widen4(*reinterpret_cast<const uint2*>(p));
}

// v as an output of type TX holds it: itself, or rounded once to bf16.
template <typename TX>
__device__ __forceinline__ float stored(float v) {
  if constexpr (std::is_same<TX, bf16>::value)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

// Store two adjacent outputs (8- or 4-byte aligned), or one, in the
// output's type: a bf16 output rounds each fp32 value once, to nearest
// even (torch's .to(torch.bfloat16)).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(bf16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

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

// The affine epilogue of the *_epi entries, applied to the filter output y
// before the store:  out = a*y + sum_{j<K} b_j * aux_j + c,  each aux in
// the output's layout (read at the output's own index), fp32 FMAs:
// fmaf(a, y, c) first, then one fmaf per aux. coef = [a, c, b0, b1, b2, b3]
// (a small float32 device buffer the module registers). K = NO_EPI: none.
// The helpers apply it to values still in registers, every aux load of a
// thread issued before any of its stores (a store through y would
// otherwise order the next loads behind it: the loop would wait on the
// memory latency of each output in turn).
constexpr int NO_EPI = -1;
constexpr int MAX_AUX = 4;

struct Affine {
  const float* aux[MAX_AUX];
  const float* coef;
};

// A thread's 8 x 8 block of a GEMM tile: row i at output index r0[i]
// (columns +0..3 and +64..67, read as float4: the aux arrays are 16-byte
// aligned like the output), rows with ok[i] false untouched.
template <int K>
__device__ __forceinline__ void affine_tile(const Affine& e, float c[8][8],
                                            const long (&r0)[8],
                                            const bool (&ok)[8]) {
  if constexpr (K != NO_EPI) {
    const float a = e.coef[0], bias = e.coef[1];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a, c[i][j], bias);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float b = e.coef[2 + k];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (!ok[i]) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v =
              *reinterpret_cast<const float4*>(e.aux[k] + r0[i] + 64 * h);
          c[i][4 * h + 0] = fmaf(b, v.x, c[i][4 * h + 0]);
          c[i][4 * h + 1] = fmaf(b, v.y, c[i][4 * h + 1]);
          c[i][4 * h + 2] = fmaf(b, v.z, c[i][4 * h + 2]);
          c[i][4 * h + 3] = fmaf(b, v.w, c[i][4 * h + 3]);
        }
      }
    }
  }
}

// N outputs of one thread, output n at index i0 + n * stride.
template <int K, int N>
__device__ __forceinline__ void affine_strided(const Affine& e, float (&v)[N],
                                               long i0, long stride) {
  if constexpr (K != NO_EPI) {
    const float a = e.coef[0], bias = e.coef[1];
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] = fmaf(a, v[n], bias);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float b = e.coef[2 + k];
      float x[N];
#pragma unroll
      for (int n = 0; n < N; ++n) x[n] = e.aux[k][i0 + n * stride];
#pragma unroll
      for (int n = 0; n < N; ++n) v[n] = fmaf(b, x[n], v[n]);
    }
  }
}

// Call f(std::integral_constant<int, K>{}) for the aux count k in
// [0, MAX_AUX] of a *_epi launch (f launches the kernel instantiated for
// K); false for a k outside it.
template <typename F>
bool dispatch_aux(int k, F&& f) {
  switch (k) {
    case 0: f(std::integral_constant<int, 0>{}); return true;
    case 1: f(std::integral_constant<int, 1>{}); return true;
    case 2: f(std::integral_constant<int, 2>{}); return true;
    case 3: f(std::integral_constant<int, 3>{}); return true;
    case 4: f(std::integral_constant<int, 4>{}); return true;
    default: return false;
  }
}

inline Affine make_affine(const float* a0, const float* a1, const float* a2,
                          const float* a3, const float* coef) {
  Affine e;
  e.aux[0] = a0;
  e.aux[1] = a1;
  e.aux[2] = a2;
  e.aux[3] = a3;
  e.coef = coef;
  return e;
}

}  // namespace rf
