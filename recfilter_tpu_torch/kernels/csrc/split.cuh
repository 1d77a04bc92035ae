// split.cuh: the split-bf16 products of the reduced precision grades on
// Hopper's tensor cores — the chunk split, the product pairs, and a
// 128 x 128 block GEMM on warp-level mma.sync (m16n8k16, bf16 in, fp32
// accumulate).
//
// The JAX package reaches a float32 grade on the TPU's bf16 matrix unit by
// splitting each float32 operand into bf16 chunks and summing chunk
// products in float32 (recfilter_tpu/kernels/completion.py:62-160); a
// grade is a product count NPROD (1 = default, 3 = px3, 4 = px4, 6 = px6).
// A bf16 x bf16 product is exact in fp32, so the tensor cores give the same
// chunk products; they run at 989 TFLOP/s dense on the H100 against 67
// TFLOP/s for fp32 FMA.
//
// Operands live in shared memory as bf16 rows with the contraction index k
// contiguous (row stride LD elements, LD = 8 mod 16 so that the eight
// 16-byte rows one ldmatrix reads fall in distinct bank groups), or, for
// the data operand of final2d_split's first product, as k rows of n
// columns (read with ldmatrix .trans). Eight warps tile the 128 x 128
// output 2 x 4, each warp 64 x 32: four m16 by four n8 fragments, 64 fp32
// accumulators a thread.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rfs {

constexpr int T = 128;        // the block's output tile edge
constexpr int THREADS = 256;  // 8 warps, 2 (m) x 4 (n)

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int nchunks(int nprod) {
  return nprod >= 6 ? 3 : (nprod >= 3 ? 2 : 1);
}

// Products on a contraction's carry rows: at least 3 (kernels/split.py:
// the carry terms cancel, and one bf16 product loses 2^-9 of terms far
// larger than the result).
__host__ __device__ constexpr int carry_nprod(int nprod) {
  return nprod >= 3 ? nprod : 3;
}

// Pair p of NPROD (smallest magnitude first, completion._prods): chunk
// pair_c of the constant times chunk pair_d of the data.
__host__ __device__ constexpr int pair_c(int nprod, int p) {
  return nprod >= 6 ? (p == 1 ? 1 : p == 2 ? 2 : p == 4 ? 1 : 0)
       : nprod >= 4 ? (p == 0 || p == 2 ? 1 : 0)
       : nprod >= 3 ? (p == 1 ? 1 : 0)
       : 0;
}
__host__ __device__ constexpr int pair_d(int nprod, int p) {
  return nprod >= 6 ? (p == 0 ? 2 : p == 1 || p == 3 ? 1 : 0)
       : nprod >= 4 ? (p <= 1 ? 1 : 0)
       : nprod >= 3 ? (p == 0 ? 1 : 0)
       : 0;
}

// The bf16 chunks of v (completion._split_vmem): each the round-to-nearest
// of what the earlier ones left, the residual exact in fp32.
template <int NC>
__device__ __forceinline__ void split(float v, bf16 (&c)[NC]) {
  float rem = v;
#pragma unroll
  for (int k = 0; k < NC - 1; ++k) {
    c[k] = __float2bfloat16_rn(rem);
    rem = __fsub_rn(rem, __bfloat162float(c[k]));
  }
  c[NC - 1] = __float2bfloat16_rn(rem);
}

// Split four floats and store chunk c of each at dst[c * cstride + 0..3]
// (8 bytes, 8-byte aligned).
template <int NC>
__device__ __forceinline__ void split_store4(bf16* dst, long cstride,
                                             float4 v) {
  bf16 a[NC], b[NC], c[NC], d[NC];
  split<NC>(v.x, a);
  split<NC>(v.y, b);
  split<NC>(v.z, c);
  split<NC>(v.w, d);
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    __nv_bfloat162 lo, hi;
    lo.x = a[k];
    lo.y = b[k];
    hi.x = c[k];
    hi.y = d[k];
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst + k * cstride) = u;
  }
}

// Split two floats and store chunk c of the pair at dst[c * cstride].
template <int NC>
__device__ __forceinline__ void split_store2(bf16* dst, long cstride,
                                             float x, float y) {
  bf16 a[NC], b[NC];
  split<NC>(x, a);
  split<NC>(y, b);
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    __nv_bfloat162 v;
    v.x = a[k];
    v.y = b[k];
    *reinterpret_cast<__nv_bfloat162*>(dst + k * cstride) = v;
  }
}

// Split one float and store chunk c at dst[c * cstride].
template <int NC>
__device__ __forceinline__ void split_store1(bf16* dst, long cstride,
                                             float x) {
  bf16 a[NC];
  split<NC>(x, a);
#pragma unroll
  for (int k = 0; k < NC; ++k) dst[k * cstride] = a[k];
}

// Copy `bytes` (a multiple of 16) from global to shared memory.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes, int tid) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = tid; i < bytes / 16; i += THREADS) d[i] = s[i];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 64 x 32 share of a 128 x 128 block product:
//   acc[mi][ni] (+)= sum_{k < K} A[m][k] * B[k][n]
// A: rows m, k contiguous (row stride lda). B_KN false: rows n, k contiguous
// (stride ldb); true: rows k, n contiguous (stride ldb). K a multiple of 16.
struct Frag {
  float acc[4][4][4];  // [m16 tile][n8 tile][mma C registers]
};

__device__ __forceinline__ void zero(Frag& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) f.acc[i][j][r] = 0.f;
}

template <bool B_KN>
__device__ __forceinline__ void mma_block(Frag& f, const bf16* A, int lda,
                                          const bf16* B, int ldb, int K) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = (warp % 2) * 64, n0 = (warp / 2) * 32;
  const bf16* a_row = A + (m0 + lane % 16) * lda + (lane / 16) * 8;
  const bf16* b_ptr =
      B_KN ? B + ((lane % 8) + ((lane / 8) % 2) * 8) * ldb + n0 +
                 (lane / 16) * 8
           : B + (n0 + (lane % 8) + (lane / 16) * 8) * ldb +
                 ((lane / 8) % 2) * 8;
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4][4], b[2][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) ldsm_x4(a[mi], a_row + mi * 16 * lda + k0);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      if (B_KN)
        ldsm_x4_t(b[nj], b_ptr + k0 * ldb + nj * 16);
      else
        ldsm_x4(b[nj], b_ptr + nj * 16 * ldb + k0);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_bf16(f.acc[mi][ni], a[mi], b[ni / 2][2 * (ni % 2)],
                 b[ni / 2][2 * (ni % 2) + 1]);
  }
}

// The split product over the NPROD pairs, smallest level first:
//   acc (+)= sum_p Ac[pair_?(p)] * Bc[pair_?(p)]
// A_CONST: A holds the constant's chunks (chunk c at A + c * astride), B
// the data's; else the reverse. Chunk strides in elements.
template <int NPROD, bool A_CONST, bool B_KN>
__device__ __forceinline__ void split_mma(Frag& f, const bf16* A, long astride,
                                          int lda, const bf16* B,
                                          long bstride, int ldb, int K) {
#pragma unroll 1
  for (int p = 0; p < NPROD; ++p) {
    const int ca = A_CONST ? pair_c(NPROD, p) : pair_d(NPROD, p);
    const int cb = A_CONST ? pair_d(NPROD, p) : pair_c(NPROD, p);
    mma_block<B_KN>(f, A + ca * astride, lda, B + cb * bstride, ldb, K);
  }
}

// split_mma with the contraction in two slabs: rows [0, KI) (the image) at
// NPROD products, rows [KI, K) (the carries) at carry_nprod(NPROD), the
// carry slab first. KI a multiple of 16.
template <int NPROD, bool A_CONST, bool B_KN>
__device__ __forceinline__ void split_mma_slabs(Frag& f, const bf16* A,
                                                long astride, int lda,
                                                const bf16* B, long bstride,
                                                int ldb, int KI, int K) {
  constexpr int CP = carry_nprod(NPROD);
  if (CP == NPROD) {
    split_mma<NPROD, A_CONST, B_KN>(f, A, astride, lda, B, bstride, ldb, K);
    return;
  }
  split_mma<CP, A_CONST, B_KN>(f, A + KI, astride, lda,
                               B + (B_KN ? (long)KI * ldb : KI), bstride,
                               ldb, K - KI);
  split_mma<NPROD, A_CONST, B_KN>(f, A, astride, lda, B, bstride, ldb, KI);
}

// Visit the thread's accumulators: fn(m, n, v0, v1) for the two adjacent
// outputs (m, n), (m, n + 1).
template <typename F>
__device__ __forceinline__ void for_pairs(const Frag& f, F&& fn) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = (warp % 2) * 64 + lane / 4;
  const int n0 = (warp / 2) * 32 + 2 * (lane % 4);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      fn(m0 + mi * 16, n0 + ni * 8, f.acc[mi][ni][0], f.acc[mi][ni][1]);
      fn(m0 + mi * 16 + 8, n0 + ni * 8, f.acc[mi][ni][2], f.acc[mi][ni][3]);
    }
}

}  // namespace rfs
