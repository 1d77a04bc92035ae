// ozaki: the dual completion of scripts/int8_ozaki_exp.py as H100 studies
// — the 3-touch executor's final-pass products with no carries, for each
// 128-row block a of x (P, na, 128, W) and each 128-wide sub-tile c:
//
//   z = Ba * x[a][:, c]        y[a][:, c] = z * Bb^T
//
// Replaces, as studies (not on any executor's path):
//   scripts/int8_ozaki_exp.py:249  f_i8  (kernel k_i8)   -> ozaki_i8
//   scripts/int8_ozaki_exp.py:159  f_px6 (kernel k_px6)  -> dual_px6
//
// ozaki_i8 — int8 Ozaki slicing on mma.sync m16n8k32 (s8 x s8 -> s32).
// x takes one power-of-two scale per 128 x Lb block from the block's |max|
// (the script's _exp_scale: bit arithmetic on the exponent), each z
// sub-tile one of its own; four 7-bit slices by round-to-nearest residuals
// (rintf: ties to even, as jnp.round). The constants arrive sliced from
// the host, (128, 10*128) int8 with level d's slices [B0 .. Bd] at columns
// OFFS[d]*128; the level-3 block [B0 B1 B2 B3] holds every slice, and
// level d's contraction is its first (d+1)*128 columns. The data slices
// stand along K highest first, [s3; s2; s1; s0], so level d reads the last
// (d+1)*128 of them: one exact int32 sum per level, converted to fp32,
// scaled by 2^(15-7d) and added from d = 0, then times the two scales —
// the script's arithmetic step for step, so the kernel equals its twin
// bit for bit. z stays on chip: fp32 in registers, then its slices in
// shared memory beside the second constant. Two kernels a launch: the
// per-sub-tile |max| of x (tile_max), then the products (one block a
// sub-tile; a block's x scale is the max of its Lb/128 sub-tiles).
//
// dual_px6 — the same dual completion as six split-bf16 products
// (split.cuh: 3-chunk splits, the pairs (0,2) (1,1) (2,0) (0,1) (1,0) (0,0)
// smallest first) on mma.sync m16n8k16 with fp32 sums: final2d_split's
// structure at nprod 6 with the carry rows absent (its 136-deep carry
// contraction at six products would need 234 KB of shared memory; here the
// 128-deep one takes 204 KB).
//
// What bounds them at 4096^2: ozaki_i8 2 dots x 10 products x 2 x 128
// ops per pixel, 85.9 G int8 ops at 1979 TOPS (0.0434 ms), against 8 B/px
// (0.0401 ms at 3.35 TB/s); dual_px6 2 x 6 x 2 x 128 FLOP per pixel, 51.5
// GFLOP at 989 TFLOP/s (0.0521 ms). Both are first kernels that stage and
// compute in turn (no cp.async pipeline, no wgmma), one block a sub-tile.

#include <stdint.h>

#include "split.cuh"

namespace {

using rfs::bf16;
constexpr int T = 128;
constexpr int THREADS = 256;
constexpr int NS = 4;             // 7-bit slices
constexpr int KS = NS * T;        // level 3's contraction, 512
constexpr int LDB = KS + 16;      // bytes per int8 operand row (528)
constexpr int OZ_SMEM = 2 * T * LDB;

// ---------------------------------------------------------------- ozaki_i8

// The script's _exp_scale: e the biased exponent of m clipped to
// [32, 253], up = 2^(153-e), dn = 2^(e-153).
__device__ __forceinline__ void exp_scale(float m, float& up, float& dn) {
  int e = (__float_as_int(m) >> 23) & 0xFF;
  e = min(max(e, 32), 253);
  up = __int_as_float((280 - e) << 23);
  dn = __int_as_float((e - 26) << 23);
}

// Four 7-bit slices of the scaled value xs (|xs| < 2^27).
__device__ __forceinline__ void slice4(float xs, int8_t (&s)[NS]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float sh = (float)(1 << (21 - 7 * i));
    const float q = rintf(__fmul_rn(xs, 1.f / sh));
    s[i] = (int8_t)(int)q;
    if (i < NS - 1) xs = __fsub_rn(xs, __fmul_rn(q, sh));
  }
}

__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c,
                                          int8_t d) {
  return (uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
         ((uint32_t)(uint8_t)c << 16) | ((uint32_t)(uint8_t)d << 24);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(rfs::smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 64 x 32 share of acc[m][n] = sum_{k < K} A[m][k] * B[n][k]
// (int8 rows, K contiguous, row strides in bytes; K a multiple of 32). The
// int8 k32 fragments are the bf16 k16 fragments byte for byte, so
// split.cuh's ldmatrix addressing carries over with bytes for elements.
__device__ __forceinline__ void mma_block_s8(int (&acc)[4][4][4],
                                             const int8_t* A, int lda,
                                             const int8_t* B, int ldb,
                                             int K) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = (warp % 2) * 64, n0 = (warp / 2) * 32;
  const int8_t* a_row = A + (m0 + lane % 16) * lda + (lane / 16) * 16;
  const int8_t* b_row =
      B + (n0 + (lane % 8) + (lane / 16) * 8) * ldb + ((lane / 8) % 2) * 16;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 32) {
    uint32_t a[4][4], b[2][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) ldsm_x4(a[mi], a_row + mi * 16 * lda + k0);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) ldsm_x4(b[nj], b_row + nj * 16 * ldb + k0);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_s8(acc[mi][ni], a[mi], b[ni / 2][2 * (ni % 2)],
               b[ni / 2][2 * (ni % 2) + 1]);
  }
}

// out (+)= 2^(15-7d) * float(acc), in fp32 (d = 0 starts the sum).
__device__ __forceinline__ void add_level(float (&out)[4][4][4],
                                          const int (&acc)[4][4][4], int d) {
  const float sc = __int_as_float((127 + 15 - 7 * d) << 23);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float t = __fmul_rn(__int2float_rn(acc[mi][ni][r]), sc);
        out[mi][ni][r] = d == 0 ? t : __fadd_rn(out[mi][ni][r], t);
      }
}

// The block's max of a per-thread value (all threads get it).
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  __syncthreads();  // red free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// The 128-row level-3 block [C0 C1 C2 C3] of a (128, 10*128) operand.
__device__ __forceinline__ void stage_const(int8_t* dst, const int8_t* C,
                                            int tid) {
  for (int i = tid; i < T * (KS / 16); i += THREADS) {
    const int r = i / (KS / 16), c16 = i % (KS / 16);
    *reinterpret_cast<uint4*>(dst + r * LDB + 16 * c16) =
        *reinterpret_cast<const uint4*>(C + (long)r * 10 * T + 6 * T +
                                        16 * c16);
  }
}

// mx[pa][c] = |max| of sub-tile (pa, c) of x, as its fp32 bits.
__global__ void __launch_bounds__(THREADS)
tile_max_kernel(const float* __restrict__ x, int* __restrict__ mx, int W) {
  __shared__ float red[THREADS / 32];
  const int c = blockIdx.x;
  const long pa = blockIdx.y;
  const float* xt = x + pa * T * W + (long)c * T;
  float m = 0.f;
  for (int i = threadIdx.x; i < T * (T / 4); i += THREADS) {
    const int r = i / (T / 4), c4 = i % (T / 4);
    const float4 v = reinterpret_cast<const float4*>(xt + (long)r * W)[c4];
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                       fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  m = block_max(m, red);
  if (threadIdx.x == 0) mx[pa * (W / T) + c] = __float_as_int(m);
}

__global__ void __launch_bounds__(THREADS, 1)
ozaki_kernel(const float* __restrict__ x, const int* __restrict__ mx,
             const int8_t* __restrict__ Ca, const int8_t* __restrict__ Cb,
             float* __restrict__ y, int W, int nlb, float eA, float eB) {
  extern __shared__ uint4 smem16[];
  __shared__ float red[THREADS / 32];
  int8_t* Cs = reinterpret_cast<int8_t*>(smem16);  // constant, level 3
  int8_t* Ds = Cs + T * LDB;                       // data slices
  const int c = blockIdx.x, tid = threadIdx.x;
  const long pa = blockIdx.y;
  const int nt = W / T;

  stage_const(Cs, Ca, tid);
  int mb = 0;  // the x block's |max| bits (non-negative floats order as ints)
  const int l0 = (c / nlb) * nlb;
  for (int j = 0; j < nlb; ++j) mb = max(mb, mx[pa * nt + l0 + j]);
  float up, dnx;
  exp_scale(__int_as_float(mb), up, dnx);

  // x's slices as the B operand: Ds[w][(3 - j) * 128 + s]
  const float* xt = x + pa * T * W + (long)c * T;
  for (int i = tid; i < T * (T / 4); i += THREADS) {
    const int w = i % T, s4 = i / T;
    int8_t q[4][NS];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      slice4(__fmul_rn(xt[(long)(4 * s4 + r) * W + w], up), q[r]);
#pragma unroll
    for (int j = 0; j < NS; ++j)
      *reinterpret_cast<uint32_t*>(Ds + w * LDB + (NS - 1 - j) * T +
                                   4 * s4) =
          pack4(q[0][j], q[1][j], q[2][j], q[3][j]);
  }
  __syncthreads();

  // z = Ba x: level d = Cs[:, 0:(d+1)128] against Ds[:, (3-d)128:512]
  int acc[4][4][4];
  float z[4][4][4];
  for (int d = 0; d < NS; ++d) {
    mma_block_s8(acc, Cs, LDB, Ds + (NS - 1 - d) * T, LDB, (d + 1) * T);
    add_level(z, acc, d);
  }
  const float zs = __fmul_rn(dnx, eA);
  float m = 0.f;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        z[mi][ni][r] = __fmul_rn(z[mi][ni][r], zs);
        m = fmaxf(m, fabsf(z[mi][ni][r]));
      }
  m = block_max(m, red);  // its syncs also end every warp's reads above
  float upz, dnz;
  exp_scale(m, upz, dnz);

  // z's slices as the A operand: Ds[r][(3 - j) * 128 + t]; Bb beside them
  const int lane = tid % 32, warp = tid / 32;
  const int mrow = (warp % 2) * 64 + lane / 4;
  const int ncol = (warp / 2) * 32 + 2 * (lane % 4);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int8_t q0[NS], q1[NS];
        slice4(__fmul_rn(z[mi][ni][2 * h], upz), q0);
        slice4(__fmul_rn(z[mi][ni][2 * h + 1], upz), q1);
        const int r = mrow + mi * 16 + 8 * h, t = ncol + ni * 8;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          *reinterpret_cast<uint16_t*>(Ds + r * LDB + (NS - 1 - j) * T + t) =
              (uint16_t)((uint8_t)q0[j] | ((uint8_t)q1[j] << 8));
      }
  stage_const(Cs, Cb, tid);
  __syncthreads();

  // y = z Bb^T, level by level; reuses z's registers for y
  for (int d = 0; d < NS; ++d) {
    mma_block_s8(acc, Ds + (NS - 1 - d) * T, LDB, Cs, LDB, (d + 1) * T);
    add_level(z, acc, d);
  }
  const float ys = __fmul_rn(dnz, eB);
  float* yt = y + pa * T * W + (long)c * T;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mrow + mi * 16 + 8 * h, o = ncol + ni * 8;
        *reinterpret_cast<float2*>(yt + (long)r * W + o) =
            make_float2(__fmul_rn(z[mi][ni][2 * h], ys),
                        __fmul_rn(z[mi][ni][2 * h + 1], ys));
      }
}

// ---------------------------------------------------------------- dual_px6

constexpr int LD6 = T + 8;                 // bf16 row stride (8 mod 16)
constexpr long CH6 = (long)T * LD6;        // elements per chunk
constexpr int PX6_SMEM = 2 * 3 * (int)CH6 * (int)sizeof(bf16);

__global__ void __launch_bounds__(THREADS, 1)
dual_px6_kernel(const float* __restrict__ x, const bf16* __restrict__ Ac,
                const bf16* __restrict__ Bc, float* __restrict__ y, int W) {
  extern __shared__ uint4 smem16[];
  bf16* Cs = reinterpret_cast<bf16*>(smem16);  // 3 constant chunks
  bf16* Ds = Cs + 3 * CH6;                     // 3 data chunks
  const int c = blockIdx.x, tid = threadIdx.x;
  const long pa = blockIdx.y;

  // z = sum_p Ba_i x_j: x as k rows (s), n columns (w)
  rfs::copy16(Cs, Ac, 3 * (int)CH6 * (int)sizeof(bf16), tid);
  const float* xt = x + pa * T * W + (long)c * T;
  for (int i = tid; i < T * (T / 4); i += THREADS) {
    const int k = i / (T / 4), c4 = i % (T / 4);
    rfs::split_store4<3>(Ds + k * LD6 + 4 * c4, CH6,
                         reinterpret_cast<const float4*>(xt + (long)k * W)[c4]);
  }
  __syncthreads();
  rfs::Frag f;
  rfs::zero(f);
  rfs::split_mma<6, true, true>(f, Cs, CH6, LD6, Ds, CH6, LD6, T);
  __syncthreads();

  // y = sum_p z_j Bb_i^T: z's chunks as rows r, k contiguous
  rfs::for_pairs(f, [&](int r, int t, float v0, float v1) {
    rfs::split_store2<3>(Ds + r * LD6 + t, CH6, v0, v1);
  });
  rfs::copy16(Cs, Bc, 3 * (int)CH6 * (int)sizeof(bf16), tid);
  __syncthreads();
  rfs::zero(f);
  rfs::split_mma<6, false, false>(f, Ds, CH6, LD6, Cs, CH6, LD6, T);
  float* yt = y + pa * T * W + (long)c * T;
  rfs::for_pairs(f, [&](int r, int o, float v0, float v1) {
    *reinterpret_cast<float2*>(yt + (long)r * W + o) = make_float2(v0, v1);
  });
}

}  // namespace

// x (pa, 128, W) fp32; mx (pa, W/128) int32 scratch; Ca, Cb (128, 1280)
// int8 from kernels/int8_mm.ozaki_operand with scales 2^ea, 2^eb; nlb =
// Lb / 128 sub-tiles per x scale block.
extern "C" int ozaki_i8_launch(const float* x, int* mx, const void* Ca,
                               const void* Cb, float* y, int pa, int W,
                               int nlb, int ea, int eb, void* stream) {
  if (pa <= 0 || pa >= 65536 || W % T || nlb <= 0 || (W / T) % nlb)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(W / T, pa);
  tile_max_kernel<<<grid, THREADS, 0, s>>>(x, mx, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ozaki_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             OZ_SMEM);
  if (err != cudaSuccess) return (int)err;
  ozaki_kernel<<<grid, THREADS, OZ_SMEM, s>>>(
      x, mx, static_cast<const int8_t*>(Ca), static_cast<const int8_t*>(Cb),
      y, W, nlb, ldexpf(1.f, ea), ldexpf(1.f, eb));
  return (int)cudaGetLastError();
}

// x (pa, 128, W) fp32; Ac, Bc (3, 128, 136) bf16 from
// kernels/int8_mm.px6_operand.
extern "C" int dual_px6_launch(const float* x, const void* Ac,
                               const void* Bc, float* y, int pa, int W,
                               void* stream) {
  if (pa <= 0 || pa >= 65536 || W % T) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dual_px6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      PX6_SMEM);
  if (err != cudaSuccess) return (int)err;
  dual_px6_kernel<<<dim3(W / T, pa), THREADS, PX6_SMEM,
                    (cudaStream_t)stream>>>(
      x, static_cast<const bf16*>(Ac), static_cast<const bf16*>(Bc), y, W);
  return (int)cudaGetLastError();
}

extern "C" const char* ozaki_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
