// final2d: passes 2+3 of the 3-touch 2-D executor — read the image once,
// complete both dimensions, write the output once.
//
// Replaces recfilter_tpu/kernels/final2d.py::final2d_px (Pallas kernel
// _final_px_kernel). Per 128 x 128 tile (block (p, a, b)), with v(i) the
// tile's matrix variant (interior, first or last):
//
//   Z = Ba_v(a) * x_tile + Ra_v(a)[:, :8] * NA_t[p,a,:, tile cols]
//   Y[s,o] = sum_t Z[s,t] * Bb_v(b)[o,t] + sum_k NB_t[p,a, b*8+k, s] * Rb_v(b)[o,k]
//
// Z lives only in shared memory: it never goes to device memory, which is
// what makes the executor touch the image three times instead of five.
//
// What bounds it: two 128 x 136 x 128 products per tile are 2 x 136 MACs
// per pixel (about 544 FLOP/px, about 9.1 GFLOP at 4096^2) against 12 B/px
// of traffic, so on the H100's fp32 CUDA cores it is bound by arithmetic,
// not by bandwidth. The design is a plain register-tiled SIMT GEMM: both
// products run as C[m][n] = sum_kk A[kk][m] * B[kk][n] with the 8 carry
// rows appended to the 128-deep contraction (kk < 136), A and B staged
// whole in shared memory (2 x 68 KB), each of 256 threads holding an 8 x 8
// block of C in registers and reading float4 fragments free of bank
// conflicts. fp32 FMA throughout; no wgmma, TMA or TF32 yet.
//
// final2d_epi: the same kernel with the affine epilogue in its store loop
// (replaces _final_px_kernel's epilogue with eaux operands):
//
//   out = a * Y + sum_{j<k} b_j * aux_j + c,   k <= 4
//
// each aux in x's (p, na, T, W) layout, read with the store's own float4
// indexing, fp32 FMAs (common.cuh's affine_tile). The unsharp mask's combine
// (1 + w) * image - w * blur rides here with the image as its one aux, so
// the blur never touches device memory. Each aux adds 4 B/px of reads to
// the 12 B/px of traffic; the kernel stays bound by its arithmetic.
//
// Operand layouts (host-prepared, transposed so every stage is a
// contiguous copy):
//   A1 (nva, 136, 128) = [Ba^T ; Ra^T]      rows kk, columns s
//   B2 (nvb, 136, 128) = [Bb^T ; Rb^T]      rows kk, columns o
//
// final2d_k: the same two products at the HIGHEST grade's layouts —
// replaces recfilter_tpu/kernels/final2d.py::final2d (Pallas kernel
// _final2d_kernel), which overlap2d._fused_2d_kernel_path calls on the
// overlap_k backend. Three things the px entry fixes are free here:
//   * Ta, the tile of the leading axis, is any value up to 128: A1's
//     columns past Ta are zero, so Z's rows past Ta are zero and the store
//     skips them;
//   * the carries are the sums of the orders, not padded to 8: Ka, Kb up to
//     32, each padded on chip to a multiple of 8 (zero rows), so the
//     contraction depths are Ta + 8*ceil(Ka/8) and 128 + 8*ceil(Kb/8), and
//     2 x 160 x 128 x 4 B = 160 KB of shared memory at K = 32;
//   * NA arrives in row form (p, na, Ka, W), NB as (p, na, nb, Ta, Kb): its
//     Kb carries of row s are gathered, transposed, under Z^T.
// Per tile:
//   Z = A1_v(a)^T [x_tile; NA_tile]           (Ta + Ka deep)
//   Y = [Z^T; NB_tile^T]^T B2_v(b)             (128 + Kb deep)
// with A1 (nva, Ta + Kap, 128) = [Ba^T; Ra^T] (columns >= Ta zero) and B2
// (nvb, 128 + Kbp, 128) = [Bb^T; Rb^T]. Its bound is final2d's: about
// 2 x (128 + 6) x 2 = 536 FLOP/px, 9.0 GFLOP at 4096^2 with Ka = Kb = 6,
// 0.134 ms at 67 TFLOP/s fp32; the same GEMM, the same design.
//
// final2d_k_bf16: final2d_k with bf16 products — replaces the same Pallas
// kernel at matmul_dtype=bfloat16 (the overlap backends' Plan.matmul_dtype):
//   Z  = bf16(Ba) * bf16(x)   (fp32 accumulation)  +  Ra * NA   (fp32)
//   Zc = bf16(Z)
//   Y  = Zc * bf16(Bb)^T      (fp32 accumulation)  +  NB * Rb^T (fp32)
// Y float32, at final2d_k's layouts and shape limits. The two image-sized
// products run on the bf16 tensor cores (split.cuh's mma.sync m16n8k16
// block, one product: bf16 x bf16 is exact in fp32, so each is the JAX
// kernel's dot with fp32 accumulation); the carry rows' products stay fp32
// FMAs into accumulators of their own, added to the tensor cores' sums as
// the JAX kernel adds its two dots. x is rounded to bf16 as it is staged,
// Z as it goes to shared memory. The constants come rounded from the host
// (float64 to float32 to bf16, as the JAX kernel's float32 operand cast to
// bf16): Ab (nva, 128, 136) = bf16(Ba) rows s, t contiguous (zero past
// Ta), Bb (nvb, 128, 136) = bf16(Bb) rows o, t contiguous; the carry
// columns are read from final2d_k's A1 and B2. Shared memory: two bf16
// operands of 128 rows of 136 and two fp32 carry operands of 32 rows of
// 128, 100 KB. What bounds it: 12 B/px of traffic (x read, y written, both
// fp32) against 2 x 2 x 128 tensor-core FLOP per pixel: bytes, at the
// card's peaks.

#include "common.cuh"
#include "split.cuh"

namespace {

constexpr int T = rf::GT;      // tile edge, Ta = Tb
constexpr int SLOTS = 8;       // carry rows per slot
constexpr int KX = T + SLOTS;  // contraction depth: 128 image rows + 8 carries
constexpr int THREADS = rf::GEMM_THREADS;
constexpr int SMEM_BYTES = 2 * KX * T * sizeof(float);

using rf::gemm_tile;
using rf::row_of;
using rf::stage_rows;
using rf::variant;

template <int K>  // aux count of the affine epilogue; rf::NO_EPI: none
__global__ void __launch_bounds__(THREADS, 1)
final2d_kernel(const float* __restrict__ x,    // (p, na, T, W)
               const float* __restrict__ NA,   // (p, na, 8, W)
               const float* __restrict__ NB,   // (p, na, nb*8, T)
               const float* __restrict__ A1,   // (nva, KX, T)
               const float* __restrict__ B2,   // (nvb, KX, T)
               float* __restrict__ y,          // (p, na, T, W)
               rf::Affine epi,                 // aux: (p, na, T, W)
               int na, int nb, int nva, int nvb) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // KX x T
  float* Bs = As + KX * T;                      // KX x T

  const int b = blockIdx.x, a = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long W = (long)nb * T;
  const long pa = (long)p * na + a;
  const int va = variant(nva, a, na), vb = variant(nvb, b, nb);

  // dim-A completion: Z = [Ba^T; Ra^T]^T [x; NA]
  stage_rows(As, A1 + (long)va * KX * T, KX, T, tid);
  stage_rows(Bs, x + pa * T * W + (long)b * T, T, W, tid);
  stage_rows(Bs + T * T, NA + pa * SLOTS * W + (long)b * T, SLOTS, W, tid);
  __syncthreads();
  float c[8][8];
  gemm_tile(As, Bs, c, ty, tx, KX);
  __syncthreads();

  // dim-B completion: Y = [Z^T; NB]^T [Bb^T; Rb^T]. Z goes to shared
  // memory transposed (As[t][s] = Z[s][t]), never to device memory.
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int t = row_of(j, tx);
    *reinterpret_cast<float4*>(As + t * T + ty * 4) =
        make_float4(c[0][j], c[1][j], c[2][j], c[3][j]);
    *reinterpret_cast<float4*>(As + t * T + 64 + ty * 4) =
        make_float4(c[4][j], c[5][j], c[6][j], c[7][j]);
  }
  stage_rows(As + T * T, NB + (pa * nb + b) * SLOTS * T, SLOTS, T, tid);
  stage_rows(Bs, B2 + (long)vb * KX * T, KX, T, tid);
  __syncthreads();
  gemm_tile(As, Bs, c, ty, tx, KX);

  long r0[8];
  bool ok[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r0[i] = pa * T * W + (long)b * T + (long)row_of(i, ty) * W + tx * 4;
    ok[i] = true;
  }
  rf::affine_tile<K>(epi, c, r0, ok);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    *reinterpret_cast<float4*>(y + r0[i]) =
        make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
    *reinterpret_cast<float4*>(y + r0[i] + 64) =
        make_float4(c[i][4], c[i][5], c[i][6], c[i][7]);
  }
}

template <int K>
int launch(const float* x, const float* NA, const float* NB, const float* A1,
           const float* B2, float* y, const rf::Affine& epi, int p, int na,
           int nb, int nva, int nvb, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      final2d_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, na, p);
  final2d_kernel<K><<<grid, THREADS, SMEM_BYTES, stream>>>(
      x, NA, NB, A1, B2, y, epi, na, nb, nva, nvb);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(THREADS, 1)
final2d_k_kernel(const float* __restrict__ x,   // (p, na, Ta, W)
                 const float* __restrict__ NA,  // (p, na, Ka, W)
                 const float* __restrict__ NB,  // (p, na, nb, Ta, Kb)
                 const float* __restrict__ A1,  // (nva, Ta + Kap, T)
                 const float* __restrict__ B2,  // (nvb, T + Kbp, T)
                 float* __restrict__ y,         // (p, na, Ta, W)
                 int na, int nb, int Ta, int Ka, int Kb, int nva, int nvb) {
  extern __shared__ float4 smem4[];
  const int Kap = (Ka + SLOTS - 1) / SLOTS * SLOTS;
  const int Kbp = (Kb + SLOTS - 1) / SLOTS * SLOTS;
  const int D1 = Ta + Kap, D2 = T + Kbp;
  const int D = D1 > D2 ? D1 : D2;
  float* As = reinterpret_cast<float*>(smem4);  // D x T
  float* Bs = As + D * T;                       // D x T

  const int b = blockIdx.x, a = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long W = (long)nb * T;
  const long pa = (long)p * na + a;
  const int va = variant(nva, a, na), vb = variant(nvb, b, nb);

  // dim-A completion: Z = A1^T [x; NA], the carry rows zero-padded
  stage_rows(As, A1 + (long)va * D1 * T, D1, T, tid);
  stage_rows(Bs, x + pa * Ta * W + (long)b * T, Ta, W, tid);
  stage_rows(Bs + Ta * T, NA + pa * Ka * W + (long)b * T, Ka, W, tid);
  for (int i = tid; i < (Kap - Ka) * T; i += THREADS)
    Bs[(Ta + Ka) * T + i] = 0.f;
  __syncthreads();
  float c[8][8];
  gemm_tile(As, Bs, c, ty, tx, D1);
  __syncthreads();

  // dim-B completion: Y = [Z^T; NB^T]^T [Bb^T; Rb^T]; Z^T goes to shared
  // memory (As[t][s] = Z[s][t]), never to device memory
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int t = row_of(j, tx);
    *reinterpret_cast<float4*>(As + t * T + ty * 4) =
        make_float4(c[0][j], c[1][j], c[2][j], c[3][j]);
    *reinterpret_cast<float4*>(As + t * T + 64 + ty * 4) =
        make_float4(c[4][j], c[5][j], c[6][j], c[7][j]);
  }
  const float* nbt = NB + (pa * nb + b) * (long)Ta * Kb;
  for (int i = tid; i < Kbp * T; i += THREADS) {
    const int k = i / T, s = i % T;
    As[(T + k) * T + s] = k < Kb && s < Ta ? nbt[(long)s * Kb + k] : 0.f;
  }
  stage_rows(Bs, B2 + (long)vb * D2 * T, D2, T, tid);
  __syncthreads();
  gemm_tile(As, Bs, c, ty, tx, D2);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = row_of(i, ty);
    if (s >= Ta) continue;
    const long r0 = pa * Ta * W + (long)b * T + (long)s * W + tx * 4;
    *reinterpret_cast<float4*>(y + r0) =
        make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
    *reinterpret_cast<float4*>(y + r0 + 64) =
        make_float4(c[i][4], c[i][5], c[i][6], c[i][7]);
  }
}

constexpr int LDK = T + 8;   // row stride of the bf16 operands (elements)
constexpr int KMAX = 32;     // carries per axis
constexpr int SMEM_K_BF16 = 2 * T * LDK * (int)sizeof(rf::bf16) +
                            2 * KMAX * T * (int)sizeof(float);

// The accumulators of a warp's 64 x 32 share (split.cuh's Frag layout)
// plus sum_{k < K} P[k][m] * Q[k][n], P and Q fp32 rows of 128 in shared
// memory, summed on their own first (the JAX kernel's second dot).
__device__ __forceinline__ void add_carry_rows(rfs::Frag& f, const float* P,
                                               const float* Q, int K) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = (warp % 2) * 64 + lane / 4;
  const int n0 = (warp / 2) * 32 + 2 * (lane % 4);
  float c[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[i][j][r] = 0.f;
  for (int k = 0; k < K; ++k) {
    float pm[8];
    float2 qn[4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      pm[i] = P[k * T + m0 + (i / 2) * 16 + (i % 2) * 8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      qn[j] = *reinterpret_cast<const float2*>(Q + k * T + n0 + j * 8);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float a = pm[2 * mi + h];
          c[mi][ni][2 * h] = fmaf(a, qn[ni].x, c[mi][ni][2 * h]);
          c[mi][ni][2 * h + 1] = fmaf(a, qn[ni].y, c[mi][ni][2 * h + 1]);
        }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        f.acc[i][j][r] = __fadd_rn(f.acc[i][j][r], c[i][j][r]);
}

__global__ void __launch_bounds__(THREADS, 1)
final2d_k_bf16_kernel(const float* __restrict__ x,   // (p, na, Ta, W)
                      const float* __restrict__ NA,  // (p, na, Ka, W)
                      const float* __restrict__ NB,  // (p, na, nb, Ta, Kb)
                      const float* __restrict__ A1,  // (nva, Ta + Kap, T)
                      const float* __restrict__ B2,  // (nvb, T + Kbp, T)
                      const rf::bf16* __restrict__ Ab,  // (nva, T, LDK)
                      const rf::bf16* __restrict__ Bb,  // (nvb, T, LDK)
                      float* __restrict__ y,         // (p, na, Ta, W)
                      int na, int nb, int Ta, int Ka, int Kb, int nva,
                      int nvb) {
  extern __shared__ float4 smem4[];
  rf::bf16* Cs = reinterpret_cast<rf::bf16*>(smem4);  // T x LDK: Ab, then Bb
  rf::bf16* Ds = Cs + T * LDK;  // x as t rows of n, then Zc as s rows of t
  float* Ps = reinterpret_cast<float*>(Ds + T * LDK);  // KMAX x T
  float* Qs = Ps + KMAX * T;                            // KMAX x T
  const int Kap = (Ka + SLOTS - 1) / SLOTS * SLOTS;
  const int Kbp = (Kb + SLOTS - 1) / SLOTS * SLOTS;
  const int D1 = Ta + Kap, D2 = T + Kbp;
  const int K1 = (Ta + 15) / 16 * 16;  // the first product's depth

  const int b = blockIdx.x, a = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x;
  const long W = (long)nb * T;
  const long pa = (long)p * na + a;
  const int va = variant(nva, a, na), vb = variant(nvb, b, nb);

  // dim-A completion: Z = bf16(Ba) bf16(x) + Ra NA
  rfs::copy16(Cs, Ab + (long)va * T * LDK, T * LDK * (int)sizeof(rf::bf16),
              tid);
  const float* xt = x + pa * Ta * W + (long)b * T;
  for (int i = tid; i < K1 * (T / 4); i += THREADS) {
    const int t = i / (T / 4), c4 = i % (T / 4);
    const float4 v = t < Ta
        ? reinterpret_cast<const float4*>(xt + (long)t * W)[c4]
        : make_float4(0.f, 0.f, 0.f, 0.f);
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(Ds + t * LDK + 4 * c4) = u;
  }
  stage_rows(Ps, A1 + ((long)va * D1 + Ta) * T, Ka, T, tid);   // Ra^T
  stage_rows(Qs, NA + pa * Ka * W + (long)b * T, Ka, W, tid);  // NA
  __syncthreads();
  rfs::Frag f;
  rfs::zero(f);
  rfs::mma_block<true>(f, Cs, LDK, Ds, LDK, K1);
  add_carry_rows(f, Ps, Qs, Ka);
  __syncthreads();

  // dim-B completion: Y = Zc bf16(Bb)^T + NB Rb^T; Zc, Z rounded once to
  // bf16, goes to shared memory as s rows, never to device memory
  rfs::for_pairs(f, [&](int s, int t, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(Ds + s * LDK + t) =
        __floats2bfloat162_rn(v0, v1);
  });
  rfs::copy16(Cs, Bb + (long)vb * T * LDK, T * LDK * (int)sizeof(rf::bf16),
              tid);
  const float* nbt = NB + (pa * nb + b) * (long)Ta * Kb;
  for (int i = tid; i < Kb * T; i += THREADS) {
    const int k = i / T, s = i % T;
    Ps[k * T + s] = s < Ta ? nbt[(long)s * Kb + k] : 0.f;     // NB^T
  }
  stage_rows(Qs, B2 + ((long)vb * D2 + T) * T, Kb, T, tid);   // Rb^T
  __syncthreads();
  rfs::zero(f);
  rfs::mma_block<false>(f, Ds, LDK, Cs, LDK, T);
  add_carry_rows(f, Ps, Qs, Kb);

  float* yt = y + pa * Ta * W + (long)b * T;
  rfs::for_pairs(f, [&](int s, int o, float v0, float v1) {
    if (s < Ta)
      *reinterpret_cast<float2*>(yt + (long)s * W + o) = make_float2(v0, v1);
  });
}

}  // namespace

extern "C" int final2d_launch(const float* x, const float* NA,
                              const float* NB, const float* A1,
                              const float* B2, float* y, int p, int na,
                              int nb, int nva, int nvb, void* stream) {
  return launch<rf::NO_EPI>(x, NA, NB, A1, B2, y, rf::Affine{}, p, na, nb,
                            nva, nvb, (cudaStream_t)stream);
}

// coef = [a, c, b0..b3] (float32, on the card); aux0..aux{k-1} in x's
// layout, the rest unread
extern "C" int final2d_epi_launch(const float* x, const float* NA,
                                  const float* NB, const float* A1,
                                  const float* B2, const float* aux0,
                                  const float* aux1, const float* aux2,
                                  const float* aux3, const float* coef,
                                  float* y, int p, int na, int nb, int nva,
                                  int nvb, int k, void* stream) {
  const rf::Affine epi = rf::make_affine(aux0, aux1, aux2, aux3, coef);
  int err = (int)cudaErrorInvalidValue;
  rf::dispatch_aux(k, [&](auto kc) {
    err = launch<decltype(kc)::value>(x, NA, NB, A1, B2, y, epi, p, na, nb,
                                      nva, nvb, (cudaStream_t)stream);
  });
  return err;
}

// Ta <= 128, Ka and Kb <= 32 (the shared memory of one block)
extern "C" int final2d_k_launch(const float* x, const float* NA,
                                const float* NB, const float* A1,
                                const float* B2, float* y, int p, int na,
                                int nb, int Ta, int Ka, int Kb, int nva,
                                int nvb, void* stream) {
  if (Ta < 1 || Ta > T || Ka < 1 || Ka > 32 || Kb < 1 || Kb > 32)
    return (int)cudaErrorInvalidValue;
  const int Kap = (Ka + SLOTS - 1) / SLOTS * SLOTS;
  const int Kbp = (Kb + SLOTS - 1) / SLOTS * SLOTS;
  const int D = Ta + Kap > T + Kbp ? Ta + Kap : T + Kbp;
  const int smem = 2 * D * T * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      final2d_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, na, p);
  final2d_k_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, NA, NB, A1, B2, y, na, nb, Ta, Ka, Kb, nva, nvb);
  return (int)cudaGetLastError();
}

// final2d_k's shapes; Ab and Bb the bf16 constants (module docstring)
extern "C" int final2d_k_bf16_launch(const float* x, const float* NA,
                                     const float* NB, const float* A1,
                                     const float* B2, const rf::bf16* Ab,
                                     const rf::bf16* Bb, float* y, int p,
                                     int na, int nb, int Ta, int Ka, int Kb,
                                     int nva, int nvb, void* stream) {
  if (Ta < 1 || Ta > T || Ka < 1 || Ka > KMAX || Kb < 1 || Kb > KMAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      final2d_k_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_K_BF16);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, na, p);
  final2d_k_bf16_kernel<<<grid, THREADS, SMEM_K_BF16,
                          (cudaStream_t)stream>>>(
      x, NA, NB, A1, B2, Ab, Bb, y, na, nb, Ta, Ka, Kb, nva, nvb);
  return (int)cudaGetLastError();
}

extern "C" const char* final2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
