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

#include "common.cuh"

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

extern "C" const char* final2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
