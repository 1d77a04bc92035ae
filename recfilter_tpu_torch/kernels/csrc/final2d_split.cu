// final2d_split: passes 2+3 of the 3-touch 2-D executor at the reduced
// precision grades (default, px3, px4) — final2d's products as split-bf16
// tensor-core products, one block a tile (final2d_split.cuh) — and
// final2d_split_epi, the same with an affine epilogue in the store.
//
// Replaces recfilter_tpu/kernels/final2d.py::final2d_px (Pallas kernel
// _final_px_kernel, mode 0) at nprod 1, 3 and 4, without and with its
// epilogue (applied to each output block in VMEM there, :694 and :746):
// final2d_split_epi writes
//
//   out = a * Y + sum_{k < K} b_k * aux_k + c      (K <= 4)
//
// with each aux in the output's (p, na, 128, W) layout, fp32 FMAs in
// common.cuh's order (fmaf(a, y, c), then one fmaf per aux), every aux
// load of a thread issued before its stores: the unsharp mask's combine,
// so Y never touches device memory (final2d_epi's form at px6).
//
// bf16 storage (final2d_split_bf16, final2d_split_epi_bf16: final2d_px on
// a bf16 x at nprod 1, which the JAX package's bf16 mode runs, writing y in
// x's dtype): x read as bf16 into the one data chunk (a bf16 value is its
// own chunk: no split), the products and sums as at nprod 1 on fp32 x,
// the fp32 accumulators (after the epilogue, whose aux arrays stay fp32)
// rounded once to bf16, to nearest even. 4 B/px of x and y in place of 8.
// The JAX kernel rounds Y to bf16 before its epilogue (o_ref's dtype);
// here the epilogue reads the fp32 Y and the output rounds once.
//
// What bounds it: 2 x 2 x (128 NPROD + 8 carry_nprod) FLOP per pixel, 27.4
// GFLOP at 4096^2 and px3 on the bf16 tensor cores (989 TFLOP/s: 0.028
// ms), against 12 B/px of traffic (0.060 ms at 3.35 TB/s), 4 B/px more per
// aux: at the card's peaks it is bound by bytes. This first kernel stages
// and computes in turn (no cp.async or TMA pipeline, no wgmma), one block
// a tile.

#include "final2d_split.cuh"

namespace {

using f2s::bf16;
using f2s::T;

// TX: x's and y's type, float or bf16
template <int NPROD, int K, typename TX>
__global__ void __launch_bounds__(rfs::THREADS, 1)
final2d_split_kernel(const TX* __restrict__ x,      // (p, na, T, W)
                     const float* __restrict__ NA,  // (p, na, 8, W)
                     const float* __restrict__ NB,  // (p, na, nb*8, T)
                     const bf16* __restrict__ Ac,   // (nva, NC, T, LD)
                     const bf16* __restrict__ Bc,   // (nvb, NC, T, LD)
                     TX* __restrict__ y,            // (p, na, T, W)
                     rf::Affine epi, int na, int nb, int nva, int nvb) {
  extern __shared__ uint4 smem16[];
  const int b = blockIdx.x, a = blockIdx.y, p = blockIdx.z;
  const long W = (long)nb * T;
  const long pa = (long)p * na + a;
  rfs::Frag f;
  f2s::split_tile<NPROD>(f, x, NA, NB, Ac, Bc, smem16, pa, b,
                         rf::variant(nva, a, na), rf::variant(nvb, b, nb),
                         nb);

  // the thread's outputs (m, n), (m, n + 1) of for_pairs' order
  const long base = pa * T * W + (long)b * T;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = (warp % 2) * 64 + lane / 4;
  const int n0 = (warp / 2) * 32 + 2 * (lane % 4);
  if constexpr (K != rf::NO_EPI) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[2] = {f.acc[mi][ni][2 * h], f.acc[mi][ni][2 * h + 1]};
          rf::affine_strided<K, 2>(
              epi, v, base + (long)(m0 + mi * 16 + 8 * h) * W + n0 + ni * 8,
              1);
          f.acc[mi][ni][2 * h] = v[0];
          f.acc[mi][ni][2 * h + 1] = v[1];
        }
  }
  TX* yt = y + base;
  rfs::for_pairs(f, [&](int s, int o, float v0, float v1) {
    rf::store2(yt + (long)s * W + o, v0, v1);
  });
}

template <int NPROD, int K, typename TX>
int launch(const TX* x, const float* NA, const float* NB, const bf16* Ac,
           const bf16* Bc, TX* y, const rf::Affine& epi, int p, int na,
           int nb, int nva, int nvb, cudaStream_t stream) {
  constexpr int smem = f2s::smem_bytes<NPROD>();
  cudaError_t err = cudaFuncSetAttribute(
      final2d_split_kernel<NPROD, K, TX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, na, p);
  final2d_split_kernel<NPROD, K, TX><<<grid, rfs::THREADS, smem, stream>>>(
      x, NA, NB, Ac, Bc, y, epi, na, nb, nva, nvb);
  return (int)cudaGetLastError();
}

template <int K>
int by_nprod(int nprod, const float* x, const float* NA, const float* NB,
             const void* Ac, const void* Bc, float* y, const rf::Affine& epi,
             int p, int na, int nb, int nva, int nvb, cudaStream_t s) {
  const bf16* A = static_cast<const bf16*>(Ac);
  const bf16* B = static_cast<const bf16*>(Bc);
  switch (nprod) {
    case 1:
      return launch<1, K>(x, NA, NB, A, B, y, epi, p, na, nb, nva, nvb, s);
    case 3:
      return launch<3, K>(x, NA, NB, A, B, y, epi, p, na, nb, nva, nvb, s);
    case 4:
      return launch<4, K>(x, NA, NB, A, B, y, epi, p, na, nb, nva, nvb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 storage: nprod 1 only (the JAX package's _kernel_nprod)
template <int K>
int bf16_nprod(int nprod, const void* x, const float* NA, const float* NB,
               const void* Ac, const void* Bc, void* y,
               const rf::Affine& epi, int p, int na, int nb, int nva,
               int nvb, cudaStream_t s) {
  if (nprod != 1) return (int)cudaErrorInvalidValue;
  return launch<1, K>(static_cast<const bf16*>(x), NA, NB,
                      static_cast<const bf16*>(Ac),
                      static_cast<const bf16*>(Bc), static_cast<bf16*>(y),
                      epi, p, na, nb, nva, nvb, s);
}

}  // namespace

// nprod in {1, 3, 4}; Ac, Bc from kernels/final2d.py's Final2DSplit
extern "C" int final2d_split_launch(const float* x, const float* NA,
                                    const float* NB, const void* Ac,
                                    const void* Bc, float* y, int p, int na,
                                    int nb, int nva, int nvb, int nprod,
                                    void* stream) {
  return by_nprod<rf::NO_EPI>(nprod, x, NA, NB, Ac, Bc, y, rf::Affine{}, p,
                              na, nb, nva, nvb, (cudaStream_t)stream);
}

// coef = [a, c, b0..b3] (float32, on the card); aux0..aux{k-1} in y's
// (p, na, T, W) layout, the rest unread
extern "C" int final2d_split_epi_launch(
    const float* x, const float* NA, const float* NB, const void* Ac,
    const void* Bc, const float* aux0, const float* aux1, const float* aux2,
    const float* aux3, const float* coef, float* y, int p, int na, int nb,
    int nva, int nvb, int nprod, int k, void* stream) {
  if (coef == nullptr) return (int)cudaErrorInvalidValue;
  const rf::Affine epi = rf::make_affine(aux0, aux1, aux2, aux3, coef);
  int ret = (int)cudaErrorInvalidValue;
  rf::dispatch_aux(k, [&](auto kc) {
    ret = by_nprod<decltype(kc)::value>(nprod, x, NA, NB, Ac, Bc, y, epi, p,
                                        na, nb, nva, nvb,
                                        (cudaStream_t)stream);
  });
  return ret;
}

// x, y (p, na, T, W) bf16, nprod 1; the rest as final2d_split_launch
extern "C" int final2d_split_bf16_launch(const void* x, const float* NA,
                                         const float* NB, const void* Ac,
                                         const void* Bc, void* y, int p,
                                         int na, int nb, int nva, int nvb,
                                         int nprod, void* stream) {
  return bf16_nprod<rf::NO_EPI>(nprod, x, NA, NB, Ac, Bc, y, rf::Affine{}, p,
                                na, nb, nva, nvb, (cudaStream_t)stream);
}

// x, y bf16, nprod 1; the aux arrays float32; the rest as
// final2d_split_epi_launch
extern "C" int final2d_split_epi_bf16_launch(
    const void* x, const float* NA, const float* NB, const void* Ac,
    const void* Bc, const float* aux0, const float* aux1, const float* aux2,
    const float* aux3, const float* coef, void* y, int p, int na, int nb,
    int nva, int nvb, int nprod, int k, void* stream) {
  if (coef == nullptr) return (int)cudaErrorInvalidValue;
  const rf::Affine epi = rf::make_affine(aux0, aux1, aux2, aux3, coef);
  int ret = (int)cudaErrorInvalidValue;
  rf::dispatch_aux(k, [&](auto kc) {
    ret = bf16_nprod<decltype(kc)::value>(nprod, x, NA, NB, Ac, Bc, y, epi,
                                          p, na, nb, nva, nvb,
                                          (cudaStream_t)stream);
  });
  return ret;
}

extern "C" const char* final2d_split_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
