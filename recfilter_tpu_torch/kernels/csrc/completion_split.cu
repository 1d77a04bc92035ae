// completion_split.cu: the unrotated completion at the reduced precision
// grades — completion_split, replacing
// recfilter_tpu/kernels/completion.py::completion_pass(rot=False,
// nprod=n) at nprod 1 (default), 3 (px3) and 4 (px4). The same kernel as
// completion.cu's completion (completion_tc.cuh), instantiated at NPROD:
// the per-tile product
//
//   Y[l, t, :] = sum_(i,j) Bc_i[v(t)] * [x[l, t, :]; N[t, :, l]]_j
//
// over split.cuh's chunk pairs (i, j), smallest level first — NPROD on the
// 128 signal rows, carry_nprod(NPROD) >= 3 on the carry rows (the carry
// terms cancel: kernels/split.py; the JAX package takes one at nprod 1) —
// the carry slab first (wgmma.cuh's split_products). B is the host's
// constant [Btot | Rcat | 0] in two chunks (wgmma.cuh's b_chunks; 73.7 KB
// at sl = 8), so two warpgroups' stages fit beside it at every sl <= 56.
// Bound: 2 x (128 NPROD + S carry_nprod) bf16 operations per sample
// against 8 B of traffic — at the card's peaks, by bytes.
//
// completion_split_epi: the same with the affine epilogue a * y + sum_k
// b_k * aux_k + c (k <= 4) in the store, as completion_epi at px6 —
// completion_pass(rot=False, nprod=n) with its eaux
// (recfilter_tpu/kernels/completion.py:273-278). Each aux adds 4 B per
// sample of reads.
//
// completion_split_bf16, completion_split_epi_bf16 (bf16 storage: the JAX
// package's bf16 mode runs completion_pass on a bf16 x at nprod 1): x read
// as bf16 into the one data chunk (its own split, exact), the carry rows
// at carry_nprod(1) = 3 products as at nprod 1, the fp32 accumulators
// (after the epilogue; its aux arrays float32) rounded once to bf16 in the
// store. 4 B of traffic per sample in place of 8.

#include "completion_tc.cuh"

// nprod in {1, 3, 4}; Bc: kernels/completion.py's CompletionSplit.Bc_k,
// (nv, 2, 128 * KP) bf16
extern "C" int completion_split_launch(const float* x, const float* N,
                                       const void* Bc, float* y, int q,
                                       int n, int sl, int nv, int nprod,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const rf::Affine none{};
  switch (nprod) {
    case 1: return static_launch<1>(x, N, Bc, y, none, 0, q, n, sl, nv, s);
    case 3: return static_launch<3>(x, N, Bc, y, none, 0, q, n, sl, nv, s);
    case 4: return static_launch<4>(x, N, Bc, y, none, 0, q, n, sl, nv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// coef = [a, c, b0..b3] (float32, on the card); aux0..aux{k-1} in y's
// (q, n, 128) layout, the rest unread
extern "C" int completion_split_epi_launch(
    const float* x, const float* N, const void* Bc, const float* aux0,
    const float* aux1, const float* aux2, const float* aux3,
    const float* coef, float* y, int q, int n, int sl, int nv, int k,
    int nprod, void* stream) {
  if (coef == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const rf::Affine e = rf::make_affine(aux0, aux1, aux2, aux3, coef);
  switch (nprod) {
    case 1: return static_launch<1>(x, N, Bc, y, e, k, q, n, sl, nv, s);
    case 3: return static_launch<3>(x, N, Bc, y, e, k, q, n, sl, nv, s);
    case 4: return static_launch<4>(x, N, Bc, y, e, k, q, n, sl, nv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, y (q, n, 128) bf16, nprod 1 (bf16 storage); the rest as
// completion_split_launch
extern "C" int completion_split_bf16_launch(const void* x, const float* N,
                                            const void* Bc, void* y, int q,
                                            int n, int sl, int nv, int nprod,
                                            void* stream) {
  if (nprod != 1) return (int)cudaErrorInvalidValue;
  return static_launch<1>(static_cast<const rf::bf16*>(x), N, Bc,
                          static_cast<rf::bf16*>(y), rf::Affine{}, 0, q, n,
                          sl, nv, (cudaStream_t)stream);
}

// x, y bf16, nprod 1; the aux arrays float32 in y's layout; the rest as
// completion_split_epi_launch
extern "C" int completion_split_epi_bf16_launch(
    const void* x, const float* N, const void* Bc, const float* aux0,
    const float* aux1, const float* aux2, const float* aux3,
    const float* coef, void* y, int q, int n, int sl, int nv, int k,
    int nprod, void* stream) {
  if (coef == nullptr || nprod != 1) return (int)cudaErrorInvalidValue;
  return static_launch<1>(static_cast<const rf::bf16*>(x), N, Bc,
                          static_cast<rf::bf16*>(y),
                          rf::make_affine(aux0, aux1, aux2, aux3, coef), k,
                          q, n, sl, nv, (cudaStream_t)stream);
}

extern "C" const char* completion_split_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
