// completion_rot.cu: the rotated completion at every grade, with its
// optional stencil consumer and affine epilogue — completion_rot and
// completion_rot_epi, completion_rot.cuh's completion_rot_kernel<NPROD, KC>
// (the header gives the design), replacing
// recfilter_tpu/kernels/completion.py::completion_pass(rot=True,
// nprod=NPROD) with its stencil (_stencil_rows) and its epilogue (eaux);
// completion_rot_bf16 and completion_rot_epi_bf16 the same at NPROD 1 on a
// bf16 x and y (bf16 storage), without a stencil, and
// completion_rot_stencil_bf16 and completion_rot_stencil_epi_bf16 with one
// (the stencil body on a bf16 x stage, the taps and the epilogue on the
// fp32 accumulators, y rounded once).
// NPROD 6 (px6), 4 (px4), 3 (px3), 1 (default); KC = sl / 16 rounded up
// carry k16 steps; with a stencil or without (STENCIL). A source of its
// own, so that nvcc builds its 40 instantiations beside completion.cu's and
// completion_rot_tails.cu's.
//
// What bounds it: 8 B of traffic per sample (plus (hp + hn) / 128 of a read
// for the halo rows and 4 B per aux array) against 2 x (128 NPROD + S
// carry_nprod(NPROD)) bf16 operations — at the card's peaks (3.35 TB/s,
// 989 TFLOP/s dense bf16), the bytes.
//
// Shared memory: B's b_chunks(NPROD) chunks (110.6 KB at px6, 73.7 KB at
// the reduced grades, at sl <= 16), the taps, and per warpgroup an x stage
// of (64 * 144 + sl * 68) * 4 B (39.0 KB at sl = 8) and a stencil stage of
// (hp + 128 + hn) * 68 * 4 B over it. The launcher takes two warpgroups
// where they fit in the 227 KB a block may have, else one, and refuses
// with cudaErrorLaunchOutOfResources where even one does not.

#include "completion_rot.cuh"

namespace {

template <int NPROD, int KC, bool STENCIL, typename TX>
int rot_go(const TX* x, const float* N, const rfs::bf16* Bc,
           const float* prev, const float* nxt, const float* taps, TX* y,
           const rf::Affine& epi, int naux, int q, int n, int sl, int nv,
           int hp, int hn, int ntaps, int start_clamp, int end_clamp,
           cudaStream_t stream) {
  constexpr int KP = T + 16 * KC, NC = rfw::b_chunks(NPROD);
  int nwg = 2;
  while (nwg > 0 &&
         rot_smem<TX>(KP, NC, sl, hp, hn, ntaps, nwg) > MAX_SMEM)
    --nwg;
  if (nwg == 0) return (int)cudaErrorLaunchOutOfResources;
  const long smem = rot_smem<TX>(KP, NC, sl, hp, hn, ntaps, nwg);
  cudaError_t err = cudaFuncSetAttribute(
      completion_rot_kernel<NPROD, KC, STENCIL, TX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long nb = (q + rfw::TM - 1) / rfw::TM;
  const int grid = rfp::persistent_grid(rfp::walk_groups(n, nb, nv, nwg));
  completion_rot_kernel<NPROD, KC, STENCIL, TX>
      <<<grid, nwg * rfw::WG, (int)smem, stream>>>(
          x, N, Bc, prev, nxt, taps, y, epi, naux, q, n, sl, nv, hp, hn,
          ntaps, start_clamp, end_clamp, nwg);
  return (int)cudaGetLastError();
}

// the body with or without a stencil
template <int NPROD, int KC, typename TX>
int rot_launch_kc(const TX* x, const float* N, const rfs::bf16* Bc,
                  const float* prev, const float* nxt, const float* taps,
                  TX* y, const rf::Affine& epi, int naux, int q, int n,
                  int sl, int nv, int hp, int hn, int ntaps, int start_clamp,
                  int end_clamp, cudaStream_t stream) {
  if (ntaps > 0)
    return rot_go<NPROD, KC, true>(x, N, Bc, prev, nxt, taps, y, epi, naux,
                                   q, n, sl, nv, hp, hn, ntaps, start_clamp,
                                   end_clamp, stream);
  return rot_go<NPROD, KC, false>(x, N, Bc, prev, nxt, taps, y, epi, naux, q,
                                  n, sl, nv, hp, hn, ntaps, start_clamp,
                                  end_clamp, stream);
}

template <int NPROD, typename TX>
int rot_launch_np(const TX* x, const float* N, const rfs::bf16* Bc,
                  const float* prev, const float* nxt, const float* taps,
                  TX* y, const rf::Affine& epi, int naux, int q, int n,
                  int sl, int nv, int hp, int hn, int ntaps, int start_clamp,
                  int end_clamp, cudaStream_t s) {
  switch ((sl + 15) / 16) {
    case 1:
      return rot_launch_kc<NPROD, 1>(x, N, Bc, prev, nxt, taps, y, epi, naux,
                                     q, n, sl, nv, hp, hn, ntaps, start_clamp,
                                     end_clamp, s);
    case 2:
      return rot_launch_kc<NPROD, 2>(x, N, Bc, prev, nxt, taps, y, epi, naux,
                                     q, n, sl, nv, hp, hn, ntaps, start_clamp,
                                     end_clamp, s);
    case 3:
      return rot_launch_kc<NPROD, 3>(x, N, Bc, prev, nxt, taps, y, epi, naux,
                                     q, n, sl, nv, hp, hn, ntaps, start_clamp,
                                     end_clamp, s);
    default:
      return rot_launch_kc<NPROD, 4>(x, N, Bc, prev, nxt, taps, y, epi, naux,
                                     q, n, sl, nv, hp, hn, ntaps, start_clamp,
                                     end_clamp, s);
  }
}

bool rot_args_ok(int q, int n, int sl, int nv, int hp, int hn, int ntaps,
                 int naux) {
  return !(sl < 8 || sl > MAX_SL || sl % 8 || hp < 0 || hn < 0 || hp > T ||
           hn > T || ntaps < 0 || (ntaps == 0 && (hp || hn)) || q < 1 ||
           n < 1 || (nv != 1 && nv != 3) || naux < 0 || naux > rf::MAX_AUX);
}

int rot_launch(const float* x, const float* N, const void* Bc,
               const float* prev, const float* nxt, const float* taps,
               float* y, const rf::Affine& epi, int naux, int q, int n,
               int sl, int nv, int hp, int hn, int ntaps, int start_clamp,
               int end_clamp, int nprod, cudaStream_t s) {
  if (!rot_args_ok(q, n, sl, nv, hp, hn, ntaps, naux))
    return (int)cudaErrorInvalidValue;
  const rfs::bf16* B = static_cast<const rfs::bf16*>(Bc);
  switch (nprod) {
    case 1:
      return rot_launch_np<1>(x, N, B, prev, nxt, taps, y, epi, naux, q, n,
                              sl, nv, hp, hn, ntaps, start_clamp, end_clamp,
                              s);
    case 3:
      return rot_launch_np<3>(x, N, B, prev, nxt, taps, y, epi, naux, q, n,
                              sl, nv, hp, hn, ntaps, start_clamp, end_clamp,
                              s);
    case 4:
      return rot_launch_np<4>(x, N, B, prev, nxt, taps, y, epi, naux, q, n,
                              sl, nv, hp, hn, ntaps, start_clamp, end_clamp,
                              s);
    case 6:
      return rot_launch_np<6>(x, N, B, prev, nxt, taps, y, epi, naux, q, n,
                              sl, nv, hp, hn, ntaps, start_clamp, end_clamp,
                              s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// bf16 storage: nprod 1 (the JAX package's _kernel_nprod), with a
// stencil (ntaps > 0) or without
int rot_launch_bf16(const void* x, const float* N, const void* Bc,
                    const float* prev, const float* nxt, const float* taps,
                    void* y, const rf::Affine& epi, int naux, int q, int n,
                    int sl, int nv, int hp, int hn, int ntaps,
                    int start_clamp, int end_clamp, int nprod,
                    cudaStream_t s) {
  if (nprod != 1 || !rot_args_ok(q, n, sl, nv, hp, hn, ntaps, naux))
    return (int)cudaErrorInvalidValue;
  return rot_launch_np<1>(static_cast<const rf::bf16*>(x), N,
                          static_cast<const rfs::bf16*>(Bc), prev, nxt, taps,
                          static_cast<rf::bf16*>(y), epi, naux, q, n, sl, nv,
                          hp, hn, ntaps, start_clamp, end_clamp, s);
}

}  // namespace

// Bc: kernels/completion.py's CompletionPass.Bc_k, (nv, b_chunks(nprod),
// 128 * KP) bf16; taps (ntaps, 2) float32 [d, c]; prev, nxt the halo strips
// (null where hp, hn are 0)
extern "C" int completion_rot_launch(const float* x, const float* N,
                                     const void* Bc, const float* prev,
                                     const float* nxt, const float* taps,
                                     float* y, int q, int n, int sl, int nv,
                                     int hp, int hn, int ntaps,
                                     int start_clamp, int end_clamp,
                                     int nprod, void* stream) {
  return rot_launch(x, N, Bc, prev, nxt, taps, y, rf::Affine{}, 0, q, n, sl,
                    nv, hp, hn, ntaps, start_clamp, end_clamp, nprod,
                    (cudaStream_t)stream);
}

// coef = [a, c, b0..b3] (float32, on the card); aux0..aux{k-1} in y's
// (n * 128, q) layout, the rest unread
extern "C" int completion_rot_epi_launch(
    const float* x, const float* N, const void* Bc, const float* prev,
    const float* nxt, const float* taps, const float* aux0,
    const float* aux1, const float* aux2, const float* aux3,
    const float* coef, float* y, int q, int n, int sl, int nv, int hp,
    int hn, int ntaps, int start_clamp, int end_clamp, int k, int nprod,
    void* stream) {
  if (coef == nullptr) return (int)cudaErrorInvalidValue;
  return rot_launch(x, N, Bc, prev, nxt, taps, y,
                    rf::make_affine(aux0, aux1, aux2, aux3, coef), k, q, n,
                    sl, nv, hp, hn, ntaps, start_clamp, end_clamp, nprod,
                    (cudaStream_t)stream);
}

// x (q, n, 128) and y (n * 128, q) bf16, nprod 1, no stencil; the rest as
// completion_rot_launch
extern "C" int completion_rot_bf16_launch(const void* x, const float* N,
                                          const void* Bc, void* y, int q,
                                          int n, int sl, int nv, int nprod,
                                          void* stream) {
  return rot_launch_bf16(x, N, Bc, nullptr, nullptr, nullptr, y,
                         rf::Affine{}, 0, q, n, sl, nv, 0, 0, 0, 0, 0, nprod,
                         (cudaStream_t)stream);
}

// x, y bf16 as completion_rot_bf16_launch; the aux arrays float32 in y's
// layout, coef as completion_rot_epi_launch
extern "C" int completion_rot_epi_bf16_launch(
    const void* x, const float* N, const void* Bc, const float* aux0,
    const float* aux1, const float* aux2, const float* aux3,
    const float* coef, void* y, int q, int n, int sl, int nv, int k,
    int nprod, void* stream) {
  if (coef == nullptr) return (int)cudaErrorInvalidValue;
  return rot_launch_bf16(x, N, Bc, nullptr, nullptr, nullptr, y,
                         rf::make_affine(aux0, aux1, aux2, aux3, coef), k, q,
                         n, sl, nv, 0, 0, 0, 0, 0, nprod,
                         (cudaStream_t)stream);
}

// x (q, n, 128) and y (n * 128, q) bf16, nprod 1, with a stencil (ntaps
// >= 1); the rest as completion_rot_launch
extern "C" int completion_rot_stencil_bf16_launch(
    const void* x, const float* N, const void* Bc, const float* prev,
    const float* nxt, const float* taps, void* y, int q, int n, int sl,
    int nv, int hp, int hn, int ntaps, int start_clamp, int end_clamp,
    int nprod, void* stream) {
  if (ntaps < 1) return (int)cudaErrorInvalidValue;
  return rot_launch_bf16(x, N, Bc, prev, nxt, taps, y, rf::Affine{}, 0, q,
                         n, sl, nv, hp, hn, ntaps, start_clamp, end_clamp,
                         nprod, (cudaStream_t)stream);
}

// x, y bf16 as completion_rot_stencil_bf16_launch; the aux arrays float32
// in y's layout, coef as completion_rot_epi_launch
extern "C" int completion_rot_stencil_epi_bf16_launch(
    const void* x, const float* N, const void* Bc, const float* prev,
    const float* nxt, const float* taps, const float* aux0,
    const float* aux1, const float* aux2, const float* aux3,
    const float* coef, void* y, int q, int n, int sl, int nv, int hp,
    int hn, int ntaps, int start_clamp, int end_clamp, int k, int nprod,
    void* stream) {
  if (coef == nullptr || ntaps < 1) return (int)cudaErrorInvalidValue;
  return rot_launch_bf16(x, N, Bc, prev, nxt, taps, y,
                         rf::make_affine(aux0, aux1, aux2, aux3, coef), k, q,
                         n, sl, nv, hp, hn, ntaps, start_clamp, end_clamp,
                         nprod, (cudaStream_t)stream);
}

extern "C" const char* completion_rot_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
