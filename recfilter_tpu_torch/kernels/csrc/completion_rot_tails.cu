// completion_rot_tails.cu: the rotated completion that also writes the next
// pass's local tails, at every grade — completion_rot_tails,
// completion_rot.cuh's completion_rot_tails_kernel<NPROD> (the header gives
// the design), replacing recfilter_tpu/kernels/completion.py::
// completion_pass(rot=True, nprod=NPROD, next_tails=) (_completion_kernel
// with kt > 0), the tails in fp64 in tails.cu's order where the JAX
// package splits them at the grade. sl = 8 (single-slot carries on both
// sides); q a multiple of n2 * 128. completion_rot_tails_bf16: the same at
// nprod 1 on a bf16 x and y, the tails from y's values as rounded to bf16
// (bf16 storage; 158.0 KB of shared memory, the x stages halved).
//
// What bounds it: 8 B of traffic per sample (and 8 * 4 / 128 B of tails
// writes) against 2 x (128 NPROD + S carry_nprod(NPROD)) bf16 operations
// and 2 * S2 fp64 operations — at the card's peaks, the bytes.
//
// Shared memory: B's chunks, two x stages of (64 * 144 + 8 * 68) * 4 B, a
// half tile (128 x 68 floats) and G2's rows (8 x 128 doubles): 231.7 KB at
// px6, 194.8 KB at the reduced grades.

#include "completion_rot.cuh"

namespace {

template <int NPROD, typename TX>
int rot_tails_launch(const TX* x, const float* N, const void* Bc,
                     const float* G2, TX* y, float* tails2, int q, int n,
                     int nv, int n2, int S2, int nv2, cudaStream_t stream) {
  constexpr int KP = T + 16, NC = rfw::b_chunks(NPROD);
  const long smem = (long)NC * T * KP * 2 +
                     4L * (2 * (xst<TX>() + 8 * LDNS) + T * LDZ) +
                     8L * 8 * T;
  if (smem > MAX_SMEM) return (int)cudaErrorLaunchOutOfResources;
  cudaError_t err = cudaFuncSetAttribute(
      completion_rot_tails_kernel<NPROD, TX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = rfp::persistent_grid(rfp::walk_groups(n, q / T, nv, 1));
  completion_rot_tails_kernel<NPROD, TX>
      <<<grid, 2 * rfw::WG, (int)smem, stream>>>(
          x, N, static_cast<const rfs::bf16*>(Bc), G2, y, tails2, q, n, nv,
          n2, S2, nv2);
  return (int)cudaGetLastError();
}

bool rot_tails_ok(int q, int n, int sl, int nv, int n2, int S2, int nv2) {
  return !(sl != 8 || n < 1 || n2 < 1 || S2 < 1 || S2 > 8 || q < 1 ||
           q % (n2 * T) || (nv != 1 && nv != 3) || (nv2 != 1 && nv2 != 3));
}

}  // namespace

// Bc: kernels/completion.py's CompletionPass.Bc_k, (nv, b_chunks(nprod),
// 128 * 144) bf16; G2 (nv2, 8, 128) float32, rows S2.. zeros; tails2 (n2,
// 8, n * 128 * ra)
extern "C" int completion_rot_tails_launch(
    const float* x, const float* N, const void* Bc, const float* G2,
    float* y, float* tails2, int q, int n, int sl, int nv, int n2, int S2,
    int nv2, int nprod, void* stream) {
  if (!rot_tails_ok(q, n, sl, nv, n2, S2, nv2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nprod) {
    case 1:
      return rot_tails_launch<1>(x, N, Bc, G2, y, tails2, q, n, nv, n2, S2,
                                 nv2, s);
    case 3:
      return rot_tails_launch<3>(x, N, Bc, G2, y, tails2, q, n, nv, n2, S2,
                                 nv2, s);
    case 4:
      return rot_tails_launch<4>(x, N, Bc, G2, y, tails2, q, n, nv, n2, S2,
                                 nv2, s);
    case 6:
      return rot_tails_launch<6>(x, N, Bc, G2, y, tails2, q, n, nv, n2, S2,
                                 nv2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x (q, n, 128) and y (n * 128, q) bf16, nprod 1; the tails from y's values
// as rounded to bf16 (float32); the rest as completion_rot_tails_launch
extern "C" int completion_rot_tails_bf16_launch(
    const void* x, const float* N, const void* Bc, const float* G2, void* y,
    float* tails2, int q, int n, int sl, int nv, int n2, int S2, int nv2,
    int nprod, void* stream) {
  if (nprod != 1 || !rot_tails_ok(q, n, sl, nv, n2, S2, nv2))
    return (int)cudaErrorInvalidValue;
  return rot_tails_launch<1>(static_cast<const rf::bf16*>(x), N, Bc, G2,
                             static_cast<rf::bf16*>(y), tails2, q, n, nv, n2,
                             S2, nv2, (cudaStream_t)stream);
}

extern "C" const char* completion_rot_tails_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
