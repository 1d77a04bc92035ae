// rows_final: completion of a scan along a non-last axis — the rows pass's
// second read of the array, and its only write.
//
// Replaces recfilter_tpu/kernels/final2d.py::rows_final_px (Pallas kernel
// _rows_final_kernel). Per 128 x 128 tile of x (p, n, T, W) (block
// (l, a, p)), with v(a) the tile's matrix variant along the scanned axis
// (interior, first or last):
//
//   y[p,a,:, tile] = Btot_v(a) * x[p,a,:, tile] + Rhat_v(a)[:, :8] * N[p,a,:, tile]
//
// with N (p, n, 8, W) the solved, slot-padded carries. It is the first
// product of final2d.cu on its own: one 128 x 136 x 128 GEMM on the shared
// routine of common.cuh, the 8 carry rows appended to the 128-deep
// contraction, the output written straight from registers.
//
// What bounds it: 136 MACs per element (272 FLOP) against 12 B of traffic
// (x read, y written, the carries 1/16 of that), so on the H100's fp32 CUDA
// cores it is bound by arithmetic. The design is final2d.cu's plain
// register-tiled SIMT GEMM: A1 = [Btot^T; Rhat^T] (136 x 128, prepared on
// the host per variant) and [x tile; N rows] staged whole in shared memory,
// each of 256 threads holding an 8 x 8 block of the output. fp32 FMA; no
// wgmma, TMA or TF32 yet. The TPU kernel's bf16 chunk splitting emulates
// fp32 products on the TPU matrix unit and has no counterpart here.

#include "common.cuh"

namespace {

constexpr int T = rf::GT;      // tile edge
constexpr int SLOTS = 8;       // carry rows per slot
constexpr int KX = T + SLOTS;  // contraction depth: 128 rows + 8 carries
constexpr int THREADS = rf::GEMM_THREADS;
constexpr int SMEM_BYTES = 2 * KX * T * sizeof(float);

using rf::gemm_tile;
using rf::row_of;
using rf::stage_rows;
using rf::variant;

__global__ void __launch_bounds__(THREADS, 1)
rows_final_kernel(const float* __restrict__ x,   // (p, n, T, W)
                  const float* __restrict__ N,   // (p, n, 8, W)
                  const float* __restrict__ A1,  // (nv, KX, T)
                  float* __restrict__ y,         // (p, n, T, W)
                  int n, int nl, int nv) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // KX x T
  float* Bs = As + KX * T;                      // KX x T

  const int l = blockIdx.x, a = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long W = (long)nl * T;
  const long pa = (long)p * n + a;

  // Y = [Btot^T; Rhat^T]^T [x; N]
  stage_rows(As, A1 + (long)variant(nv, a, n) * KX * T, KX, T, tid);
  stage_rows(Bs, x + pa * T * W + (long)l * T, T, W, tid);
  stage_rows(Bs + T * T, N + pa * SLOTS * W + (long)l * T, SLOTS, W, tid);
  __syncthreads();
  float c[8][8];
  gemm_tile(As, Bs, c, ty, tx, KX);

  float* yt = y + pa * T * W + (long)l * T;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* yr = yt + (long)row_of(i, ty) * W;
    *reinterpret_cast<float4*>(yr + tx * 4) =
        make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
    *reinterpret_cast<float4*>(yr + 64 + tx * 4) =
        make_float4(c[i][4], c[i][5], c[i][6], c[i][7]);
  }
}

}  // namespace

extern "C" int rows_final_launch(const float* x, const float* N,
                                 const float* A1, float* y, int p, int n,
                                 int nl, int nv, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rows_final_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nl, n, p);
  rows_final_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, N, A1, y, n, nl, nv);
  return (int)cudaGetLastError();
}

extern "C" const char* rows_final_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
