// bsolve: the dim-B carry glue of the 3-touch 2-D executor and its solve,
// in one launch.
//
// Replaces recfilter_tpu/kernels/final2d.py::bsolve_pass (Pallas kernel
// _bsolve_kernel), which overlap2d.fused_2d_px takes with
// RECFILTER_PX2D_BK=1. Per (p, a), from the solved dim-A carries NA (8
// slot rows, Ka of them real, W = nb*T lanes) and the moments kernel's
// term1 fold (nb slot groups of 8 rows, T columns), with M = nb*Kb real
// dim-B carries q = (b, k):
//
//   GN[q, j]  = sum_t Gb_v(b)[k, t] * NA[j, b*T + t]             j < Ka
//   bB[q, o]  = term1[b*8 + k, o] + sum_j Ra_v(a)[o, j] * GN[q, j]
//   NB[r, o]  = sum_q CM[r, q] * bB[q, o]                          r < M
//
// written into the final kernel's slot-padded (p, na, nb*8, T) layout,
// zeros in the pad slots (rows k >= Kb of each slot group). CM is the real
// (M x M) block of the padded solve matrix: its pad columns meet term1's
// rows k >= Kb, which the kernel never reads, and its pad rows are the
// zero pad slots.
//
// What bounds it: the solve, M^2 * T fp64 MACs per (p, a) (4.7 M at
// 4096^2 with Kb = 6; 0.32 GFLOP with GN and the coupling over the 32
// (p, a)), against 12.9 MB of NA, term1, NB and CM: 0.0048 ms at the
// card's 67 TFLOP/s of fp64, above the bytes' 0.0039 ms. The TPU kernel
// multiplies a block-diagonal G (97 % zeros at nb = 32) and a padded
// (nb*8)^2 matrix; here each b is its own small product and only real
// rows enter. The grid (T/C, na, p) splits the T columns of each (p, a)
// over blocks (128 blocks at 4096^2 on 132 SMs; 16 or 8 columns a block,
// more blocks, measured slower: tests/torch_carry_study.py), and each
// block computes the small GN again, one carry a thread. CM (295 KB in
// fp64 at nb = 32, stored transposed, [q][r]) passes through shared
// memory in 48 KB chunks of rows, each loaded by the whole block at once
// with coalesced loads; the bB block (M x C fp64) sits in shared memory,
// and each thread owns one row of the C-column output, 32 independent
// FMAs for every CM entry it reads. (Read from L2 inside the row loop,
// CM's load latency bound the kernel: 0.09 ms at 4096^2.)
//
// Everything runs in fp64 from fp32 NA and term1, as the port's glue does:
// fp32 glue misses the px6 bound (ROADMAP, queue 3).

#include <cuda_runtime.h>

namespace {

constexpr int T = 128;        // tile edge, Ta = Tb
constexpr int SLOTS = 8;      // carry rows per slot
constexpr int THREADS = 256;
constexpr int C = 32;         // output columns a block
constexpr int MAX_SMEM = 232448;
constexpr long CHUNK_BYTES = 48 * 1024;  // the staged rows of CM

__device__ __forceinline__ int variant(int nv, int i, int n) {
  if (nv == 1) return 0;
  return i == 0 ? 1 : (i == n - 1 ? 2 : 0);
}

__global__ void __launch_bounds__(THREADS)
bsolve_kernel(const float* __restrict__ NA,     // (p, na, 8, W)
              const float* __restrict__ term1,  // (p, na, nb*8, T)
              const double* __restrict__ Gb,    // (nvb, Kb, T)
              const double* __restrict__ RaT,   // (nva, Ka, T): [j][o]
              const double* __restrict__ CMT,   // (M, M): [q][r]
              float* __restrict__ NB,           // (p, na, nb*8, T)
              int na, int nb, int Ka, int Kb, int nva, int nvb, int QC) {
  extern __shared__ double smem[];
  const int M = nb * Kb;
  double* gn = smem;            // M x 8: GN[q][j]
  double* bb = gn + M * SLOTS;  // M x C: bB[q][c]
  double* ra = bb + M * C;      // 8 x C: Ra_v(a)[c0 + c][j] at [j][c]
  double* cms = ra + SLOTS * C;  // QC x M: a chunk of CMT's rows

  const int c0 = blockIdx.x * C, a = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x;
  const long W = (long)nb * T;
  const long pa = (long)p * na + a;
  const int va = variant(nva, a, na);

  for (int i = tid; i < SLOTS * C; i += THREADS) {
    const int j = i / C, c = i % C;
    ra[i] = j < Ka ? RaT[((long)va * Ka + j) * T + c0 + c] : 0.0;
  }

  // GN: one real carry q = (b, k) a thread, all Ka carries j of NA; the
  // t loop unrolled so that eight steps' loads are in flight at once
  const float* nap = NA + pa * SLOTS * W;
  for (int q = tid; q < M; q += THREADS) {
    const int b = q / Kb, k = q % Kb;
    const double* g = Gb + ((long)variant(nvb, b, nb) * Kb + k) * T;
    const float* nr = nap + (long)b * T;
    double acc[SLOTS];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) acc[j] = 0.0;
#pragma unroll 8
    for (int t = 0; t < T; ++t) {
      const double gv = __ldg(g + t);
#pragma unroll
      for (int j = 0; j < SLOTS; ++j)
        if (j < Ka) acc[j] = fma(gv, (double)__ldg(nr + j * W + t), acc[j]);
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) gn[q * SLOTS + j] = acc[j];
  }
  __syncthreads();

  // bB for this block's C columns: term1 plus the dim-A coupling
  const long slab = pa * nb * SLOTS * T;  // this (p, a)'s term1 / NB rows
  const float* t1 = term1 + slab + c0;
  for (int i = tid; i < M * C; i += THREADS) {
    const int q = i / C, c = i % C;
    const int b = q / Kb, k = q % Kb;
    double v = t1[(long)(b * SLOTS + k) * T + c];
    for (int j = 0; j < Ka; ++j) v = fma(ra[j * C + c], gn[q * SLOTS + j], v);
    bb[i] = v;
  }

  // the solve: row r of CM times the bB block, C columns a thread, CM
  // staged through shared memory QC rows of CMT at a time (coalesced
  // loads, all in flight together, then shared reads at shared latency)
  float* nbp = NB + slab + c0;
  for (int r0 = 0; r0 < M; r0 += THREADS) {
    const int r = r0 + tid;
    double acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0;
    for (int q0 = 0; q0 < M; q0 += QC) {
      const int qn = M - q0 < QC ? M - q0 : QC;
      __syncthreads();  // bB written; the previous chunk consumed
      const double* src = CMT + (long)q0 * M;
      for (int i = tid; i < qn * M; i += THREADS) cms[i] = src[i];
      __syncthreads();
      if (r < M) {
        for (int q = 0; q < qn; ++q) {
          const double cm = cms[q * M + r];
          const double2* row =
              reinterpret_cast<const double2*>(bb + (q0 + q) * C);
#pragma unroll
          for (int c2 = 0; c2 < C / 2; ++c2) {
            const double2 v = row[c2];
            acc[2 * c2] = fma(cm, v.x, acc[2 * c2]);
            acc[2 * c2 + 1] = fma(cm, v.y, acc[2 * c2 + 1]);
          }
        }
      }
    }
    if (r < M) {
      const int b = r / Kb, k = r % Kb;
      float4* dst =
          reinterpret_cast<float4*>(nbp + (long)(b * SLOTS + k) * T);
#pragma unroll
      for (int c4 = 0; c4 < C / 4; ++c4)
        dst[c4] = make_float4((float)acc[4 * c4], (float)acc[4 * c4 + 1],
                              (float)acc[4 * c4 + 2], (float)acc[4 * c4 + 3]);
    }
  }
  // the pad slots
  const int pad = SLOTS - Kb;
  for (int i = tid; i < nb * pad * C; i += THREADS) {
    const int c = i % C, bk = i / C;
    const int b = bk / pad, k = Kb + bk % pad;
    nbp[(long)(b * SLOTS + k) * T + c] = 0.f;
  }
}

}  // namespace

// Ka, Kb in [1, 8]; M = nb*Kb bounded by shared memory (M*(8 + C)*8 bytes
// and at least one row of CM beside them)
extern "C" int bsolve_launch(const float* NA, const float* term1,
                             const double* Gb, const double* RaT,
                             const double* CMT, float* NB, int p, int na,
                             int nb, int Ka, int Kb, int nva, int nvb,
                             void* stream) {
  if (Ka < 1 || Ka > SLOTS || Kb < 1 || Kb > SLOTS || nb < 1)
    return (int)cudaErrorInvalidValue;
  const long M = (long)nb * Kb;
  const long fixed = (M * (SLOTS + C) + SLOTS * C) * (long)sizeof(double);
  const long row = M * (long)sizeof(double);
  long QC = (CHUNK_BYTES < MAX_SMEM - fixed ? CHUNK_BYTES : MAX_SMEM - fixed)
            / row;
  if (QC < 1) return (int)cudaErrorInvalidValue;
  if (QC > M) QC = M;
  const long smem = fixed + QC * row;
  cudaError_t err = cudaFuncSetAttribute(
      bsolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(T / C, na, p);
  bsolve_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      NA, term1, Gb, RaT, CMT, NB, na, nb, Ka, Kb, nva, nvb, (int)QC);
  return (int)cudaGetLastError();
}

extern "C" const char* bsolve_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
