// gemm_pair: the int8 / bf16 rate probe of scripts/int8_rate_probe.py as
// an H100 study — one GEMM tiling, two products:
//
//   C[m][n] = sum_k A[m][k] * Bt[n][k]       (A (M, K), Bt (N, K))
//
// Replaces, as studies (not on any executor's path):
//   scripts/int8_rate_probe.py:53  f_int8_pl (kernel k_int8) -> gemm_i8
//   scripts/int8_rate_probe.py:77  f_bf16_pl (kernel k_bf16) -> gemm_bf16
//
// gemm_i8: int8 x int8 -> int32 sums on mma.sync m16n8k32, stored as
// (sum >> 13) truncated to int8 (raw = 1: the int32 sums). gemm_bf16: bf16
// x bf16 -> fp32 sums on mma.sync m16n8k16, stored bf16. The pair differs
// in the product only: 128 x 128 output tiles, 256 threads (eight warps of
// 64 x 32), K in steps of 64 bytes (32 bf16 or 64 int8) staged through a
// four-stage cp.async ring in shared memory (rows 80 bytes apart: the
// eight 16-byte rows an ldmatrix reads fall in distinct banks), so each
// step loads the same bytes and issues the same number of mma.sync, and
// the int8 product does twice the operations per instruction. The probe's
// 512 x 512 VMEM block is a TPU shape; this tiling keeps two blocks on an
// SM (80 KB of shared memory each) and 1024 blocks in flight at 4096^3.
//
// What bounds them at 4096^3: 137.4 G operations, at 1979 int8 TOPS
// (0.0694 ms) and 989 bf16 TFLOP/s (0.139 ms), against 50 MB of traffic
// (0.015 ms). mma.sync reaches only part of Hopper's tensor-core rate
// (wgmma, the rest, is a later redesign's tool); the ratio of the two
// times is what the study reads.

#include <stdint.h>

#include "split.cuh"

namespace {

constexpr int BM = 128, BN = 128;
constexpr int BK = 64;            // bytes of K a stage
constexpr int LDS = BK + 16;      // bytes per staged row
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int SMEM = STAGES * (BM + BN) * LDS;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   rfs::smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(rfs::smem_addr(p)));
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  rfs::mma_bf16(d, a, b0, b1);
}

__device__ __forceinline__ void store(int8_t* C, long i, int v0, int v1,
                                      int raw) {
  if (raw) {
    *reinterpret_cast<int2*>(reinterpret_cast<int*>(C) + i) =
        make_int2(v0, v1);
  } else {
    *reinterpret_cast<uint16_t*>(C + i) =
        (uint16_t)((uint8_t)(v0 >> 13) | ((uint8_t)(v1 >> 13) << 8));
  }
}
__device__ __forceinline__ void store(rfs::bf16* C, long i, float v0,
                                      float v1, int) {
  *reinterpret_cast<__nv_bfloat162*>(C + i) = __floats2bfloat162_rn(v0, v1);
}

// Acc: int (int8 products) or float (bf16); Out: int8_t or bf16.
template <typename Acc, typename Out>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ Bt,
            Out* __restrict__ C, int N, int Kb, int raw) {
  extern __shared__ uint4 smem16[];
  uint8_t* sA = reinterpret_cast<uint8_t*>(smem16);
  uint8_t* sB = sA + STAGES * BM * LDS;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const uint8_t* Ab = A + (long)blockIdx.y * BM * Kb;
  const uint8_t* Bb = Bt + (long)blockIdx.x * BN * Kb;
  const int KT = Kb / BK;

  auto load = [&](int stage, int kt) {
    for (int i = tid; i < BM * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), c = i % (BK / 16);
      cp_async16(sA + (stage * BM + r) * LDS + 16 * c,
                 Ab + (long)r * Kb + (long)kt * BK + 16 * c);
      cp_async16(sB + (stage * BN + r) * LDS + 16 * c,
                 Bb + (long)r * Kb + (long)kt * BK + 16 * c);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }

  Acc acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
  const int m0 = (warp % 2) * 64, n0 = (warp / 2) * 32;
  const int a_off = (m0 + lane % 16) * LDS + (lane / 16) * 16;
  const int b_off =
      (n0 + (lane % 8) + (lane / 16) * 8) * LDS + ((lane / 8) % 2) * 16;

#pragma unroll 1
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(nk % STAGES, nk);
    cp_async_commit();
    const uint8_t* a = sA + (kt % STAGES) * BM * LDS + a_off;
    const uint8_t* b = sB + (kt % STAGES) * BN * LDS + b_off;
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 32) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldsm_x4(af[mi], a + mi * 16 * LDS + k0);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) ldsm_x4(bfr[nj], b + nj * 16 * LDS + k0);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(acc[mi][ni], af[mi], bfr[ni / 2][2 * (ni % 2)],
              bfr[ni / 2][2 * (ni % 2) + 1]);
    }
  }
  cp_async_wait<0>();

  const long row0 = (long)blockIdx.y * BM + m0 + lane / 4;
  const int col0 = blockIdx.x * BN + n0 + 2 * (lane % 4);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store(C, (row0 + mi * 16 + 8 * h) * N + col0 + ni * 8,
              acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1], raw);
}

template <typename Acc, typename Out>
int launch(const void* A, const void* Bt, void* C, int M, int N, int Kb,
           int raw, cudaStream_t s) {
  if (M <= 0 || N <= 0 || M % BM || N % BN || Kb <= 0 || Kb % BK ||
      M / BM >= 65536)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<Acc, Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return (int)err;
  gemm_kernel<Acc, Out><<<dim3(N / BN, M / BM), THREADS, SMEM, s>>>(
      static_cast<const uint8_t*>(A), static_cast<const uint8_t*>(Bt),
      static_cast<Out*>(C), N, Kb, raw);
  return (int)cudaGetLastError();
}

}  // namespace

// A (M, K), Bt (N, K) int8; C (M, N) int8, or int32 sums with raw = 1.
extern "C" int gemm_i8_launch(const void* A, const void* Bt, void* C, int M,
                              int N, int K, int raw, void* stream) {
  return launch<int, int8_t>(A, Bt, C, M, N, K, raw, (cudaStream_t)stream);
}

// A (M, K), Bt (N, K) bf16; C (M, N) bf16.
extern "C" int gemm_bf16_launch(const void* A, const void* Bt, void* C,
                                int M, int N, int K, void* stream) {
  return launch<float, rfs::bf16>(A, Bt, C, M, N, 2 * K, 0,
                                  (cudaStream_t)stream);
}

extern "C" const char* gemm_pair_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
