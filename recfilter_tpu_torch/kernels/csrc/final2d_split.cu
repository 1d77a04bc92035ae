// final2d_split: passes 2+3 of the 3-touch 2-D executor at the reduced
// precision grades (default, px3, px4) — final2d's products as split-bf16
// tensor-core products.
//
// Replaces recfilter_tpu/kernels/final2d.py::final2d_px (Pallas kernel
// _final_px_kernel, mode 0) at nprod 1, 3 and 4. Per 128 x 128 tile
// (block (b, a, p)), v(i) the tile's matrix variant (interior, first or
// last, final2d.cu's rule):
//
//   Z = sum_(i,j) Ac_i[v(a)] * [x; NA]_j          (128 x 144 x 128)
//   Y = sum_(i,j) [Z; NB^T]_j * Bc_i[v(b)]^T       (128 x 144 x 128)
//
// over the NPROD chunk pairs (i, j) of split.cuh, smallest level first, on
// the 128 image rows and carry_nprod(NPROD) >= 3 pairs on the carry rows
// (kernels/split.py: one product on cancelling carry terms puts the 4096^2
// headline past the default grade's bound; the JAX kernel takes NPROD on
// both), fp32 accumulation on mma.sync m16n8k16. x and the dim-A carries
// NA are split into bf16 chunks as they are staged; Z is split again from
// the accumulators into shared memory, beside the dim-B carries NB (both
// carries arrive in fp32 from the float64 glue, as in the JAX kernel). Z
// never touches device memory.
//
// Operands (host-prepared once per module, every variant):
//   Ac (nva, NC, 128, LD) bf16: [Ba | Ra | 0] rows s, k contiguous
//   Bc (nvb, NC, 128, LD) bf16: [Bb | Rb | 0] rows o, k contiguous
// the 136-deep contraction (128 image rows + 8 carry slots) padded with
// zeros to 144, rows LD = 152 apart. Shared memory holds two regions: the
// constant's chunks (Ac, then Bc) and the data's (x and NA as k rows of
// 128 columns, then Z and NB as s rows of LD): NC x 77 KB with NC = 2
// chunks (the carry rows' grade) at every NPROD here, 156 KB.
//
// What bounds it: 2 x 2 x (128 NPROD + 8 carry_nprod) FLOP per pixel, 27.4
// GFLOP at 4096^2 and px3 on the bf16 tensor cores (989 TFLOP/s: 0.028
// ms), against 12 B/px of traffic (0.060 ms at 3.35 TB/s): at the card's
// peaks it is bound by bytes. This first kernel stages and
// computes in turn (no cp.async or TMA pipeline, no wgmma), one block a
// tile.

#include "split.cuh"

namespace {

using rfs::bf16;
constexpr int T = rfs::T;
constexpr int SLOTS = 8;
constexpr int KP = 144;       // contraction: 128 + 8 carries, padded to 16
constexpr int LD = KP + 8;    // row stride of k-contiguous operands
constexpr int LDX = T + 8;    // row stride of x's k rows (n contiguous)
constexpr long CONST_CHUNK = (long)T * LD;  // elements per constant chunk
constexpr long DATA_CHUNK = (long)KP * LDX;  // >= T * LD: x, then Z

__host__ __device__ constexpr int smem_bytes(int nc) {
  return nc * (int)(CONST_CHUNK + DATA_CHUNK) * (int)sizeof(bf16);
}

__device__ __forceinline__ int variant(int nv, int i, int n) {
  if (nv == 1) return 0;
  return i == 0 ? 1 : (i == n - 1 ? 2 : 0);
}

template <int NPROD>
__global__ void __launch_bounds__(rfs::THREADS, 1)
final2d_split_kernel(const float* __restrict__ x,   // (p, na, T, W)
                     const float* __restrict__ NA,  // (p, na, 8, W)
                     const float* __restrict__ NB,  // (p, na, nb*8, T)
                     const bf16* __restrict__ Ac,   // (nva, NC, T, LD)
                     const bf16* __restrict__ Bc,   // (nvb, NC, T, LD)
                     float* __restrict__ y,         // (p, na, T, W)
                     int na, int nb, int nva, int nvb) {
  constexpr int NC = rfs::nchunks(rfs::carry_nprod(NPROD));
  extern __shared__ uint4 smem16[];
  bf16* Cs = reinterpret_cast<bf16*>(smem16);  // NC constant chunks
  bf16* Ds = Cs + NC * CONST_CHUNK;            // NC data chunks

  const int b = blockIdx.x, a = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x;
  const long W = (long)nb * T;
  const long pa = (long)p * na + a;
  const int va = variant(nva, a, na), vb = variant(nvb, b, nb);

  // dim-A completion: Z = sum Ac_i [x; NA]_j (data as k rows, n columns)
  rfs::copy16(Cs, Ac + (long)va * NC * CONST_CHUNK,
              NC * (int)CONST_CHUNK * (int)sizeof(bf16), tid);
  const float* xt = x + pa * T * W + (long)b * T;
  const float* nat = NA + pa * SLOTS * W + (long)b * T;
  for (int i = tid; i < (T + SLOTS) * (T / 4); i += rfs::THREADS) {
    const int k = i / (T / 4), c4 = i % (T / 4);
    const float4 v = k < T
        ? reinterpret_cast<const float4*>(xt + (long)k * W)[c4]
        : reinterpret_cast<const float4*>(nat + (long)(k - T) * W)[c4];
    rfs::split_store4<NC>(Ds + k * LDX + 4 * c4, DATA_CHUNK, v);
  }
  for (int i = tid; i < (KP - T - SLOTS) * (T / 4); i += rfs::THREADS) {
    const int k = T + SLOTS + i / (T / 4), c4 = i % (T / 4);
    rfs::split_store4<NC>(Ds + k * LDX + 4 * c4, DATA_CHUNK,
                          make_float4(0.f, 0.f, 0.f, 0.f));
  }
  __syncthreads();
  rfs::Frag f;
  rfs::zero(f);
  rfs::split_mma_slabs<NPROD, true, true>(f, Cs, CONST_CHUNK, LD, Ds,
                                          DATA_CHUNK, LDX, T, KP);
  __syncthreads();

  // dim-B completion: Y = sum [Z; NB^T]_j Bc_i^T. Z's chunks go to shared
  // memory as s rows, k contiguous; never to device memory.
  rfs::for_pairs(f, [&](int s, int t, float v0, float v1) {
    rfs::split_store2<NC>(Ds + s * LD + t, DATA_CHUNK, v0, v1);
  });
  const float* nbt = NB + (pa * nb + b) * SLOTS * T;
  for (int i = tid; i < (KP - T) * T; i += rfs::THREADS) {
    const int k = i / T, s = i % T;
    rfs::split_store1<NC>(Ds + s * LD + T + k, DATA_CHUNK,
                          k < SLOTS ? nbt[(long)k * T + s] : 0.f);
  }
  rfs::copy16(Cs, Bc + (long)vb * NC * CONST_CHUNK,
              NC * (int)CONST_CHUNK * (int)sizeof(bf16), tid);
  __syncthreads();
  rfs::zero(f);
  rfs::split_mma_slabs<NPROD, false, false>(f, Ds, DATA_CHUNK, LD, Cs,
                                            CONST_CHUNK, LD, T, KP);

  float* yt = y + pa * T * W + (long)b * T;
  rfs::for_pairs(f, [&](int s, int o, float v0, float v1) {
    *reinterpret_cast<float2*>(yt + (long)s * W + o) = make_float2(v0, v1);
  });
}

template <int NPROD>
int launch(const float* x, const float* NA, const float* NB, const bf16* Ac,
           const bf16* Bc, float* y, int p, int na, int nb, int nva, int nvb,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes(rfs::nchunks(rfs::carry_nprod(NPROD)));
  cudaError_t err = cudaFuncSetAttribute(
      final2d_split_kernel<NPROD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, na, p);
  final2d_split_kernel<NPROD><<<grid, rfs::THREADS, smem, stream>>>(
      x, NA, NB, Ac, Bc, y, na, nb, nva, nvb);
  return (int)cudaGetLastError();
}

}  // namespace

// nprod in {1, 3, 4}; Ac, Bc from kernels/final2d.py's Final2DSplit
extern "C" int final2d_split_launch(const float* x, const float* NA,
                                    const float* NB, const void* Ac,
                                    const void* Bc, float* y, int p, int na,
                                    int nb, int nva, int nvb, int nprod,
                                    void* stream) {
  const bf16* A = static_cast<const bf16*>(Ac);
  const bf16* B = static_cast<const bf16*>(Bc);
  cudaStream_t s = (cudaStream_t)stream;
  switch (nprod) {
    case 1: return launch<1>(x, NA, NB, A, B, y, p, na, nb, nva, nvb, s);
    case 3: return launch<3>(x, NA, NB, A, B, y, p, na, nb, nva, nvb, s);
    case 4: return launch<4>(x, NA, NB, A, B, y, p, na, nb, nva, nvb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* final2d_split_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
