// final2d_split.cuh: one tile of passes 2+3 of the 3-touch 2-D executor at
// the reduced precision grades (default, px3, px4) — final2d's products as
// split-bf16 tensor-core products. final2d_split.cu emits the tile (with
// an optional affine epilogue); final2d_stencil.cu runs it on a tile and
// its lane neighbours before its stencil bank.
//
// Per 128 x 128 tile (a, b) of image p, v(i) the tile's matrix variant
// (interior, first or last, final2d.cu's rule):
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
#pragma once

#include "common.cuh"
#include "split.cuh"

namespace f2s {

using rfs::bf16;
constexpr int T = rfs::T;
constexpr int SLOTS = 8;
constexpr int KP = 144;       // contraction: 128 + 8 carries, padded to 16
constexpr int LD = KP + 8;    // row stride of k-contiguous operands
constexpr int LDX = T + 8;    // row stride of x's k rows (n contiguous)
constexpr long CONST_CHUNK = (long)T * LD;  // elements per constant chunk
constexpr long DATA_CHUNK = (long)KP * LDX;  // >= T * LD: x, then Z

template <int NPROD>
__host__ __device__ constexpr int nc() {
  return rfs::nchunks(rfs::carry_nprod(NPROD));
}

template <int NPROD>
__host__ __device__ constexpr int smem_bytes() {
  return nc<NPROD>() * (int)(CONST_CHUNK + DATA_CHUNK) * (int)sizeof(bf16);
}

// f = Y of tile b of row tile pa = p * na + a (W = nb * 128 lanes), the
// variants va, vb already picked; smem holds smem_bytes<NPROD>() bytes. The
// block's threads all call it; it synchronises before it first writes
// shared memory, so calls may follow one another. x is float or bf16 (bf16
// storage, NPROD 1: eight values a 16-byte load, widened exactly, so the
// split — one chunk, the value itself — and every product are the float
// path's on the same values).
template <int NPROD, typename TX>
__device__ __forceinline__ void split_tile(
    rfs::Frag& f, const TX* __restrict__ x, const float* __restrict__ NA,
    const float* __restrict__ NB, const bf16* __restrict__ Ac,
    const bf16* __restrict__ Bc, void* smem, long pa, int b, int va, int vb,
    int nb) {
  constexpr int NC = nc<NPROD>();
  bf16* Cs = static_cast<bf16*>(smem);  // NC constant chunks
  bf16* Ds = Cs + NC * CONST_CHUNK;     // NC data chunks
  const int tid = threadIdx.x;
  const long W = (long)nb * T;

  // dim-A completion: Z = sum Ac_i [x; NA]_j (data as k rows, n columns)
  __syncthreads();
  rfs::copy16(Cs, Ac + (long)va * NC * CONST_CHUNK,
              NC * (int)CONST_CHUNK * (int)sizeof(bf16), tid);
  const TX* xt = x + pa * T * W + (long)b * T;
  const float* nat = NA + pa * SLOTS * W + (long)b * T;
  if constexpr (std::is_same<TX, float>::value) {
    for (int i = tid; i < (T + SLOTS) * (T / 4); i += rfs::THREADS) {
      const int k = i / (T / 4), c4 = i % (T / 4);
      const float4 v = k < T
          ? reinterpret_cast<const float4*>(xt + (long)k * W)[c4]
          : reinterpret_cast<const float4*>(nat + (long)(k - T) * W)[c4];
      rfs::split_store4<NC>(Ds + k * LDX + 4 * c4, DATA_CHUNK, v);
    }
  } else {
    for (int i = tid; i < T * (T / 8); i += rfs::THREADS) {
      const int k = i / (T / 8), c8 = i % (T / 8);
      float4 lo, hi;
      rf::widen8(reinterpret_cast<const uint4*>(xt + (long)k * W)[c8], lo,
                 hi);
      rfs::split_store4<NC>(Ds + k * LDX + 8 * c8, DATA_CHUNK, lo);
      rfs::split_store4<NC>(Ds + k * LDX + 8 * c8 + 4, DATA_CHUNK, hi);
    }
    for (int i = tid; i < SLOTS * (T / 4); i += rfs::THREADS) {
      const int k = T + i / (T / 4), c4 = i % (T / 4);
      rfs::split_store4<NC>(
          Ds + k * LDX + 4 * c4, DATA_CHUNK,
          reinterpret_cast<const float4*>(nat + (long)(k - T) * W)[c4]);
    }
  }
  for (int i = tid; i < (KP - T - SLOTS) * (T / 4); i += rfs::THREADS) {
    const int k = T + SLOTS + i / (T / 4), c4 = i % (T / 4);
    rfs::split_store4<NC>(Ds + k * LDX + 4 * c4, DATA_CHUNK,
                          make_float4(0.f, 0.f, 0.f, 0.f));
  }
  __syncthreads();
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
}

}  // namespace f2s
