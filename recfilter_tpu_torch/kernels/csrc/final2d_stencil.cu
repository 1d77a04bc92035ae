// final2d_stencil: passes 2+3 of the 3-touch 2-D executor with a fused
// 2-D stencil consumer — read the image once, complete both dimensions on
// chip, and write C channels of shifted-tap banks over the completed
// output, which itself never reaches device memory.
//
// Replaces recfilter_tpu/kernels/final2d.py::_final2d_px_stencil (Pallas
// kernel _final_px_stencil_kernel) at nprod 6 (px6) and, with the split
// body below, at 1, 3 and 4. Per 128 x 128 tile (block (p, a, b)):
//
//   1. Y = the tile's dual completion, exactly as final2d.cu computes it
//      (two register-tiled fp32 GEMMs, Z in shared memory).
//   2. The columns of the lane neighbours that the column taps read: the
//      last dxl columns of tile b-1 and the first dxr of tile b+1. Only
//      those columns are completed, re-associated so that no neighbour Z
//      is formed:  Y_nb[:, O] = A1^T (Xext * B2[:, O]) + NB^T B2[128:, O],
//      Xext = [x_nb; NA_nb]. That is 2 * 136 * 128 MACs per column (the
//      TPU kernel completes whole 128-wide neighbour sub-tiles per
//      2048-lane block: +12.5 % there, but +200 % with one tile a block).
//   3. The rows above and below come from the row-halo strips ht/hb
//      (p, na, h8, W): the neighbour tiles' edge rows, completed in both
//      dimensions by the f64 glue from the moments kernel's edge partials
//      (overlap2d.Fused2DPx.halo_strips). They cover every column, so the
//      corner regions read them too.
//   4. For each channel c and output pixel (s, o):
//        out[c][s, o] = sum_taps coeff * v(s + dy, o + dx)
//      with the JAX package's border rule: at the last row tile a dy > 0
//      read clamps to the last row, then at the last column tile a dx > 0
//      read clamps to the last column; negative offsets past the first
//      tile read zero. Products then sums, each rounded, in tap order (the
//      twin's order).
//
// What bounds it: the two GEMMs, 2 x 136 MACs per pixel, as final2d.cu
// (bound by fp32 arithmetic); the neighbour columns add 2*(dxl+dxr)*136/
// (2*128*136) of that, and the taps 2 FLOP each per pixel and channel.
// Traffic: x, the carries and the halo strips in, C outputs out.
// Shared memory: the GEMMs' 2 x 136 x 128 floats, then over the same space
// M = the tile with its neighbour columns (128 x (dxl + 128 + dxr) floats)
// and the side columns' work area: two 136 x 8 blocks, and where they fit
// the tile's A1 and the neighbour's [x; NA] (136 x 128 each: both up to
// dxl + dxr = 31, A1 up to 167). The taps sit in shared memory too (up to
// 128 taps, 8 channels). The tap phase keeps each thread's 64 sums in
// registers, the taps outermost.
//
// Operand layouts as final2d.cu:
//   A1 (nva, 136, 128) = [Ba^T ; Ra^T]      B2 (nvb, 136, 128) = [Bb^T ; Rb^T]
//   taps (ntaps, 3) = (dy, dx, coeff) by channel, toff (C + 1) offsets
//
// The reduced grades (nprod 1, 3, 4: default, px3, px4). Step 1 is
// final2d_split's tile (final2d_split.cuh: split-bf16 products on mma.sync,
// carry rows at carry_nprod >= 3, Ac and Bc its host-split operands), and
// so is step 2: the lane neighbours' columns are those of tiles b - 1 and
// b + 1 as final2d_split computes them whole, the same instructions on the
// same operands, so the value the bank reads across a seam is the value
// that neighbour tile emits (the JAX kernel's subtile_y). That is three
// tiles' products a block where a neighbour is read (the simple form).
// Steps 3 and 4 are the px6 kernel's, shared (bank_taps). Shared memory:
// the products' 156 KB, then over the same space M (the tile with its
// neighbour columns, up to 192 KB); the neighbour columns themselves,
// computed while the products hold shared memory, wait in a device-memory
// scratch (128 x (dxl + dxr) floats a tile) that the block reads back.
//
// bf16 storage (final2d_stencil_bf16: _final2d_px_stencil on a bf16 x at
// nprod 1, the JAX package's bf16 mode): x is read as bf16 into the one
// data chunk (final2d_split.cuh's split_tile, as final2d_split_bf16 reads
// it) for the block's tile and for both lane neighbours, so a neighbour
// column is the value that tile's own block emits; the scratch `side`, M
// and the taps stay fp32, and each bank value is rounded once to bf16
// after its taps (2 B of x read and 2*C B written per pixel).

#include "common.cuh"
#include "final2d_split.cuh"

namespace {

constexpr int T = rf::GT;      // tile edge, Ta = Tb
constexpr int SLOTS = 8;       // carry rows per slot
constexpr int KX = T + SLOTS;  // contraction depth: 128 image rows + 8 carries
constexpr int THREADS = rf::GEMM_THREADS;
constexpr int JC = 8;          // neighbour columns per pass
constexpr int MAX_REACH = 128;
constexpr int MAX_TAPS = 128;  // taps staged in shared memory (else read
constexpr int MAX_C = 8;       //   from device memory)
constexpr int MAX_SMEM = 224 * 1024;  // dynamic, beside the static taps

using rf::gemm_tile;
using rf::row_of;
using rf::stage_rows;
using rf::variant;

// M[s][mcol0 + j] = Y_nb[s][o0 + j], j < cnt: columns of the completed
// neighbour tile bn (same row tile a), without forming its Z. The work
// area holds Bsel and U and, where they fit beside M (`stage` bit 1, bit
// 0), the tile's A1 and the neighbour's Xext = [x_nb; NA_nb]; what does
// not fit is read from device memory (through L1 and L2).
__device__ void side_columns(const float* __restrict__ x,
                             const float* __restrict__ NA,
                             const float* __restrict__ NB,
                             const float* __restrict__ A1v,
                             const float* __restrict__ B2, float* M, int WM,
                             int mcol0, int o0, int cnt, float* work,
                             int stage, long pa, long W, int bn, int nb,
                             int nvb, int tid) {
  const float* B2v = B2 + (long)variant(nvb, bn, nb) * KX * T;
  const float* xt = x + pa * T * W + (long)bn * T;     // rows s, stride W
  const float* nat = NA + pa * SLOTS * W + (long)bn * T;
  const float* nbt = NB + (pa * nb + bn) * SLOTS * T;  // rows k, cols s
  const bool sx = stage & 1, sa = stage & 2;
  float* Xs = work;                         // KX x T, where staged
  float* As = Xs + (sx ? KX * T : 0);       // KX x T, where staged
  float* Bsel = As + (sa ? KX * T : 0);     // KX x JC: B2v[kk][o0 + j]
  float* U = Bsel + KX * JC;                // KX x JC: Xext * Bsel
  if (sx) {
    stage_rows(Xs, xt, T, W, tid);
    stage_rows(Xs + T * T, nat, SLOTS, W, tid);
  }
  if (sa) stage_rows(As, A1v, KX, T, tid);
  const float* A = sa ? As : A1v;
  for (int j0 = 0; j0 < cnt; j0 += JC) {
    const int jn = min(JC, cnt - j0);
    for (int i = tid; i < KX * JC; i += THREADS) {
      const int kk = i / JC, j = i % JC;
      Bsel[i] = j < jn ? B2v[kk * T + o0 + j0 + j] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < KX * JC; i += THREADS) {
      const int kk = i / JC, j = i % JC;
      const float* row = sx ? Xs + kk * T
                            : (kk < T ? xt + kk * W : nat + (kk - T) * W);
      float acc = 0.f;
#pragma unroll 8
      for (int t = 0; t < T; ++t) acc = fmaf(row[t], Bsel[t * JC + j], acc);
      U[i] = acc;
    }
    __syncthreads();
    for (int i = tid; i < T * JC; i += THREADS) {
      const int s = i % T, j = i / T;
      if (j < jn) {
        float acc = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < KX; ++kk)
          acc = fmaf(A[kk * T + s], U[kk * JC + j], acc);
        for (int k = 0; k < SLOTS; ++k)
          acc = fmaf(__ldg(nbt + k * T + s), Bsel[(T + k) * JC + j], acc);
        M[s * WM + mcol0 + j0 + j] = acc;
      }
    }
    __syncthreads();
  }
}

// Steps 3-4: every channel's taps over M (the tile's Y at columns
// dxl .. dxl + 127, its neighbour columns either side, row stride WM);
// rows outside the tile from the halo strips. The taps are staged in
// shared memory where they fit. A thread owns column o of rows s0, s0 + 2,
// ...: its 64 sums stay in registers while the taps run in order, and a
// warp shares its row.
// TO: the banks' type, float or bf16 (each value rounded once)
template <typename TO>
__device__ __forceinline__ void bank_taps(
    const float* M, int WM, int dxl, const float* __restrict__ ht,
    const float* __restrict__ hb, const float* __restrict__ taps,
    const int* __restrict__ toff, int ntaps, TO* __restrict__ out,
    long pa, int a, int na, int b, int nb, int h8, int C, int tid) {
  __shared__ float tsm[3 * MAX_TAPS];
  __shared__ int toffs[MAX_C + 1];
  const bool tfit = ntaps <= MAX_TAPS && C <= MAX_C;
  if (tfit) {
    for (int i = tid; i < 3 * ntaps; i += THREADS) tsm[i] = taps[i];
    for (int i = tid; i <= C; i += THREADS) toffs[i] = toff[i];
  }
  __syncthreads();
  const float* tp = tfit ? tsm : taps;
  const int* to = tfit ? toffs : toff;
  const long W = (long)nb * T;
  const float* htp = ht + pa * h8 * W;
  const float* hbp = hb + pa * h8 * W;
  const long plane = (long)gridDim.z * na * T * W;
  const int o = tid % T, s0 = tid / T;
  for (int ch = 0; ch < C; ++ch) {
    float acc[T / 2];
    const int k0 = to[ch], k1 = to[ch + 1];
    for (int k = k0; k < k1; ++k) {
      const int dy = (int)tp[3 * k], dx = (int)tp[3 * k + 1];
      const float cf = tp[3 * k + 2];
      int cc = o + dx;
      if (dx > 0 && b == nb - 1 && cc > T - 1) cc = T - 1;
      const long gc = (long)b * T + cc;
#pragma unroll
      for (int j = 0; j < T / 2; ++j) {
        int r = s0 + 2 * j + dy;
        if (dy > 0 && a == na - 1 && r > T - 1) r = T - 1;
        float v;
        if (r >= 0 && r < T)
          v = M[r * WM + dxl + cc];
        else if (gc < 0)
          v = 0.f;
        else if (r < 0)
          v = a > 0 ? htp[(h8 + r) * W + gc] : 0.f;
        else
          v = a < na - 1 ? hbp[(r - T) * W + gc] : 0.f;
        const float term = __fmul_rn(cf, v);
        acc[j] = k == k0 ? term : __fadd_rn(acc[j], term);
      }
    }
    TO* oc = out + ch * plane + pa * T * W + (long)b * T + o;
#pragma unroll
    for (int j = 0; j < T / 2; ++j)
      rf::store1(oc + (long)(s0 + 2 * j) * W, acc[j]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
final2d_stencil_kernel(const float* __restrict__ x,     // (p, na, T, W)
                       const float* __restrict__ NA,    // (p, na, 8, W)
                       const float* __restrict__ NB,    // (p, na, nb*8, T)
                       const float* __restrict__ A1,    // (nva, KX, T)
                       const float* __restrict__ B2,    // (nvb, KX, T)
                       const float* __restrict__ ht,    // (p, na, h8, W)
                       const float* __restrict__ hb,    // (p, na, h8, W)
                       const float* __restrict__ taps,  // (ntaps, 3)
                       const int* __restrict__ toff,    // (C + 1)
                       float* __restrict__ out,         // (C, p, na, T, W)
                       int na, int nb, int nva, int nvb, int h8, int dxl,
                       int dxr, int C, int ntaps, int stage) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // KX x T
  float* Bs = As + KX * T;                      // KX x T

  const int b = blockIdx.x, a = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long W = (long)nb * T;
  const long pa = (long)p * na + a;
  const int va = variant(nva, a, na), vb = variant(nvb, b, nb);

  // 1. the tile's dual completion (final2d.cu)
  stage_rows(As, A1 + (long)va * KX * T, KX, T, tid);
  stage_rows(Bs, x + pa * T * W + (long)b * T, T, W, tid);
  stage_rows(Bs + T * T, NA + pa * SLOTS * W + (long)b * T, SLOTS, W, tid);
  __syncthreads();
  float c[8][8];
  gemm_tile(As, Bs, c, ty, tx, KX);
  __syncthreads();
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
  __syncthreads();

  // 2. M = [left columns | the tile | right columns], rows s < T
  const int WM = dxl + T + dxr;
  float* M = reinterpret_cast<float*>(smem4);
  float* work = M + T * WM;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      M[row_of(i, ty) * WM + dxl + row_of(j, tx)] = c[i][j];
  const float* A1v = A1 + (long)va * KX * T;
  if (dxl) {
    if (b > 0)
      side_columns(x, NA, NB, A1v, B2, M, WM, 0, T - dxl, dxl, work,
                   stage, pa, W, b - 1, nb, nvb, tid);
    else
      for (int i = tid; i < T * dxl; i += THREADS)
        M[(i / dxl) * WM + i % dxl] = 0.f;
  }
  if (dxr) {
    if (b < nb - 1)
      side_columns(x, NA, NB, A1v, B2, M, WM, dxl + T, 0, dxr, work,
                   stage, pa, W, b + 1, nb, nvb, tid);
    else
      for (int i = tid; i < T * dxr; i += THREADS)
        M[(i / dxr) * WM + dxl + T + i % dxr] = 0.f;
  }
  __syncthreads();

  // 3-4. every channel's taps; rows outside the tile from the halo strips
  bank_taps(M, WM, dxl, ht, hb, taps, toff, ntaps, out, pa, a, na, b, nb, h8,
            C, tid);
}

// The reduced grades: steps 1 and 2 on final2d_split's tiles (header).
// side (p, na, nb, T, dxl + dxr): the block's neighbour columns, row s of
// tile (pa, b) at side + ((pa * nb + b) * T + s) * (dxl + dxr). TX: x's
// and the banks' type, float or bf16 (NPROD 1).
template <int NPROD, typename TX>
__global__ void __launch_bounds__(THREADS, 1)
final2d_stencil_split_kernel(
    const TX* __restrict__ x, const float* __restrict__ NA,
    const float* __restrict__ NB, const f2s::bf16* __restrict__ Ac,
    const f2s::bf16* __restrict__ Bc, const float* __restrict__ ht,
    const float* __restrict__ hb, const float* __restrict__ taps,
    const int* __restrict__ toff, TX* __restrict__ out,
    float* __restrict__ side, int na, int nb, int nva, int nvb, int h8,
    int dxl, int dxr, int C, int ntaps) {
  extern __shared__ uint4 smem16[];
  const int b = blockIdx.x, a = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x;
  const long pa = (long)p * na + a;
  const int va = variant(nva, a, na);
  const int D = dxl + dxr;
  float* sd = side + ((pa * nb + b) * T) * D;
  rfs::Frag f;
  // 2. the neighbours' columns, each from its whole tile: the last dxl
  // columns of tile b - 1 and the first dxr of tile b + 1, to the scratch
  if (dxl && b > 0) {
    f2s::split_tile<NPROD>(f, x, NA, NB, Ac, Bc, smem16, pa, b - 1, va,
                           variant(nvb, b - 1, nb), nb);
    rfs::for_pairs(f, [&](int s, int o, float v0, float v1) {
      const int c = o - (T - dxl);
      if (c >= 0) sd[s * D + c] = v0;
      if (c + 1 >= 0) sd[s * D + c + 1] = v1;
    });
  }
  if (dxr && b < nb - 1) {
    f2s::split_tile<NPROD>(f, x, NA, NB, Ac, Bc, smem16, pa, b + 1, va,
                           variant(nvb, b + 1, nb), nb);
    rfs::for_pairs(f, [&](int s, int o, float v0, float v1) {
      if (o < dxr) sd[s * D + dxl + o] = v0;
      if (o + 1 < dxr) sd[s * D + dxl + o + 1] = v1;
    });
  }
  // 1. the tile itself
  f2s::split_tile<NPROD>(f, x, NA, NB, Ac, Bc, smem16, pa, b, va,
                         variant(nvb, b, nb), nb);
  __syncthreads();  // the products are done with shared memory

  // M = [left columns | the tile | right columns] over the products' space
  const int WM = dxl + T + dxr;
  float* M = reinterpret_cast<float*>(smem16);
  rfs::for_pairs(f, [&](int s, int o, float v0, float v1) {
    M[s * WM + dxl + o] = v0;
    M[s * WM + dxl + o + 1] = v1;
  });
  for (int i = tid; i < T * D; i += THREADS) {
    const int s = i / D, c = i % D;
    const bool left = c < dxl;
    const bool there = left ? b > 0 : b < nb - 1;
    M[s * WM + (left ? c : T + c)] = there ? sd[i] : 0.f;
  }
  __syncthreads();

  // 3-4. every channel's taps (the px6 kernel's)
  bank_taps(M, WM, dxl, ht, hb, taps, toff, ntaps, out, pa, a, na, b, nb, h8,
            C, tid);
}

// the split kernel's dynamic shared memory: the products, then M
template <int NPROD>
int split_smem(int dxl, int dxr) {
  const int m = T * (dxl + T + dxr) * (int)sizeof(float);
  return f2s::smem_bytes<NPROD>() > m ? f2s::smem_bytes<NPROD>() : m;
}

template <int NPROD, typename TX>
int launch_split(const TX* x, const float* NA, const float* NB,
                 const void* Ac, const void* Bc, const float* ht,
                 const float* hb, const float* taps, const int* toff,
                 TX* out, float* side, int p, int na, int nb, int nva,
                 int nvb, int h8, int dxl, int dxr, int C, int ntaps,
                 cudaStream_t stream) {
  if ((dxl + dxr) && side == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = split_smem<NPROD>(MAX_REACH, MAX_REACH);
  cudaError_t err = cudaFuncSetAttribute(
      final2d_stencil_split_kernel<NPROD, TX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, na, p);
  final2d_stencil_split_kernel<NPROD, TX>
      <<<grid, THREADS, split_smem<NPROD>(dxl, dxr), stream>>>(
          x, NA, NB, static_cast<const f2s::bf16*>(Ac),
          static_cast<const f2s::bf16*>(Bc), ht, hb, taps, toff, out, side,
          na, nb, nva, nvb, h8, dxl, dxr, C, ntaps);
  return (int)cudaGetLastError();
}

}  // namespace

// nprod 6: A, B the fp32 operands A1, B2 of final2d.cu, side unread;
// nprod 1, 3, 4: A, B final2d_split's Ac, Bc (bf16), side the neighbour
// columns' scratch (p * na * nb * 128 * (dxl + dxr) floats)
extern "C" int final2d_stencil_launch(const float* x, const float* NA,
                                      const float* NB, const void* A,
                                      const void* B, const float* ht,
                                      const float* hb, const float* taps,
                                      const int* toff, float* out,
                                      float* side, int p, int na, int nb,
                                      int nva, int nvb, int h8, int dxl,
                                      int dxr, int C, int ntaps, int nprod,
                                      void* stream) {
  if (h8 < 1 || h8 > MAX_REACH || dxl < 0 || dxl > MAX_REACH || dxr < 0 ||
      dxr > MAX_REACH || C < 1 || ntaps < C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nprod) {
    case 1:
      return launch_split<1>(x, NA, NB, A, B, ht, hb, taps, toff, out, side,
                             p, na, nb, nva, nvb, h8, dxl, dxr, C, ntaps, s);
    case 3:
      return launch_split<3>(x, NA, NB, A, B, ht, hb, taps, toff, out, side,
                             p, na, nb, nva, nvb, h8, dxl, dxr, C, ntaps, s);
    case 4:
      return launch_split<4>(x, NA, NB, A, B, ht, hb, taps, toff, out, side,
                             p, na, nb, nva, nvb, h8, dxl, dxr, C, ntaps, s);
    case 6:
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  const float* A1 = static_cast<const float*>(A);
  const float* B2 = static_cast<const float*>(B);
  // the side-column work area: Bsel and U; the tile's A1, then the
  // neighbour's Xext, where they fit beside M
  const int gemm = 2 * KX * T, m = T * (dxl + T + dxr), jc = 2 * KX * JC;
  int stage = 0, used = m + jc;
  if ((used + KX * T) * 4 <= MAX_SMEM) stage |= 2, used += KX * T;
  if ((used + KX * T) * 4 <= MAX_SMEM) stage |= 1, used += KX * T;
  cudaError_t err = cudaFuncSetAttribute(
      final2d_stencil_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int smem = (gemm > used ? gemm : used) * (int)sizeof(float);
  const dim3 grid(nb, na, p);
  final2d_stencil_kernel<<<grid, THREADS, smem, s>>>(
      x, NA, NB, A1, B2, ht, hb, taps, toff, out, na, nb, nva, nvb, h8, dxl,
      dxr, C, ntaps, stage);
  return (int)cudaGetLastError();
}

// x (p, na, T, W) and out (C, p, na, T, W) bf16, nprod 1 (the JAX
// package's bf16 mode); the rest as final2d_stencil_launch at nprod 1
extern "C" int final2d_stencil_bf16_launch(
    const void* x, const float* NA, const float* NB, const void* A,
    const void* B, const float* ht, const float* hb, const float* taps,
    const int* toff, void* out, float* side, int p, int na, int nb, int nva,
    int nvb, int h8, int dxl, int dxr, int C, int ntaps, int nprod,
    void* stream) {
  if (nprod != 1 || h8 < 1 || h8 > MAX_REACH || dxl < 0 ||
      dxl > MAX_REACH || dxr < 0 || dxr > MAX_REACH || C < 1 || ntaps < C)
    return (int)cudaErrorInvalidValue;
  return launch_split<1>(static_cast<const rf::bf16*>(x), NA, NB, A, B, ht,
                         hb, taps, toff, static_cast<rf::bf16*>(out), side,
                         p, na, nb, nva, nvb, h8, dxl, dxr, C, ntaps,
                         (cudaStream_t)stream);
}

extern "C" const char* final2d_stencil_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
