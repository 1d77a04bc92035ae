// final2d: passes 2+3 of the 3-touch 2-D executor — read the image once,
// complete both dimensions, write the output once.
//
// Replaces recfilter_tpu/kernels/final2d.py::final2d_px at nprod 6 (px6;
// Pallas kernel _final_px_kernel). Per 128 x 128 tile (p, a, b), with v(i)
// the tile's matrix variant (interior, first or last):
//
//   Z = Ba_v(a) * x_tile + Ra_v(a)[:, :8] * NA_t[p,a,:, tile cols]
//   Y[s,o] = sum_t Z[s,t] * Bb_v(b)[o,t] + sum_k NB_t[p,a, b*8+k, s] * Rb_v(b)[o,k]
//
// both contractions (128 image rows + 8 carry slots, padded with zeros to
// 144) as the JAX kernel computes them at px6: six split-bf16 products
// (kernels/split.py's prods(6)) of the constants' three bf16 chunks (split
// from float64 on the host) by the data's three (split on chip: x and NA,
// then Z, then NB), summed in fp32 — the carry k16 step first, then the
// image's eight, each pair over its steps; the first product's pairs
// grouped by the constant's chunk (Final2D's PX_ORDER_A), the second's in
// prods(6)'s order (Final2D.split_exact models both). Z never leaves the
// chip: it is not even written to shared memory.
//
// What bounds it: 12 B/px of traffic (x read, y written; the carries 1/16
// of that) against 2 x 6 x 144 x 2 = 3456 bf16 tensor-core operations per
// pixel (58 GFLOP at 4096^2: 0.0587 ms at 989 TFLOP/s dense, against 0.040
// ms for the bytes at 3.35 TB/s), so on an H100 it is bound by the tensor
// cores. The design, on Hopper's warpgroup products (wgmma.mma_async,
// wgmma.cuh):
//   * the roles are chosen so that the first product's accumulators are the
//     second's A operand: Z (s rows x 128 columns w) = A1 * X with M = s,
//     N = w, K = t (m64n128k16); then Y = Z * Bb^T with M = s, N = o, K = w.
//     A thread's accumulators of Z columns 16c..16c+15 are exactly its A
//     fragment of the second product's k16 step c, so Z is split into its
//     three bf16 chunks in registers and fed back to the tensor cores;
//   * A1 = [Ba | Ra | 0], the first product's A operand, is read from L2 as
//     ready-made register fragments (the host packs them, Final2D.Af_k: one
//     16-byte load a thread a chunk and step), one chunk at a time: the
//     carry step's and chunk 2's loaded under the stores of the tile
//     before, chunk 1's under chunk 2's products, chunk 0's under chunk 1's;
//   * the data X = [x; NA; 0], the first product's B operand, lives in
//     shared memory as three bf16 chunks in the descriptor's core-matrix
//     order (K-major, t contiguous), its 8-row blocks of t outermost with
//     their three chunks together (xoff); the next tile's x and NA are
//     copied raw by cp.async into the same space (at XRAW, where no chunk
//     block overtakes the raw rows it is split from) as soon as the first
//     product is done, and split in place under the second product, each
//     pair of rows (t, t + 1) of a column one 32-bit store after a
//     lane-pair shuffle;
//   * B2 = [Bb | Rb | 0], the second product's B operand, stays in shared
//     memory (three chunks, Final2D.Bc_k: core_pack without the k
//     permutation, staged once a variant); the second product runs in two
//     halves of 64 outputs (m64n64k16), each stored as soon as it is done;
//   * registers: a product's A fragments stay in registers until it is
//     done, so each product keeps near 140 live (one chunk of A1's
//     fragments in flight and one loading; Y in halves): with both at 172
//     ptxas serializes every wgmma (its note C7512, "insufficient register
//     resources") and the kernel runs 15 % slower on an H100;
//   * persistent blocks, one per SM, of two warpgroups, one for each half
//     of a tile's 128 rows s, walking the tiles grouped by B2's variant
//     (pipeline.cuh's item order).
// Shared memory: 2 x 3 x 128 x 144 bf16 = 221,184 B (B2 and X).
//
// final2d_epi: the same kernel with the affine epilogue in its store
// (replaces _final_px_kernel's epilogue with eaux operands):
//
//   out = a * Y + sum_{j<k} b_j * aux_j + c,   k <= 4
//
// each aux in x's (p, na, T, W) layout, read at the store's own float2
// indexing, fp32 FMAs. The unsharp mask's combine (1 + w) * image - w *
// blur rides here with the image as its one aux, so the blur never touches
// device memory. Each aux adds 4 B/px of reads.
//
// final2d_k: the same two products at the HIGHEST grade's layouts —
// replaces recfilter_tpu/kernels/final2d.py::final2d (Pallas kernel
// _final2d_kernel), which overlap2d._fused_2d_kernel_path calls on the
// overlap_k backend. Three things the px entry fixes are free here:
//   * Ta, the tile of the leading axis, is any value up to 128: A1's
//     columns past Ta are zero, so Z's rows past Ta are zero and the store
//     skips them;
//   * the carries are the sums of the orders, not padded to 8: Ka, Kb up to
//     32, each padded on chip to a multiple of 8 (zero rows), so the
//     contraction depths are Ta + 8*ceil(Ka/8) and 128 + 8*ceil(Kb/8), and
//     2 x 160 x 128 x 4 B = 160 KB of shared memory at K = 32;
//   * NA arrives in row form (p, na, Ka, W), NB as (p, na, nb, Ta, Kb): its
//     Kb carries of row s are gathered, transposed, under Z^T.
// Per tile:
//   Z = A1_v(a)^T [x_tile; NA_tile]           (Ta + Ka deep)
//   Y = [Z^T; NB_tile^T]^T B2_v(b)             (128 + Kb deep)
// with A1 (nva, Ta + Kap, 128) = [Ba^T; Ra^T] (columns >= Ta zero) and B2
// (nvb, 128 + Kbp, 128) = [Bb^T; Rb^T]. Its bound is final2d's: about
// 2 x (128 + 6) x 2 = 536 FLOP/px, 9.0 GFLOP at 4096^2 with Ka = Kb = 6,
// 0.134 ms at 67 TFLOP/s fp32; the same GEMM, the same design.
//
// final2d_k_bf16: final2d_k with bf16 products — replaces the same Pallas
// kernel at matmul_dtype=bfloat16 (the overlap backends' Plan.matmul_dtype):
//   Z  = bf16(Ba) * bf16(x)   (fp32 accumulation)  +  Ra * NA   (fp32)
//   Zc = bf16(Z)
//   Y  = Zc * bf16(Bb)^T      (fp32 accumulation)  +  NB * Rb^T (fp32)
// Y float32, at final2d_k's layouts and shape limits. The two image-sized
// products run on the bf16 tensor cores (split.cuh's mma.sync m16n8k16
// block, one product: bf16 x bf16 is exact in fp32, so each is the JAX
// kernel's dot with fp32 accumulation); the carry rows' products stay fp32
// FMAs into accumulators of their own, added to the tensor cores' sums as
// the JAX kernel adds its two dots. x is rounded to bf16 as it is staged,
// Z as it goes to shared memory. The constants come rounded from the host
// (float64 to float32 to bf16, as the JAX kernel's float32 operand cast to
// bf16): Ab (nva, 128, 136) = bf16(Ba) rows s, t contiguous (zero past
// Ta), Bb (nvb, 128, 136) = bf16(Bb) rows o, t contiguous; the carry
// columns are read from final2d_k's A1 and B2. Shared memory: two bf16
// operands of 128 rows of 136 and two fp32 carry operands of 32 rows of
// 128, 100 KB. What bounds it: 12 B/px of traffic (x read, y written, both
// fp32) against 2 x 2 x 128 tensor-core FLOP per pixel: bytes, at the
// card's peaks.

#include "common.cuh"
#include "pipeline.cuh"
#include "split.cuh"
#include "wgmma.cuh"

namespace {

constexpr int T = rf::GT;      // tile edge, Ta = Tb
constexpr int SLOTS = 8;       // carry rows per slot
constexpr int THREADS = rf::GEMM_THREADS;

using rf::gemm_tile;
using rf::row_of;
using rf::stage_rows;
using rf::variant;

// The px6 kernel (header). KP: the contraction, 128 + 8 carries + 8 zeros.
constexpr int KP = T + 16;
constexpr int CH = T * KP;       // elements of one bf16 chunk of an operand
constexpr int NCH = 3;           // chunks at px6
constexpr int KS = KP / 16;      // k16 steps; the last is the carries'
constexpr int PX_THREADS = 2 * rfw::WG;
constexpr int PX_SMEM = 2 * NCH * CH * (int)sizeof(rfs::bf16);
// X's chunks in shared memory, 8-row blocks of t outermost: element (chunk
// c, column w, row t) at xoff(c, w, t) — a block's three chunks (16
// core matrices of 8 columns w by 8 rows t each, t contiguous) together,
// so the descriptor's K-adjacent core matrices lie XBLK apart and its
// N-adjacent ones 128 bytes (the K-major layout without swizzle).
constexpr int XR = (T + SLOTS) / 8;    // 8-row blocks of X = [x; NA]
constexpr int XBLK = NCH * T * 8;      // elements of one 8-row block
constexpr int XLD = T + 4;             // row stride of X copied raw (floats)
constexpr int XG = 3;                  // 8-row blocks split at a time
static_assert((XR + XG - 1) / XG == 6, "split_x walks six groups");
// X copied raw at XRAW bytes into the chunks' space: chunk block m (its
// bytes [2 XBLK m, 2 XBLK (m + 1))) ends at or before raw block m's first
// byte, so a group of blocks, read by every thread before any of its
// chunks is stored, overwrites only raw rows of its own or earlier groups
constexpr int XRAW = 36864;
static_assert(XRAW % 16 == 0 && XRAW >= 2 * XBLK * XR - 8 * XLD * 4 * (XR - 1)
                  && XRAW + (T + SLOTS) * XLD * 4 <= NCH * CH * 2,
              "X copied raw must fit its chunks' space, past their blocks");
__host__ __device__ constexpr int xoff(int c, int w, int t) {
  return (t / 8) * XBLK + c * T * 8 + (w / 8) * 64 + (w % 8) * 8 + t % 8;
}
// Descriptor of X's chunk c at k16 step s: K-adjacent core matrices XBLK
// elements apart (leading byte offset), N-adjacent 128 bytes (stride).
__device__ __forceinline__ uint64_t xdesc(const rfs::bf16* Xs, int c, int s) {
  const uint64_t a = rfw::smem_u32(Xs + 2 * s * XBLK + c * T * 8);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(2 * XBLK / 16) << 16) |
         (uint64_t(128 / 16) << 32);
}
constexpr unsigned FULL = 0xffffffffu;

// The descriptor `base` with `off16` 16-byte units added to its address,
// formed at its product: opaque to the compiler, so it does not keep the
// walk's 108 loop-invariant descriptors in registers.
__device__ __forceinline__ uint64_t at(uint64_t base, int off16) {
  asm volatile("" : "+l"(base));
  return base + off16;
}

// d += A * B for one k16 step of a 64 x 64 product (wgmma m64n64k16: the
// accumulators of wgmma.cuh's mma, columns 0..63).
__device__ __forceinline__ void mma64(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void fence_acc32(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += half h (outputs 64h .. 64h + 63) of the second product: the carry
// step, then the image's steps, each pair of split.prods(6) over them; A
// Z's chunks (zc, NB's at the carry step), B B2's chunks at Bs.
__device__ __forceinline__ void px_half_b(float (&d)[32],
                                          const uint32_t (&zc)[NCH][KS][4],
                                          const rfs::bf16* Bs, int h) {
  const uint64_t base = rfw::desc(Bs, KP);
  const int o16 = h * 8 * KP;  // 8 core-matrix rows of outputs, 16 B units
#pragma unroll
  for (int p = 0; p < 6; ++p)
    mma64(d, zc[rfs::pair_d(6, p)][KS - 1],
          at(base, o16 + (rfs::pair_c(6, p) * CH + 128 * (KS - 1)) / 8));
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int c = 0; c < KS - 1; ++c)
      mma64(d, zc[rfs::pair_d(6, p)][c],
            at(base, o16 + (rfs::pair_c(6, p) * CH + 128 * c) / 8));
}

// The first product's pairs (constant chunk, data chunk) in the kernel's
// order: grouped by the constant's chunk, smallest level first (chunk 2,
// then 1, then 0: kernels/final2d.py's PX_ORDER_A), so a chunk's
// fragments are loaded from L2 while the group before runs.
__host__ __device__ constexpr int oa_d(int i, int q) {  // group i, pair q
  return i == 2 ? 0 : i == 1 ? 1 - q : 2 - q;
}

// z += the carry step of the first product: chunk i's fragment ac[i],
// the data's chunks at the last step, every pair of PX_ORDER_A.
__device__ __forceinline__ void px_carry_a(float (&z)[64],
                                           const uint32_t (&ac)[NCH][4],
                                           const rfs::bf16* Xs) {
  const uint64_t base = xdesc(Xs, 0, 0);
#pragma unroll
  for (int i = NCH - 1; i >= 0; --i)
#pragma unroll
    for (int q = 0; q < NCH - i; ++q)
      rfw::mma(z, ac[i], at(base, (2 * (KS - 1) * XBLK + oa_d(i, q) * T *
                                   8) / 8));
}

// z += group i of the first product over the image's steps: the
// constant's chunk i (fragments a), every data chunk it pairs with.
template <int I>
__device__ __forceinline__ void px_group_a(float (&z)[64],
                                           const uint32_t (&a)[KS - 1][4],
                                           const rfs::bf16* Xs) {
  const uint64_t base = xdesc(Xs, 0, 0);
#pragma unroll
  for (int q = 0; q < NCH - I; ++q)
#pragma unroll
    for (int c = 0; c < KS - 1; ++c)
      rfw::mma(z, a[c], at(base, (2 * c * XBLK + oa_d(I, q) * T * 8) / 8));
}

template <bool EPI>
__global__ void __launch_bounds__(PX_THREADS, 1)
final2d_px_kernel(const float* __restrict__ x,        // (p, na, T, W)
                  const float* __restrict__ NA,       // (p, na, 8, W)
                  const float* __restrict__ NB,       // (p, na, nb*8, T)
                  const uint4* __restrict__ Af,       // (nva, 2, 3, KS, 128)
                  const rfs::bf16* __restrict__ Bc,   // (nvb, 3, CH)
                  float* __restrict__ y,              // (p, na, T, W)
                  rf::Affine epi, int naux, int p, int na, int nb, int nva,
                  int nvb) {
  extern __shared__ uint4 smem16[];
  rfs::bf16* Bs = reinterpret_cast<rfs::bf16*>(smem16);  // B2's chunks
  rfs::bf16* Xs = Bs + NCH * CH;                          // X's chunks
  uint32_t* X32 = reinterpret_cast<uint32_t*>(Xs);

  const int wg = threadIdx.x / rfw::WG, tid = threadIdx.x % rfw::WG;
  const int lane = tid % 32, qd = lane % 4;
  const int r = 64 * wg + 16 * (tid / 32) + lane / 4;  // rows r, r + 8
  const long W = (long)nb * T;
  const int nl = p * na, items = nb * nl;

  // X of tile (pa, b): [x; NA] (136 rows t of 128 columns w) copied raw
  // into the Xs region (rows of XLD floats) by cp.async, under the
  // products and the stores of the tile before
  float* raw = reinterpret_cast<float*>(reinterpret_cast<char*>(Xs) + XRAW);
  auto load_x = [&](long pa, int b) {
    const float* xt = x + pa * T * W + (long)b * T;
    const float* nt = NA + pa * SLOTS * W + (long)b * T;
    for (int i = threadIdx.x; i < (T + SLOTS) * (T / 4); i += PX_THREADS) {
      const int t = i / (T / 4), c = 4 * (i % (T / 4));
      rfp::cp16(raw + t * XLD + c,
                (t < T ? xt + (long)t * W : nt + (long)(t - T) * W) + c,
                true);
    }
  };
  // ... then split in place into Xs's chunks: block warp wq takes the
  // 8 x 16 blocks (R, G = wq) of X, R < 17; lane (tt, qq) reads row 8R +
  // tt, columns 16 wq + 4qq .. + 3 as a float4; lanes tt and tt ^ 1 swap
  // halves, so each holds rows (t0, t0 + 1) of two columns, split into
  // chunks and stored as 32-bit pairs at xoff(c, w, t0). XG blocks at a
  // time, each group read by every thread before any of its chunks is
  // stored (XRAW); then rows 136..143 (block 17) zeros.
  auto split_rows = [&](auto g) {
    constexpr int M0 = decltype(g)::value * XG;
    constexpr int M1 = M0 + XG < XR ? M0 + XG : XR;
    const int wq = threadIdx.x / 32, tt = lane % 8, qq = lane / 8;
    const bool odd = tt & 1;
    float4 v[M1 - M0];
#pragma unroll
    for (int m = M0; m < M1; ++m)
      v[m - M0] = *reinterpret_cast<const float4*>(
          raw + (8 * m + tt) * XLD + 16 * wq + 4 * qq);
    __syncthreads();  // every thread holds its samples of the group
#pragma unroll
    for (int m = M0; m < M1; ++m) {
      const float4 u = v[m - M0];
      const int t0 = 8 * m + (tt & ~1);
      const int w = 16 * wq + 4 * qq + (odd ? 2 : 0);
      const float r0 = __shfl_xor_sync(FULL, odd ? u.x : u.z, 1);
      const float r1 = __shfl_xor_sync(FULL, odd ? u.y : u.w, 1);
      uint32_t ca[NCH], cb[NCH];
      rfw::split_pair<NCH>(odd ? r0 : u.x, odd ? u.z : r0, ca);
      rfw::split_pair<NCH>(odd ? r1 : u.y, odd ? u.w : r1, cb);
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        X32[xoff(ch, w, t0) / 2] = ca[ch];
        X32[xoff(ch, w + 1, t0) / 2] = cb[ch];
      }
    }
  };
  auto split_x = [&]() {
    split_rows(std::integral_constant<int, 0>{});
    split_rows(std::integral_constant<int, 1>{});
    split_rows(std::integral_constant<int, 2>{});
    split_rows(std::integral_constant<int, 3>{});
    split_rows(std::integral_constant<int, 4>{});
    split_rows(std::integral_constant<int, 5>{});
    for (int i = threadIdx.x; i < XBLK / 2; i += PX_THREADS)
      X32[XR * XBLK / 2 + i] = 0u;
  };

  // this warpgroup's A1 fragments of variant va — the carry step's of
  // every chunk (ac) and the image steps' of chunk 2 (a2) by load_a; chunk
  // 1's (a1) and chunk 0's (into a2) while the chunk before is multiplied —
  // and its four NB carries of tile (pa, b): rows r, r + 8, carries 2qd,
  // 2qd + 1
  uint32_t ac[NCH][4], a2[KS - 1][4], a1[KS - 1][4];
  float nbv[4];
  const uint4* afw = Af + (long)wg * NCH * KS * rfw::WG + tid;
  auto frags = [&](int va, int i, uint32_t (&a)[KS - 1][4]) {
    const uint4* src = afw + ((long)(va * 2 * NCH + i) * KS) * rfw::WG;
#pragma unroll
    for (int c = 0; c < KS - 1; ++c) {
      const uint4 u = __ldg(src + c * rfw::WG);
      a[c][0] = u.x, a[c][1] = u.y, a[c][2] = u.z, a[c][3] = u.w;
    }
  };
  auto load_a = [&](long pa, int b) {
    const int va = rf::variant(nva, (int)(pa % na), na);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const uint4 u = __ldg(afw + ((long)(va * 2 * NCH + i) * KS + KS - 1) *
                                      rfw::WG);
      ac[i][0] = u.x, ac[i][1] = u.y, ac[i][2] = u.z, ac[i][3] = u.w;
    }
    frags(va, 2, a2);
    const float* nbt = NB + (pa * nb + b) * SLOTS * T;
    nbv[0] = nbt[(2 * qd) * T + r];
    nbv[1] = nbt[(2 * qd + 1) * T + r];
    nbv[2] = nbt[(2 * qd) * T + r + 8];
    nbv[3] = nbt[(2 * qd + 1) * T + r + 8];
  };

  if ((int)blockIdx.x >= items) return;
  int b, cur_vb;
  long pa;
  {
    int bl;
    rfp::item(blockIdx.x, nb, nl, nvb, b, bl);
    pa = bl;
  }
  cur_vb = rf::variant(nvb, b, nb);
  load_x(pa, b);
  rfp::commit();
  rfw::stage_b<NCH>(smem16, Bc, cur_vb, CH);  // waits for load_x's copies
  load_a(pa, b);
  split_x();
  rfw::fence_async_smem();
  __syncthreads();

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    // Z = A1 X: the carry step, then the image's steps
    float z[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) z[i] = 0.f;
    rfw::fence_acc(z);
    rfw::fence();
    // in three groups by A1's chunk, each waited for before its registers
    // take the chunk after next
    {
      const int va = rf::variant(nva, (int)(pa % na), na);
      px_carry_a(z, ac, Xs);
      px_group_a<2>(z, a2, Xs);
      rfw::commit();
      frags(va, 1, a1);
      rfw::wait_all();
      rfw::fence();
      px_group_a<1>(z, a1, Xs);
      rfw::commit();
      frags(va, 0, a2);
      rfw::wait_all();
      rfw::fence();
      px_group_a<0>(z, a2, Xs);
      rfw::commit();
      rfw::wait_all();
    }
    rfw::fence_acc(z);
    __syncthreads();  // both warpgroups are past their products on Xs

    // the next tile's X copied in under the second product
    const int nxt = it + gridDim.x;
    int b2 = 0;
    long pa2 = 0;
    if (nxt < items) {
      int bl;
      rfp::item(nxt, nb, nl, nvb, b2, bl);
      pa2 = bl;
      load_x(pa2, b2);
    }
    rfp::commit();

    // Y = [Z | NB] B2: Z's chunks from the accumulators (columns 16c ..
    // 16c + 15 are the A fragment of step c), NB's as the carry step
    uint32_t zc[NCH][KS][4];
#pragma unroll
    for (int c = 0; c < KS - 1; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t t2[NCH];
        rfw::split_pair<NCH>(z[8 * c + 2 * e], z[8 * c + 2 * e + 1], t2);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) zc[ch][c][e] = t2[ch];
      }
    {
      uint32_t t0[NCH], t1[NCH];
      rfw::split_pair<NCH>(nbv[0], nbv[1], t0);
      rfw::split_pair<NCH>(nbv[2], nbv[3], t1);
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        zc[ch][KS - 1][0] = t0[ch];
        zc[ch][KS - 1][1] = t1[ch];
        zc[ch][KS - 1][2] = zc[ch][KS - 1][3] = 0u;
      }
    }
    // Y in two halves of 64 outputs, one after the other (32 accumulators
    // each); the next tile's X split under the second half's products
    long base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      base[h] = (pa * T + r + 8 * h) * W + (long)b * T + 2 * qd;
    float d[32];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] = 0.f;
      fence_acc32(d);
      rfw::fence();
      px_half_b(d, zc, Bs, half);
      rfw::commit();
      if (half == 1) {
        rfp::wait_pending(0);  // this thread's copies of X
        __syncthreads();       // ... and every thread's
        if (nxt < items) split_x();
      }
      rfw::wait_all();
      fence_acc32(d);
      if (half == 1 && nxt < items) load_a(pa2, b2);  // under the stores

      // d[4j + 2h + e]: row r + 8h, output 64 half + 8j + 2qd + e
      const int o0 = 64 * half;
      if constexpr (EPI) {
        const float a = epi.coef[0], c = epi.coef[1];
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = fmaf(a, d[i], c);
        for (int k = 0; k < naux; ++k) {
          const float bk = epi.coef[2 + k];
          const float* aux = epi.aux[k] + o0;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 u =
                  *reinterpret_cast<const float2*>(aux + base[h] + 8 * j);
              d[4 * j + 2 * h] = fmaf(bk, u.x, d[4 * j + 2 * h]);
              d[4 * j + 2 * h + 1] = fmaf(bk, u.y, d[4 * j + 2 * h + 1]);
            }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          rf::store2(y + o0 + base[h] + 8 * j, d[4 * j + 2 * h],
                     d[4 * j + 2 * h + 1]);
    }

    b = b2;
    pa = pa2;
    if (nxt < items) {
      const int v = rf::variant(nvb, b, nb);
      if (v != cur_vb) {  // every warpgroup is past its products on Bs
        rfw::stage_b<NCH>(smem16, Bc, v, CH);
        cur_vb = v;
      }
    }
    rfw::fence_async_smem();  // the chunks visible to the tensor cores
    __syncthreads();
  }
}

int px_launch(const float* x, const float* NA, const float* NB,
              const void* Af, const void* Bc, float* y, const rf::Affine& epi,
              int naux, int p, int na, int nb, int nva, int nvb,
              cudaStream_t stream) {
  if (p < 1 || na < 1 || nb < 1 || (nva != 1 && nva != 3) ||
      (nvb != 1 && nvb != 3) || naux < 0 || naux > rf::MAX_AUX ||
      (long)p * na * nb >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  // final2d and final2d_epi each run a kernel built without the other's
  // branch: ptxas then allocates final2d_epi's without a spill
  const auto kernel = epi.coef != nullptr ? final2d_px_kernel<true>
                                          : final2d_px_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int grid = rfp::persistent_grid((long)p * na * nb);
  kernel<<<grid, PX_THREADS, PX_SMEM, stream>>>(
      x, NA, NB, static_cast<const uint4*>(Af),
      static_cast<const rfs::bf16*>(Bc), y, epi, naux, p, na, nb, nva, nvb);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(THREADS, 1)
final2d_k_kernel(const float* __restrict__ x,   // (p, na, Ta, W)
                 const float* __restrict__ NA,  // (p, na, Ka, W)
                 const float* __restrict__ NB,  // (p, na, nb, Ta, Kb)
                 const float* __restrict__ A1,  // (nva, Ta + Kap, T)
                 const float* __restrict__ B2,  // (nvb, T + Kbp, T)
                 float* __restrict__ y,         // (p, na, Ta, W)
                 int na, int nb, int Ta, int Ka, int Kb, int nva, int nvb) {
  extern __shared__ float4 smem4[];
  const int Kap = (Ka + SLOTS - 1) / SLOTS * SLOTS;
  const int Kbp = (Kb + SLOTS - 1) / SLOTS * SLOTS;
  const int D1 = Ta + Kap, D2 = T + Kbp;
  const int D = D1 > D2 ? D1 : D2;
  float* As = reinterpret_cast<float*>(smem4);  // D x T
  float* Bs = As + D * T;                       // D x T

  const int b = blockIdx.x, a = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long W = (long)nb * T;
  const long pa = (long)p * na + a;
  const int va = variant(nva, a, na), vb = variant(nvb, b, nb);

  // dim-A completion: Z = A1^T [x; NA], the carry rows zero-padded
  stage_rows(As, A1 + (long)va * D1 * T, D1, T, tid);
  stage_rows(Bs, x + pa * Ta * W + (long)b * T, Ta, W, tid);
  stage_rows(Bs + Ta * T, NA + pa * Ka * W + (long)b * T, Ka, W, tid);
  for (int i = tid; i < (Kap - Ka) * T; i += THREADS)
    Bs[(Ta + Ka) * T + i] = 0.f;
  __syncthreads();
  float c[8][8];
  gemm_tile(As, Bs, c, ty, tx, D1);
  __syncthreads();

  // dim-B completion: Y = [Z^T; NB^T]^T [Bb^T; Rb^T]; Z^T goes to shared
  // memory (As[t][s] = Z[s][t]), never to device memory
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int t = row_of(j, tx);
    *reinterpret_cast<float4*>(As + t * T + ty * 4) =
        make_float4(c[0][j], c[1][j], c[2][j], c[3][j]);
    *reinterpret_cast<float4*>(As + t * T + 64 + ty * 4) =
        make_float4(c[4][j], c[5][j], c[6][j], c[7][j]);
  }
  const float* nbt = NB + (pa * nb + b) * (long)Ta * Kb;
  for (int i = tid; i < Kbp * T; i += THREADS) {
    const int k = i / T, s = i % T;
    As[(T + k) * T + s] = k < Kb && s < Ta ? nbt[(long)s * Kb + k] : 0.f;
  }
  stage_rows(Bs, B2 + (long)vb * D2 * T, D2, T, tid);
  __syncthreads();
  gemm_tile(As, Bs, c, ty, tx, D2);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = row_of(i, ty);
    if (s >= Ta) continue;
    const long r0 = pa * Ta * W + (long)b * T + (long)s * W + tx * 4;
    *reinterpret_cast<float4*>(y + r0) =
        make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
    *reinterpret_cast<float4*>(y + r0 + 64) =
        make_float4(c[i][4], c[i][5], c[i][6], c[i][7]);
  }
}

constexpr int LDK = T + 8;   // row stride of the bf16 operands (elements)
constexpr int KMAX = 32;     // carries per axis
constexpr int SMEM_K_BF16 = 2 * T * LDK * (int)sizeof(rf::bf16) +
                            2 * KMAX * T * (int)sizeof(float);

// The accumulators of a warp's 64 x 32 share (split.cuh's Frag layout)
// plus sum_{k < K} P[k][m] * Q[k][n], P and Q fp32 rows of 128 in shared
// memory, summed on their own first (the JAX kernel's second dot).
__device__ __forceinline__ void add_carry_rows(rfs::Frag& f, const float* P,
                                               const float* Q, int K) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = (warp % 2) * 64 + lane / 4;
  const int n0 = (warp / 2) * 32 + 2 * (lane % 4);
  float c[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[i][j][r] = 0.f;
  for (int k = 0; k < K; ++k) {
    float pm[8];
    float2 qn[4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      pm[i] = P[k * T + m0 + (i / 2) * 16 + (i % 2) * 8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      qn[j] = *reinterpret_cast<const float2*>(Q + k * T + n0 + j * 8);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float a = pm[2 * mi + h];
          c[mi][ni][2 * h] = fmaf(a, qn[ni].x, c[mi][ni][2 * h]);
          c[mi][ni][2 * h + 1] = fmaf(a, qn[ni].y, c[mi][ni][2 * h + 1]);
        }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        f.acc[i][j][r] = __fadd_rn(f.acc[i][j][r], c[i][j][r]);
}

__global__ void __launch_bounds__(THREADS, 1)
final2d_k_bf16_kernel(const float* __restrict__ x,   // (p, na, Ta, W)
                      const float* __restrict__ NA,  // (p, na, Ka, W)
                      const float* __restrict__ NB,  // (p, na, nb, Ta, Kb)
                      const float* __restrict__ A1,  // (nva, Ta + Kap, T)
                      const float* __restrict__ B2,  // (nvb, T + Kbp, T)
                      const rf::bf16* __restrict__ Ab,  // (nva, T, LDK)
                      const rf::bf16* __restrict__ Bb,  // (nvb, T, LDK)
                      float* __restrict__ y,         // (p, na, Ta, W)
                      int na, int nb, int Ta, int Ka, int Kb, int nva,
                      int nvb) {
  extern __shared__ float4 smem4[];
  rf::bf16* Cs = reinterpret_cast<rf::bf16*>(smem4);  // T x LDK: Ab, then Bb
  rf::bf16* Ds = Cs + T * LDK;  // x as t rows of n, then Zc as s rows of t
  float* Ps = reinterpret_cast<float*>(Ds + T * LDK);  // KMAX x T
  float* Qs = Ps + KMAX * T;                            // KMAX x T
  const int Kap = (Ka + SLOTS - 1) / SLOTS * SLOTS;
  const int Kbp = (Kb + SLOTS - 1) / SLOTS * SLOTS;
  const int D1 = Ta + Kap, D2 = T + Kbp;
  const int K1 = (Ta + 15) / 16 * 16;  // the first product's depth

  const int b = blockIdx.x, a = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x;
  const long W = (long)nb * T;
  const long pa = (long)p * na + a;
  const int va = variant(nva, a, na), vb = variant(nvb, b, nb);

  // dim-A completion: Z = bf16(Ba) bf16(x) + Ra NA
  rfs::copy16(Cs, Ab + (long)va * T * LDK, T * LDK * (int)sizeof(rf::bf16),
              tid);
  const float* xt = x + pa * Ta * W + (long)b * T;
  for (int i = tid; i < K1 * (T / 4); i += THREADS) {
    const int t = i / (T / 4), c4 = i % (T / 4);
    const float4 v = t < Ta
        ? reinterpret_cast<const float4*>(xt + (long)t * W)[c4]
        : make_float4(0.f, 0.f, 0.f, 0.f);
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(Ds + t * LDK + 4 * c4) = u;
  }
  stage_rows(Ps, A1 + ((long)va * D1 + Ta) * T, Ka, T, tid);   // Ra^T
  stage_rows(Qs, NA + pa * Ka * W + (long)b * T, Ka, W, tid);  // NA
  __syncthreads();
  rfs::Frag f;
  rfs::zero(f);
  rfs::mma_block<true>(f, Cs, LDK, Ds, LDK, K1);
  add_carry_rows(f, Ps, Qs, Ka);
  __syncthreads();

  // dim-B completion: Y = Zc bf16(Bb)^T + NB Rb^T; Zc, Z rounded once to
  // bf16, goes to shared memory as s rows, never to device memory
  rfs::for_pairs(f, [&](int s, int t, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(Ds + s * LDK + t) =
        __floats2bfloat162_rn(v0, v1);
  });
  rfs::copy16(Cs, Bb + (long)vb * T * LDK, T * LDK * (int)sizeof(rf::bf16),
              tid);
  const float* nbt = NB + (pa * nb + b) * (long)Ta * Kb;
  for (int i = tid; i < Kb * T; i += THREADS) {
    const int k = i / T, s = i % T;
    Ps[k * T + s] = s < Ta ? nbt[(long)s * Kb + k] : 0.f;     // NB^T
  }
  stage_rows(Qs, B2 + ((long)vb * D2 + T) * T, Kb, T, tid);   // Rb^T
  __syncthreads();
  rfs::zero(f);
  rfs::mma_block<false>(f, Ds, LDK, Cs, LDK, T);
  add_carry_rows(f, Ps, Qs, Kb);

  float* yt = y + pa * Ta * W + (long)b * T;
  rfs::for_pairs(f, [&](int s, int o, float v0, float v1) {
    if (s < Ta)
      *reinterpret_cast<float2*>(yt + (long)s * W + o) = make_float2(v0, v1);
  });
}

}  // namespace

// Af, Bc: kernels/final2d.py's Final2D.Af_k (nva, 2, 3, KS, 128) 16-byte
// register fragments of [Ba | Ra | 0] and Final2D.Bc_k (nvb, 3, 128 * 144)
// core-packed chunks of [Bb | Rb | 0]
extern "C" int final2d_launch(const float* x, const float* NA,
                              const float* NB, const void* Af,
                              const void* Bc, float* y, int p, int na,
                              int nb, int nva, int nvb, void* stream) {
  return px_launch(x, NA, NB, Af, Bc, y, rf::Affine{}, 0, p, na, nb, nva,
                   nvb, (cudaStream_t)stream);
}

// coef = [a, c, b0..b3] (float32, on the card); aux0..aux{k-1} in x's
// layout, the rest unread
extern "C" int final2d_epi_launch(const float* x, const float* NA,
                                  const float* NB, const void* Af,
                                  const void* Bc, const float* aux0,
                                  const float* aux1, const float* aux2,
                                  const float* aux3, const float* coef,
                                  float* y, int p, int na, int nb, int nva,
                                  int nvb, int k, void* stream) {
  return px_launch(x, NA, NB, Af, Bc, y,
                   rf::make_affine(aux0, aux1, aux2, aux3, coef), k, p, na,
                   nb, nva, nvb, (cudaStream_t)stream);
}

// Ta <= 128, Ka and Kb <= 32 (the shared memory of one block)
extern "C" int final2d_k_launch(const float* x, const float* NA,
                                const float* NB, const float* A1,
                                const float* B2, float* y, int p, int na,
                                int nb, int Ta, int Ka, int Kb, int nva,
                                int nvb, void* stream) {
  if (Ta < 1 || Ta > T || Ka < 1 || Ka > 32 || Kb < 1 || Kb > 32)
    return (int)cudaErrorInvalidValue;
  const int Kap = (Ka + SLOTS - 1) / SLOTS * SLOTS;
  const int Kbp = (Kb + SLOTS - 1) / SLOTS * SLOTS;
  const int D = Ta + Kap > T + Kbp ? Ta + Kap : T + Kbp;
  const int smem = 2 * D * T * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      final2d_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, na, p);
  final2d_k_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, NA, NB, A1, B2, y, na, nb, Ta, Ka, Kb, nva, nvb);
  return (int)cudaGetLastError();
}

// final2d_k's shapes; Ab and Bb the bf16 constants (module docstring)
extern "C" int final2d_k_bf16_launch(const float* x, const float* NA,
                                     const float* NB, const float* A1,
                                     const float* B2, const rf::bf16* Ab,
                                     const rf::bf16* Bb, float* y, int p,
                                     int na, int nb, int Ta, int Ka, int Kb,
                                     int nva, int nvb, void* stream) {
  if (Ta < 1 || Ta > T || Ka < 1 || Ka > KMAX || Kb < 1 || Kb > KMAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      final2d_k_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_K_BF16);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, na, p);
  final2d_k_bf16_kernel<<<grid, THREADS, SMEM_K_BF16,
                          (cudaStream_t)stream>>>(
      x, NA, NB, A1, B2, Ab, Bb, y, na, nb, Ta, Ka, Kb, nva, nvb);
  return (int)cudaGetLastError();
}

extern "C" const char* final2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
