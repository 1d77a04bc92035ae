// completion_rot.cuh: the rotated completion on the tensor cores — the
// kernels of completion_rot.cu (completion_rot, completion_rot_epi) and
// completion_rot_tails.cu (completion_rot_tails), at every grade (NPROD 1,
// 3, 4, 6). They replace recfilter_tpu/kernels/completion.py::
// completion_pass(rot=True, nprod=NPROD) (Pallas kernel _completion_kernel,
// its rot branch, its stencil consumer _stencil_rows and its next-pass
// tails) with transposed slot-padded carries. For x (q lines, n tiles,
// 128), the solved carries N (n, sl, q) and v(t) the tile's variant:
//
//   Y[t*128 + o, l] = (Btot_v(t) * x[l, t, :] + Rcat_v(t) * N[t, :, l])[o]
//
// emitted ROTATED into an (n*128, q) output, the product being
// completion_tc.cuh's: the split-bf16 products of wgmma.cuh's
// split_products<NPROD, KC> (the carry slab at carry_nprod(NPROD), then the
// 128 signal rows at NPROD, each smallest level first), B the host's
// constant [Btot | Rcat | 0] in b_chunks(NPROD) chunks in the core-matrix
// order (kernels/completion.py's tc_constant), A split on chip from a fp32
// stage, work items of 64 lines of one tile walked by persistent blocks of
// one or two warpgroups (pipeline.cuh's Walk). Only the emit differs.
//
// A warp's accumulators for one output hold 8 consecutive lines (wgmma's
// fragment rows lane/4), so the rotated store without a stencil goes
// straight from the registers: four outputs x 8 lines an instruction, whole
// 32-byte sectors (the affine epilogue first, each aux array's loads issued
// before its products and the stores).
//
// With a stencil (ntaps > 0) each output is
//
//   out[t*128 + o, l] = sum_k c_k * Z[o + d_k][l]
//
// over the completed tile Z between its neighbour tiles' halo rows — prev
// (n, hp, q), the hp last rows of tile t-1, above, and nxt (n, hn, q), the
// hn first rows of tile t+1, below — zeros past the array; "clamp"
// (start_clamp for d < 0 at tile 0, end_clamp for d > 0 at tile n-1)
// replicates the tile's first or last row: the JAX package's _stencil_rows.
// Products then sums, each rounded (no FMA), in tap order, as the twins
// take them; then the affine epilogue (the consumer order of
// completion.py:266-278). The tile goes to a stage of (hp + 128 + hn) rows
// of 64 lines (row stride 68 floats: the fragment writes and the line-wise
// reads free of bank conflicts) between its halo rows, over the
// warpgroup's x stage once the products have it in registers: the halo
// rows load after the tile is written, the next item once the emit has
// read the stage; two warpgroups wherever their stages fit, so one's emit
// runs under the other's products. (A stencil stage of its own, so that
// the loads ran under the emit, fits beside one warpgroup only at C1's
// reach and measured 1.1-1.4x slower at every grade.)
//
// completion_rot_tails (no stencil, no epilogue, sl = 8) also writes the
// next pass of a rotation chain's local tails: with q = ra * n2 * 128
// lines, 128-line block b is tile c = b % n2 of the next pass's scanned
// axis on its a = b / n2-th extent, and
//
//   tails2[c, s, (t*128 + o) * ra + a] = sum_j G2_v(c)[s, j] * Y[t*128 + o,
//                                                                 b*128 + j]
//
// (rows s >= S2 zeros), in fp64 from the fp32 outputs and G2's fp32 rows,
// one fma per j ascending from 0.0 — tails.cu's order, so a chained pass
// reads bit for bit the tails an unchained one reads from y. Its work item
// is a whole 128-line block of one tile, a warpgroup a half, each with the
// x stage and the products of completion_rot (so its y is completion_rot's
// bit for bit). Once a warpgroup's stage is in registers the next item's
// loads go there, under the store, the tails and the next wait; the
// halves then pass in turn through one staged half tile (128 outputs x 64
// lines, row stride 68 floats: the fragment writes and the float4 row
// reads free of bank conflicts) beside the stages, each output's fp64
// chains sweeping warpgroup 0's lines and then warpgroup 1's, so they see
// the 128 lines of a next-pass tile in order; G2's rows are staged in fp64
// (converted once an item, not once a product). (The whole tile staged over
// both x stages, the loads after the tails: 12 % slower than completion_rot
// + tails; warpgroups on items of their own, each in two halves with the
// chains kept in shared memory between them: 1.2x slower.)
//
// bf16 storage (completion_rot_bf16, completion_rot_epi_bf16,
// completion_rot_tails_bf16: completion_pass(rot=True) on a bf16 x at
// NPROD 1, the JAX package's bf16 mode, with no stencil): the x stage holds
// bf16 rows (completion_tc.cuh's stage_x), the products are those of NPROD
// 1 on the same values, and the fp32 accumulators (after the epilogue,
// whose aux arrays stay fp32) are rounded once to bf16. A warp's bf16
// outputs of one row are 16 B an instruction where the fp32 ones are 32 B:
// so rot_store packs them first — two shuffles pair each line with the
// next (one 4-byte word), one more joins those pairs into four lines (8
// bytes) — and each store instruction writes 32 consecutive bytes of 8
// rows (16 lines each), where rows start 8-byte aligned (q % 4 == 0);
// else one 2-byte store an element. The
// tails kernel's chains read the outputs as rounded to bf16, so the chained
// tails are those tails.cu reads from the stored y, bit for bit (the JAX
// package extracts them from the fp32 accumulators). With a stencil
// (completion_rot_stencil_bf16, completion_rot_stencil_epi_bf16) the x
// stage is bf16 as above, the stencil stage Z and the halo rows stay fp32
// (Z over the x stage and the carry rows: with a bf16 x stage the stencil
// stage is the larger, and rot_smem sizes the stage from it), the taps
// and the epilogue act on the fp32 accumulators, and each output is
// rounded once to bf16 in rot_stencil's store: one 2-byte element a thread
// over consecutive lines, 64 B a warp and row, two whole sectors.
#pragma once

#include "completion_tc.cuh"

namespace {

// row stride (floats) of a stencil stage and of rot_tails' half tile
constexpr int LDZ = rfw::TM + 4;

// One warpgroup's item — 64 lines of tile t from line l0, and their sl
// carry rows — into its stage (x's rows at Xs, the carry rows at Ns),
// asynchronously; lines past q as zeros.
template <typename TX>
__device__ __forceinline__ void stage_item(TX* Xs, float* Ns,
                                           const TX* __restrict__ x,
                                           const float* __restrict__ N,
                                           int t, int l0, int q, int n,
                                           int sl, int tid, bool vec) {
  stage_x(Xs, x, t, l0, q, n, tid);
  const float* Nt = N + (long)t * sl * q + l0;
  if (vec) {
    for (int i = tid; i < sl * (rfw::TM / 4); i += rfw::WG) {
      const int s = i >> 4, l = 4 * (i & 15);
      const bool ok = l0 + l < q;
      rfp::cp16(Ns + s * LDNS + l, ok ? Nt + (long)s * q + l : N, ok);
    }
  } else {
    for (int i = tid; i < sl * rfw::TM; i += rfw::WG) {
      const int s = i >> 6, l = i & 63;
      const bool ok = l0 + l < q;
      rfp::cp4(Ns + s * LDNS + l, ok ? Nt + (long)s * q + l : N, ok);
    }
  }
}

// The products of a warpgroup's item from its stage (x rows at Xs, the
// carry rows at Ns): d[4j + 2h + e] is line r + 8h of the item, output
// 8j + 2qd + e. issued() as split_products'.
template <int NPROD, int KC, typename TX, typename Issued>
__device__ __forceinline__ void item_products(float (&d)[64],
                                              const rfs::bf16* Bs,
                                              const TX* Xs, const float* Ns,
                                              int sl, int r, int qd,
                                              Issued&& issued) {
  constexpr int KP = T + 16 * KC;
  rfw::split_products<NPROD, KC>(
      d, Bs, T * KP, KP,
      [&](int k0, float (&u)[4], float (&w)[4]) {
        if (k0 >= T) {
          const int p0 = k0 - T + 4 * qd;
#pragma unroll
          for (int e = 0; e < 4; ++e) u[e] = w[e] = 0.f;
          if (p0 < sl) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              u[e] = Ns[(p0 + e) * LDNS + r];
              w[e] = Ns[(p0 + e) * LDNS + r + 8];
            }
          }
        } else {
          const float4 a = rf::load4f(Xs + r * LDX + k0 + 4 * qd);
          const float4 c = rf::load4f(Xs + (r + 8) * LDX + k0 + 4 * qd);
          u[0] = a.x, u[1] = a.y, u[2] = a.z, u[3] = a.w;
          w[0] = c.x, w[1] = c.y, w[2] = c.z, w[3] = c.w;
        }
      },
      issued);
}

// The bf16 outputs of one j — v[e][h] of row `row` + e, line r + 8h —
// packed across the warp and stored 8 bytes a lane (the header): with lane
// bits c = lane/4 % 2 and b = lane/8 % 2, the lane stores row `row` + c,
// lines `line` .. + 3 (line = the warp's first + 8b + 4 (lane/16)).
__device__ __forceinline__ void rot_store_packed(rf::bf16* __restrict__ y,
                                                 const float (&v)[2][2],
                                                 long row, int line, int q,
                                                 int lane) {
  const int c = (lane >> 2) & 1, b = (lane >> 3) & 1;
  uint32_t w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t p = rfw::as_u32(__floats2bfloat162_rn(v[0][h], v[1][h]));
    const uint32_t o = __shfl_xor_sync(0xffffffffu, p, 4);
    // c 0: output e 0 at (its line, the next); c 1: output e 1 at (the
    // line before, its line)
    w[h] = c ? __byte_perm(p, o, 0x3276) : __byte_perm(p, o, 0x5410);
  }
  const uint32_t got = __shfl_xor_sync(0xffffffffu, b ? w[0] : w[1], 8);
  if (line < q)
    *reinterpret_cast<uint2*>(y + (row + c) * q + line) =
        b ? make_uint2(got, w[1]) : make_uint2(w[0], got);
}

// The rotated store of a warpgroup's accumulators with no stencil: output
// row row0 + 8j + 2qd + e, lines l0 + r + 8h; the affine epilogue first.
// A bf16 y whose rows are 8-byte aligned goes through rot_store_packed.
template <typename TX>
__device__ __forceinline__ void rot_store(float (&d)[64],
                                          TX* __restrict__ y,
                                          const rf::Affine& epi, int naux,
                                          long row0, int l0, int q, int r,
                                          int qd) {
  bool ok[2];
  long at[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ok[h] = l0 + r + 8 * h < q;
    at[h] = (row0 + 2 * qd) * q + l0 + r + 8 * h;
  }
  if (epi.coef != nullptr) {
    const float a = epi.coef[0], c = epi.coef[1];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = fmaf(a, d[i], c);
    for (int k = 0; k < naux; ++k) {
      const float bk = epi.coef[2 + k];
      const float* aux = epi.aux[k];
      float u[64];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            u[4 * j + 2 * h + e] =
                ok[h] ? aux[at[h] + (long)(8 * j + e) * q] : 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = fmaf(bk, u[i], d[i]);
    }
  }
  if constexpr (std::is_same<TX, rf::bf16>::value) {
    if (q % 4 == 0) {
      const int lane = threadIdx.x % 32;
      const int line = l0 + (r - lane / 4) + 8 * ((lane >> 3) & 1) +
                       4 * (lane >> 4);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float v[2][2] = {{d[4 * j], d[4 * j + 2]},
                               {d[4 * j + 1], d[4 * j + 3]}};
        rot_store_packed(y, v, row0 + 8 * j + 2 * qd, line, q, lane);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (ok[h]) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          rf::store1(y + at[h] + (long)(8 * j + e) * q, d[4 * j + 2 * h + e]);
      }
}

// The halo rows of the item (tile t, lines l0..l0+63) into the stencil
// stage Z — rows r < hp of prev, then hn of nxt, at stage rows r and
// r + 128 — asynchronously, zeros past the array or past q.
__device__ __forceinline__ void stage_halo(float* Z,
                                           const float* __restrict__ prev,
                                           const float* __restrict__ nxt,
                                           const float* any, int t, int l0,
                                           int q, int n, int hp, int hn,
                                           int tid, bool vec) {
  const int per = vec ? rfw::TM / 4 : rfw::TM;  // copies a halo row
  for (int i = tid; i < (hp + hn) * per; i += rfw::WG) {
    const int rr = i / per, l = (i - rr * per) * (vec ? 4 : 1);
    const bool top = rr < hp;
    const bool ok = l0 + l < q && (top ? t > 0 : t < n - 1);
    const float* src =
        top ? prev + ((long)t * hp + rr) * q : nxt + ((long)t * hn + rr - hp) * q;
    float* dst = Z + (top ? rr : rr + T) * LDZ + l;
    if (vec)
      rfp::cp16(dst, ok ? src + l0 + l : any, ok);
    else
      rfp::cp4(dst, ok ? src + l0 + l : any, ok);
  }
}

// The stencil's emit of the item staged in Z (rows hp + o): each of the
// thread's 64 outputs o = og + 2s at line l0 + l summed over the taps in
// tap order (products then sums, each rounded), the taps outer so the
// outputs' reads are in flight together; then the affine epilogue (every
// aux load of an array before its products) and the stores.
template <typename TY>
__device__ __forceinline__ void rot_stencil(
    const float* __restrict__ Z, const int* __restrict__ dt,
    const float* __restrict__ ct, TY* __restrict__ y,
    const rf::Affine& epi, int naux, int t, int n, int l0, int q, int hp,
    int ntaps, bool sc, bool ec, int tid) {
  constexpr int OUT = T / 2;
  const int l = tid & (rfw::TM - 1), og = tid / rfw::TM;
  if (l0 + l >= q) return;
  float acc[OUT];
  for (int k = 0; k < ntaps; ++k) {
    const int dk = dt[k];
    const float c = ct[k];
#pragma unroll
    for (int s = 0; s < OUT; ++s) {
      int rr = og + 2 * s + dk;
      if (dk > 0 && ec && rr > T - 1) rr = T - 1;
      if (dk < 0 && sc && rr < 0) rr = 0;
      const float term = __fmul_rn(c, Z[(hp + rr) * LDZ + l]);
      acc[s] = k == 0 ? term : __fadd_rn(acc[s], term);
    }
  }
  const long y0 = ((long)t * T + og) * q + l0 + l, step = 2L * q;
  if (epi.coef != nullptr) {
    const float a = epi.coef[0], c = epi.coef[1];
#pragma unroll
    for (int s = 0; s < OUT; ++s) acc[s] = fmaf(a, acc[s], c);
    for (int k = 0; k < naux; ++k) {
      const float bk = epi.coef[2 + k];
      const float* aux = epi.aux[k];
      float u[OUT];
#pragma unroll
      for (int s = 0; s < OUT; ++s) u[s] = aux[y0 + s * step];
#pragma unroll
      for (int s = 0; s < OUT; ++s) acc[s] = fmaf(bk, u[s], acc[s]);
    }
  }
#pragma unroll
  for (int s = 0; s < OUT; ++s) rf::store1(y + y0 + s * step, acc[s]);
}

// Shared memory of completion_rot (bytes): B's chunks, the taps, and per
// warpgroup a stage, the larger of its x stage and its stencil stage.
template <typename TX>
long rot_smem(int kp, int nc, int sl, int hp, int hn, int ntaps, int nwg) {
  const long xs = xst<TX>() + (long)sl * LDNS;
  const long zh = ntaps ? (long)(hp + T + hn) * LDZ : 0;
  return (long)nc * T * kp * 2 + 4L * ((2L * ntaps + 3) / 4 * 4) +
         4L * nwg * (xs > zh ? xs : zh);
}

// completion_rot, completion_rot_epi: nwg warpgroups (blockDim.x = 128
// nwg), each with its own item and stages; epi.coef null: no epilogue.
// STENCIL: ntaps > 0 (a body of its own, so that the emit without one
// carries no stencil state across the products). TX: x's and y's type,
// float or bf16.
template <int NPROD, int KC, bool STENCIL, typename TX>
__global__ void __launch_bounds__(2 * rfw::WG, 1)
completion_rot_kernel(const TX* __restrict__ x,          // (q, n, T)
                      const float* __restrict__ N,       // (n, sl, q)
                      const rfs::bf16* __restrict__ Bc,  // (nv, NCB, T * KP)
                      const float* __restrict__ prev,    // (n, hp, q)
                      const float* __restrict__ nxt,     // (n, hn, q)
                      const float* __restrict__ taps,    // (ntaps, 2): d, c
                      TX* __restrict__ y,                // (n * T, q)
                      rf::Affine epi, int naux,          // aux: (n * T, q)
                      int q, int n, int sl, int nv, int hp, int hn,
                      int ntaps, int start_clamp, int end_clamp, int nwg) {
  constexpr int KP = T + 16 * KC, CH = T * KP;
  constexpr int NCB = rfw::b_chunks(NPROD);
  extern __shared__ uint4 smem16[];
  rfs::bf16* Bs = reinterpret_cast<rfs::bf16*>(smem16);
  int* dt = reinterpret_cast<int*>(Bs + NCB * CH);   // tap offsets d_k
  float* ct = reinterpret_cast<float*>(dt + ntaps);  // tap weights c_k
  float* ring = reinterpret_cast<float*>(dt) + (2 * ntaps + 3) / 4 * 4;
  const int xs = xst<TX>() + sl * LDNS, zh = ntaps ? (hp + T + hn) * LDZ : 0;
  const int stage = xs > zh ? xs : zh;  // floats, a multiple of 4

  const int wg = threadIdx.x / rfw::WG, tid = threadIdx.x % rfw::WG;
  const int lane = tid % 32, qd = lane % 4;
  const int r = 16 * (tid / 32) + lane / 4;  // fragment rows r, r + 8
  const int nb = (q + rfw::TM - 1) / rfw::TM;
  const bool vec = q % 4 == 0;  // N, the halo rows, y 16-byte aligned rows
  TX* Xs = reinterpret_cast<TX*>(ring + wg * stage);
  float* Ns = ring + wg * stage + xst<TX>();
  float* Z = ring + wg * stage;  // the stencil stage, over the x stage
  const rfp::Walk walk(n, nb, nv, nwg);
  for (int k = threadIdx.x; k < ntaps; k += blockDim.x) {
    dt[k] = (int)taps[2 * k];
    ct[k] = taps[2 * k + 1];
  }  // read after stage_b's barrier (every block stages B first)

  auto load = [&](int g) {
    int end;
    const int it = walk.first(g, nwg, end) + wg;
    if (g >= walk.gs[3] || it >= end) return false;
    int t, b;
    rfp::item(it, n, nb, nv, t, b);
    stage_item(Xs, Ns, x, N, t, b * rfw::TM, q, n, sl, tid, vec);
    return true;
  };

  bool have = load(blockIdx.x);
  rfp::commit();
  int cur_v = -1;
  for (int g = blockIdx.x; g < walk.gs[3]; g += gridDim.x) {
    int end;
    const int it = walk.first(g, nwg, end) + wg;
    {
      int t0, b0;
      rfp::item(it - wg, n, nb, nv, t0, b0);
      const int v = rf::variant(nv, t0, n);
      if (v != cur_v) {
        rfw::stage_b<NCB>(smem16, Bc, v, CH);
        cur_v = v;
      }
    }
    if (!have) {  // none in this group: the stage is free for the next
      have = load(g + gridDim.x);
      rfp::commit();
      continue;
    }
    rfp::wait_pending(0);  // this item's stage
    rfw::wg_sync(wg);
    int t, b;
    rfp::item(it, n, nb, nv, t, b);
    const int l0 = b * rfw::TM;
    float d[64];
    item_products<NPROD, KC>(d, Bs, Xs, Ns, sl, r, qd, [&] {
      if constexpr (!STENCIL) {  // the stage is in registers: the next
        rfw::wg_sync(wg);        // item's loads
        have = load(g + gridDim.x);
        rfp::commit();
      }
    });
    if constexpr (!STENCIL) {
      rot_store(d, y, epi, naux, (long)t * T, l0, q, r, qd);
    } else {
      rfw::wg_sync(wg);  // every thread is past the x stage
      // the tile between its halo rows: Z[hp + o][line]
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            Z[(hp + 8 * j + 2 * qd + e) * LDZ + r + 8 * h] =
                d[4 * j + 2 * h + e];
      stage_halo(Z, prev, nxt, N, t, l0, q, n, hp, hn, tid, vec);
      rfp::commit();
      rfp::wait_pending(0);  // the halo rows
      rfw::wg_sync(wg);
      rot_stencil(Z, dt, ct, y, epi, naux, t, n, l0, q, hp, ntaps,
                  start_clamp && t == 0, end_clamp && t == n - 1, tid);
      rfw::wg_sync(wg);  // the stencil stage is read: refill it
      have = load(g + gridDim.x);
      rfp::commit();
    }
  }
}

// completion_rot_tails (sl = 8, KC 1): two warpgroups, an item a 128-line
// block b of tile t, warpgroup wg its lines b*128 + 64 wg. TX: x's and y's
// type (the tails read y's values as stored).
template <int NPROD, typename TX>
__global__ void __launch_bounds__(2 * rfw::WG, 1)
completion_rot_tails_kernel(const TX* __restrict__ x,          // (q, n, T)
                            const float* __restrict__ N,       // (n, 8, q)
                            const rfs::bf16* __restrict__ Bc,  // (nv, NCB,
                                                               //  T * KP)
                            const float* __restrict__ G2,      // (nv2, 8, T)
                            TX* __restrict__ y,                // (n * T, q)
                            float* __restrict__ tails2,  // (n2, 8, n*T*ra)
                            int q, int n, int nv, int n2, int S2, int nv2) {
  constexpr int SL = 8, KP = T + 16, CH = T * KP;
  constexpr int NCB = rfw::b_chunks(NPROD);
  constexpr int STAGE = xst<TX>() + SL * LDNS;
  extern __shared__ uint4 smem16[];
  rfs::bf16* Bs = reinterpret_cast<rfs::bf16*>(smem16);
  float* ring = reinterpret_cast<float*>(Bs + NCB * CH);
  float* Zh = ring + 2 * STAGE;  // a half of the tile: Zh[o][j], 64 lines
  // G2's rows of the item's next-pass tile, in fp64
  double* Gs = reinterpret_cast<double*>(Zh + T * LDZ);

  const int wg = threadIdx.x / rfw::WG, tid = threadIdx.x % rfw::WG;
  const int lane = tid % 32, qd = lane % 4;
  const int r = 16 * (tid / 32) + lane / 4;
  const int nb = q / T;
  TX* Xs = reinterpret_cast<TX*>(ring + wg * STAGE);
  float* Ns = ring + wg * STAGE + xst<TX>();
  const rfp::Walk walk(n, nb, nv, 1);
  const long nT = (long)n * T;
  const int ra = q / (n2 * T);
  // output o's slots s0, s0 + 2, s0 + 4, s0 + 6
  const int o = threadIdx.x % T, s0 = threadIdx.x / T;

  auto load = [&](int g) {
    if (g >= walk.gs[3]) return;
    int end, t, b;
    rfp::item(walk.first(g, 1, end), n, nb, nv, t, b);
    stage_item(Xs, Ns, x, N, t, b * T + wg * rfw::TM, q, n, SL, tid, true);
  };

  load(blockIdx.x);
  rfp::commit();
  int cur_v = -1;
  for (int g = blockIdx.x; g < walk.gs[3]; g += gridDim.x) {
    int end, t, b;
    rfp::item(walk.first(g, 1, end), n, nb, nv, t, b);
    const int v = rf::variant(nv, t, n);
    if (v != cur_v) {
      rfw::stage_b<NCB>(smem16, Bc, v, CH);
      cur_v = v;
    }
    rfp::wait_pending(0);  // this item's stage
    rfw::wg_sync(wg);
    float d[64];
    item_products<NPROD, 1>(d, Bs, Xs, Ns, SL, r, qd, [&] {
      rfw::wg_sync(wg);  // the stage is in registers: the next item's loads
      load(g + gridDim.x);
      rfp::commit();
    });
    const int l0 = b * T + wg * rfw::TM;
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = rf::stored<TX>(d[i]);
    rot_store(d, y, rf::Affine{}, 0, (long)t * T, l0, q, r, qd);

    const int a = b / n2, c = b % n2;
    const float* g2v = G2 + (long)rf::variant(nv2, c, n2) * 8 * T;
    for (int i = threadIdx.x; i < 8 * T; i += blockDim.x)
      Gs[i] = (double)g2v[i];
    // four fp64 chains, one fma per line ascending from 0.0: warpgroup 0's
    // half of the tile, then warpgroup 1's, through Zh
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    const float* z = Zh + o * LDZ;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (wg == h) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              Zh[(8 * j + 2 * qd + e) * LDZ + r + 8 * hh] =
                  d[4 * j + 2 * hh + e];
      }
      __syncthreads();
      const double* gh = Gs + h * rfw::TM;
#pragma unroll 4
      for (int j = 0; j < rfw::TM; j += 4) {
        const float4 zv = *reinterpret_cast<const float4*>(z + j);
        const double zz[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const double* gm = gh + (s0 + 2 * m) * T + j;
          const double2 ga = *reinterpret_cast<const double2*>(gm);
          const double2 gb = *reinterpret_cast<const double2*>(gm + 2);
          acc[m] = fma(ga.x, zz[0], acc[m]);
          acc[m] = fma(ga.y, zz[1], acc[m]);
          acc[m] = fma(gb.x, zz[2], acc[m]);
          acc[m] = fma(gb.y, zz[3], acc[m]);
        }
      }
      __syncthreads();  // Zh (and after the second half Gs) is read
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int s = s0 + 2 * m;
      tails2[(((long)c * 8 + s) * nT + (long)t * T + o) * ra + a] =
          s < S2 ? (float)acc[m] : 0.f;
    }
  }
}

}  // namespace
