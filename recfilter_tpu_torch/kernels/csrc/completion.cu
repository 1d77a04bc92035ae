// completion.cu: the completion of every tile of a 1-D last-axis pass — read
// the signal once, inject the solved carries, write the output once — in
// its unrotated (completion, completion_epi, completion_traced) and
// rotated (completion_rot, completion_rot_epi, completion_rot_tails) forms;
// the reduced grades' unrotated form is completion_split.cu's
// (completion_split), the same kernel (completion_tc.cuh) at NPROD 1, 3, 4.
//
// completion: replaces recfilter_tpu/kernels/completion.py::completion_pass
// (Pallas kernel _completion_kernel) with rot=False, nprod=6 and
// transposed slot-padded carries. For x (q lines, n tiles, 128), the
// solved carries N (n, sl, q) and v(t) the tile's matrix variant
// (interior, first or last):
//
//   Y[l, t, :] = Btot_v(t) * x[l, t, :] + Rcat_v(t) * N[t, :, l]
//
// computed as the JAX package computes it at px6: x and its carries split
// into three bf16 chunks on chip (_split_vmem), the constant [Btot | Rcat]
// into three from float64 on the host (_split_const_np), and the six chunk
// products of split.py's prods(6) — (0,2), (1,1), (2,0), (0,1), (1,0),
// (0,0), constant chunk first — summed in fp32, smallest level first: the
// carry rows (sl of them, padded with zeros to a multiple of 16) all six
// products, then the 128 signal rows all six. A bf16 x bf16 product is
// exact in fp32, so the arithmetic is the TPU kernel's; the sums round at
// other places (the tensor cores' accumulation).
//
// What bounds it: 8 B of traffic per sample against 2 * 6 * (128 + S)
// bf16 operations — at the H100's peaks (3.35 TB/s, 989 TFLOP/s dense
// bf16) the bytes. The design:
//   * the products on wgmma (m64n128k16, wgmma.cuh), work items of 64
//     lines of one tile (one wgmma M; 306 lines take five items, 14 line
//     slots idle), the A operand — the signal and carry chunks — split
//     from a fp32 stage into registers, once per item, the B operand — the
//     three constant chunks, 128 x (128 + 16 KC) in wgmma's core-matrix
//     order — resident in shared memory;
//   * persistent blocks, one per SM, of two warpgroups (one where two
//     stages do not fit beside B: sl >= 48), each with its own item and
//     stage, so one's split and stores run under the other's products;
//     the block walks the (tile, 64-line block) items in groups of one
//     item a warpgroup (pipeline.cuh's order: a block meets each matrix
//     variant once, so B is staged at most three times a block, a flat
//     cp.async copy of the host-prepared chunks; a group never mixes
//     variants);
//   * a stage a warpgroup filled by cp.async — 64 lines of x at a row
//     stride of 144 floats (a warp's float4 fragment reads free of bank
//     conflicts) and the item's sl carry rows — refilled with the next
//     item as soon as the split has the stage in registers, so the loads
//     run under the products and the stores;
//   * the output stored from the accumulators, each thread two adjacent
//     outputs, four threads a 32-byte sector.
// Shared memory: 3 * 128 * (128 + 16 KC) * 2 B of chunks (KC = sl / 16
// rounded up) and a stage of (64 * 144 + sl * 68) * 4 B a warpgroup.
//
// completion_epi: the same kernel with the affine epilogue applied to the
// accumulators before the store, out = a * Y + sum_{j<k} b_j * aux_j + c
// (k <= 4 aux arrays in y's (q, n, 128) layout; fmaf(a, Y, c), then one
// fmaf per aux, every aux load issued before the stores) — the epilogue of
// completion_pass (eaux operands, recfilter_tpu/kernels/completion.py:273).
// Each aux adds 4 B per sample of reads.
//
// completion_traced: the learnable executor's completion, replacing
// recfilter_tpu/kernels/completion.py::completion_pass_traced (nprod=6):
// the same kernel with sl = 8 and one variant, but Btot (128, 128) and
// Rcat (128, S <= 8) are runtime matrices built from trainable
// coefficients, in their natural layout: each block copies them into its
// ring once (cp.async, the loads in flight together), splits them from
// there into B's three bf16 chunks (_split_vmem), and zeros the carry rows
// past S on both operands (N's pad rows are never read). So the caller
// runs no cat, pad, split or transpose per call.
//
// The three are completion_tc.cuh's kernel at NPROD 6.

#include "completion_tc.cuh"

namespace {

constexpr int THREADS = rf::GEMM_THREADS;  // 16 x 16, 8 x 8 outputs each

// completion_rot: the same per-tile product in fp32 (one fmaf chain an
// output, not the six split products of completion), emitted ROTATED — the tile
// transposed, Y[t*128 + o, l] into an (n*128, q) output — with an optional
// shifted-tap stencil consumer along the scanned axis fused into the emit.
//
// Replaces completion_pass(rot=True) and its stencil epilogue
// (_completion_kernel with _stencil_rows). With ntaps > 0 each output is
//
//   out[t*128 + o, l] = sum_k c_k * Z[o + d_k][l]
//
// over the completed tile Z between its neighbour tiles' halo rows — prev
// (the hp last rows of tile t-1, completed) above and nxt (the hn first
// rows of tile t+1) below — where the globally-first/last tile applies the
// border rule: "zero" reads 0 past the array (the halo rows there are
// never read), "clamp" (start_clamp for d < 0 at tile 0, end_clamp for
// d > 0 at tile n-1) replicates the global first or last row — the JAX
// package's _stencil_rows. Products then sums, each rounded (no FMA), in
// tap order, as the twin _stencil_flat takes them. completion_rot_epi
// (K >= 0) then applies the affine epilogue to each output, after the
// stencil (the consumer order of completion.py:266-278), its aux in y's
// (n*128, q) layout, every aux load of a thread issued before its stores.
//
// What bounds it: 2 * (128 + sl) fp32 FLOP per sample against 8 B of
// traffic (plus (hp + hn) / 128 of a read for the halo rows), so on the
// H100's CUDA cores the arithmetic: 0.0696 ms at C1's x pass (4096 lines,
// 32 tiles, sl = 8). So the loads, the product and the stores must
// overlap, and the product must not wait on shared memory:
//   * persistent blocks, one per SM, walking the (tile, 128-line block)
//     items (pipeline.cuh's walk: a block meets each matrix variant once),
//     the operand B_v = [Btot | Rcat] (nv, 128, 128 + sl), outputs as rows,
//     resident in shared memory and staged again only when the variant
//     changes;
//   * a ring of nbuf (2 where it fits, else 1) item stages filled by
//     cp.async — the x tile as it arrives (line-major, row stride 132) and
//     N's sl carry rows — so the next item's loads run under this item's
//     product and emit;
//   * pipeline.cuh's gemm_lines: both operands read along the contraction,
//     free of bank conflicts, one fmaf per row ascending from 0.f (x rows
//     then carry rows): y bit for bit that of completion_rot_tails;
//   * without a stencil, each thread's accumulators hold four consecutive
//     lines of each of its outputs, stored straight to y as float4 (32 B
//     sectors whole); with one, the tile goes to the freed stage in two
//     halves of 64 lines, transposed at a row stride of 68 floats (free of
//     bank conflicts), between its halo rows (loaded into registers ahead
//     of their use: the first half's before the product), and each thread
//     sums 32 outputs with the taps outer, the taps staged in shared
//     memory once per block.
// Shared memory: the operand 128 * (132 + sl) floats, the taps, and nbuf
// stages of max(128 * 132 + 128 * sl, (hp + 128 + hn) * 68) floats:
// 215,072 bytes for C1's passes (sl = 8, hp + hn <= 38, nbuf = 2). The
// launcher takes two stages where they fit in the 227 KB a block may
// have, else one, and refuses with cudaErrorLaunchOutOfResources where
// even one does not (only past about 3,900 taps).
// Measured at C1's x pass (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00
// W): 0.1714 ms of device time with the 3-tap stencil, 0.1466 without
// (40.6 % and 46.5 % of the bound), against 0.1268 for one torch.matmul
// that emits the same rotated layout (cuBLAS's fp32 SIMT GEMM) and 0.1281
// for one batched matmul with the stencil folded into the operand. The
// product runs at about half the fp32 peak; a second register set for the next
// step's fragments, and 512 threads of 4 x 8 sums (spilling at 128
// registers), measured no faster. The tensor cores are the way past it
// (split-bf16 products, with completion_rot_tails: ROADMAP Queue 2).
constexpr int LDZ = T / 2 + 4;  // row stride of a staged half tile

// The rotated emit of a thread's accumulators with no stencil: output row
// r0 + out_of(j), lines l0 + line_of(i); the affine epilogue first, each
// aux array's sixteen loads issued before their products (a use stalls
// the warp until its load lands: one load at a time would wait on the
// memory once per load).
template <int K>
__device__ __forceinline__ void rot_emit_direct(float (&c)[8][8],
                                                float* __restrict__ y,
                                                const rf::Affine& epi,
                                                long r0, int l0, int q,
                                                bool vec, int ty, int tx) {
  if constexpr (K != rf::NO_EPI) {
    const float a = epi.coef[0], bias = epi.coef[1];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a, c[i][j], bias);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float bk = epi.coef[2 + k];
      const float* aux = epi.aux[k];
      float u[8][8];  // u[4h + v][j]: line l0 + h*64 + ty*4 + v, out j
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int l = l0 + h * 64 + ty * 4;
          const float* p = aux + (r0 + rfp::out_of(j, tx)) * q + l;
          if (vec) {
            const float4 w = l < q ? *reinterpret_cast<const float4*>(p)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
            u[4 * h][j] = w.x;
            u[4 * h + 1][j] = w.y;
            u[4 * h + 2][j] = w.z;
            u[4 * h + 3][j] = w.w;
          } else {
#pragma unroll
            for (int v = 0; v < 4; ++v) u[4 * h + v][j] = l + v < q ? p[v] : 0.f;
          }
        }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(bk, u[i][j], c[i][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = l0 + h * 64 + ty * 4;
      float* yo = y + (r0 + rfp::out_of(j, tx)) * q + l;
      if (vec && l < q) {
        *reinterpret_cast<float4*>(yo) =
            make_float4(c[4 * h][j], c[4 * h + 1][j], c[4 * h + 2][j],
                        c[4 * h + 3][j]);
      } else if (!vec) {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (l + v < q) yo[v] = c[4 * h + v][j];
      }
    }
}

// The fused stencil's emit of one half of the tile (lines lh + l, l < 64),
// staged in Z (rows hp + o, the halo rows around them): each of the
// thread's OUT outputs o = og + STEP*s summed over the taps in tap order
// (products then sums, each rounded), the taps outer so the outputs' reads
// are in flight together; then the affine epilogue and the stores.
constexpr int STEP = THREADS / (T / 2);  // output rows a pass of threads
constexpr int OUT = T / STEP;            // outputs per thread and half
template <int K>
__device__ __forceinline__ void rot_emit_stencil(
    const float* __restrict__ Z, const int* __restrict__ dt,
    const float* __restrict__ ct, float* __restrict__ y,
    const rf::Affine& epi, int t, int n, int lh, int q, int hp, int ntaps,
    int start_clamp, int end_clamp, int tid) {
  const int l = tid & (T / 2 - 1), og = tid / (T / 2);
  if (lh + l >= q) return;
  const bool sc = start_clamp && t == 0, ec = end_clamp && t == n - 1;
  float acc[OUT];
  for (int k = 0; k < ntaps; ++k) {
    const int d = dt[k];
    const float c = ct[k];
#pragma unroll
    for (int s = 0; s < OUT; ++s) {
      int r = og + STEP * s + d;
      if (d > 0 && ec && r > T - 1) r = T - 1;
      if (d < 0 && sc && r < 0) r = 0;
      const float term = __fmul_rn(c, Z[(hp + r) * LDZ + l]);
      acc[s] = k == 0 ? term : __fadd_rn(acc[s], term);
    }
  }
  const long y0 = (long)t * T * q + lh + l + (long)og * q;
  rf::affine_strided<K>(epi, acc, y0, (long)STEP * q);
#pragma unroll
  for (int s = 0; s < OUT; ++s) y[y0 + (long)s * STEP * q] = acc[s];
}

// The halo values base + u*THREADS + tid (u < HC) of the half of lines
// lh.. (value i: row i / 64 of prev (i < hp*64) or nxt, line lh + i % 64;
// zeros past the array or past q), into registers; then into Z's halo rows.
constexpr int HC = 16;
__device__ __forceinline__ void load_halo(float (&hv)[HC],
                                          const float* __restrict__ prev,
                                          const float* __restrict__ nxt,
                                          int base, int halo, int t, int n,
                                          int lh, int q, int hp, int hn,
                                          int tid) {
#pragma unroll
  for (int u = 0; u < HC; ++u) {
    const int i = base + u * THREADS + tid;
    const int r = i >> 6, l = i & 63;
    hv[u] = 0.f;
    if (i < halo && lh + l < q) {
      if (r < hp) {
        if (t > 0) hv[u] = prev[((long)t * hp + r) * q + lh + l];
      } else if (t < n - 1) {
        hv[u] = nxt[((long)t * hn + r - hp) * q + lh + l];
      }
    }
  }
}
__device__ __forceinline__ void store_halo(float* Z, const float (&hv)[HC],
                                           int base, int halo, int hp,
                                           int tid) {
#pragma unroll
  for (int u = 0; u < HC; ++u) {
    const int i = base + u * THREADS + tid;
    const int r = i >> 6, l = i & 63;
    if (i < halo) Z[(r < hp ? r : r + T) * LDZ + l] = hv[u];
  }
}

template <int K>  // affine epilogue aux count, or NO_EPI
__global__ void __launch_bounds__(THREADS, 1)
completion_rot_kernel(const float* __restrict__ x,     // (q, n, T)
                      const float* __restrict__ N,     // (n, sl, q)
                      const float* __restrict__ BT,    // (nv, T, T + sl)
                      const float* __restrict__ prev,  // (n, hp, q)
                      const float* __restrict__ nxt,   // (n, hn, q)
                      const float* __restrict__ taps,  // (ntaps, 2): d, c
                      float* __restrict__ y,           // (n * T, q)
                      rf::Affine epi,                  // aux: (n * T, q)
                      int q, int n, int sl, int nv, int hp, int hn,
                      int ntaps, int start_clamp, int end_clamp, int nbuf) {
  extern __shared__ float4 smem4[];
  const int depth = T + sl, ldb = depth + 4;
  const int xn = T * rfp::LDX + sl * T, zh = ntaps ? (hp + T + hn) * LDZ : 0;
  const int stage = xn > zh ? xn : zh;  // floats, a multiple of 4
  int* dt = reinterpret_cast<int*>(smem4);          // tap offsets d_k
  float* ct = reinterpret_cast<float*>(dt + ntaps);  // tap weights c_k
  float* Bs = reinterpret_cast<float*>(smem4) + (2 * ntaps + 3) / 4 * 4;
  float* ring = Bs + T * ldb;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nb = (q + T - 1) / T, items = n * nb;
  const bool vec = q % 4 == 0;  // y, N and aux rows 16-byte aligned
  for (int k = tid; k < ntaps; k += THREADS) {
    dt[k] = (int)taps[2 * k];
    ct[k] = taps[2 * k + 1];
  }

  // one item's x tile and carry rows into a stage, asynchronously; lines
  // past q as zeros
  auto load = [&](int it, float* st) {
    int t, b;
    rfp::item(it, n, nb, nv, t, b);
    const int l0 = b * T;
    for (int i = tid; i < T * (T / 4); i += THREADS) {
      const int r = i >> 5, c4 = i & 31;
      const bool ok = l0 + r < q;
      rfp::cp16(st + r * rfp::LDX + 4 * c4,
                ok ? x + ((long)(l0 + r) * n + t) * T + 4 * c4 : x, ok);
    }
    float* Ns = st + T * rfp::LDX;
    const float* Nt = N + (long)t * sl * q + l0;
    if (vec) {
      for (int i = tid; i < sl * (T / 4); i += THREADS) {
        const int s = i >> 5, l = 4 * (i & 31);
        const bool ok = l0 + l < q;
        rfp::cp16(Ns + s * T + l, ok ? Nt + (long)s * q + l : N, ok);
      }
    } else {
      for (int i = tid; i < sl * T; i += THREADS) {
        const int s = i >> 7, l = i & 127;
        const bool ok = l0 + l < q;
        rfp::cp4(Ns + s * T + l, ok ? Nt + (long)s * q + l : N, ok);
      }
    }
  };

  for (int p = 0; p + 1 < nbuf; ++p) {  // the ring's first items
    const int it = blockIdx.x + p * gridDim.x;
    if (it < items) load(it, ring + p * stage);
    rfp::commit();
  }
  int cur_v = -1, idx = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++idx) {
    int t, b;
    rfp::item(it, n, nb, nv, t, b);
    const int v = rf::variant(nv, t, n);
    if (v != cur_v) {  // every thread is past the last product (loop end)
      const float* src = BT + (long)v * T * depth;
      const int row4 = depth / 4;
      for (int i = tid; i < T * row4; i += THREADS) {
        const int o = i / row4, c4 = i - o * row4;
        rfp::cp16(Bs + o * ldb + 4 * c4, src + (long)o * depth + 4 * c4,
                  true);
      }
      rfp::commit();
      cur_v = v;
    }
    const int ahead = it + (nbuf - 1) * gridDim.x;
    if (ahead < items) load(ahead, ring + (idx + nbuf - 1) % nbuf * stage);
    rfp::commit();
    rfp::wait_pending(nbuf - 1);  // this item's stage (and B) landed
    __syncthreads();

    float* st = ring + idx % nbuf * stage;
    const int l0 = b * T;
    // the fused stencil's halo rows, a half at a time in registers: the
    // first half's loads issued before the product, the second's before
    // the first half's taps, so their latency hides under work (where
    // they take more than HC values a thread, the rest load after)
    const int halo = ntaps ? (hp + hn) * (T / 2) : 0;  // values a half
    float hv[HC];
    if (ntaps) load_halo(hv, prev, nxt, 0, halo, t, n, l0, q, hp, hn, tid);
    float c[8][8];
    rfp::gemm_lines(st, st + T * rfp::LDX, Bs, ldb, sl, c, ty, tx);
    if (ntaps == 0) {
      rot_emit_direct<K>(c, y, epi, (long)t * T, l0, q, vec, ty, tx);
    } else {
      // each half of 64 lines: the tile's rows transposed into the stage
      // (Z[hp + o][l]) between the halo rows, then the taps
      float* Z = st;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lh = l0 + h * (T / 2);
        __syncthreads();  // the product (h = 0) or the first half is read
        store_halo(Z, hv, 0, halo, hp, tid);
        for (int base = HC * THREADS; base < halo; base += HC * THREADS) {
          load_halo(hv, prev, nxt, base, halo, t, n, lh, q, hp, hn, tid);
          store_halo(Z, hv, base, halo, hp, tid);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float4*>(Z + (hp + rfp::out_of(j, tx)) * LDZ +
                                     ty * 4) =
              make_float4(c[4 * h][j], c[4 * h + 1][j], c[4 * h + 2][j],
                          c[4 * h + 3][j]);
        if (h == 0)
          load_halo(hv, prev, nxt, 0, halo, t, n, lh + T / 2, q, hp, hn,
                    tid);
        __syncthreads();
        rot_emit_stencil<K>(Z, dt, ct, y, epi, t, n, lh, q, hp, ntaps,
                            start_clamp, end_clamp, tid);
      }
    }
    __syncthreads();  // the stage is read: it may be refilled
  }
}

// completion_rot_tails: completion_rot with no stencil that ALSO writes the
// next pass's local tails, read from the tile it already holds, so the next
// pass of a rotation chain starts at its carry solve without reading the
// signal (the next pass touches device memory twice: read x, write y).
//
// Replaces completion_pass(rot=True, next_tails=) (_completion_kernel with
// kt > 0). After a rotated emit the next pass scans this pass's line axis:
// with q = ra * n2 * 128 lines, line block b (128 lines) is tile
// c = b % n2 of the next pass's scanned axis on its a = b / n2-th extent
// (images: ra = 1; volumes: ra whole extents, the other rotated axes). The
// next pass's lines are this pass's outputs t*128 + o, a-minor, so
//
//   tails2[c, s, (t*128 + o) * ra + a] = sum_j G2_v(c)[s, j] * Y[t*128 + o,
//                                                                 b*128 + j]
//
// in the (n2, 8, n*128 * ra) slot-padded transposed layout the next pass's
// solve reads (rows s >= S2 written as zeros), v(c) = variant(nv2, c, n2).
// The sums run in fp64 from the fp32 tile values and the fp32 rows of G2,
// in tails.cu's order (one fma per tau, ascending), so a chained pass reads
// bit for bit the tails an unchained pass would read from y.
//
// What bounds it: the GEMM, as for completion_rot (2 * (128 + 8) FLOP per
// sample in fp32); the tails add 2 * S2 fp64 FLOP per sample and 8 / 128 of
// a write. Shared memory: the GEMM's 139 KB at sl = 8, then the tile at a
// row stride of 129 floats (so both the coalesced y rows and the per-output
// tails dot products read it free of bank conflicts) and G2's 8 rows in
// fp64 over the same space (74 KB).
constexpr int ZS = T + 1;  // row stride of the staged tile

__global__ void __launch_bounds__(THREADS, 1)
completion_rot_tails_kernel(const float* __restrict__ x,   // (q, n, T)
                            const float* __restrict__ N,   // (n, sl, q)
                            const float* __restrict__ BR,  // (nv, T + sl, T)
                            const float* __restrict__ G2,  // (nv2, 8, T)
                            float* __restrict__ y,         // (n * T, q)
                            float* __restrict__ tails2,    // (n2, 8, n*T*ra)
                            int q, int n, int sl, int nv, int n2, int S2,
                            int nv2) {
  extern __shared__ float4 smem4[];
  const int depth = T + sl;
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + depth * T;

  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int l0 = b * T;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int v = rf::variant(nv, t, n);

  for (int i = tid; i < T * (T / 4); i += THREADS) {
    const int l = i % T, c4 = i / T;
    const float4 val = reinterpret_cast<const float4*>(
        x + ((long)(l0 + l) * n + t) * T)[c4];
    As[(4 * c4 + 0) * T + l] = val.x;
    As[(4 * c4 + 1) * T + l] = val.y;
    As[(4 * c4 + 2) * T + l] = val.z;
    As[(4 * c4 + 3) * T + l] = val.w;
  }
  const float* Nt = N + (long)t * sl * q;
  for (int i = tid; i < sl * T; i += THREADS) {
    const int s = i / T, l = i % T;
    As[(T + s) * T + l] = Nt[(long)s * q + l0 + l];
  }
  rf::stage_rows(Bs, BR + (long)v * depth * T, depth, T, tid);
  __syncthreads();

  float c[8][8];
  rf::gemm_tile(As, Bs, c, ty, tx, depth);
  __syncthreads();

  // the tile, transposed: Zs[o][l] = Y[l][o]; G2's rows in fp64 after it
  float* Zs = reinterpret_cast<float*>(smem4);
  double* g2 = reinterpret_cast<double*>(Zs + T * ZS);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      Zs[rf::row_of(j, tx) * ZS + rf::row_of(i, ty)] = c[i][j];
  const int a = b / n2, cn = b % n2;
  const float* g2v = G2 + (long)rf::variant(nv2, cn, n2) * 8 * T;
  for (int i = tid; i < 8 * T; i += THREADS) g2[i] = (double)g2v[i];
  __syncthreads();

  const int l = tid % T;
  float* yt = y + (long)t * T * q + l0 + l;
  for (int o = tid / T; o < T; o += THREADS / T)
    yt[(long)o * q] = Zs[o * ZS + l];

  // the next pass's tails: output o of this tile is one of its lines
  const int o = tid % T;
  const long nT = (long)n * T;
  const int ra = q / (n2 * T);
  const float* z = Zs + o * ZS;
  for (int s = tid / T; s < 8; s += THREADS / T) {
    float val = 0.f;
    if (s < S2) {
      const double* gs = g2 + s * T;
      double acc = 0.0;
      for (int j = 0; j < T; ++j) acc = fma(gs[j], (double)z[j], acc);
      val = (float)acc;
    }
    tails2[(((long)cn * 8 + s) * nT + (long)t * T + o) * ra + a] = val;
  }
}

// Shared memory of completion_rot (bytes): the taps, the operand, nbuf
// stages.
inline long rot_smem(int sl, int hp, int hn, int ntaps, int nbuf) {
  const long xn = (long)T * (T + 4) + (long)sl * T;
  const long zh = ntaps ? (long)(hp + T + hn) * LDZ : 0;
  return 4 * ((2L * ntaps + 3) / 4 * 4 + (long)T * (T + sl + 4) +
              nbuf * (xn > zh ? xn : zh));
}

template <int K>
int rot_launch(const float* x, const float* N, const float* BT,
               const float* prev, const float* nxt, const float* taps,
               float* y, const rf::Affine& epi, int q, int n, int sl, int nv,
               int hp, int hn, int ntaps, int start_clamp, int end_clamp,
               cudaStream_t stream) {
  if (sl < 8 || sl > MAX_SL || sl % 8 || hp < 0 || hn < 0 || hp > T ||
      hn > T || ntaps < 0 || (ntaps == 0 && (hp || hn)) || q < 1 || n < 1 ||
      (nv != 1 && nv != 3))
    return (int)cudaErrorInvalidValue;
  const int nbuf = rot_smem(sl, hp, hn, ntaps, 2) <= MAX_SMEM ? 2 : 1;
  const long smem = rot_smem(sl, hp, hn, ntaps, nbuf);
  if (smem > MAX_SMEM) return (int)cudaErrorLaunchOutOfResources;
  cudaError_t err = cudaFuncSetAttribute(
      completion_rot_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = rfp::persistent_grid((long)n * ((q + T - 1) / T));
  completion_rot_kernel<K><<<grid, THREADS, (int)smem, stream>>>(
      x, N, BT, prev, nxt, taps, y, epi, q, n, sl, nv, hp, hn, ntaps,
      start_clamp, end_clamp, nbuf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int completion_rot_tails_launch(
    const float* x, const float* N, const float* BR, const float* G2,
    float* y, float* tails2, int q, int n, int sl, int nv, int n2, int S2,
    int nv2, void* stream) {
  if (sl != 8 || n2 < 1 || S2 < 1 || S2 > 8 || q < 1 || q % (n2 * T) ||
      (nv2 != 1 && nv2 != 3))
    return (int)cudaErrorInvalidValue;
  const int gemm = 2 * (T + sl) * T * (int)sizeof(float);
  const int stage = T * ZS * (int)sizeof(float) + 8 * T * (int)sizeof(double);
  const int smem = gemm > stage ? gemm : stage;
  cudaError_t err = cudaFuncSetAttribute(
      completion_rot_tails_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n, q / T);
  completion_rot_tails_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, N, BR, G2, y, tails2, q, n, sl, nv, n2, S2, nv2);
  return (int)cudaGetLastError();
}


// BT = [Btot | Rcat] per variant, (nv, 128, 128 + sl)
extern "C" int completion_rot_launch(const float* x, const float* N,
                                     const float* BT, const float* prev,
                                     const float* nxt, const float* taps,
                                     float* y, int q, int n, int sl, int nv,
                                     int hp, int hn, int ntaps,
                                     int start_clamp, int end_clamp,
                                     void* stream) {
  return rot_launch<rf::NO_EPI>(x, N, BT, prev, nxt, taps, y, rf::Affine{},
                                q, n, sl, nv, hp, hn, ntaps, start_clamp,
                                end_clamp, (cudaStream_t)stream);
}

// coef = [a, c, b0..b3] (float32, on the card); aux0..aux{k-1} in y's
// (n * 128, q) layout, the rest unread
extern "C" int completion_rot_epi_launch(
    const float* x, const float* N, const float* BT, const float* prev,
    const float* nxt, const float* taps, const float* aux0,
    const float* aux1, const float* aux2, const float* aux3,
    const float* coef, float* y, int q, int n, int sl, int nv, int hp,
    int hn, int ntaps, int start_clamp, int end_clamp, int k,
    void* stream) {
  const rf::Affine epi = rf::make_affine(aux0, aux1, aux2, aux3, coef);
  int err = (int)cudaErrorInvalidValue;
  rf::dispatch_aux(k, [&](auto kc) {
    err = rot_launch<decltype(kc)::value>(
        x, N, BT, prev, nxt, taps, y, epi, q, n, sl, nv, hp, hn, ntaps,
        start_clamp, end_clamp, (cudaStream_t)stream);
  });
  return err;
}

// Bc: kernels/completion.py's CompletionPass.Bc_k, (nv, 3, 128 * KP) bf16
extern "C" int completion_launch(const float* x, const float* N,
                                 const void* Bc, float* y, int q, int n,
                                 int sl, int nv, void* stream) {
  return static_launch<6>(x, N, Bc, y, rf::Affine{}, 0, q, n, sl, nv,
                          (cudaStream_t)stream);
}

// coef = [a, c, b0..b3] (float32, on the card); aux0..aux{k-1} in y's
// (q, n, 128) layout, the rest unread
extern "C" int completion_epi_launch(const float* x, const float* N,
                                     const void* Bc, const float* aux0,
                                     const float* aux1, const float* aux2,
                                     const float* aux3, const float* coef,
                                     float* y, int q, int n, int sl, int nv,
                                     int k, void* stream) {
  if (coef == nullptr) return (int)cudaErrorInvalidValue;
  return static_launch<6>(x, N, Bc, y,
                          rf::make_affine(aux0, aux1, aux2, aux3, coef), k,
                          q, n, sl, nv, (cudaStream_t)stream);
}

// the learnable executor's completion: N (n, 8, q), Btot (T, T) and Rcat
// (T, S) as they are (see completion_tc_kernel<true>)
extern "C" int completion_traced_launch(const float* x, const float* N,
                                        const float* Btot, const float* Rcat,
                                        float* y, int q, int n, int S,
                                        void* stream) {
  if (S < 1 || S > 8 || q < 1 || n < 1) return (int)cudaErrorInvalidValue;
  return tc_launch<true, 1, 6>(x, N, nullptr, Btot, Rcat, y, rf::Affine{},
                               0, q, n, 8, 1, S, (cudaStream_t)stream);
}

extern "C" const char* completion_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
