// completion: the completion of every tile of a 1-D last-axis pass — read
// the signal once, inject the solved carries, write the output once.
//
// Replaces recfilter_tpu/kernels/completion.py::completion_pass (Pallas
// kernel _completion_kernel) with rot=False and transposed slot-padded
// carries. For x (q lines, n tiles, 128), the solved carries N (n, sl, q)
// and v(t) the tile's matrix variant (interior, first or last):
//
//   Y[l, t, :] = Btot_v(t) * x[l, t, :] + Rcat_v(t) * N[t, :, l]
//
// One block takes one tile t and 128 lines and runs it as one GEMM over a
// (128 + sl)-deep contraction, the carry rows stacked under the signal
// rows, as final2d.cu stacks its 8 carry rows:
//
//   A[kk][l] = x[l, t, kk] (kk < 128),  N[t, kk-128, l]  (kk >= 128)
//   B[kk][o] = Btot_v[o][kk]           , Rcat_v[o][kk-128]
//   Y[l, t, o] = sum_kk A[kk][l] * B[kk][o]
//
// with common.cuh's register-tiled GEMM (the one final2d.cu runs). The
// operand B_v = [Btot^T; Rcat^T] (nv, 128 + sl, 128) is prepared on the
// host, so it stages as a contiguous copy; x is transposed on its way into
// shared memory (consecutive threads take consecutive lines, so the
// shared stores are free of bank conflicts).
//
// What bounds it: 2 * (128 + sl) FLOP per sample against 8 B of traffic,
// so on the H100's fp32 CUDA cores it is bound by arithmetic (3.4 GFLOP at
// 10M samples and sl = 8). fp32 FMA throughout; no wgmma, TMA or TF32 yet.
// Shared memory is 2 * (128 + sl) * 128 * 4 B: 139 KB at sl = 8, 188 KB at
// sl = 56, one block per SM.
//
// completion_epi (K >= 0): the same kernel with the affine epilogue in its
// store loop, out = a * Y + sum_{j<K} b_j * aux_j + c (K <= 4, each aux in
// y's (q, n, T) layout, read with the store's float4 indexing; fp32 FMAs,
// common.cuh's affine_tile) — the epilogue of completion_pass (eaux operands,
// recfilter_tpu/kernels/completion.py:273). Each aux adds 4 B per sample of
// reads; the kernel stays bound by its arithmetic.
//
// completion_split: completion (unrotated, no epilogue) at the reduced
// precision grades — replaces completion_pass(rot=False, nprod=n) at nprod 1
// (default), 3 (px3) and 4 (px4). The same per-tile product
//
//   Y[l, t, :] = sum_(i,j) Bc_i[v(t)] * [x[l, t, :]; N[t, :, l]]_j
//
// over split.cuh's chunk pairs (i, j), smallest level first — NPROD on the
// 128 signal rows, carry_nprod(NPROD) >= 3 on the carry rows (the carry
// terms cancel: kernels/split.py) — on bf16 tensor cores (mma.sync
// m16n8k16, fp32 accumulation): the signal and its
// carries are split into bf16 chunks as they are staged (lines l as rows,
// the contraction contiguous), the constant Bc (nv, NC, 128, LD) = [Btot |
// Rcat | 0] (rows o) was split on the host. The contraction 128 + sl is
// padded with zeros to a multiple of 16 (LD = that + 8); shared memory is
// 2 x NC x 128 x LD x 2 B with NC = 2 chunks at every NPROD here, 156 KB
// with sl = 8, 205 KB at sl = 56.
// Bound: 2 x (128 NPROD + sl carry_nprod) FLOP per sample on the bf16
// tensor cores against 8 B of traffic — at the card's peaks, by bytes.
//
// completion_traced (TRACED = true): the learnable executor's completion,
// replacing recfilter_tpu/kernels/completion.py::completion_pass_traced.
// The same GEMM with sl = 8, one variant, but Btot (128, 128) and Rcat
// (128, S <= 8) are runtime matrices built from trainable coefficients, in
// their natural layout: the block transposes them on the way into shared
// memory (B[kk][o] = Btot[o][kk], Rcat[o][kk-128]; consecutive threads take
// consecutive outputs o, so the stores are free of bank conflicts) and
// zeros the slot rows past S, on both operands: N's pad rows are never
// read. So the caller runs no cat, pad or transpose per call. Staging
// the transpose costs each block one 64 KB read of Btot, from L2 after the
// first blocks, as the static path's [Btot^T; Rcat^T] does.

#include "common.cuh"
#include "split.cuh"

namespace {

constexpr int T = rf::GT;                  // tile width, and lines per block
constexpr int THREADS = rf::GEMM_THREADS;  // 16 x 16, 8 x 8 outputs each
constexpr int MAX_SL = 56;                 // carry rows the layout takes

// S: the carry rows read from N (sl for the static entry, the real rows of
// Rcat for the traced one); rows S..sl-1 of the contraction are zeros.
template <bool TRACED, int K>  // K: affine epilogue aux count, or NO_EPI
__global__ void __launch_bounds__(THREADS, 1)
completion_kernel(const float* __restrict__ x,   // (q, n, T)
                  const float* __restrict__ N,   // (n, sl, q)
                  const float* __restrict__ BR,  // (nv, T + sl, T); traced:
                                                 // Btot (T, T)
                  const float* __restrict__ Rc,  // traced: Rcat (T, S)
                  float* __restrict__ y,         // (q, n, T)
                  rf::Affine epi,                // aux: (q, n, T)
                  int q, int n, int sl, int nv, int S) {
  extern __shared__ float4 smem4[];
  const int depth = T + sl;
  float* As = reinterpret_cast<float*>(smem4);  // depth x T, columns: lines
  float* Bs = As + depth * T;                   // depth x T, columns: outputs

  const int t = blockIdx.x;
  const int l0 = blockIdx.y * T;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int v = rf::variant(nv, t, n);

  for (int i = tid; i < T * (T / 4); i += THREADS) {
    const int l = i % T, c4 = i / T;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (l0 + l < q)
      val = reinterpret_cast<const float4*>(
          x + ((long)(l0 + l) * n + t) * T)[c4];
    As[(4 * c4 + 0) * T + l] = val.x;
    As[(4 * c4 + 1) * T + l] = val.y;
    As[(4 * c4 + 2) * T + l] = val.z;
    As[(4 * c4 + 3) * T + l] = val.w;
  }
  const float* Nt = N + (long)t * sl * q;
  for (int i = tid; i < sl * T; i += THREADS) {
    const int s = i / T, l = i % T;
    As[(T + s) * T + l] =
        (s < S && l0 + l < q) ? Nt[(long)s * q + l0 + l] : 0.f;
  }
  if constexpr (TRACED) {
    for (int i = tid; i < T * (T / 4); i += THREADS) {
      const int o = i % T, c4 = i / T;
      const float4 b = reinterpret_cast<const float4*>(BR + (long)o * T)[c4];
      Bs[(4 * c4 + 0) * T + o] = b.x;
      Bs[(4 * c4 + 1) * T + o] = b.y;
      Bs[(4 * c4 + 2) * T + o] = b.z;
      Bs[(4 * c4 + 3) * T + o] = b.w;
    }
    for (int i = tid; i < sl * T; i += THREADS) {
      const int s = i / T, o = i % T;
      Bs[(T + s) * T + o] = s < S ? Rc[(long)o * S + s] : 0.f;
    }
  } else {
    rf::stage_rows(Bs, BR + (long)v * depth * T, depth, T, tid);
  }
  __syncthreads();

  float c[8][8];
  rf::gemm_tile(As, Bs, c, ty, tx, depth);

  long r0[8];
  bool ok[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = l0 + rf::row_of(i, ty);
    r0[i] = ((long)l * n + t) * T + tx * 4;
    ok[i] = l < q;
  }
  rf::affine_tile<K>(epi, c, r0, ok);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (ok[i]) {
      *reinterpret_cast<float4*>(y + r0[i]) =
          make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
      *reinterpret_cast<float4*>(y + r0[i] + 64) =
          make_float4(c[i][4], c[i][5], c[i][6], c[i][7]);
    }
  }
}

// completion_rot: the same per-tile product, emitted ROTATED — the tile
// transposed, Y[t*128 + o, l] into an (n*128, q) output — with an optional
// shifted-tap stencil consumer along the scanned axis fused into the emit.
//
// Replaces completion_pass(rot=True) and its stencil epilogue
// (_completion_kernel with _stencil_rows). The GEMM runs as above; the
// tile then goes to shared memory transposed, Zs[hp + o][l], between the
// neighbour tiles' halo rows — prev (the hp last rows of tile t-1,
// completed) above and nxt (the hn first rows of tile t+1) below — so the
// output rows leave as 512-byte rows of lines, coalesced. With ntaps > 0
// each output is
//
//   out[t*128 + o, l] = sum_k c_k * Zs[hp + r_k][l],   r_k = o + d_k
//
// where the globally-first/last tile applies the border rule: "zero"
// reads 0 past the array (the halo rows there are never read), "clamp"
// (start_clamp for d < 0 at tile 0, end_clamp for d > 0 at tile n-1)
// replicates the global first or last row — the JAX package's
// _stencil_rows. Products then sums, each rounded (no FMA), in tap order,
// as the twin _stencil_flat takes them. completion_rot_epi (K >= 0) then
// applies the affine epilogue to each output, after the stencil (the
// consumer order of completion.py:266-278), its aux in y's (n*128, q)
// layout.
//
// What bounds it: the GEMM, as for completion (2 * (128 + sl) FLOP per
// sample); the stencil adds 2 FLOP per tap and the halo reads (hp + hn)
// rows per 128. Shared memory: the GEMM's 2 * (128 + sl) * 128 floats,
// then the (hp + 128 + hn) * 128 staged rows over the same space
// (hp, hn <= 128: 196 KB at most).
template <int K>  // affine epilogue aux count, or NO_EPI
__global__ void __launch_bounds__(THREADS, 1)
completion_rot_kernel(const float* __restrict__ x,     // (q, n, T)
                      const float* __restrict__ N,     // (n, sl, q)
                      const float* __restrict__ BR,    // (nv, T + sl, T)
                      const float* __restrict__ prev,  // (n, hp, q)
                      const float* __restrict__ nxt,   // (n, hn, q)
                      const float* __restrict__ taps,  // (ntaps, 2): d, c
                      float* __restrict__ y,           // (n * T, q)
                      rf::Affine epi,                  // aux: (n * T, q)
                      int q, int n, int sl, int nv, int hp, int hn,
                      int ntaps, int start_clamp, int end_clamp) {
  extern __shared__ float4 smem4[];
  const int depth = T + sl;
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + depth * T;

  const int t = blockIdx.x;
  const int l0 = blockIdx.y * T;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int v = rf::variant(nv, t, n);

  for (int i = tid; i < T * (T / 4); i += THREADS) {
    const int l = i % T, c4 = i / T;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (l0 + l < q)
      val = reinterpret_cast<const float4*>(
          x + ((long)(l0 + l) * n + t) * T)[c4];
    As[(4 * c4 + 0) * T + l] = val.x;
    As[(4 * c4 + 1) * T + l] = val.y;
    As[(4 * c4 + 2) * T + l] = val.z;
    As[(4 * c4 + 3) * T + l] = val.w;
  }
  const float* Nt = N + (long)t * sl * q;
  for (int i = tid; i < sl * T; i += THREADS) {
    const int s = i / T, l = i % T;
    As[(T + s) * T + l] = l0 + l < q ? Nt[(long)s * q + l0 + l] : 0.f;
  }
  rf::stage_rows(Bs, BR + (long)v * depth * T, depth, T, tid);
  __syncthreads();

  float c[8][8];
  rf::gemm_tile(As, Bs, c, ty, tx, depth);
  __syncthreads();

  // the tile, transposed: Zs[hp + o][l] = Y[l][o] (float4 along lines)
  float* Zs = reinterpret_cast<float*>(smem4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int o = rf::row_of(j, tx);
    *reinterpret_cast<float4*>(Zs + (hp + o) * T + ty * 4) =
        make_float4(c[0][j], c[1][j], c[2][j], c[3][j]);
    *reinterpret_cast<float4*>(Zs + (hp + o) * T + 64 + ty * 4) =
        make_float4(c[4][j], c[5][j], c[6][j], c[7][j]);
  }
  if (ntaps > 0) {
    for (int i = tid; i < hp * T; i += THREADS) {
      const int r = i / T, l = i % T;
      Zs[i] = (t > 0 && l0 + l < q)
                  ? prev[((long)t * hp + r) * q + l0 + l] : 0.f;
    }
    for (int i = tid; i < hn * T; i += THREADS) {
      const int r = i / T, l = i % T;
      Zs[(hp + T + r) * T + l] = (t < n - 1 && l0 + l < q)
                                     ? nxt[((long)t * hn + r) * q + l0 + l]
                                     : 0.f;
    }
  }
  __syncthreads();

  const int l = tid % T;
  if (l0 + l >= q) return;
  const long y0 = (long)t * T * q + l0 + l;
  // outputs o = ob + s * STEP, s < CH, per chunk: the epilogue's aux loads
  // of a chunk are in flight together (common.cuh's affine_strided); with
  // no epilogue one output per step
  constexpr int STEP = THREADS / T, CH = K == rf::NO_EPI ? 1 : 8;
  static_assert(T % (CH * STEP) == 0, "the chunks cover the tile's rows");
  for (int ob = tid / T; ob < T; ob += CH * STEP) {
    float v[CH];
#pragma unroll
    for (int s = 0; s < CH; ++s) {
      const int o = ob + s * STEP;
      if (ntaps == 0) {
        v[s] = Zs[(hp + o) * T + l];
        continue;
      }
      float acc = 0.f;
      for (int k = 0; k < ntaps; ++k) {
        const int d = (int)taps[2 * k];
        int r = o + d;
        if (d > 0 && end_clamp && t == n - 1 && r > T - 1) r = T - 1;
        if (d < 0 && start_clamp && t == 0 && r < 0) r = 0;
        const float term = __fmul_rn(taps[2 * k + 1], Zs[(hp + r) * T + l]);
        acc = k == 0 ? term : __fadd_rn(acc, term);
      }
      v[s] = acc;
    }
    rf::affine_strided<K>(epi, v, y0 + (long)ob * q, (long)STEP * q);
#pragma unroll
    for (int s = 0; s < CH; ++s) y[y0 + (long)(ob + s * STEP) * q] = v[s];
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
// What bounds it: the GEMM, as for completion (2 * (128 + 8) FLOP per
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

template <int K>
int rot_launch(const float* x, const float* N, const float* BR,
               const float* prev, const float* nxt, const float* taps,
               float* y, const rf::Affine& epi, int q, int n, int sl, int nv,
               int hp, int hn, int ntaps, int start_clamp, int end_clamp,
               cudaStream_t stream) {
  if (sl < 8 || sl > MAX_SL || sl % 8 || hp < 0 || hn < 0 || hp > T ||
      hn > T || ntaps < 0 || (ntaps == 0 && (hp || hn)))
    return (int)cudaErrorInvalidValue;
  const int max_smem = (2 * (T + MAX_SL) > 3 * T ? 2 * (T + MAX_SL) : 3 * T)
                       * T * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      completion_rot_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      max_smem);
  if (err != cudaSuccess) return (int)err;
  const int gemm = 2 * (T + sl) * T, stage = (hp + T + hn) * T;
  const int smem = (gemm > stage ? gemm : stage) * (int)sizeof(float);
  const dim3 grid(n, (q + T - 1) / T);
  completion_rot_kernel<K><<<grid, THREADS, smem, stream>>>(
      x, N, BR, prev, nxt, taps, y, epi, q, n, sl, nv, hp, hn, ntaps,
      start_clamp, end_clamp);
  return (int)cudaGetLastError();
}

template <int K>
int plain_launch(const float* x, const float* N, const float* BR, float* y,
                 const rf::Affine& epi, int q, int n, int sl, int nv,
                 cudaStream_t stream) {
  if (sl < 8 || sl > MAX_SL || sl % 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      completion_kernel<false, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * (T + MAX_SL) * T * (int)sizeof(float));
  if (err != cudaSuccess) return (int)err;
  const int smem = 2 * (T + sl) * T * (int)sizeof(float);
  const dim3 grid(n, (q + T - 1) / T);
  completion_kernel<false, K><<<grid, THREADS, smem, stream>>>(
      x, N, BR, nullptr, y, epi, q, n, sl, nv, sl);
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


extern "C" int completion_rot_launch(const float* x, const float* N,
                                     const float* BR, const float* prev,
                                     const float* nxt, const float* taps,
                                     float* y, int q, int n, int sl, int nv,
                                     int hp, int hn, int ntaps,
                                     int start_clamp, int end_clamp,
                                     void* stream) {
  return rot_launch<rf::NO_EPI>(x, N, BR, prev, nxt, taps, y, rf::Affine{},
                                q, n, sl, nv, hp, hn, ntaps, start_clamp,
                                end_clamp, (cudaStream_t)stream);
}

// coef = [a, c, b0..b3] (float32, on the card); aux0..aux{k-1} in y's
// (n * 128, q) layout, the rest unread
extern "C" int completion_rot_epi_launch(
    const float* x, const float* N, const float* BR, const float* prev,
    const float* nxt, const float* taps, const float* aux0,
    const float* aux1, const float* aux2, const float* aux3,
    const float* coef, float* y, int q, int n, int sl, int nv, int hp,
    int hn, int ntaps, int start_clamp, int end_clamp, int k, void* stream) {
  const rf::Affine epi = rf::make_affine(aux0, aux1, aux2, aux3, coef);
  int err = (int)cudaErrorInvalidValue;
  rf::dispatch_aux(k, [&](auto kc) {
    err = rot_launch<decltype(kc)::value>(
        x, N, BR, prev, nxt, taps, y, epi, q, n, sl, nv, hp, hn, ntaps,
        start_clamp, end_clamp, (cudaStream_t)stream);
  });
  return err;
}

extern "C" int completion_launch(const float* x, const float* N,
                                 const float* BR, float* y, int q, int n,
                                 int sl, int nv, void* stream) {
  return plain_launch<rf::NO_EPI>(x, N, BR, y, rf::Affine{}, q, n, sl, nv,
                                  (cudaStream_t)stream);
}

// coef = [a, c, b0..b3] (float32, on the card); aux0..aux{k-1} in y's
// (q, n, 128) layout, the rest unread
extern "C" int completion_epi_launch(const float* x, const float* N,
                                     const float* BR, const float* aux0,
                                     const float* aux1, const float* aux2,
                                     const float* aux3, const float* coef,
                                     float* y, int q, int n, int sl, int nv,
                                     int k, void* stream) {
  const rf::Affine epi = rf::make_affine(aux0, aux1, aux2, aux3, coef);
  int err = (int)cudaErrorInvalidValue;
  rf::dispatch_aux(k, [&](auto kc) {
    err = plain_launch<decltype(kc)::value>(x, N, BR, y, epi, q, n, sl, nv,
                                            (cudaStream_t)stream);
  });
  return err;
}

// the learnable executor's completion: N (n, 8, q), Btot (T, T) and Rcat
// (T, S) as they are (see completion_kernel<true>)
extern "C" int completion_traced_launch(const float* x, const float* N,
                                        const float* Btot, const float* Rcat,
                                        float* y, int q, int n, int S,
                                        void* stream) {
  constexpr int sl = 8;
  if (S < 1 || S > sl) return (int)cudaErrorInvalidValue;
  const int smem = 2 * (T + sl) * T * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      completion_kernel<true, rf::NO_EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n, (q + T - 1) / T);
  completion_kernel<true, rf::NO_EPI>
      <<<grid, THREADS, smem, (cudaStream_t)stream>>>(
          x, N, Btot, Rcat, y, rf::Affine{}, q, n, sl, 1, S);
  return (int)cudaGetLastError();
}

namespace {

template <int NPROD>
__global__ void __launch_bounds__(rfs::THREADS, 1)
completion_split_kernel(const float* __restrict__ x,      // (q, n, T)
                        const float* __restrict__ N,      // (n, sl, q)
                        const rfs::bf16* __restrict__ Bc,  // (nv, NC, T, LD)
                        float* __restrict__ y,            // (q, n, T)
                        int q, int n, int sl, int nv) {
  constexpr int NC = rfs::nchunks(rfs::carry_nprod(NPROD));
  const int KP = (T + sl + 15) / 16 * 16, LD = KP + 8;
  const long chunk = (long)T * LD;
  extern __shared__ uint4 smem16[];
  rfs::bf16* Cs = reinterpret_cast<rfs::bf16*>(smem16);  // constant chunks
  rfs::bf16* Ds = Cs + NC * chunk;                       // data chunks

  const int t = blockIdx.x, l0 = blockIdx.y * T, tid = threadIdx.x;
  const int v = rf::variant(nv, t, n);
  rfs::copy16(Cs, Bc + (long)v * NC * chunk,
              NC * (int)chunk * (int)sizeof(rfs::bf16), tid);
  for (int i = tid; i < T * (T / 4); i += THREADS) {
    const int l = i / (T / 4), c4 = i % (T / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (l0 + l < q)
      val = reinterpret_cast<const float4*>(
          x + ((long)(l0 + l) * n + t) * T)[c4];
    rfs::split_store4<NC>(Ds + l * LD + 4 * c4, chunk, val);
  }
  const float* Nt = N + (long)t * sl * q;
  for (int i = tid; i < (KP - T) * T; i += THREADS) {
    const int s = i / T, l = i % T;
    rfs::split_store1<NC>(Ds + l * LD + T + s, chunk,
                          (s < sl && l0 + l < q) ? Nt[(long)s * q + l0 + l]
                                                 : 0.f);
  }
  __syncthreads();
  rfs::Frag f;
  rfs::zero(f);
  rfs::split_mma_slabs<NPROD, false, false>(f, Ds, chunk, LD, Cs, chunk,
                                            LD, T, KP);
  rfs::for_pairs(f, [&](int l, int o, float v0, float v1) {
    if (l0 + l < q)
      *reinterpret_cast<float2*>(y + ((long)(l0 + l) * n + t) * T + o) =
          make_float2(v0, v1);
  });
}

template <int NPROD>
int split_launch(const float* x, const float* N, const rfs::bf16* Bc,
                 float* y, int q, int n, int sl, int nv,
                 cudaStream_t stream) {
  const int LD = (T + sl + 15) / 16 * 16 + 8;
  const int smem =
      2 * rfs::nchunks(rfs::carry_nprod(NPROD)) * T * LD *
      (int)sizeof(rfs::bf16);
  cudaError_t err = cudaFuncSetAttribute(
      completion_split_kernel<NPROD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n, (q + T - 1) / T);
  completion_split_kernel<NPROD><<<grid, THREADS, smem, stream>>>(
      x, N, Bc, y, q, n, sl, nv);
  return (int)cudaGetLastError();
}

}  // namespace

// nprod in {1, 3, 4}; sl a multiple of 8 up to MAX_SL; Bc from
// kernels/completion.py's CompletionSplit
extern "C" int completion_split_launch(const float* x, const float* N,
                                       const void* Bc, float* y, int q,
                                       int n, int sl, int nv, int nprod,
                                       void* stream) {
  if (sl < 8 || sl > MAX_SL || sl % 8) return (int)cudaErrorInvalidValue;
  const rfs::bf16* B = static_cast<const rfs::bf16*>(Bc);
  cudaStream_t s = (cudaStream_t)stream;
  switch (nprod) {
    case 1: return split_launch<1>(x, N, B, y, q, n, sl, nv, s);
    case 3: return split_launch<3>(x, N, B, y, q, n, sl, nv, s);
    case 4: return split_launch<4>(x, N, B, y, q, n, sl, nv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* completion_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
