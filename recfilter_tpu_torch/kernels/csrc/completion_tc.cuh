// completion_tc.cuh: the unrotated completion on the tensor cores,
// completion_tc_kernel<TRACED, KC, NPROD>, and its launchers — the kernel
// of completion.cu's completion, completion_epi and completion_traced
// (NPROD 6; its header gives the design) and of completion_split.cu's
// completion_split (NPROD 1, 3, 4): one kernel, two sources, so that nvcc
// builds their instantiations in parallel (each source its own library,
// hence the anonymous namespace). x and y are float, or bf16 (bf16
// storage, completion_split_bf16 at NPROD 1: the stage holds x's bf16 rows,
// read widened into the one data chunk, exact; y rounded once).
#pragma once

#include "common.cuh"
#include "pipeline.cuh"
#include "split.cuh"
#include "wgmma.cuh"

namespace {

constexpr int T = rf::GT;          // tile width, and lines per block
constexpr int MAX_SL = 56;         // carry rows the layout takes
constexpr long MAX_SMEM = 232448;  // shared memory a block may take

// x stage row stride (elements of x's type TX) and carry stage row stride
// LDNS (floats). A fragment read takes four consecutive samples of rows r
// and r + 8 a thread (lanes r = lane / 4, qd = lane % 4): 16 bytes at
// fp32, where a quarter warp reads two rows (144 floats apart: 16 banks),
// 8 bytes at bf16, where a half warp reads four rows (144 bf16 apart: 8
// banks) — no bank conflict either way, and each row 16-byte aligned.
constexpr int LDX = 144;
constexpr int LDNS = 68;
// floats of a stage's x rows
template <typename TX>
__host__ __device__ constexpr int xst() {
  return rfw::TM * LDX * (int)sizeof(TX) / 4;
}
constexpr int XST = xst<float>();

// Shared memory (bytes): the nc chunks of B (KP rows), one stage a
// warpgroup.
template <typename TX = float>
constexpr long tc_smem(int kp, int sl, int nwg, int nc) {
  return (long)nc * T * kp * 2 + 4L * nwg * (xst<TX>() + (long)sl * LDNS);
}
// completion_traced (sl = 8, px6) runs two warpgroups, whose stages hold
// its fp32 [Btot | Rcat] (S <= 8) while it splits them
static_assert(tc_smem(T + 16, 8, 2, rfw::b_chunks(6)) <= MAX_SMEM &&
                  2 * (XST + 8 * LDNS) >= T * (T + 8),
              "completion_traced's matrices outgrow its stages");

// 64 lines of tile t from line l0 into a stage's x rows Xs, asynchronously
// (16-byte copies; lines past q as zeros).
template <typename TX>
__device__ __forceinline__ void stage_x(TX* Xs, const TX* __restrict__ x,
                                        int t, int l0, int q, int n,
                                        int tid) {
  constexpr int V = 16 / (int)sizeof(TX);  // elements a copy
  for (int i = tid; i < rfw::TM * (T / V); i += rfw::WG) {
    const int rr = i / (T / V), c = V * (i % (T / V));
    const bool ok = l0 + rr < q;
    rfp::cp16(Xs + rr * LDX + c,
              ok ? x + ((long)(l0 + rr) * n + t) * T + c : x, ok);
  }
}

// NPROD: the grade (6 for completion, completion_epi and completion_traced;
// 1, 3, 4 for completion_split). TRACED: Btot, Rcat runtime fp32 matrices
// split here (one variant, sl = 8); else Bc, the host's chunks (nv, NCB,
// 128 * KP) in core-matrix order.
// S: the carry rows read from N (sl, or the real rows of Rcat); rows S..
// are zeros. epi.coef null: no epilogue; else naux aux arrays (float32).
// nwg warpgroups (blockDim.x = 128 nwg), each with its own stage and items.
// TX: x's and y's type, float or bf16 (not TRACED).
template <bool TRACED, int KC, int NPROD, typename TX = float>
__global__ void __launch_bounds__(2 * rfw::WG, 1)
completion_tc_kernel(const TX* __restrict__ x,          // (q, n, T)
                     const float* __restrict__ N,       // (n, sl, q)
                     const rfs::bf16* __restrict__ Bc,  // (nv, NCB, T * KP)
                     const float* __restrict__ Btot,    // traced: (T, T)
                     const float* __restrict__ Rcat,    // traced: (T, S)
                     TX* __restrict__ y,                // (q, n, T)
                     rf::Affine epi, int naux, int q, int n, int sl, int nv,
                     int S, int nwg) {
  constexpr int KP = T + 16 * KC;  // the contraction, padded
  constexpr int CH = T * KP;       // elements of a chunk of B
  constexpr int NCB = rfw::b_chunks(NPROD);  // chunks of B
  extern __shared__ uint4 smem16[];
  rfs::bf16* Bs = reinterpret_cast<rfs::bf16*>(smem16);
  const int stage = xst<TX>() + sl * LDNS;  // floats, a multiple of 4
  float* ring = reinterpret_cast<float*>(Bs + NCB * CH);

  const int wg = threadIdx.x / rfw::WG, tid = threadIdx.x % rfw::WG;
  const int lane = tid % 32, qd = lane % 4;
  const int r = 16 * (tid / 32) + lane / 4;  // fragment rows r, r + 8
  const int nb = (q + rfw::TM - 1) / rfw::TM;
  const bool vec = q % 4 == 0;  // N's rows 16-byte aligned
  TX* Xs = reinterpret_cast<TX*>(ring + wg * stage);  // this warpgroup's
  float* Ns = ring + wg * stage + xst<TX>();             // stage
  const rfp::Walk walk(n, nb, nv, nwg);

  // this warpgroup's item of group g into its stage, asynchronously;
  // lines past q and carry rows past S as zeros; false if it has none
  auto load = [&](int g) {
    int end;
    const int it = walk.first(g, nwg, end) + wg;
    if (g >= walk.gs[3] || it >= end) return false;
    int t, b;
    rfp::item(it, n, nb, nv, t, b);
    const int l0 = b * rfw::TM;
    stage_x(Xs, x, t, l0, q, n, tid);
    float* Nw = Ns;
    const float* Nt = N + (long)t * sl * q + l0;
    if (vec) {
      for (int i = tid; i < sl * (rfw::TM / 4); i += rfw::WG) {
        const int s = i >> 4, l = 4 * (i & 15);
        const bool ok = s < S && l0 + l < q;
        rfp::cp16(Nw + s * LDNS + l, ok ? Nt + (long)s * q + l : N, ok);
      }
    } else {
      for (int i = tid; i < sl * rfw::TM; i += rfw::WG) {
        const int s = i >> 6, l = i & 63;
        const bool ok = s < S && l0 + l < q;
        rfp::cp4(Nw + s * LDNS + l, ok ? Nt + (long)s * q + l : N, ok);
      }
    }
    return true;
  };

  if constexpr (TRACED) {
    // [Btot | Rcat] into the stages (fp32, by cp.async: the loads in
    // flight together), then split into B's chunks, in core-matrix order,
    // with zeros past Rcat's S columns
    float* Bf = ring;  // Btot (T x T), then Rcat (T x S)
    for (int i = threadIdx.x; i < T * T / 4; i += blockDim.x)
      rfp::cp16(Bf + 4 * i, Btot + 4 * i, true);
    for (int i = threadIdx.x; i < T * S; i += blockDim.x)
      rfp::cp4(Bf + T * T + i, Rcat + i, true);
    rfp::commit();
    rfp::wait_pending(0);
    __syncthreads();
    for (int i = threadIdx.x; i < T * (KP / 2); i += blockDim.x) {
      const int o = i / (KP / 2), k = 2 * (i - o * (KP / 2));
      const int kk = (k & ~15) + rfw::kperm(k & 15);  // kk, kk + 1
      float u = 0.f, v = 0.f;
      if (kk < T) {
        const float2 b2 = *reinterpret_cast<const float2*>(Bf + o * T + kk);
        u = b2.x;
        v = b2.y;
      } else {
        if (kk - T < S) u = Bf[T * T + o * S + kk - T];
        if (kk + 1 - T < S) v = Bf[T * T + o * S + kk + 1 - T];
      }
      uint32_t c[NCB];
      rfw::split_pair<NCB>(u, v, c);
      const int off = rfw::core_off(o, k, KP);
#pragma unroll
      for (int ch = 0; ch < NCB; ++ch)
        *reinterpret_cast<uint32_t*>(Bs + ch * CH + off) = c[ch];
    }
    rfw::fence_async_smem();
    __syncthreads();  // B is written, the stages free for the items
  }

  bool have = load(blockIdx.x);
  rfp::commit();
  int cur_v = -1;
  for (int g = blockIdx.x; g < walk.gs[3]; g += gridDim.x) {
    int end;
    const int it = walk.first(g, nwg, end) + wg;
    if constexpr (!TRACED) {
      int t0, b0;
      rfp::item(it - wg, n, nb, nv, t0, b0);
      const int v = rf::variant(nv, t0, n);
      if (v != cur_v) {
        rfw::stage_b<NCB>(smem16, Bc, v, CH);
        cur_v = v;
      }
    }
    if (!have) {  // none in this group (its range's odd last item): the
      have = load(g + gridDim.x);  // stage is free for the next
      rfp::commit();
      continue;
    }
    rfp::wait_pending(0);  // this item's stage
    rfw::wg_sync(wg);
    int t, b;
    rfp::item(it, n, nb, nv, t, b);

    // the carry rows (zeros past sl), then the signal, as float4 along
    // the contraction; the next item's loads run under the products and
    // the stores
    float d[64];
    rfw::split_products<NPROD, KC>(
        d, Bs, CH, KP,
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
        [&] {
          rfw::wg_sync(wg);
          have = load(g + gridDim.x);
          rfp::commit();
        });

    // d[4j + 2h + e]: line l0 + r + 8h, output 8j + 2qd + e
    const int l0 = b * rfw::TM;
    long base[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = l0 + r + 8 * h;
      ok[h] = l < q;
      base[h] = ((long)l * n + t) * T + 2 * qd;
    }
    if (epi.coef != nullptr) {
      const float a = epi.coef[0], c = epi.coef[1];
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = fmaf(a, d[i], c);
      for (int k = 0; k < naux; ++k) {
        const float bk = epi.coef[2 + k];
        const float* aux = epi.aux[k];
        float2 u[2][16];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            u[h][j] = ok[h] ? *reinterpret_cast<const float2*>(
                                  aux + base[h] + 8 * j)
                            : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            d[4 * j + 2 * h] = fmaf(bk, u[h][j].x, d[4 * j + 2 * h]);
            d[4 * j + 2 * h + 1] = fmaf(bk, u[h][j].y, d[4 * j + 2 * h + 1]);
          }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (ok[h]) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          rf::store2(y + base[h] + 8 * j, d[4 * j + 2 * h],
                     d[4 * j + 2 * h + 1]);
      }
  }
}

// Two warpgroups where their stages fit beside B's nc chunks, else one,
// else 0.
template <typename TX>
constexpr int tc_nwg(int kp, int sl, int nc) {
  return tc_smem<TX>(kp, sl, 2, nc) <= MAX_SMEM
             ? 2
             : (tc_smem<TX>(kp, sl, 1, nc) <= MAX_SMEM);
}

template <bool TRACED, int KC, int NPROD, typename TX>
int tc_launch(const TX* x, const float* N, const rfs::bf16* Bc,
              const float* Btot, const float* Rcat, TX* y,
              const rf::Affine& epi, int naux, int q, int n, int sl, int nv,
              int S, cudaStream_t stream) {
  constexpr int KP = T + 16 * KC, NC = rfw::b_chunks(NPROD);
  const int nwg = tc_nwg<TX>(KP, sl, NC);
  if (nwg == 0) return (int)cudaErrorLaunchOutOfResources;
  const long smem = tc_smem<TX>(KP, sl, nwg, NC);
  cudaError_t err = cudaFuncSetAttribute(
      completion_tc_kernel<TRACED, KC, NPROD, TX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long nb = (q + rfw::TM - 1) / rfw::TM;
  const int grid = rfp::persistent_grid(rfp::walk_groups(n, nb, nv, nwg));
  completion_tc_kernel<TRACED, KC, NPROD, TX>
      <<<grid, nwg * rfw::WG, (int)smem, stream>>>(
          x, N, Bc, Btot, Rcat, y, epi, naux, q, n, sl, nv, S, nwg);
  return (int)cudaGetLastError();
}

// completion, completion_epi (NPROD 6) and completion_split (1, 3, 4; and
// bf16 at 1): KC = sl / 16 rounded up carry k16 steps
template <int NPROD, typename TX = float>
int static_launch(const TX* x, const float* N, const void* Bc, TX* y,
                  const rf::Affine& epi, int naux, int q, int n, int sl,
                  int nv, cudaStream_t stream) {
  if (sl < 8 || sl > MAX_SL || sl % 8 || q < 1 || n < 1 ||
      (nv != 1 && nv != 3) || naux < 0 || naux > rf::MAX_AUX)
    return (int)cudaErrorInvalidValue;
  const rfs::bf16* B = static_cast<const rfs::bf16*>(Bc);
  switch ((sl + 15) / 16) {
    case 1:
      return tc_launch<false, 1, NPROD>(x, N, B, nullptr, nullptr, y, epi,
                                        naux, q, n, sl, nv, sl, stream);
    case 2:
      return tc_launch<false, 2, NPROD>(x, N, B, nullptr, nullptr, y, epi,
                                        naux, q, n, sl, nv, sl, stream);
    case 3:
      return tc_launch<false, 3, NPROD>(x, N, B, nullptr, nullptr, y, epi,
                                        naux, q, n, sl, nv, sl, stream);
    default:
      return tc_launch<false, 4, NPROD>(x, N, B, nullptr, nullptr, y, epi,
                                        naux, q, n, sl, nv, sl, stream);
  }
}

}  // namespace
