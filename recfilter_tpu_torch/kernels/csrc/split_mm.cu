// split_mm: the split-bf16 probes of the JAX package's scripts/ as H100
// studies — how a float32-grade product with one constant 128 x 128 matrix
// costs least on Hopper.
//
// Replaces, as studies (not on any executor's path):
//   scripts/pallas_split_matmul.py::pallas_split_mm   (kernel _kernel)
//   scripts/pallas_split_matmul.py::pallas_split_mm_t (kernel _kernel_t)
//   scripts/px3t_sweep.py::build                      (kernel _kernel)
//   scripts/px6_stack_exp.py::build          (kernels _kern_sep, _kern_stack)
//
// Every probe is one product shape: for tile t (128 columns of the input
// x, L lines of n tiles) and each line l,
//
//   C[l][o] = sum_k Bn[o][k] * x[l, t*128 + k]   (+ sum_s R[o][s] N[l][s])
//
// emitted in place, y[l, t*128 + o] (emit 0: pallas_split_mm, whose x * B
// is Bn = B^T), or transposed, y[t*128 + o, l] — directly from the
// accumulators (emit 1, the probes' "t" orientation: the product computed
// as C^T, the constant the row operand), or through a shared-memory
// transpose of the fp32 result (emit 2, px3t_sweep's "s" orientation).
// The carry term rides the contraction at the product's own grade (carry
// 1, "split") or is added in fp32 afterwards (carry 2, the probes'
// HIGHEST carry dot). A block stages the constant once and loops over nt
// tiles x lb/128 line blocks (px3t_sweep's tiles per block and block
// width).
//
// Three mechanisms, one entry each:
//   split_mm       bf16 chunks on tensor cores (split.cuh), NPROD 1/3/4/6;
//                  stack = 1 loads every chunk's fragments once per k step
//                  and runs the NPROD products from registers (px6_stack's
//                  one stacked contraction), stack = 0 runs the products
//                  one after another (its six separate dots)
//   split_mm_tf32  TF32 tensor cores, mma.sync m16n8k8: 1xTF32 (operands
//                  rounded to TF32) or 3xTF32 (big + small parts, the
//                  small x small product dropped)
//   split_mm_fp32  fp32 FMA on the CUDA cores (common.cuh's register-tiled
//                  GEMM: the port's px6 kernels' arithmetic)
// Bound: 2 x 128 x 128 FLOP per line and tile per product at the
// mechanism's peak (989 TFLOP/s bf16, 495 TF32, 67 fp32) against 8 B per
// element of x and y; simple staged kernels, no pipelining.

#include "common.cuh"
#include "split.cuh"

namespace {

using rfs::bf16;
constexpr int T = 128;
constexpr int THREADS = 256;
constexpr int MAX_S = 8;

// The block's work: tiles t0..t0+nt-1, line blocks of 128 from line0.
struct Work {
  int t0, line0;
};
__device__ __forceinline__ Work work(int nt, int lb) {
  return {(int)blockIdx.x * nt, (int)blockIdx.y * lb};
}

// Store the block's fragment for tile t, lines l0..: emit 0 or 1 (direct).
// Fragment (m, n) is (line, output) for emit 0, (output, line) for 1.
__device__ __forceinline__ void store_pair(float* y, int emit, int L, int W,
                                           int t, int l0, int m, int n,
                                           float v0, float v1) {
  if (emit == 0) {
    if (l0 + m < L)
      *reinterpret_cast<float2*>(y + (long)(l0 + m) * W + t * T + n) =
          make_float2(v0, v1);
  } else if (l0 + n < L) {  // L even: both lines present
    *reinterpret_cast<float2*>(y + (long)(t * T + m) * L + l0 + n) =
        make_float2(v0, v1);
  }
}

// px6_stack's one stacked contraction: at every k step every chunk's
// fragments are loaded once and the NPROD products run from registers.
template <int NPROD, bool A_CONST>
__device__ __forceinline__ void stacked_mma(rfs::Frag& f, const bf16* A,
                                            const bf16* B, long chunk,
                                            int ld, int K) {
  constexpr int NC = rfs::nchunks(NPROD);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = (warp % 2) * 64, n0 = (warp / 2) * 32;
  const bf16* a_row = A + (m0 + lane % 16) * ld + (lane / 16) * 8;
  const bf16* b_row =
      B + (n0 + (lane % 8) + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8;
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[NC][4][4], b[NC][2][4];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        rfs::ldsm_x4(a[c][mi], a_row + c * chunk + mi * 16 * ld + k0);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        rfs::ldsm_x4(b[c][nj], b_row + c * chunk + nj * 16 * ld + k0);
    }
#pragma unroll
    for (int p = 0; p < NPROD; ++p) {
      const int ca = A_CONST ? rfs::pair_c(NPROD, p) : rfs::pair_d(NPROD, p);
      const int cb = A_CONST ? rfs::pair_d(NPROD, p) : rfs::pair_c(NPROD, p);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          rfs::mma_bf16(f.acc[mi][ni], a[ca][mi], b[cb][ni / 2][2 * (ni % 2)],
                        b[cb][ni / 2][2 * (ni % 2) + 1]);
    }
  }
}

// split_mm: K = 128, or 144 with the carry in the contraction (carry 1);
// Cc (NC, T, K + 8) bf16 rows o; R (T, 8) fp32 for carry 2.
template <int NPROD>
__global__ void __launch_bounds__(THREADS, 1)
split_mm_kernel(const float* __restrict__ x, const float* __restrict__ N,
                const float* __restrict__ R, const bf16* __restrict__ Cc,
                float* __restrict__ y, int L, int n, int nt, int lb, int S,
                int emit, int carry, int stack) {
  constexpr int NC = rfs::nchunks(NPROD);
  const int K = carry == 1 ? T + 16 : T, LD = K + 8;
  const long chunk = (long)T * LD;
  const long W = (long)n * T;
  extern __shared__ uint4 smem16[];
  bf16* Cs = reinterpret_cast<bf16*>(smem16);
  bf16* Ds = Cs + NC * chunk;  // data chunks; emit 2: the fp32 transpose
  const long dbytes = NC * chunk * 2 > T * (T + 4) * 4
                          ? NC * chunk * 2 : T * (T + 4) * 4;
  float* Ns = reinterpret_cast<float*>(reinterpret_cast<char*>(Ds) + dbytes);
  float* Rs = Ns + T * MAX_S;
  const int tid = threadIdx.x;

  rfs::copy16(Cs, Cc, NC * (int)chunk * 2, tid);
  if (carry == 2)
    for (int i = tid; i < T * MAX_S; i += THREADS)
      Rs[i] = (i % MAX_S) < S ? R[(i / MAX_S) * S + i % MAX_S] : 0.f;
  const Work wk = work(nt, lb);
  for (int tt = 0; tt < nt; ++tt) {
    const int t = wk.t0 + tt;
    for (int l0 = wk.line0; l0 < wk.line0 + lb; l0 += T) {
      if (t >= n || l0 >= L) continue;
      __syncthreads();  // the previous tile is done with Ds
      for (int i = tid; i < T * (T / 4); i += THREADS) {
        const int l = i / (T / 4), c4 = i % (T / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (l0 + l < L)
          v = reinterpret_cast<const float4*>(x + (long)(l0 + l) * W +
                                              (long)t * T)[c4];
        rfs::split_store4<NC>(Ds + l * LD + 4 * c4, chunk, v);
      }
      if (carry == 1)
        for (int i = tid; i < 16 * T; i += THREADS) {
          const int s = i / T, l = i % T;
          rfs::split_store1<NC>(
              Ds + l * LD + T + s, chunk,
              s < S && l0 + l < L ? N[(long)(l0 + l) * S + s] : 0.f);
        }
      if (carry == 2)
        for (int i = tid; i < T * MAX_S; i += THREADS) {
          const int l = i / MAX_S, s = i % MAX_S;
          Ns[i] = s < S && l0 + l < L ? N[(long)(l0 + l) * S + s] : 0.f;
        }
      __syncthreads();
      rfs::Frag f;
      rfs::zero(f);
      const bool ct = emit == 1;  // the constant is the row operand
      if (stack) {
        if (ct)
          stacked_mma<NPROD, true>(f, Cs, Ds, chunk, LD, K);
        else
          stacked_mma<NPROD, false>(f, Ds, Cs, chunk, LD, K);
      } else if (ct) {
        rfs::split_mma<NPROD, true, false>(f, Cs, chunk, LD, Ds, chunk, LD,
                                           K);
      } else {
        rfs::split_mma<NPROD, false, false>(f, Ds, chunk, LD, Cs, chunk, LD,
                                            K);
      }
      if (emit == 2) __syncthreads();  // Ds becomes the fp32 transpose
      float* Ys = reinterpret_cast<float*>(Ds);
      rfs::for_pairs(f, [&](int m, int nn, float v0, float v1) {
        if (carry == 2) {  // + sum_s R[o][s] N[l][s] in fp32
          const int l = ct ? nn : m, o = ct ? m : nn;
          for (int s = 0; s < MAX_S; ++s) {
            v0 = fmaf(Rs[o * MAX_S + s], Ns[l * MAX_S + s], v0);
            v1 = fmaf(ct ? Rs[o * MAX_S + s] : Rs[(o + 1) * MAX_S + s],
                      ct ? Ns[(l + 1) * MAX_S + s] : Ns[l * MAX_S + s], v1);
          }
        }
        if (emit == 2) {
          Ys[nn * (T + 4) + m] = v0;  // Ys[o][l]
          Ys[(nn + 1) * (T + 4) + m] = v1;
        } else {
          store_pair(y, emit, L, (int)W, t, l0, m, nn, v0, v1);
        }
      });
      if (emit == 2) {
        __syncthreads();
        for (int i = tid; i < T * (T / 4); i += THREADS) {
          const int o = i / (T / 4), c4 = i % (T / 4);
          if (l0 + 4 * c4 < L)  // L a multiple of 4
            *reinterpret_cast<float4*>(y + (long)(t * T + o) * L + l0 +
                                       4 * c4) =
                reinterpret_cast<const float4*>(Ys + o * (T + 4))[c4];
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// big (TF32 rounding of v) and small (TF32 rounding of the rest)
__device__ __forceinline__ void tf32_parts(float v, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(__fsub_rn(v, __uint_as_float(big)));
}

// split_mm_tf32: K = 128, or 136 with the carry in the contraction (at
// TF32 grade); operands fp32 in shared memory, rows k-contiguous, stride
// K + 4 (conflict-free fragment loads). Bf (T, K) fp32 rows o.
template <int NPASS>
__global__ void __launch_bounds__(THREADS, 1)
split_mm_tf32_kernel(const float* __restrict__ x, const float* __restrict__ N,
                     const float* __restrict__ Bf, float* __restrict__ y,
                     int L, int n, int nt, int lb, int S, int emit,
                     int carry) {
  const int K = carry ? T + MAX_S : T, LD = K + 4;
  const long W = (long)n * T;
  extern __shared__ uint4 smem16[];
  float* Cs = reinterpret_cast<float*>(smem16);  // T x LD, rows o
  float* Ds = Cs + T * LD;                       // T x LD, rows l
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  for (int i = tid; i < T * K; i += THREADS)
    Cs[(i / K) * LD + i % K] = Bf[i];
  const Work wk = work(nt, lb);
  const bool ct = emit == 1;
  const float* As = ct ? Cs : Ds;
  const float* Bs = ct ? Ds : Cs;
  const int m0 = (warp % 2) * 64, n0 = (warp / 2) * 32;
  for (int tt = 0; tt < nt; ++tt) {
    const int t = wk.t0 + tt;
    for (int l0 = wk.line0; l0 < wk.line0 + lb; l0 += T) {
      if (t >= n || l0 >= L) continue;
      __syncthreads();
      for (int i = tid; i < T * (T / 4); i += THREADS) {
        const int l = i / (T / 4), c4 = i % (T / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (l0 + l < L)
          v = reinterpret_cast<const float4*>(x + (long)(l0 + l) * W +
                                              (long)t * T)[c4];
        *reinterpret_cast<float4*>(Ds + l * LD + 4 * c4) = v;
      }
      if (carry)
        for (int i = tid; i < T * MAX_S; i += THREADS) {
          const int l = i / MAX_S, s = i % MAX_S;
          Ds[l * LD + T + s] =
              s < S && l0 + l < L ? N[(long)(l0 + l) * S + s] : 0.f;
        }
      __syncthreads();
      float acc[4][4][4] = {};
#pragma unroll 1
      for (int k0 = 0; k0 < K; k0 += 8) {
        uint32_t ab[4][4], as[4][4], bb[4][2], bs[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const float* r0 = As + (m0 + mi * 16 + g) * LD + k0 + q;
          const float* r1 = r0 + 8 * LD;
          tf32_parts(r0[0], ab[mi][0], as[mi][0]);
          tf32_parts(r1[0], ab[mi][1], as[mi][1]);
          tf32_parts(r0[4], ab[mi][2], as[mi][2]);
          tf32_parts(r1[4], ab[mi][3], as[mi][3]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const float* c0 = Bs + (n0 + ni * 8 + g) * LD + k0 + q;
          tf32_parts(c0[0], bb[ni][0], bs[ni][0]);
          tf32_parts(c0[4], bb[ni][1], bs[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            if (NPASS == 3) {  // smallest first
              mma_tf32(acc[mi][ni], as[mi], bb[ni][0], bb[ni][1]);
              mma_tf32(acc[mi][ni], ab[mi], bs[ni][0], bs[ni][1]);
            }
            mma_tf32(acc[mi][ni], ab[mi], bb[ni][0], bb[ni][1]);
          }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store_pair(y, emit, L, (int)W, t, l0, m0 + mi * 16 + g + 8 * h,
                       n0 + ni * 8 + 2 * q, acc[mi][ni][2 * h],
                       acc[mi][ni][2 * h + 1]);
    }
  }
}

// split_mm_fp32: fp32 FMA, common.cuh's GEMM: As[k][l] (the data
// transposed on its way in), Bs[k][o] = Bk (K, T) fp32, K = 128 or 136
// (carry rows). c[i][j] is (line row_of(i, ty), output row_of(j, tx)).
__global__ void __launch_bounds__(THREADS, 1)
split_mm_fp32_kernel(const float* __restrict__ x, const float* __restrict__ N,
                     const float* __restrict__ Bk, float* __restrict__ y,
                     int L, int n, int nt, int lb, int S, int emit,
                     int carry) {
  const int K = carry ? T + MAX_S : T;
  const long W = (long)n * T;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // K x T (k, line)
  float* Bs = As + K * T;                       // K x T (k, output)
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  rf::stage_rows(Bs, Bk, K, T, tid);
  const Work wk = work(nt, lb);
  for (int tt = 0; tt < nt; ++tt) {
    const int t = wk.t0 + tt;
    for (int l0 = wk.line0; l0 < wk.line0 + lb; l0 += T) {
      if (t >= n || l0 >= L) continue;
      __syncthreads();
      for (int i = tid; i < T * (T / 4); i += THREADS) {
        const int l = i % T, c4 = i / T;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (l0 + l < L)
          v = reinterpret_cast<const float4*>(x + (long)(l0 + l) * W +
                                              (long)t * T)[c4];
        As[(4 * c4 + 0) * T + l] = v.x;
        As[(4 * c4 + 1) * T + l] = v.y;
        As[(4 * c4 + 2) * T + l] = v.z;
        As[(4 * c4 + 3) * T + l] = v.w;
      }
      if (carry)
        for (int i = tid; i < MAX_S * T; i += THREADS) {
          const int s = i / T, l = i % T;
          As[(T + s) * T + l] =
              s < S && l0 + l < L ? N[(long)(l0 + l) * S + s] : 0.f;
        }
      __syncthreads();
      float c[8][8];
      rf::gemm_tile(As, Bs, c, ty, tx, K);
      if (emit == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int l = l0 + rf::row_of(i, ty);
          if (l >= L) continue;
          float* row = y + (long)l * W + (long)t * T + tx * 4;
          *reinterpret_cast<float4*>(row) =
              make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
          *reinterpret_cast<float4*>(row + 64) =
              make_float4(c[i][4], c[i][5], c[i][6], c[i][7]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int o = rf::row_of(j, tx);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int l = l0 + 64 * h + ty * 4;
            if (l < L)  // L a multiple of 4
              *reinterpret_cast<float4*>(y + (long)(t * T + o) * L + l) =
                  make_float4(c[4 * h][j], c[4 * h + 1][j], c[4 * h + 2][j],
                              c[4 * h + 3][j]);
          }
        }
      }
    }
  }
}

dim3 grid_of(int L, int n, int nt, int lb) {
  return dim3((n + nt - 1) / nt, (L + lb - 1) / lb);
}

bool shape_ok(int L, int n, int nt, int lb, int S, int emit) {
  return L > 0 && L % 4 == 0 && n > 0 && nt > 0 && lb > 0 && lb % T == 0 &&
         S >= 0 && S <= MAX_S && emit >= 0 && emit <= 2 &&
         (L + lb - 1) / lb < 65536;
}

template <int NPROD>
int bf16_launch(const float* x, const float* N, const float* R,
                const bf16* Cc, float* y, int L, int n, int nt, int lb,
                int S, int emit, int carry, int stack, cudaStream_t stream) {
  constexpr int NC = rfs::nchunks(NPROD);
  const int LD = (carry == 1 ? T + 16 : T) + 8;
  const int dbytes = NC * T * LD * 2 > T * (T + 4) * 4 ? NC * T * LD * 2
                                                        : T * (T + 4) * 4;
  const int smem = NC * T * LD * 2 + dbytes + 2 * T * MAX_S * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      split_mm_kernel<NPROD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  split_mm_kernel<NPROD><<<grid_of(L, n, nt, lb), THREADS, smem, stream>>>(
      x, N, R, Cc, y, L, n, nt, lb, S, emit, carry, stack);
  return (int)cudaGetLastError();
}

template <int NPASS>
int tf32_launch(const float* x, const float* N, const float* Bf, float* y,
                int L, int n, int nt, int lb, int S, int emit, int carry,
                cudaStream_t stream) {
  const int smem = 2 * T * ((carry ? T + MAX_S : T) + 4) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      split_mm_tf32_kernel<NPASS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  split_mm_tf32_kernel<NPASS>
      <<<grid_of(L, n, nt, lb), THREADS, smem, stream>>>(
          x, N, Bf, y, L, n, nt, lb, S, emit, carry);
  return (int)cudaGetLastError();
}

}  // namespace

// emit 0: y (L, n*128); 1, 2: y (n*128, L). carry 0: none, 1: in the
// contraction (Cc holds R's chunks in columns 128..), 2: fp32 after (R).
extern "C" int split_mm_launch(const float* x, const float* N, const float* R,
                               const void* Cc, float* y, int L, int n,
                               int nt, int lb, int S, int nprod, int emit,
                               int carry, int stack, void* stream) {
  if (!shape_ok(L, n, nt, lb, S, emit) || carry < 0 || carry > 2 ||
      (emit == 0 && carry == 2))
    return (int)cudaErrorInvalidValue;
  const bf16* C = static_cast<const bf16*>(Cc);
  cudaStream_t s = (cudaStream_t)stream;
  switch (nprod) {
    case 1: return bf16_launch<1>(x, N, R, C, y, L, n, nt, lb, S, emit,
                                  carry, stack, s);
    case 3: return bf16_launch<3>(x, N, R, C, y, L, n, nt, lb, S, emit,
                                  carry, stack, s);
    case 4: return bf16_launch<4>(x, N, R, C, y, L, n, nt, lb, S, emit,
                                  carry, stack, s);
    case 6: return bf16_launch<6>(x, N, R, C, y, L, n, nt, lb, S, emit,
                                  carry, stack, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// npass 1 or 3; carry 0 or 1 (Bf (T, 136) with R in columns 128..)
extern "C" int split_mm_tf32_launch(const float* x, const float* N,
                                    const float* Bf, float* y, int L, int n,
                                    int nt, int lb, int S, int npass,
                                    int emit, int carry, void* stream) {
  if (!shape_ok(L, n, nt, lb, S, emit) || emit == 2 || carry < 0 ||
      carry > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (npass == 1)
    return tf32_launch<1>(x, N, Bf, y, L, n, nt, lb, S, emit, carry, s);
  if (npass == 3)
    return tf32_launch<3>(x, N, Bf, y, L, n, nt, lb, S, emit, carry, s);
  return (int)cudaErrorInvalidValue;
}

// carry 0 or 1 (Bk (136, T) with R^T in rows 128..)
extern "C" int split_mm_fp32_launch(const float* x, const float* N,
                                    const float* Bk, float* y, int L, int n,
                                    int nt, int lb, int S, int emit,
                                    int carry, void* stream) {
  if (!shape_ok(L, n, nt, lb, S, emit) || emit == 2 || carry < 0 ||
      carry > 1)
    return (int)cudaErrorInvalidValue;
  const int smem = 2 * (carry ? T + MAX_S : T) * T * 4;
  cudaError_t err = cudaFuncSetAttribute(
      split_mm_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  split_mm_fp32_kernel<<<grid_of(L, n, nt, lb), THREADS, smem,
                         (cudaStream_t)stream>>>(x, N, Bk, y, L, n, nt, lb,
                                                 S, emit, carry);
  return (int)cudaGetLastError();
}

extern "C" const char* split_mm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
