// fused: the strip passes of the pallas backend — every scan of one axis
// in one launch, the tile carry walked in order inside the block.
//
// Replaces recfilter_tpu/kernels/fused.py::dim_pass_rows (Pallas kernel
// _row_pass_kernel) and ::dim_pass_cols (_col_pass_kernel). Per scan, in
// the scan list's order, per tile t in scan order (ascending causal,
// descending anticausal), with M_t = B_edge at the first tile processed
// under a clamp border and B elsewhere:
//
//   rows (x (L, n*T), T = 128, lines on the slow axis):
//     y_t = x_t * M_t^T + carry * RN^T        carry = y_t[:, T-K:] causal,
//                                                     y_t[:, :K]   anticausal
//   cols (x (outer, n*T, Lc), the scan on axis -2, lines on the minor axis):
//     y_t = M_t * x_t + RN * carry            carry = y_t[T-K:, :] / y_t[:K, :]
//
// The anticausal matrices arrive anti-diagonally transformed, so both
// directions use one formula. Between scans the zero padding past w_real
// is re-zeroed (the columns, resp. rows, at or past w_real are stored as
// 0 by every scan but the last), so a later scan sees a zero border there.
// The carry is read straight from the tile's outputs: the TPU kernel's
// selector product (Sel) works around Mosaic's slicing and has no
// counterpart here.
//
// Layout choice (the TPU strip of Lb lines x the whole extent does not
// fit: one 4096-wide fp32 line is 16 KB of the block's 227 KB): a block
// owns Lb lines (rows: Lb rows of x; cols: Lb consecutive minor-axis
// columns of one outer slice) and walks the n tiles in order. Each tile is
// one GEMM over the contraction [tile; carry] of depth T + K, in one
// orientation for both kernels — C[o][line], the host-built operand
// [M_t^T; RN^T] (T+K, T) indexed by the output o (each thread's 8 outputs
// read as broadcast double2 fragments) and the tile's lines as columns
// (the rows kernel transposes its tile as it stages it). The operand is
// staged in shared memory once per scan (twice under a clamp border), the
// tile next to the K carry rows, which the GEMM's output threads write
// back for the next tile. Scan i+1 reads scan i's output from device
// memory (the same block's lines, ordered by __syncthreads), so a pass
// with S scans moves 2*S*4 B/px instead of the TPU strip's 8 B/px.
//
// Precision: fp32 operands and storage, fp64 accumulation. An fp32 sum of
// the T + K products cancels (the sigma=5 Gaussian's outputs are ~20 times
// below its inputs): with fp32 sums the headline filter sat at 2.0e-6 to
// 2.9e-6 of the output peak from the f64 oracle at 512^2 to 1024^2 (the
// JAX package's kernel alike), with fp64 sums at 3.7e-7 to 4.7e-7 (plain
// twins on the CPU); the px6 bound is 2e-6. The matrix operand is staged
// in shared memory as double (converted once per scan), the tile as float
// (converted as it is read).
//
// What bounds it: 2*(T+K) FLOP per pixel per scan in fp64 (524 FLOP/px for
// two order-3 scans at T = 128: 0.131 ms at 4096^2 at the H100's 67
// TFLOP/s of fp64 on its tensor cores, DMMA, the card's peak for the type
// and level with fp32 outside them) against 8 B/px in and out (0.040 ms;
// 0.080 ms with the extra round trip of the second scan), so arithmetic
// bounds it. This design issues its fp64 FMAs on the CUDA cores, at half
// that rate (33.5 TFLOP/s), so it cannot come within 2x of the bound; the
// rest of its gap is the latency chain below. The tile loop is a latency
// chain (tile t needs tile t-1's carry), so parallelism comes from lines
// only: Lb lines a block (16, 32 or 64), one block per SM (the double
// operand alone is 136 KB at T = 128), so 4096 lines run as 128 blocks of
// 32 in one wave. Each thread of 256 holds an RM x RN register tile of C
// in fp64; no tensor cores yet.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16: ty picks rows of C, tx columns
constexpr int ROW_T = 128;    // the rows pass's tile (the JAX package's 128)

// v[i] = (double)p[i], i < N, with the widest aligned shared loads.
template <int N>
__device__ __forceinline__ void lds(const float* p, double* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <int N>  // N even
__device__ __forceinline__ void lds(const double* p, double* v) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const double2 t = *reinterpret_cast<const double2*>(p + i);
    v[i] = t.x;
    v[i + 1] = t.y;
  }
}

// c[i][j] = sum_{kk < depth} A[kk][ty*RM + i] * B[kk][tx*RN + j] in fp64,
// A the double operand (a warp reads two fragments: broadcast), B the
// float tile (contiguous fragments across the warp)
template <int RM, int RN>
__device__ __forceinline__ void gemm(const double* A, int lda, const float* B,
                                     int ldb, int depth, int ty, int tx,
                                     double (&c)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) c[i][j] = 0.0;
#pragma unroll 2
  for (int kk = 0; kk < depth; ++kk) {
    double a[RM], b[RN];
    lds<RM>(A + kk * lda + ty * RM, a);
    lds<RN>(B + kk * ldb + tx * RN, b);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) c[i][j] = fma(a[i], b[j], c[i][j]);
  }
}

// One kernel for both orientations: per tile the GEMM
//   C[o][line] = sum_kk Ms[kk][o] * Xs[kk][line],  depth T + K,
// Ms (T+K, 16*RM) doubles, the operand [M^T; RN^T] with zero columns past
// T; Xs (T+K, Lb) floats, the tile's lines as columns over the K carry
// rows. Thread (ty, tx) holds outputs o = ty*RM + i and lines
// tx*RN + j, Lb = 16*RN lines a block. ROWS: x (L, n*128), a block owns Lb
// rows, the tile transposed into Xs as it is staged, T = 128 (RM = 8);
// else x (outer, n*T, Lc), a block owns Lb consecutive minor-axis columns
// of one outer slice (blockIdx.y), T <= 16*RM. x and y carry no
// __restrict__: every scan after the first reads y where it writes it.
template <int RM, int RN, bool ROWS>
__global__ void __launch_bounds__(THREADS)
strip_kernel(const float* x, const float* __restrict__ ops, float* y,
             int lines, int n, int T, int K, int nscan, int w_real,
             int causal_mask, int edge_mask) {
  constexpr int MS = 16 * RM, LB = 16 * RN;
  extern __shared__ float4 smem4[];
  double* Ms = reinterpret_cast<double*>(smem4);            // (T+K) x MS
  float* Xs = reinterpret_cast<float*>(Ms + (T + K) * MS);  // (T+K) x LB

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long l0 = (long)blockIdx.x * LB;
  const long ext = (long)n * T;  // the padded scanned extent
  // rows: element (line, pos) at line*ext + pos; cols: at base + pos*lines
  // + line
  const long base = ROWS ? 0 : (long)blockIdx.y * ext * lines;
  const int depth = T + K;

  for (int si = 0; si < nscan; ++si) {
    const bool causal = (causal_mask >> si) & 1;
    const bool edge = (edge_mask >> si) & 1;
    const bool rezero = si + 1 < nscan && w_real < ext;
    const float* src = si == 0 ? x : y;
    __syncthreads();  // the last scan's GEMMs, carry writes and stores done
    for (int i = tid; i < K * LB; i += THREADS) Xs[T * LB + i] = 0.f;
    for (int it = 0; it < n; ++it) {
      const int t = causal ? it : n - 1 - it;
      if (it == 0 || (it == 1 && edge)) {  // stage [M^T; RN^T]
        const float* op =
            ops + ((long)(2 * si + (it == 0 && edge)) * depth) * T;
        for (int i = tid; i < depth * MS; i += THREADS) {
          const int kk = i / MS, o = i % MS;
          Ms[i] = o < T ? (double)op[kk * T + o] : 0.0;
        }
      }
      if constexpr (ROWS) {  // float4 along a row, four Xs rows a load
        for (int i = tid; i < (T / 4) * LB; i += THREADS) {
          const int line = i % LB, s4 = i / LB;
          const long gl = l0 + line;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (gl < lines)
            v = *reinterpret_cast<const float4*>(src + gl * ext +
                                                 (long)t * T + 4 * s4);
          Xs[(4 * s4) * LB + line] = v.x;
          Xs[(4 * s4 + 1) * LB + line] = v.y;
          Xs[(4 * s4 + 2) * LB + line] = v.z;
          Xs[(4 * s4 + 3) * LB + line] = v.w;
        }
      } else {
        for (int i = tid; i < T * LB; i += THREADS) {
          const int s = i / LB, l = i % LB;
          const long gl = l0 + l;
          Xs[i] = gl < lines ? src[base + ((long)t * T + s) * lines + gl]
                             : 0.f;
        }
      }
      __syncthreads();
      double c[RM][RN];
      gemm<RM, RN>(Ms, MS, Xs, LB, depth, ty, tx, c);
      __syncthreads();  // every thread has read the carry rows and the tile
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int o = ty * RM + i;
        const int slot = causal ? o - (T - K) : o;
        if (o < T && slot >= 0 && slot < K) {
#pragma unroll
          for (int j = 0; j < RN; ++j)
            Xs[(T + slot) * LB + tx * RN + j] = (float)c[i][j];
        }
      }
      if constexpr (ROWS) {  // RM = 8 consecutive outputs: two float4
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const long gl = l0 + tx * RN + j;
          if (gl >= lines) continue;
#pragma unroll
          for (int h = 0; h < RM; h += 4) {
            const long pos = (long)t * T + ty * RM + h;
            float v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              v[q] = rezero && pos + q >= w_real ? 0.f : (float)c[h + q][j];
            *reinterpret_cast<float4*>(y + gl * ext + pos) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int o = ty * RM + i;
          if (o >= T) continue;
          const long pos = (long)t * T + o;
          const bool zero = rezero && pos >= w_real;
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const long gl = l0 + tx * RN + j;
            if (gl < lines)
              y[base + pos * lines + gl] = zero ? 0.f : (float)c[i][j];
          }
        }
      }
    }
  }
}

template <typename Kern, typename... Args>
int launch(Kern kern, dim3 grid, int smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

static int smem_bytes(int T, int K, int rm, int lb) {
  return (T + K) * (16 * rm * (int)sizeof(double) + lb * (int)sizeof(float));
}

// x, y (L, n*128); ops (nscan, 2, 128+K, 128): [M^T; RN^T] interior, edge.
// lb in {16, 32, 64}; bit si of causal_mask / edge_mask: scan si is
// causal / has a clamp edge tile.
extern "C" int dim_pass_rows_launch(const float* x, const float* ops,
                                    float* y, int L, int n, int K, int nscan,
                                    int w_real, int causal_mask,
                                    int edge_mask, int lb, void* stream) {
  if (K < 1 || K > ROW_T || nscan < 1 || nscan > 30 || L < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(ROW_T, K, 8, lb);
  const dim3 grid((L + lb - 1) / lb);
  cudaStream_t s = (cudaStream_t)stream;
#define RF_ROWS(RN_)                                                        \
  if (lb == 16 * RN_)                                                       \
    return launch(strip_kernel<8, RN_, true>, grid, smem, s, x, ops, y, L, \
                  n, ROW_T, K, nscan, w_real, causal_mask, edge_mask);
  RF_ROWS(1) RF_ROWS(2) RF_ROWS(4)
#undef RF_ROWS
  return (int)cudaErrorInvalidValue;
}

// x, y (outer, n*T, Lc); ops (nscan, 2, T+K, T); T <= 128; lb in
// {16, 32, 64}.
extern "C" int dim_pass_cols_launch(const float* x, const float* ops,
                                    float* y, int outer, int Lc, int n,
                                    int T, int K, int nscan, int w_real,
                                    int causal_mask, int edge_mask, int lb,
                                    void* stream) {
  if (T < 1 || T > 128 || K < 1 || K > T || nscan < 1 || nscan > 30 ||
      outer < 1 || outer > 65535 || Lc < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  const int rm = T <= 32 ? 2 : (T <= 64 ? 4 : 8);
  const int smem = smem_bytes(T, K, rm, lb);
  const dim3 grid((Lc + lb - 1) / lb, outer);
  cudaStream_t s = (cudaStream_t)stream;
#define RF_COLS(RM_, RN_)                                                   \
  if (rm == RM_ && lb == 16 * RN_)                                          \
    return launch(strip_kernel<RM_, RN_, false>, grid, smem, s, x, ops, y,  \
                  Lc, n, T, K, nscan, w_real, causal_mask, edge_mask);
  RF_COLS(2, 1) RF_COLS(2, 2) RF_COLS(2, 4)
  RF_COLS(4, 1) RF_COLS(4, 2) RF_COLS(4, 4)
  RF_COLS(8, 1) RF_COLS(8, 2) RF_COLS(8, 4)
#undef RF_COLS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
