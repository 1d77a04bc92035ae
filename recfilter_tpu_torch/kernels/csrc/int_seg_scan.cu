// int_seg_scan: one wrapping unit scan over an integer axis too long for
// int_scan.cu's gates, in chunks of C (even) — its two kernel phases.
//
// Replaces recfilter_tpu/kernels/int_scan.py::_segmented_unit_scan (Pallas
// kernels _seg_chunk_kernel, _seg_fix_kernel, _seg_sub_kernel,
// _seg_sub_fix_kernel). Along an axis of extent E cut into n chunks of C:
//
//   carries (int_seg_carries): per chunk j, the exit value l_j of the
//     chunk-local scan (zero state at its entry): y at jC + C - 1 (causal;
//     the chunk zero-padded to C) or at jC (anticausal), int32;
//   chain (the caller, torch on the tiny carries): incoming_j = the sum of
//     l over the chunks before j in scan order — with C even, a^C = 1, so
//     the carries chain by plain addition;
//   fix (int_seg_fix): the chunk re-scanned from x with its incoming carry
//     as the entry state, stored in the input's type.
//
// The JAX package writes the int32 chunk scans in its first kernel and adds
// a^(steps from entry) * incoming in the second (four touches of the
// array). Here the first phase only sums — the exit value of a chunk-local
// unit scan is D_exit * sum_i D_i f x_i, with D_i = (-1)^i over the GLOBAL
// index when a = -1 — and the fix phase re-scans x with the entry state, so
// the array is read twice and written once, and no int32 intermediate is
// written for int8/int16 inputs. Layouts as in int_scan.cu: 0 the last axis
// (rows, E), a block per (chunk, row); 1 any other axis (P, E, W), a block
// per (32 columns, chunk, p). The scans are in int_scan.cuh.
//
// What bounds it: device-memory bandwidth (two reads and one write of the
// array; the carries are E / C per line).

#include "int_scan.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rfi::THREADS)
lane_carries(const T* x, int32_t* c, long E, long C, int n, rfi::Unit u) {
  __shared__ uint32_t warp_tot[rfi::THREADS / 32];
  const long j = blockIdx.x, row = blockIdx.y;
  const long e0 = j * C, e1 = e0 + C < E ? e0 + C : E;
  const T* src = x + row * E;
  uint32_t tot = 0;
  for (long i = e0 + threadIdx.x; i < e1; i += rfi::THREADS)
    tot += rfi::par(rfi::ld(src + i) * u.f, i, u.neg);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, d);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = tot;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0;
    for (int w = 0; w < rfi::THREADS / 32; ++w) s += warp_tot[w];
    c[row * n + j] = (int32_t)rfi::par(s, u.causal ? e0 + C - 1 : e0, u.neg);
  }
}

template <typename T>
__global__ void __launch_bounds__(rfi::THREADS)
lane_fix(const T* x, const int32_t* inc, T* y, long E, long C, int n,
         rfi::Unit u) {
  __shared__ rfi::LaneSmem sm;
  const long j = blockIdx.x, row = blockIdx.y;
  const long e0 = j * C, e1 = e0 + C < E ? e0 + C : E;
  const uint32_t carry = rfi::par((uint32_t)inc[row * n + j],
                                  u.causal ? e0 - 1 : e0 + C, u.neg);
  rfi::lane_scan(x + row * E, y + row * E, e0, e1, u, carry, sm);
}

template <typename T>
__global__ void __launch_bounds__(rfi::COLS * rfi::SEG)
sub_carries(const T* x, int32_t* c, long E, long W, long C, int n,
            rfi::Unit u) {
  __shared__ uint32_t tot_s[rfi::SEG][rfi::COLS];
  const long col = (long)blockIdx.x * rfi::COLS + threadIdx.x;
  const long j = blockIdx.y, p = blockIdx.z;
  const long r0 = j * C, r1 = r0 + C < E ? r0 + C : E;
  const long len = (r1 - r0 + rfi::SEG - 1) / rfi::SEG;
  const long a = r0 + threadIdx.y * len, e = a + len < r1 ? a + len : r1;
  const T* src = x + p * E * W;
  uint32_t tot = 0;
  if (col < W) {
#pragma unroll 8
    for (long i = a; i < e; ++i)
      tot += rfi::par(rfi::ld(src + i * W + col) * u.f, i, u.neg);
  }
  tot_s[threadIdx.y][threadIdx.x] = tot;
  __syncthreads();
  if (threadIdx.y == 0 && col < W) {
    uint32_t s = 0;
    for (int t = 0; t < rfi::SEG; ++t) s += tot_s[t][threadIdx.x];
    c[(p * n + j) * W + col] =
        (int32_t)rfi::par(s, u.causal ? r0 + C - 1 : r0, u.neg);
  }
}

template <typename T>
__global__ void __launch_bounds__(rfi::COLS * rfi::SEG)
sub_fix(const T* x, const int32_t* inc, T* y, long E, long W, long C, int n,
        rfi::Unit u) {
  __shared__ rfi::SubSmem sm;
  const long col = (long)blockIdx.x * rfi::COLS + threadIdx.x;
  const long j = blockIdx.y, p = blockIdx.z;
  const long r0 = j * C, r1 = r0 + C < E ? r0 + C : E;
  const uint32_t carry =
      col < W ? rfi::par((uint32_t)inc[(p * n + j) * W + col],
                         u.causal ? r0 - 1 : r0 + C, u.neg)
              : 0u;
  rfi::sub_scan(x + p * E * W, y + p * E * W, r0, r1, W, col, u, carry, sm);
}

bool bad_args(int layout, int P, int E, int W, int C, int bytes) {
  const int n = C > 0 ? (E + C - 1) / C : 0;
  return C < 2 || C % 2 || P < 1 || E < 1 || W < 1 ||
         (bytes != 1 && bytes != 2 && bytes != 4) ||
         (layout == 0 && P > 65535) ||
         (layout == 1 && (n > 65535 || P > 65535)) ||
         (layout != 0 && layout != 1);
}

template <typename T>
cudaError_t carries(const void* x, int32_t* c, int layout, int P, int E,
                    int W, int C, rfi::Unit u, cudaStream_t s) {
  const int n = (E + C - 1) / C;
  if (layout == 0)
    lane_carries<T><<<dim3(n, P), rfi::THREADS, 0, s>>>(
        static_cast<const T*>(x), c, E, C, n, u);
  else
    sub_carries<T><<<dim3((W + rfi::COLS - 1) / rfi::COLS, n, P),
                     dim3(rfi::COLS, rfi::SEG), 0, s>>>(
        static_cast<const T*>(x), c, E, W, C, n, u);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fix(const void* x, const int32_t* inc, void* y, int layout,
                int P, int E, int W, int C, rfi::Unit u, cudaStream_t s) {
  const int n = (E + C - 1) / C;
  if (layout == 0)
    lane_fix<T><<<dim3(n, P), rfi::THREADS, 0, s>>>(
        static_cast<const T*>(x), inc, static_cast<T*>(y), E, C, n, u);
  else
    sub_fix<T><<<dim3((W + rfi::COLS - 1) / rfi::COLS, n, P),
                 dim3(rfi::COLS, rfi::SEG), 0, s>>>(
        static_cast<const T*>(x), inc, static_cast<T*>(y), E, W, C, n, u);
  return cudaGetLastError();
}

}  // namespace

extern "C" int int_seg_carries_launch(const void* x, int32_t* c, int layout,
                                      int P, int E, int W, int bytes, int C,
                                      int f, int a, int causal,
                                      void* stream) {
  if (bad_args(layout, P, E, W, C, bytes)) return (int)cudaErrorInvalidValue;
  const rfi::Unit u = {(uint32_t)f, a < 0, causal != 0};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bytes) {
    case 1: return (int)carries<int8_t>(x, c, layout, P, E, W, C, u, s);
    case 2: return (int)carries<int16_t>(x, c, layout, P, E, W, C, u, s);
    default: return (int)carries<int32_t>(x, c, layout, P, E, W, C, u, s);
  }
}

extern "C" int int_seg_fix_launch(const void* x, const int32_t* inc, void* y,
                                  int layout, int P, int E, int W, int bytes,
                                  int C, int f, int a, int causal,
                                  void* stream) {
  if (bad_args(layout, P, E, W, C, bytes)) return (int)cudaErrorInvalidValue;
  const rfi::Unit u = {(uint32_t)f, a < 0, causal != 0};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bytes) {
    case 1: return (int)fix<int8_t>(x, inc, y, layout, P, E, W, C, u, s);
    case 2: return (int)fix<int16_t>(x, inc, y, layout, P, E, W, C, u, s);
    default: return (int)fix<int32_t>(x, inc, y, layout, P, E, W, C, u, s);
  }
}

extern "C" const char* int_seg_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
