// int_scan: chained wrapping unit scans over the full extent of an integer
// axis — one dimension of a summed-area table or an integral image in one
// read and one write.
//
// Replaces recfilter_tpu/kernels/int_scan.py::int_unit_dim_pass (Pallas
// kernels _lane_kernel and _sublane_kernel). For int8, int16 or int32
// arrays, computed in 32 bits with wrap-around and stored in the input's
// type, it applies up to 8 unit scans (f, a = +-1, causal or anticausal) in
// order along one axis:
//   * layout 0, the last axis: x (rows, E), one block per line;
//   * layout 1, any other axis: x (P, E, W), a block per (32 columns, p).
// The scans themselves are in int_scan.cuh. Each unit after the first
// re-reads the output the block wrote (low bits of the stored type: exact).
//
// What bounds it: one read and one write of the array (a 4096^2 int32 SAT
// axis moves 134 MB) against a few integer adds per element — device-memory
// bandwidth on an H100. The TPU kernel holds the whole extent in VMEM and
// scans by log-step doubling; here a block streams its lines in tiles with
// a running carry (lanes) or splits its columns into segments (sublanes),
// so nothing bounds the extent but the callers' gates (65,536 on the last
// axis, 4,096 on another, as in the JAX package; beyond them
// int_seg_scan.cu runs).

#include "int_scan.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rfi::THREADS)
int_lane_kernel(const T* x, T* y, long E, rfi::Units us) {
  __shared__ rfi::LaneSmem sm;
  const long row = blockIdx.x;
  const T* src = x + row * E;
  T* dst = y + row * E;
  for (int k = 0; k < us.n; ++k)
    rfi::lane_scan(k ? dst : src, dst, 0, E, us.u[k], 0u, sm);
}

template <typename T>
__global__ void __launch_bounds__(rfi::COLS * rfi::SEG)
int_sub_kernel(const T* x, T* y, long E, long W, rfi::Units us) {
  __shared__ rfi::SubSmem sm;
  const long off = (long)blockIdx.y * E * W;
  const long col = (long)blockIdx.x * rfi::COLS + threadIdx.x;
  for (int k = 0; k < us.n; ++k)
    rfi::sub_scan(k ? y + off : x + off, y + off, 0, E, W, col, us.u[k], 0u,
                  sm);
}

template <typename T>
cudaError_t launch(const void* x, void* y, int layout, int P, int E, int W,
                   const rfi::Units& us, cudaStream_t stream) {
  if (layout == 0) {
    int_lane_kernel<T><<<P, rfi::THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), E, us);
  } else {
    const dim3 grid((W + rfi::COLS - 1) / rfi::COLS, P);
    int_sub_kernel<T><<<grid, dim3(rfi::COLS, rfi::SEG), 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), E, W, us);
  }
  return cudaGetLastError();
}

}  // namespace

// units: host array of n_units (f, a, causal) int triples.
extern "C" int int_scan_launch(const void* x, void* y, const int* units,
                               int layout, int P, int E, int W, int bytes,
                               int n_units, void* stream) {
  if (n_units < 1 || n_units > rfi::MAX_UNITS || P < 1 || E < 1 || W < 1 ||
      (layout == 1 && P > 65535) || (layout != 0 && layout != 1))
    return (int)cudaErrorInvalidValue;
  rfi::Units us;
  us.n = n_units;
  for (int k = 0; k < n_units; ++k)
    us.u[k] = {(uint32_t)units[3 * k], units[3 * k + 1] < 0,
               units[3 * k + 2] != 0};
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (bytes) {
    case 1: err = launch<int8_t>(x, y, layout, P, E, W, us, s); break;
    case 2: err = launch<int16_t>(x, y, layout, P, E, W, us, s); break;
    case 4: err = launch<int32_t>(x, y, layout, P, E, W, us, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* int_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
