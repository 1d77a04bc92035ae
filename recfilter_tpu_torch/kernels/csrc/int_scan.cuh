// int_scan.cuh: the wrapping unit scans shared by int_scan.cu (the full
// extent of a line in one block) and int_seg_scan.cu (chunks of a line,
// with incoming carries).
//
// One unit scan along an axis is, for a = +1 or -1 and an integer tap f,
//
//   y[i] = f * x[i] + a * y[i -/+ 1]      (causal / anticausal, zero state)
//
// exact modulo 2^32: the integer filters' wrap-around semantics. With
// D = diag((-1)^i) over the GLOBAL index i along the axis, a = -1 becomes a
// plain prefix sum: y = D * cumsum(D * f * x) (a suffix sum when
// anticausal). Every add and multiply runs in uint32_t (signed overflow is
// undefined in C++): values are sign-extended from the stored type on load
// and their low bits stored back, which is exact for int8 and int16 too,
// because the low k bits of a wrapping integer-linear map depend only on
// the low k bits of its input.
//
// Two layouts, as in the JAX package:
//   * lane: the scanned axis is the last, lines (rows, E) contiguous —
//     a block scans one line in tiles of 1024 (4 per thread): a coalesced
//     striped load, a blocked re-read from shared memory, a thread-local
//     scan, warp shuffles, a block combine, a running carry across tiles;
//   * sublane: any other axis, as (P, E, W) with W contiguous — a block
//     takes 32 columns (one per lane, coalesced row loads) and cuts the
//     scanned rows into SEG segments: each thread sums its segment, the
//     segment sums are combined in shared memory, and each thread then
//     re-walks its segment with its incoming carry.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rfi {

constexpr int THREADS = 256;       // lane layout: threads per block
constexpr int ITEMS = 4;           // lane layout: elements per thread and tile
constexpr int TILE = THREADS * ITEMS;
constexpr int COLS = 32;           // sublane layout: columns per block
constexpr int SEG = 32;            // sublane layout: segments per column
constexpr int MAX_UNITS = 8;

struct Unit {
  uint32_t f;   // feed-forward tap (two's complement bits)
  int neg;      // feedback a = -1
  int causal;
};

struct Units {
  int n;
  Unit u[MAX_UNITS];
};

template <typename T>
__device__ __forceinline__ uint32_t ld(const T* p) {
  return (uint32_t)(int32_t)*p;  // sign-extend, then the ring's bits
}

template <typename T>
__device__ __forceinline__ void st(T* p, uint32_t v) {
  using U = typename std::make_unsigned<T>::type;
  *reinterpret_cast<U*>(p) = (U)v;  // the low bits, by unsigned narrowing
}

// D_i * v, with D_i = (-1)^i when the feedback is -1
__device__ __forceinline__ uint32_t par(uint32_t v, long i, int neg) {
  return (neg && (i & 1)) ? 0u - v : v;
}

// Shared scratch of the lane layout.
struct LaneSmem {
  alignas(16) uint32_t tile[TILE];
  uint32_t warp_tot[THREADS / 32];
};

// Scan positions [e0, e1) of the line at `src` (global indices from the
// line's start) into `dst` for one unit, starting from the transformed
// carry `carry` (D_entry * y_entry). Returns the transformed carry at the
// range's exit. src may equal dst. All threads of the block call it.
template <typename T>
__device__ uint32_t lane_scan(const T* src, T* dst, long e0, long e1,
                              const Unit& u, uint32_t carry, LaneSmem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long ntiles = (e1 - e0 + TILE - 1) / TILE;
  for (long it = 0; it < ntiles; ++it) {
    const long b = e0 + (u.causal ? it : ntiles - 1 - it) * TILE;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {  // striped, coalesced load
      const long i = b + k * THREADS + tid;
      uint32_t v = 0;
      if (i < e1) v = par(ld(src + i) * u.f, i, u.neg);
      sm.tile[k * THREADS + tid] = v;
    }
    __syncthreads();
    uint4 q4 = reinterpret_cast<const uint4*>(sm.tile)[tid];  // blocked
    uint32_t v[ITEMS] = {q4.x, q4.y, q4.z, q4.w};
    uint32_t tot;
    if (u.causal) {
#pragma unroll
      for (int j = 1; j < ITEMS; ++j) v[j] += v[j - 1];
      tot = v[ITEMS - 1];
    } else {
#pragma unroll
      for (int j = ITEMS - 2; j >= 0; --j) v[j] += v[j + 1];
      tot = v[0];
    }
    // inclusive scan of the thread totals within the warp, in scan order
    uint32_t inc = tot;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = u.causal ? __shfl_up_sync(0xffffffffu, inc, d)
                                  : __shfl_down_sync(0xffffffffu, inc, d);
      if (u.causal ? lane >= d : lane + d < 32) inc += o;
    }
    if (lane == (u.causal ? 31 : 0)) sm.warp_tot[warp] = inc;
    __syncthreads();
    uint32_t before = carry + inc - tot, block = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      const uint32_t t = sm.warp_tot[w];
      block += t;
      if (u.causal ? w < warp : w > warp) before += t;
    }
    const long p0 = b + (long)tid * ITEMS;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) v[j] = par(v[j] + before, p0 + j, u.neg);
    reinterpret_cast<uint4*>(sm.tile)[tid] = make_uint4(v[0], v[1], v[2], v[3]);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {  // striped, coalesced store
      const long i = b + k * THREADS + tid;
      if (i < e1) st(dst + i, sm.tile[k * THREADS + tid]);
    }
    carry += block;
    __syncthreads();  // the tile and the warp totals are reused
  }
  return carry;
}

// Shared scratch of the sublane layout.
struct SubSmem {
  uint32_t tot[SEG][COLS];
};

// Scan rows [r0, r1) of column `col` of the (E, W) plane at `src` into
// `dst` for one unit, from the transformed carry `carry`. Threads are
// (threadIdx.x = column in the block, threadIdx.y = segment); a thread
// whose column is past W still joins the barriers. src may equal dst.
template <typename T>
__device__ void sub_scan(const T* src, T* dst, long r0, long r1, long W,
                         long col, const Unit& u, uint32_t carry,
                         SubSmem& sm) {
  const int lx = threadIdx.x, s = threadIdx.y;
  const long len = (r1 - r0 + SEG - 1) / SEG;
  const long a = r0 + s * len, e = a + len < r1 ? a + len : r1;
  const bool on = col < W;
  uint32_t tot = 0;
  if (on) {
#pragma unroll 8
    for (long i = a; i < e; ++i) tot += par(ld(src + i * W + col) * u.f, i,
                                            u.neg);
  }
  sm.tot[s][lx] = tot;
  __syncthreads();
  for (int t = 0; t < SEG; ++t)
    if (u.causal ? t < s : t > s) carry += sm.tot[t][lx];
  if (on) {
    if (u.causal) {
#pragma unroll 8
      for (long i = a; i < e; ++i) {
        carry += par(ld(src + i * W + col) * u.f, i, u.neg);
        st(dst + i * W + col, par(carry, i, u.neg));
      }
    } else {
#pragma unroll 8
      for (long i = e - 1; i >= a; --i) {
        carry += par(ld(src + i * W + col) * u.f, i, u.neg);
        st(dst + i * W + col, par(carry, i, u.neg));
      }
    }
  }
  __syncthreads();  // tot is reused; dst is re-read by the next unit
}

}  // namespace rfi
