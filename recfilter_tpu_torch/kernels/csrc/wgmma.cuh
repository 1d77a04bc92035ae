// wgmma.cuh: split-bf16 products on Hopper's warpgroup tensor-core
// instruction — wgmma.mma_async m64n128k16, bf16 in, fp32 accumulate, the
// A operand (64 rows) from registers, the B operand (128 columns) from
// shared memory through a matrix descriptor.
//
// B lives in shared memory K-major with no swizzle: 8 x 8 bf16 "core
// matrices" (8 columns n, 8 consecutive k each, 16 bytes a column, 128
// bytes a core matrix), the core matrices of one 8-column group along k
// contiguous. For a B of KP rows k:
//
//   element (n, k) at  ((n / 8) * (KP / 8) + k / 8) * 64 + (n % 8) * 8 + k % 8
//
// so the descriptor of a k16 step has a leading byte offset (the next 8 k)
// of 128 bytes and a stride byte offset (the next 8 columns) of KP * 16.
// The host prepares a constant in this order (kernels/completion.py's
// core_pack), so staging it is a flat copy.
//
// The A fragment of a warp (rows 16w..16w+15 of the warpgroup's 64) is
// mma.sync's m16n8k16 fragment: registers a0..a3 hold the pairs (row
// lane/4, k 2(lane%4) + {0, 1}), (row + 8, same k), (row, k + 8), (row + 8,
// k + 8). A thread reads its pairs from a fp32 stage as two float4 of four
// consecutive samples, so the contraction of each k16 step is permuted:
// position kl of the step holds sample phys(kl) (kperm below), on both
// operands. The accumulator d[64] of the 64 x 128 product: d[4j + 2h + e]
// is row 16w + lane/4 + 8h, column 8j + 2(lane%4) + e.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline.cuh"
#include "split.cuh"

namespace rfw {

constexpr int WG = 128;  // threads of a warpgroup
constexpr int TM = 64;   // rows of A (wgmma M)
constexpr int TN = 128;  // columns of B (wgmma N)

// The sample a k16 step's position kl holds: pairs 2c, 2c+1 are samples
// 4c, 4c+1 and pairs 8 + 2c, 9 + 2c samples 4c + 2, 4c + 3.
__host__ __device__ constexpr int kperm(int kl) {
  return 4 * ((kl % 8) / 2) + 2 * (kl / 8) + kl % 2;
}

// Element offset of B's (n, k) in the core-matrix order above.
__host__ __device__ constexpr int core_off(int n, int k, int kp) {
  return ((n / 8) * (kp / 8) + k / 8) * 64 + (n % 8) * 8 + k % 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptor of the TN x 16 slice of B at p (its k16 step's first core
// matrix), B with KP rows k: no swizzle, leading byte offset 128 B, stride
// byte offset KP * 16 B (both in 16-byte units).
__device__ __forceinline__ uint64_t desc(const __nv_bfloat16* p, int kp) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(8) << 16) | (uint64_t(kp) << 32);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// Chunks of B at grade NPROD: those of the carry slab, which takes the
// most products (split.cuh's carry_nprod; the signal's are its first ones).
__host__ __device__ constexpr int b_chunks(int nprod) {
  return rfs::nchunks(rfs::carry_nprod(nprod));
}

// The NC bf16 chunks of the pair (u, v) (split.cuh's split<NC>, the JAX
// package's _split_vmem: each the round-to-nearest of what the earlier
// ones left, the residuals exact), packed u low, v high.
template <int NC>
__device__ __forceinline__ void split_pair(float u, float v,
                                           uint32_t (&c)[NC]) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
    c[i] = as_u32(h);
    u = __fsub_rn(u, __low2float(h));
    v = __fsub_rn(v, __high2float(h));
  }
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Shared-memory writes of this thread (cp.async, st.shared) visible to the
// async proxy, which wgmma reads B through; before the barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += A * B for one k16 step: A the warpgroup's 64 x 16 fragment in
// registers, B the descriptor's 16 x 128 slice.
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                    uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// A k16 step's A fragment in its NC chunks: u[e] and w[e] the fp32
// samples 4qd + e of rows r and r + 8 — so the pairs (u0, u1), (w0, w1)
// at positions 2qd, 2qd + 1 and (u2, u3), (w2, w3) at 2qd + 8, 2qd + 9
// (kperm) — into a[ch][s].
template <int NC, int S>
__device__ __forceinline__ void frag(uint32_t (&a)[NC][S][4], int s,
                                     const float (&u)[4],
                                     const float (&w)[4]) {
  uint32_t c[4][NC];
  split_pair<NC>(u[0], u[1], c[0]);
  split_pair<NC>(w[0], w[1], c[1]);
  split_pair<NC>(u[2], u[3], c[2]);
  split_pair<NC>(w[2], w[3], c[3]);
#pragma unroll
  for (int ch = 0; ch < NC; ++ch)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[ch][s][i] = c[i][ch];
}

// The NPROD products of split.cuh's pairs over S k16 steps of A (NC chunks
// in registers) and B (chunk c at Bs + c * ch, the first step at element
// k0 of each), smallest level first, each pair over all its steps.
template <int NPROD, int NC, int S>
__device__ __forceinline__ void products(float (&d)[64],
                                         const uint32_t (&a)[NC][S][4],
                                         const __nv_bfloat16* Bs, int ch,
                                         int k0, int kp) {
#pragma unroll
  for (int p = 0; p < NPROD; ++p)
#pragma unroll
    for (int s = 0; s < S; ++s)
      mma(d, a[rfs::pair_d(NPROD, p)][s],
          desc(Bs + rfs::pair_c(NPROD, p) * ch + k0 + 128 * s, kp));
}

__device__ __forceinline__ void wg_sync(int wg) {  // one warpgroup's barrier
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(WG) : "memory");
}

// B's NC chunks of variant v — the host's split constant (nv, NC, ch) in
// the core-matrix order above — into shared memory at dst: a flat
// cp.async copy by the whole block, once every warpgroup is past its last
// products on the old variant; visible to the async proxy on return.
template <int NC>
__device__ __forceinline__ void stage_b(uint4* dst, const __nv_bfloat16* Bc,
                                        int v, int ch) {
  __syncthreads();
  const uint4* src = reinterpret_cast<const uint4*>(Bc + (long)NC * v * ch);
  for (int i = threadIdx.x; i < NC * ch / 8; i += blockDim.x)
    rfp::cp16(dst + i, src + i, true);
  rfp::commit();
  rfp::wait_pending(0);
  fence_async_smem();
  __syncthreads();
}

// One item's product, d = the warpgroup's 64 x 128 block of the split
// product over a contraction of 128 signal samples and KC k16 steps of
// carry rows (B's k >= 128, kp = 128 + 16 KC), as the JAX package sums it
// at grade NPROD (1, 3, 4 or 6): the carry slab's carry_nprod(NPROD)
// products first, then the signal slab's NPROD, each smallest level
// first; the carry rows split into b_chunks(NPROD) chunks, the signal
// into nchunks(NPROD) (B holds b_chunks(NPROD) chunks). rd(k0, u, w)
// reads the fp32 samples k0 + 4qd + e (e < 4) of the thread's rows r and
// r + 8 — k0 = 128 + 16 s for the carry steps, 16 s for the signal's —
// into u and w (zeros past the real carry rows); the signal's chunks are
// split under the carry products. issued() runs once the products are
// issued and every sample is in registers (the stage is free: the next
// item's loads go there).
template <int NPROD, int KC, typename Read, typename Issued>
__device__ __forceinline__ void split_products(float (&d)[64],
                                               const __nv_bfloat16* Bs,
                                               int ch, int kp, Read&& rd,
                                               Issued&& issued) {
  constexpr int T = 128;
  constexpr int CP = rfs::carry_nprod(NPROD);
  constexpr int NCC = rfs::nchunks(CP), NCS = rfs::nchunks(NPROD);
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  uint32_t ac[NCC][KC][4];
#pragma unroll
  for (int s = 0; s < KC; ++s) {
    float u[4], w[4];
    rd(T + 16 * s, u, w);
    frag<NCC, KC>(ac, s, u, w);
  }
  fence_acc(d);
  fence();
  products<CP, NCC, KC>(d, ac, Bs, ch, 128 * (T / 16), kp);
  commit();
  if constexpr (KC > 1) wait_all();  // the carry chunks' registers
  uint32_t ai[NCS][T / 16][4];
#pragma unroll
  for (int s = 0; s < T / 16; ++s) {
    float u[4], w[4];
    rd(16 * s, u, w);
    frag<NCS, T / 16>(ai, s, u, w);
  }
  fence();
  products<NPROD, NCS, T / 16>(d, ai, Bs, ch, 0, kp);
  commit();
  issued();
  wait_all();
  fence_acc(d);
}

}  // namespace rfw
