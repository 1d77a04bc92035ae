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

// The three bf16 chunks of the pair (u, v) (split.cuh's split<3>, the JAX
// package's _split_vmem: each the round-to-nearest of what the earlier
// ones left, the residuals exact), packed u low, v high.
__device__ __forceinline__ void split3(float u, float v, uint32_t (&c)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
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

}  // namespace rfw
