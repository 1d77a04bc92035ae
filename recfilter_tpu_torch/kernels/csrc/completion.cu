// completion.cu: the completion of every tile of a 1-D last-axis pass — read
// the signal once, inject the solved carries, write the output once — in
// its unrotated px6 forms (completion, completion_epi, completion_traced);
// the reduced grades' unrotated form is completion_split.cu's
// (completion_split), the same kernel (completion_tc.cuh) at NPROD 1, 3, 4,
// and the rotated forms at every grade are completion_rot.cu's
// (completion_rot, completion_rot_epi) and completion_rot_tails.cu's, on
// the same product (completion_rot.cuh).
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
