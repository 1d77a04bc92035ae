// moments2d: pass 1 of the 3-touch 2-D executor — both dimensions' raw
// tails from one read of the image.
//
// Replaces recfilter_tpu/kernels/final2d.py::moments2d_px (Pallas kernel
// _moments_px_kernel) with its term1 fold on. Per 128 x 128 tile x of the
// (p, na, Ta, W) image, with v(i) the tile's matrix variant (interior,
// first or last — clamp edges and the pad projector):
//
//   bA_t [p,a,k, b*Tb+w] = sum_s Ga_v(a)[k,s] * x[s,w]          k < Ka
//   U    [k,s]           = sum_t Gb_v(b)[k,t] * x[s,t]          k < Kb
//   term1[p,a, b*8+k, o] = sum_s Btot_a_v(a)[o,s] * U[k,s]      k < Kb
//
// and explicit zeros in the pad slots (rows Ka..7 of bA_t, Kb..7 of each
// term1 slot group): the carry solve multiplies them by zero columns, and
// an uninitialised NaN there would poison the result.
//
// With h8 > 0 (moments2d_px's edge_mats, the row-halo feed of a fused 2-D
// stencil consumer) it also emits each tile's edge completion partials,
// the first and last h8 rows of its dim-A completion matrix times x:
//
//   ht[p,a,k, b*Tb+w] = sum_s Btot_a_v(a)[k, s] * x[s,w]          k < h8
//   hb[p,a,k, b*Tb+w] = sum_s Btot_a_v(a)[Ta-h8+k, s] * x[s,w]
//
// from the same staged tile (E = those 2*h8 rows, (nva, 2*h8, T)), fp64
// sums like the tails: 2*h8 more MACs per pixel.
//
// What bounds it: it reads 4 B/px and does Ka + 2*Kb MACs per pixel (18
// for the 3rd-order Gaussian pair), so on an H100 it is bound by
// device-memory bandwidth. The design reads each x tile from device memory
// once into shared memory (row stride 132 floats: column reads by
// consecutive threads and float4 row reads by consecutive rows are both
// free of bank conflicts) and keeps U on chip.
//
// The sums accumulate in fp64 (fp32 loads and stores). These tails seed
// the carries, and the carry solve and injection amplify their error
// about thirtyfold for the sigma=5 Gaussian: fp32 accumulation here left the
// whole filter at 3.4e-6 of the output peak against the f64 oracle (the
// px6 bound is 2e-6), fp64 accumulation at 6e-7 (plain twins on the CPU,
// 512^2). At 18 MACs per pixel the H100's fp64 rate keeps the kernel near
// its bandwidth bound. The TPU kernel's bf16 chunk splitting works around
// the TPU matrix unit and has no counterpart here.

//
// moments2d_k: pass 1 at the HIGHEST grade's layouts — replaces
// recfilter_tpu/kernels/final2d.py::moments2d (Pallas kernel
// _moments_kernel), which overlap2d._fused_2d_kernel_path calls on the
// overlap_k backend. Per tile (b, a, p), any Ta <= 128, the carries the
// unpadded sums of the orders (Ka, Kb <= 32):
//
//   bA[p,a,k, b*Tb+w] = sum_s Ga_v(a)[k,s] * x[s,w]          (p, na, Ka, W)
//   U [p,a,b,s,k]     = sum_t Gb_v(b)[k,t] * x[s,t]          (p, na, nb, Ta, Kb)
//
// raw U, untransposed, with no term1 fold (the glue applies Btot_a). The
// sums accumulate in fp64 from fp32 loads, for the reason above, in eight
// carries a pass (two threads a column or row, four carries each). It
// reads 4 B/px and writes (Ka + Kb) / 128 of that again, with Ka + Kb
// fp64 MACs per pixel (12 for the 3rd-order Gaussian pair: 0.4 GFLOP at
// 4096^2, 0.006 ms at 67 TFLOP/s of fp64 on the tensor cores, 0.012 ms
// at the CUDA cores' 33.5 TFLOP/s this loop runs at), so device memory
// bounds it: 0.022 ms at 3.35 TB/s for the 64 MB image and its outputs.

#include <cuda_runtime.h>

namespace {

constexpr int T = 128;        // tile edge, Ta = Tb
constexpr int SLOTS = 8;      // carry rows per slot
constexpr int THREADS = 256;  // two threads per column: slots kg, kg+2, ..
constexpr int XS = T + 4;     // padded shared row stride of the x tile
constexpr int SMEM_BYTES =
    (T * XS + 2 * SLOTS * T) * sizeof(float) + 2 * SLOTS * T * sizeof(double);

__device__ __forceinline__ int variant(int nv, int i, int n) {
  if (nv == 1) return 0;
  return i == 0 ? 1 : (i == n - 1 ? 2 : 0);
}

__global__ void __launch_bounds__(THREADS)
moments2d_kernel(const float* __restrict__ x,     // (p, na, T, W)
                 const float* __restrict__ Ga,    // (nva, 8, T)
                 const float* __restrict__ Gb,    // (nvb, 8, T)
                 const float* __restrict__ Ba1T,  // (nva, T, T): [s][o]
                 const float* __restrict__ E,     // (nva, 2*h8, T)
                 float* __restrict__ bA,          // (p, na, 8, W)
                 float* __restrict__ term1,       // (p, na, nb*8, T)
                 float* __restrict__ ht,          // (p, na, h8, W)
                 float* __restrict__ hb,          // (p, na, h8, W)
                 int na, int nb, int Ka, int Kb, int nva, int nvb, int h8) {
  extern __shared__ float4 smem4[];
  double* us = reinterpret_cast<double*>(smem4);  // 8 x T: U[k][s]
  double* es = us + SLOTS * T;                    // 8 x T: 8 edge rows
  float* xs = reinterpret_cast<float*>(es + SLOTS * T);  // T rows x XS
  float* ga = xs + T * XS;                        // 8 x T
  float* gb = ga + SLOTS * T;                     // 8 x T

  const int b = blockIdx.x, a = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x;
  const long W = (long)nb * T;
  const long pa = (long)p * na + a;
  const int va = variant(nva, a, na), vb = variant(nvb, b, nb);

  const float* xt = x + pa * T * W + (long)b * T;
  for (int i = tid; i < T * (T / 4); i += THREADS) {
    const int r = i / (T / 4), c4 = i % (T / 4);
    reinterpret_cast<float4*>(xs + r * XS)[c4] =
        reinterpret_cast<const float4*>(xt + r * W)[c4];
  }
  const float* gav = Ga + (long)va * SLOTS * T;
  const float* gbv = Gb + (long)vb * SLOTS * T;
  for (int i = tid; i < SLOTS * T; i += THREADS) {
    ga[i] = gav[i];
    gb[i] = gbv[i];
  }
  __syncthreads();

  const int col = tid % T;  // w for bA, s for U, o for term1
  const int kg = tid / T;   // this thread's slots: kg, kg+2, kg+4, kg+6

  // dim-A tails: column w of G_a * x
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int s = 0; s < T; ++s) {
    const double xv = xs[s * XS + col];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = fma((double)ga[(kg + 2 * j) * T + s], xv, acc[j]);
  }
  float* bAt = bA + pa * SLOTS * W + (long)b * T + col;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = kg + 2 * j;
    bAt[k * W] = k < Ka ? (float)acc[j] : 0.f;
  }

  // edge completion partials: column w of the 2*h8 edge rows * x, eight
  // rows a pass, staged in fp64 (no conversion per product)
  const float* Ev = E + (long)va * 2 * h8 * T;
  for (int k0 = kg; k0 < 2 * h8; k0 += 8) {
    __syncthreads();  // the previous pass has read its rows
    for (int i = tid; i < SLOTS * T; i += THREADS)
      es[i] = k0 - kg + i / T < 2 * h8 ? (double)Ev[(k0 - kg) * T + i] : 0.0;
    __syncthreads();
    double e[4] = {0.0, 0.0, 0.0, 0.0};
    for (int s = 0; s < T; ++s) {
      const double xv = xs[s * XS + col];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e[j] = fma(es[(kg + 2 * j) * T + s], xv, e[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 2 * j;
      if (k < 2 * h8) {
        float* dst = k < h8 ? ht + (pa * h8 + k) * W
                            : hb + (pa * h8 + k - h8) * W;
        dst[(long)b * T + col] = (float)e[j];
      }
    }
  }

  // dim-B moments: row s of x * G_b^T, kept in shared memory (fp64)
  double u[4] = {0.0, 0.0, 0.0, 0.0};
  const float* xrow = xs + col * XS;
  for (int t = 0; t < T; t += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(xrow + t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* g = gb + (kg + 2 * j) * T + t;
      u[j] = fma((double)g[0], (double)xv.x, u[j]);
      u[j] = fma((double)g[1], (double)xv.y, u[j]);
      u[j] = fma((double)g[2], (double)xv.z, u[j]);
      u[j] = fma((double)g[3], (double)xv.w, u[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = kg + 2 * j;
    us[k * T + col] = k < Kb ? u[j] : 0.0;
  }
  __syncthreads();

  // term1 = Btot_a * U^T: output column o, Btot_a^T rows read coalesced
  const float* bt = Ba1T + (long)va * T * T + col;
  double t1[4] = {0.0, 0.0, 0.0, 0.0};
  for (int s = 0; s < T; ++s) {
    const double bv = __ldg(bt + s * T);
#pragma unroll
    for (int j = 0; j < 4; ++j) t1[j] = fma(us[(kg + 2 * j) * T + s], bv, t1[j]);
  }
  float* t1p = term1 + (pa * nb + b) * SLOTS * T + col;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = kg + 2 * j;
    t1p[k * T] = k < Kb ? (float)t1[j] : 0.f;
  }
}

constexpr int KMAX = 32;  // moments2d_k's largest carry count per axis

__global__ void __launch_bounds__(THREADS)
moments2d_k_kernel(const float* __restrict__ x,   // (p, na, Ta, W)
                   const float* __restrict__ Ga,  // (nva, Ka, Ta)
                   const float* __restrict__ Gb,  // (nvb, Kb, T)
                   float* __restrict__ bA,        // (p, na, Ka, W)
                   float* __restrict__ U,         // (p, na, nb, Ta, Kb)
                   int na, int nb, int Ta, int Ka, int Kb, int nva,
                   int nvb) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);          // Ta rows x XS
  double* ga = reinterpret_cast<double*>(xs + Ta * XS);  // Ka x Ta
  double* gb = ga + Ka * Ta;                             // Kb x T

  const int b = blockIdx.x, a = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x;
  const long W = (long)nb * T;
  const long pa = (long)p * na + a;
  const int va = variant(nva, a, na), vb = variant(nvb, b, nb);

  const float* xt = x + pa * Ta * W + (long)b * T;
  for (int i = tid; i < Ta * (T / 4); i += THREADS) {
    const int r = i / (T / 4), c4 = i % (T / 4);
    reinterpret_cast<float4*>(xs + r * XS)[c4] =
        reinterpret_cast<const float4*>(xt + r * W)[c4];
  }
  const float* gav = Ga + (long)va * Ka * Ta;
  for (int i = tid; i < Ka * Ta; i += THREADS) ga[i] = gav[i];
  const float* gbv = Gb + (long)vb * Kb * T;
  for (int i = tid; i < Kb * T; i += THREADS) gb[i] = gbv[i];
  __syncthreads();

  const int col = tid % T;  // w for bA, s for U
  const int kg = tid / T;   // carries kg, kg+2, kg+4, kg+6 of each pass

  // dim-A tails: column w of G_a * x
  float* bAt = bA + pa * Ka * W + (long)b * T + col;
  for (int k0 = 0; k0 < Ka; k0 += SLOTS) {
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    int kr[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + kg + 2 * j;
      kr[j] = (k < Ka ? k : Ka - 1) * Ta;
    }
    for (int s = 0; s < Ta; ++s) {
      const double xv = xs[s * XS + col];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fma(ga[kr[j] + s], xv, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + kg + 2 * j;
      if (k < Ka) bAt[k * W] = (float)acc[j];
    }
  }

  // dim-B moments: row s of x * G_b^T, raw
  if (col < Ta) {
    const float* xrow = xs + col * XS;
    float* Ut = U + ((pa * nb + b) * Ta + col) * (long)Kb;
    for (int k0 = 0; k0 < Kb; k0 += SLOTS) {
      double u[4] = {0.0, 0.0, 0.0, 0.0};
      int kr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + kg + 2 * j;
        kr[j] = (k < Kb ? k : Kb - 1) * T;
      }
      for (int t = 0; t < T; t += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xrow + t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const double* g = gb + kr[j] + t;
          u[j] = fma(g[0], (double)xv.x, u[j]);
          u[j] = fma(g[1], (double)xv.y, u[j]);
          u[j] = fma(g[2], (double)xv.z, u[j]);
          u[j] = fma(g[3], (double)xv.w, u[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + kg + 2 * j;
        if (k < Kb) Ut[k] = (float)u[j];
      }
    }
  }
}

}  // namespace

extern "C" int moments2d_launch(const float* x, const float* Ga,
                                const float* Gb, const float* Ba1T,
                                const float* E, float* bA, float* term1,
                                float* ht, float* hb, int p, int na, int nb,
                                int Ka, int Kb, int nva, int nvb, int h8,
                                void* stream) {
  if (h8 < 0 || h8 > T) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      moments2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, na, p);
  moments2d_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, Ga, Gb, Ba1T, E, bA, term1, ht, hb, na, nb, Ka, Kb, nva, nvb, h8);
  return (int)cudaGetLastError();
}

// Ta <= 128, Ka and Kb <= 32
extern "C" int moments2d_k_launch(const float* x, const float* Ga,
                                  const float* Gb, float* bA, float* U,
                                  int p, int na, int nb, int Ta, int Ka,
                                  int Kb, int nva, int nvb, void* stream) {
  if (Ta < 1 || Ta > T || Ka < 1 || Ka > KMAX || Kb < 1 || Kb > KMAX)
    return (int)cudaErrorInvalidValue;
  const int smem = (Ka * Ta + Kb * T) * (int)sizeof(double) +
                   Ta * XS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      moments2d_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, na, p);
  moments2d_k_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, Ga, Gb, bA, U, na, nb, Ta, Ka, Kb, nva, nvb);
  return (int)cudaGetLastError();
}

extern "C" const char* moments2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
