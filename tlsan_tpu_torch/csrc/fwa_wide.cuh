// Device code of the wide variants of the feature-wise attention kernels K1
// (fwa_fwd.cu) and K2 (fwa_bwd.cu): heads of more than 32 features, where the
// one-warp-per-(row, head) variants of fwa_common.cuh would hold 3·dh
// floats a lane (x, m1 and m2: 192 at dh = 64) and spill.
//
// A block of kWideThreads threads takes one (batch row b, head h) unit at a
// time and walks its S steps in chunks of C (ops/cuda/fwa.py::launch_plan
// sizes C so that the chunk's arrays fit shared memory: [C][dh] floats
// each, x, m1, m2 and, in K2, the softmax weights, dm2 and dz1).  A chunk's
// maps are two [C, dh] × [dh, dh] products: a thread computes one output
// feature e of four steps, so that each weight it reads serves four steps;
// the lanes of a warp take consecutive features, so the weights' rows are
// read coalesced from device memory, where they stay (2·dh² floats: 2 MB at
// dh = 512, above a block's shared memory; the L1 and L2 caches hold them)
// and the chunk's inputs are broadcast from shared memory.  The softmax
// over time is per feature: the thread that owns feature e (e = tid, tid +
// kWideThreads, tid + 2·kWideThreads, ... for any dh) walks the steps in
// order, so its max, its sum and the weighted sum are sequential and
// bitwise repeatable.  What bounds dh is shared memory: a chunk of one
// step, 6·dh floats (K1) or 9·dh (K2), must fit a block's.  With S <= C the maps
// are computed once; past C each pass (max, sum, weighted sum, and K2's
// backward) recomputes them chunk by chunk, re-reading x from L2.
//
// Dropout (DROP) applies the two keep masks (bytes laid out as x) as
// fwa_common.cuh's forward_step_drop does: x_in = x / keep where kept (else
// 0) is the first map's input, m1_in = m1 / keep where kept its output.
//
// Exactness: expf, IEEE division, no fast math, the additive −1e30 mask; a
// row of length 0 gets a softmax uniform over its S steps.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "fwa_common.cuh"

namespace fwa {

constexpr int kWideThreads = 256;
constexpr int kWideMaxDevices = 64;

// out[t][e] for the nt steps of a chunk and every feature e < dh:
// init + Σ_k in[t][k] · W[k][e] (or, `transposed`, Σ_k in[t][k] · W[e][k]),
// in feature order k = 0 .. dh − 1, handed to epi(t, e, value).  `in` lies
// in shared memory ([nt][dh]); W in device memory ([dh][dh]); `bias`, if
// not null, is the init of output feature e.  A thread takes feature e of
// four consecutive steps.
template <bool TRANSPOSED, class Epi>
__device__ inline void chunk_product(const float* in, const float* __restrict__ w,
                                     const float* __restrict__ bias, int dh, int nt,
                                     Epi epi) {
  const int items = dh * ((nt + 3) / 4);
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int e = idx % dh, t0 = idx / dh * 4;
    const float init = bias != nullptr ? __ldg(bias + e) : 0.0f;
    float acc[4] = {init, init, init, init};
    const float* r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = in + min(t0 + i, nt - 1) * dh;
    const float* wp = TRANSPOSED ? w + static_cast<long long>(e) * dh : w + e;
    for (int k = 0; k < dh; ++k) {
      const float wv = __ldg(TRANSPOSED ? wp + k : wp + static_cast<long long>(k) * dh);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(r[i][k], wv, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (t0 + i < nt) epi(t0 + i, e, acc[i]);
  }
}

// The maps of the steps t0 .. t0 + nt − 1 of a unit (xb: its step 0, steps
// D floats apart): X = x, M1 = relu(x · W1 + b1) (m1_in under DROP) and
// A = M1 · W2 + b2 with −1e30 added at t >= len, each [nt][dh].  Under DROP,
// A holds x_in until the second product overwrites it.  Ends with a
// barrier, after which the three arrays may be read by any thread.
template <bool DROP>
__device__ inline void wide_maps(const float* __restrict__ xb, int t0, int nt, int D, int dh,
                                 int len, const float* __restrict__ w1,
                                 const float* __restrict__ b1, const float* __restrict__ w2,
                                 const float* __restrict__ b2, const std::uint8_t* k1,
                                 const std::uint8_t* k2, float keep, float* X, float* A,
                                 float* M1) {
  for (int i = threadIdx.x; i < nt * dh; i += blockDim.x) {
    const int t = i / dh, j = i - t * dh;
    const long long off = static_cast<long long>(t0 + t) * D + j;
    const float v = __ldg(xb + off);
    X[i] = v;
    if constexpr (DROP) A[i] = k1[off] ? v / keep : 0.0f;
  }
  __syncthreads();
  chunk_product<false>(DROP ? A : X, w1, b1, dh, nt, [&](int t, int e, float z) {
    float m = fmaxf(z, 0.0f);
    if constexpr (DROP) m = k2[static_cast<long long>(t0 + t) * D + e] ? m / keep : 0.0f;
    M1[t * dh + e] = m;
  });
  __syncthreads();
  chunk_product<false>(M1, w2, b2, dh, nt, [&](int t, int e, float z) {
    A[t * dh + e] = z + (t0 + t < len ? 0.0f : kVeryNegative);
  });
  __syncthreads();
}

// The softmax statistics of one pass over a chunk, for the features this
// thread owns: pass 0 the max of m2 (A) into mx, pass 1 the sum of
// exp(m2 − max) into sm; steps in order.
__device__ inline void wide_stats(int pass, const float* A, int nt, int dh, float* mx,
                                  float* sm) {
  for (int e = threadIdx.x; e < dh; e += blockDim.x) {
    if (pass == 0) {
      float m = mx[e];
      for (int t = 0; t < nt; ++t) m = fmaxf(m, A[t * dh + e]);
      mx[e] = m;
    } else {
      float s = sm[e];
      const float m = mx[e];
      for (int t = 0; t < nt; ++t) s += expf(A[t * dh + e] - m);
      sm[e] = s;
    }
  }
}

// Raises the dynamic shared memory `kernel` may use on the current device
// to `smem` bytes (once a device and size); returns the CUDA error.
template <class Kernel>
inline int opt_in(Kernel kernel, int smem, int (&opted)[kWideMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kWideMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && smem > opted[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[device] = smem;
  }
  return 0;
}

}  // namespace fwa
