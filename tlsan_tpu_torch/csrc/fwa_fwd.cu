// Feature-wise attention (FWA) forward, K1, for Hopper (sm_90a), f32.
//
// Replaces: tlsan_tpu/ops/pallas/fwa.py::_fwa_kernel (launched by
// _fwa_forward).  Semantics are those of
// tlsan_tpu/ops/feature_attention.py::feature_wise_attention_reference:
//
//   x [B, S, D] split into H heads of dh = D / H features (a reshape);
//   m1 = relu(x_h · W1 + b1), m2 = m1 · W2 + b2  (W1, W2 [dh, dh] shared by
//   every head); −1e30 added at t >= len[b]; softmax over TIME per feature;
//   out[b, d] = Σ_t soft[b, t, d] · x[b, t, d].
//
// What bounds it on the H100: at the serving shapes (B = 128, S = 10 and
// S = 25, D = 64) it reads x once (0.33 MB and 0.82 MB, 0.10 and 0.25 µs at
// 3.35 TB/s) and does about 3 and 9 MFLOP (0.05 and 0.13 µs at 67 TFLOP/s
// f32): bytes bound it, and at these sizes the latency of one launch and of
// one unit's dependent chain, not the card's rates, sets its time.  So the
// design fills the card with independent warps and keeps each warp's chain
// short.
//
// Replicas.  A replica axis of weights (R parameter sets, each with its own
// rows: x [R, B, S, D], lengths [R, B], W1/W2 [R, dh, dh], b1/b2 [R, dh] →
// out [R, B, D]) is the grid's y axis: block (i, r) runs unit block i of
// replica r on replica r's rows and weights, with the arithmetic of one
// replica's launch, so replica r's output is bit for bit what a launch on
// its slice alone gives.  R replicas are one launch, as jax.vmap of the
// pallas_call adds a grid axis.
//
// Design (fwa_common.cuh).  One warp per (batch row, head): 1,024 warps at
// B = 128, H = 8, four to a block, spread over all 132 SMs.  Lane t loads its
// step's dh features as float4s and computes m1 and m2 in registers, with
// the weights broadcast from shared memory; the x and lengths loads go out
// before the block's one barrier (after the weights), so the two trips to
// device memory overlap.  The max and the sum over time, and
// out[b, h·dh + j] = Σ_t soft·x, are reductions across the lanes by halving
// exchanges (9 shuffles for the 8 features of a head, not 40): no [S, D]
// tile goes through shared memory.  For S > 32 each lane takes steps t,
// t + 32, ...: three passes (max, sum, weighted sum) re-read x and
// recompute the maps.  dh = 8 is specialised; any other dh <= 32 runs a
// generic variant with plain loops; wider heads run the
// wide variant (fwa_wide.cuh: a block a unit).  The TPU kernel's
// block-diagonal [D, D] lift of the head maps is not carried over: 8×8
// maps are below any tensor-core tile, and TF32 is off by contract.
//
// Dropout (train time) is the DROP variant: two keep masks laid out as x
// (bytes [B, S, D], or [R, B, S, D]; 1 = keep) for the inputs of the two
// dense maps, and keep = 1 − rate, as fwa_common.cuh's forward_step_drop
// applies them; the weighted sum reads the unmasked x.  Each lane reads its
// step's dh flags of each mask (8 bytes at dh = 8), so the masks add 2·B·S·D
// bytes to the bytes it moves.  Null mask pointers select the variant
// without dropout, whose code is that before the masks.
//
// Exactness: expf (not __expf), IEEE division, no fast-math, and the mask is
// the additive −1e30 of the reference, so a row of length 0 gets a uniform
// softmax over all S and returns the mean of x, as in the JAX package.  The
// reductions run in a fixed order: two calls agree bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "fwa_common.cuh"
#include "fwa_wide.cuh"

namespace {

using namespace fwa;

template <int DH, bool ONE, bool DROP>
__global__ void __launch_bounds__(kMaxThreads)
fwa_fwd_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               float* __restrict__ out, int units, int S, int D, int H, int dh,
               const std::uint8_t* __restrict__ k1, const std::uint8_t* __restrict__ k2,
               float keep) {
  extern __shared__ float sw[];
  const int n = features<DH>(dh);
  {  // replica blockIdx.y's rows, lengths, weights and outputs
    const long long r = blockIdx.y, rows = units / H;
    x += r * rows * S * D;
    if constexpr (DROP) k1 += r * rows * S * D, k2 += r * rows * S * D;
    lengths += r * rows;
    out += r * rows * D;
    w1 += r * dh * dh;
    w2 += r * dh * dh;
    b1 += r * dh;
    b2 += r * dh;
  }
  const int lane = threadIdx.x & (kWarp - 1);
  const int unit = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const bool active = unit < units;
  const int b = unit / H;
  const int h = unit - b * H;
  const float* xb = x + static_cast<long long>(b) * S * D + h * n;
  Drop drop{};
  if constexpr (DROP) {
    const long long base = static_cast<long long>(b) * S * D + h * n;
    drop = Drop{k1 + base, k2 + base, keep};
  }
  // the unit's loads go out before the weights' barrier, so that the two
  // trips to device memory overlap
  int len = 0;
  float xv[DH];
  const bool in = active && lane < S;
  if (active) len = lengths[b];
  if (ONE && in) load_row<DH>(xb + static_cast<long long>(lane) * D, n, xv);
  load_weights(sw, w1, b1, w2, b2, n);
  __syncthreads();
  if (!active) return;

  float acc[DH], m1[DH], m2[DH], mx[DH], sm[DH];
  if constexpr (ONE) {
    // S <= 32: lane t's step stays in registers through all three phases
    if (in) {
      maps<DH, DROP>(xv, sw, n, lane < len, drop, static_cast<long long>(lane) * D, m1, m2);
    } else {
#pragma unroll
      for (int j = 0; j < n; ++j) xv[j] = 0.0f, m2[j] = -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < n; ++j) mx[j] = m2[j];
    warp_allreduce<DH>(mx, n, lane, Max());
#pragma unroll
    for (int j = 0; j < n; ++j) sm[j] = m2[j] = in ? expf(m2[j] - mx[j]) : 0.0f;
    warp_allreduce<DH>(sm, n, lane, Sum());
#pragma unroll
    for (int j = 0; j < n; ++j) acc[j] = m2[j] / sm[j] * xv[j];
  } else {
    softmax_stats<DH, DROP>(xb, sw, n, S, D, len, lane, drop, mx, sm);
#pragma unroll
    for (int j = 0; j < n; ++j) acc[j] = 0.0f;
    for (int t = lane; t < S; t += kWarp) {
      load_row<DH>(xb + static_cast<long long>(t) * D, n, xv);
      maps<DH, DROP>(xv, sw, n, t < len, drop, static_cast<long long>(t) * D, m1, m2);
#pragma unroll
      for (int j = 0; j < n; ++j) acc[j] = fmaf(expf(m2[j] - mx[j]) / sm[j], xv[j], acc[j]);
    }
  }
  float* ob = out + static_cast<long long>(b) * D + h * n;
  if constexpr (DH == 8) {
    // lanes 0, 4, ..., 28 hold the eight totals
    const float r = reduce8(acc, lane, Sum());
    if ((lane & 3) == 0) ob[feature8(lane)] = r;
  } else {
    warp_allreduce<DH>(acc, n, lane, Sum());
    if (lane < n) ob[lane] = acc[lane];
  }
}

// The wide variant (fwa_wide.cuh): heads of more than 32 features, one block
// of kWideThreads threads a (row, head) unit, the steps in chunks of C.
// Pass 0 takes the max of m2 per feature, pass 1 the sum of exp(m2 − max),
// pass 2 out = Σ_t exp(m2 − max) / sum · x, each over the steps in order;
// with S <= C the chunk's maps are computed once for all three.
template <bool DROP>
__global__ void __launch_bounds__(kWideThreads)
fwa_fwd_wide_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    float* __restrict__ out, int units, int S, int D, int H, int dh, int C,
                    const std::uint8_t* __restrict__ k1, const std::uint8_t* __restrict__ k2,
                    float keep) {
  extern __shared__ float smem[];
  {  // replica blockIdx.y's rows, lengths, weights and outputs
    const long long r = blockIdx.y, rows = units / H;
    x += r * rows * S * D;
    if constexpr (DROP) k1 += r * rows * S * D, k2 += r * rows * S * D;
    lengths += r * rows;
    out += r * rows * D;
    w1 += r * dh * dh;
    w2 += r * dh * dh;
    b1 += r * dh;
    b2 += r * dh;
  }
  const int unit = blockIdx.x;
  const int b = unit / H;
  const int h = unit - b * H;
  const long long base = static_cast<long long>(b) * S * D + static_cast<long long>(h) * dh;
  const float* xb = x + base;
  const std::uint8_t* kb1 = DROP ? k1 + base : nullptr;
  const std::uint8_t* kb2 = DROP ? k2 + base : nullptr;
  const int len = lengths[b];
  float* X = smem;          // [C][dh] x
  float* A = X + C * dh;    // [C][dh] m2 (x_in before it under dropout)
  float* M1 = A + C * dh;   // [C][dh] m1
  float* mx = M1 + C * dh;  // [dh] each, owned by the thread of the feature
  float* sm = mx + dh;
  float* acc = sm + dh;
  for (int e = threadIdx.x; e < dh; e += blockDim.x) mx[e] = -INFINITY, sm[e] = 0.0f, acc[e] = 0.0f;
  const bool one = S <= C;
  for (int pass = 0; pass < 3; ++pass) {
    for (int t0 = 0; t0 < S; t0 += C) {
      const int nt = min(C, S - t0);
      if (!one || pass == 0) {
        __syncthreads();  // the chunk's arrays are free
        wide_maps<DROP>(xb, t0, nt, D, dh, len, w1, b1, w2, b2, kb1, kb2, keep, X, A, M1);
      }
      if (pass < 2) {
        wide_stats(pass, A, nt, dh, mx, sm);
      } else {
        for (int e = threadIdx.x; e < dh; e += blockDim.x) {
          float a = acc[e];
          const float m = mx[e], s = sm[e];
          for (int t = 0; t < nt; ++t) a = fmaf(expf(A[t * dh + e] - m) / s, X[t * dh + e], a);
          acc[e] = a;
        }
      }
    }
  }
  float* ob = out + static_cast<long long>(b) * D + static_cast<long long>(h) * dh;
  for (int e = threadIdx.x; e < dh; e += blockDim.x) ob[e] = acc[e];
}

__global__ void fwa_empty_kernel() {}

template <int DH, bool ONE, bool DROP>
int launch(const float* x, const int* lengths, const float* w1, const float* b1,
           const float* w2, const float* b2, float* out, int units, int S, int D,
           int H, int dh, int grid, int replicas, int threads, int smem,
           const std::uint8_t* k1, const std::uint8_t* k2, float keep,
           cudaStream_t stream) {
  fwa_fwd_kernel<DH, ONE, DROP><<<dim3(grid, replicas), threads, smem, stream>>>(
      x, lengths, w1, b1, w2, b2, out, units, S, D, H, dh, k1, k2, keep);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool DROP>
int launch_steps(bool one, const float* x, const int* lengths, const float* w1,
                 const float* b1, const float* w2, const float* b2, float* out, int units,
                 int S, int D, int H, int dh, int grid, int replicas, int threads, int smem,
                 const std::uint8_t* k1, const std::uint8_t* k2, float keep,
                 cudaStream_t stream) {
#define FWA_FWD_ARGS \
  x, lengths, w1, b1, w2, b2, out, units, S, D, H, dh, grid, replicas, threads, smem, k1, k2, keep, stream
  return one ? launch<DH, true, DROP>(FWA_FWD_ARGS) : launch<DH, false, DROP>(FWA_FWD_ARGS);
#undef FWA_FWD_ARGS
}

}  // namespace

extern "C" {

// Launches K1 on `stream` with the geometry of ops/cuda/fwa.py::launch_plan
// (grid × replicas blocks of `threads` = 32 · warps threads, one warp a unit
// of a replica's B·H units, `smem` bytes of weights); the tensors hold
// `replicas` replicas one after the other.  Returns cudaGetLastError() (0 =
// launched).  The caller has checked shapes, types, devices, contiguity
// and dh <= 32.  `k1` and `k2` are dropout's keep masks (bytes laid out
// as x) and `keep` = 1 − rate; null masks run the variant without dropout.
int fwa_fwd_launch(const float* x, const int* lengths, const float* w1,
                   const float* b1, const float* w2, const float* b2, float* out,
                   int units, int S, int D, int H, int dh, int grid, int replicas,
                   int threads, int smem, const std::uint8_t* k1,
                   const std::uint8_t* k2, float keep, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = k1 != nullptr;
  const bool exact = dh == 8 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                     (!drop || (reinterpret_cast<std::uintptr_t>(k1) % 8 == 0 &&
                                reinterpret_cast<std::uintptr_t>(k2) % 8 == 0));
  const bool one = S <= kWarp;
#define FWA_FWD_ARGS \
  one, x, lengths, w1, b1, w2, b2, out, units, S, D, H, dh, grid, replicas, threads, smem, \
      k1, k2, keep, s
  if (drop) {
    return exact ? launch_steps<8, true>(FWA_FWD_ARGS) : launch_steps<kMaxDh, true>(FWA_FWD_ARGS);
  }
  return exact ? launch_steps<8, false>(FWA_FWD_ARGS) : launch_steps<kMaxDh, false>(FWA_FWD_ARGS);
#undef FWA_FWD_ARGS
}

// Launches K1's wide variant (heads of more than kMaxDh features) on
// `stream` with the geometry of ops/cuda/fwa.py::launch_plan: grid ×
// replicas blocks of `threads` = kWideThreads threads, one block a unit of a
// replica's B·H units, steps in chunks of `chunk`, `smem` bytes of dynamic
// shared memory.  Otherwise as fwa_fwd_launch.
int fwa_fwd_wide_launch(const float* x, const int* lengths, const float* w1,
                        const float* b1, const float* w2, const float* b2, float* out,
                        int units, int S, int D, int H, int dh, int chunk, int grid,
                        int replicas, int threads, int smem, const std::uint8_t* k1,
                        const std::uint8_t* k2, float keep, void* stream) {
  static int opted[2][kWideMaxDevices];
  if (threads != kWideThreads || dh <= kMaxDh || chunk < 1 || grid != units)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = k1 != nullptr;
  const int err = drop ? opt_in(fwa_fwd_wide_kernel<true>, smem, opted[1])
                       : opt_in(fwa_fwd_wide_kernel<false>, smem, opted[0]);
  if (err != 0) return err;
  if (drop) {
    fwa_fwd_wide_kernel<true><<<dim3(grid, replicas), threads, smem, s>>>(
        x, lengths, w1, b1, w2, b2, out, units, S, D, H, dh, chunk, k1, k2, keep);
  } else {
    fwa_fwd_wide_kernel<false><<<dim3(grid, replicas), threads, smem, s>>>(
        x, lengths, w1, b1, w2, b2, out, units, S, D, H, dh, chunk, k1, k2, keep);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of an empty kernel: the floor of any launch's device time.
int fwa_empty_launch(void* stream) {
  fwa_empty_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* fwa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
