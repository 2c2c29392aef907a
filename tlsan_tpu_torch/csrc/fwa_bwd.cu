// Feature-wise attention (FWA) backward, K2, for Hopper (sm_90a), f32.
//
// Replaces: tlsan_tpu/ops/pallas/fwa.py::_fwa_bwd_kernel (launched by
// _fwa_backward) and the _block_diag_extract fold after it.  Given the
// forward's inputs and the incoming gradient g = dL/dout [B, D], it
// recomputes the forward (as fwa_fwd.cu does) and returns
//
//   ds  = g ⊙ x                              (out = Σ_t soft ⊙ x)
//   dm2 = soft ⊙ (ds − Σ_t soft ⊙ ds)        (softmax over time, per feature)
//   dz1 = (dm2 · W2ᵀ) ⊙ [z1 > 0]
//   dx  = soft ⊙ g + dz1 · W1ᵀ
//   dW1 = Σ_{b,t,h} x_hᵀ · dz1_h,  dW2 = Σ_{b,t,h} m1_hᵀ · dm2_h   ([dh, dh])
//   db1 = Σ dz1,  db2 = Σ dm2                                       ([dh])
//
// The plain version of the same algebra is
// ops/feature_attention.py::fwa_backward_reference.
//
// What bounds it on the H100: at the training shapes (B = 32, S = 10 and
// S = 25, D = 64) it reads x and g and writes dx (0.16 MB and 0.41 MB, 0.05
// and 0.12 µs at 3.35 TB/s) and does about 3× the forward's operations
// (1.9 and 4.8 MFLOP, 0.03 and 0.07 µs at 67 TFLOP/s f32): bytes bound it,
// and at these sizes the latency of the launch, of one unit's dependent
// chain and of the cross-block sum of the weight gradients sets its time.
//
// Design (fwa_common.cuh).  One warp per (batch row, head), lane t on step
// t, as in K1, in one launch of blocks of eight warps.  Each lane
// recomputes the forward; the softmax's max and sum and Σ_t soft ⊙ ds are
// reductions across the lanes; then the lane forms dm2, dm1 = dm2 · W2ᵀ,
// dz1 (masked by m1 > 0, which holds exactly where z1 > 0) and dx, and
// writes dx as float4s.  x and m1 go to the warp's shared memory as soon as
// they are computed, since the weight-gradient sums read them there: fewer
// values stay live across the IEEE divisions, whose slow path is a call,
// and the dh = 8 variant spills nothing.  For S > 32, lanes take steps
// t, t + 32, ...: the statistics are passes that re-read x, and the
// backward runs a chunk of 32 steps at a time.
//
// The weight gradients (2·dh² + 2·dh sums over every (b, t, h)) are summed
// in a fixed order, without float atomics, so that two calls agree bit for
// bit:
//   - over the steps of a warp: each lane stages its step's x, m1, dz1, dm2
//     and a constant 1 (the bias column) in its warp's slice of shared
//     memory, a row of 4·dh + 1 floats (the odd stride spreads the rows over
//     the banks), and lane i then sums entries i, i + 32, ... over the steps
//     in step order;
//   - over the warps of a block, in warp order;
//   - over the blocks, in block order, by a tree of groups of kGroup blocks:
//     each block writes its sums to its slot in device memory and takes a
//     ticket (an atomic integer increment, __threadfence before it); the
//     last block of a group copies the group's slots into shared memory
//     with coalesced loads, several in flight a thread, sums them in slot
//     order into one slot of the next level and resets the group's ticket,
//     and so on until one group is left, whose last block writes dW1, db1,
//     dW2 and db2.  The tickets start at 0 and are 0 again when the launch
//     ends.  At the training shapes (B = 32, 32 blocks) the tree is one
//     level; at B = 8192 two.
//
// Replicas.  A replica axis of weights (x, g, dx [R, B, ...], lengths
// [R, B], the weights and their gradients [R, dh, dh] and [R, dh]) is the
// grid's y axis, as in K1: blocks (·, r) run replica r's units, and replica r
// has its own cross-block tree, its own slots and tickets (the scratch holds
// R trees one after the other), with the grouping of one replica's launch,
// so replica r's dx, dW1, db1, dW2 and db2 are bit for bit those of a launch
// on its slice alone.
//
// Exactness: expf (not __expf), IEEE division, no fast-math, and the mask is
// the additive −1e30 of the reference.  A row of length 0 has every step
// masked; its softmax is uniform and its gradients are not zero (dm2 flows
// through the mask's addition), as in the JAX package, so nothing is
// skipped.

#include <cuda_runtime.h>

#include <cstdint>

#include "fwa_common.cuh"

namespace {

using namespace fwa;

// slots summed together at each level of the cross-block tree;
// ops/cuda/fwa.py::launch_plan sizes the scratch with the same number
constexpr int kGroup = 128;

// Stages a valid step's x and m1 into its row of the warp's shared memory,
// where the backward and the weight-gradient sums read them, so that they do
// not stay in registers through the reductions.
template <int DH>
__device__ inline void stage_forward(const float (&xv)[DH], const float (&m1)[DH], int dh,
                                     float* row) {
  const int n = features<DH>(dh);
#pragma unroll
  for (int j = 0; j < n; ++j) row[j] = xv[j], row[n + j] = m1[j];
  row[4 * n] = 1.0f;
}

// The backward of one valid step, from its staged x and m1, its softmax
// weights and the unit's statistics: writes dx and stages dz1 and dm2
// beside x and m1, so that `row` holds (x, m1, dz1, dm2, 1).
template <int DH>
__device__ inline void backward_step(float* row, const float (&soft)[DH],
                                     const float (&gv)[DH], const float (&sds)[DH],
                                     const float* sw, int dh, float* __restrict__ dxp) {
  const int n = features<DH>(dh);
  const float* w1 = sw;
  const float* w2 = sw + n * n;
  float dm2[DH], dz1[DH], dxv[DH];
  // ds = g ⊙ x rounded as the reference rounds it (__fmul_rn is never
  // contracted into an fma), so that ds − Σ_t soft ⊙ ds is exactly 0 where
  // the reference's is, as at S = 1
#pragma unroll
  for (int j = 0; j < n; ++j) dm2[j] = soft[j] * (__fmul_rn(gv[j], row[j]) - sds[j]);
#pragma unroll
  for (int d = 0; d < n; ++d) {
    float dm1 = 0.0f;  // (dm2 · W2ᵀ)[d]
#pragma unroll
    for (int e = 0; e < n; ++e) dm1 = fmaf(dm2[e], w2[d * n + e], dm1);
    dz1[d] = row[n + d] > 0.0f ? dm1 : 0.0f;  // m1 > 0 where z1 > 0
  }
#pragma unroll
  for (int d = 0; d < n; ++d) {
    float acc = 0.0f;  // (dz1 · W1ᵀ)[d]
#pragma unroll
    for (int e = 0; e < n; ++e) acc = fmaf(dz1[e], w1[d * n + e], acc);
    dxv[d] = fmaf(soft[d], gv[d], acc);
  }
  store_row<DH>(dxp, n, dxv);
#pragma unroll
  for (int j = 0; j < n; ++j) row[2 * n + j] = dz1[j], row[3 * n + j] = dm2[j];
}

// Adds to wpart[i], for the entries i = lane, lane + 32, ... of dW1 | db1 |
// dW2 | db2, the sum over the first `steps` staged steps (rows of `stride`).
__device__ inline void sum_staged(const float* stage, int stride, int steps, int dh,
                                  int lane, float* wpart) {
  const int P = 2 * dh * dh + 2 * dh;
  for (int i = lane; i < P; i += kWarp) {
    // entry i is Σ_t stage[t][left] · stage[t][right]; the bias entries take
    // the constant column 4·dh as their left factor
    int j = i, left, right;
    if (j < dh * dh) {
      left = j / dh, right = 2 * dh + j % dh;          // dW1: x, dz1
    } else if ((j -= dh * dh) < dh) {
      left = 4 * dh, right = 2 * dh + j;               // db1: dz1
    } else if ((j -= dh) < dh * dh) {
      left = dh + j / dh, right = 3 * dh + j % dh;     // dW2: m1, dm2
    } else {
      left = 4 * dh, right = 3 * dh + j - dh * dh;     // db2: dm2
    }
    float acc = wpart[i];
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      acc = fmaf(stage[t * stride + left], stage[t * stride + right], acc);
    }
    wpart[i] = acc;
  }
}

// tot[i] = Σ_k src[k·P + i] over k < count, in k order, for every i < P:
// the block copies `cap` rows at a time into `buf` with coalesced float4
// loads from L2 (P is a multiple of 4), each thread keeping kInFlight of
// them in flight, then each thread sums its entries.
constexpr int kInFlight = 8;
__device__ inline void sum_slots(const float* src, int count, int P, float* buf, int cap,
                                 float* tot) {
  for (int k0 = 0; k0 < count; k0 += cap) {
    const int rows = min(cap, count - k0);
    const int total = rows * P / 4;
    const float4* from = reinterpret_cast<const float4*>(src + static_cast<long long>(k0) * P);
    float4* to = reinterpret_cast<float4*>(buf);
    for (int v0 = threadIdx.x; v0 < total; v0 += kInFlight * blockDim.x) {
      float4 r[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int v = v0 + k * blockDim.x;
        if (v < total) r[k] = __ldcg(from + v);
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int v = v0 + k * blockDim.x;
        if (v < total) to[v] = r[k];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
      float acc = k0 == 0 ? 0.0f : tot[i];
#pragma unroll 4
      for (int k = 0; k < rows; ++k) acc += buf[k * P + i];
      tot[i] = acc;
    }
    __syncthreads();
  }
}

template <int DH, bool ONE>
__global__ void __launch_bounds__(kMaxThreads)
fwa_bwd_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ g, float* __restrict__ dx,
               float* __restrict__ slots, unsigned* __restrict__ tickets,
               float* __restrict__ dw1, float* __restrict__ db1,
               float* __restrict__ dw2, float* __restrict__ db2,
               int units, int S, int D, int H, int dh, int replica_slots,
               int replica_tickets) {
  extern __shared__ float smem[];
  __shared__ bool last;
  const int n = features<DH>(dh);
  {  // replica blockIdx.y's rows, weights, gradients and cross-block tree
    const long long r = blockIdx.y, rows = units / H;
    x += r * rows * S * D;
    g += r * rows * D;
    dx += r * rows * S * D;
    lengths += r * rows;
    w1 += r * dh * dh;
    w2 += r * dh * dh;
    dw1 += r * dh * dh;
    dw2 += r * dh * dh;
    b1 += r * dh;
    b2 += r * dh;
    db1 += r * dh;
    db2 += r * dh;
    slots += r * replica_slots;
    tickets += r * replica_tickets;
  }
  const int P = 2 * n * n + 2 * n;
  const int stride = 4 * n + 1;
  const int per_warp = kWarp * stride + P;
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  float* sw = smem;                                // W1 | W2 | b1 | b2
  float* stage = smem + P + warp * per_warp;       // this warp's 32 steps
  float* wpart = stage + kWarp * stride;           // this warp's P sums

  const int unit = blockIdx.x * warps + warp;
  const bool active = unit < units;
  const int b = unit / H;
  const int h = unit - b * H;
  const long long base = static_cast<long long>(b) * S * D + h * n;
  const float* xb = x + base;
  float* dxb = dx + base;
  // the unit's loads go out before the weights' barrier
  int len = 0;
  float gv[DH], xv[DH];
  const bool in = active && lane < S;
  if (active) {
    len = lengths[b];
    load_row<DH>(g + static_cast<long long>(b) * D + h * n, n, gv);
  }
  if (ONE && in) load_row<DH>(xb + static_cast<long long>(lane) * D, n, xv);
  load_weights(sw, w1, b1, w2, b2, n);
  for (int i = lane; i < P; i += kWarp) wpart[i] = 0.0f;
  __syncthreads();

  if (active) {
    float mx[DH], sm[DH], sds[DH], m1[DH], m2[DH];
    if constexpr (ONE) {
      // S <= 32: lane t's step is computed once
      float* row = stage + lane * stride;
      if (in) {
        forward_step<DH>(xv, sw, n, lane < len, m1, m2);
        stage_forward<DH>(xv, m1, n, row);
      } else {
#pragma unroll
        for (int j = 0; j < n; ++j) m2[j] = -INFINITY;
      }
#pragma unroll
      for (int j = 0; j < n; ++j) mx[j] = m2[j];
      warp_allreduce<DH>(mx, n, lane, Max());
#pragma unroll
      for (int j = 0; j < n; ++j) sm[j] = m2[j] = in ? expf(m2[j] - mx[j]) : 0.0f;
      warp_allreduce<DH>(sm, n, lane, Sum());
#pragma unroll
      for (int j = 0; j < n; ++j) {
        m2[j] = m2[j] / sm[j];  // soft
        sds[j] = in ? m2[j] * __fmul_rn(gv[j], row[j]) : 0.0f;
      }
      warp_allreduce<DH>(sds, n, lane, Sum());
      if (in) backward_step<DH>(row, m2, gv, sds, sw, n, dxb + static_cast<long long>(lane) * D);
      __syncwarp();
      sum_staged(stage, stride, min(S, kWarp), n, lane, wpart);
    } else {
      softmax_stats<DH>(xb, sw, n, S, D, len, lane, mx, sm);
#pragma unroll
      for (int j = 0; j < n; ++j) sds[j] = 0.0f;
      for (int t = lane; t < S; t += kWarp) {
        load_row<DH>(xb + static_cast<long long>(t) * D, n, xv);
        forward_step<DH>(xv, sw, n, t < len, m1, m2);
#pragma unroll
        for (int j = 0; j < n; ++j) {
          sds[j] = fmaf(expf(m2[j] - mx[j]) / sm[j], __fmul_rn(gv[j], xv[j]), sds[j]);
        }
      }
      warp_allreduce<DH>(sds, n, lane, Sum());
      for (int t0 = 0; t0 < S; t0 += kWarp) {
        const int t = t0 + lane;
        if (t < S) {
          float* row = stage + lane * stride;
          load_row<DH>(xb + static_cast<long long>(t) * D, n, xv);
          forward_step<DH>(xv, sw, n, t < len, m1, m2);
          stage_forward<DH>(xv, m1, n, row);
#pragma unroll
          for (int j = 0; j < n; ++j) m2[j] = expf(m2[j] - mx[j]) / sm[j];  // soft
          backward_step<DH>(row, m2, gv, sds, sw, n, dxb + static_cast<long long>(t) * D);
        }
        __syncwarp();
        sum_staged(stage, stride, min(S - t0, kWarp), n, lane, wpart);
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // this block's sums, over its warps in warp order, into slot blockIdx.x
  const int busy = min(warps, units - static_cast<int>(blockIdx.x) * warps);
  int count = gridDim.x, idx = blockIdx.x;
  float* level = slots;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    float acc = 0.0f;
    for (int w = 0; w < busy; ++w) acc += smem[P + w * per_warp + kWarp * stride + i];
    level[static_cast<long long>(idx) * P + i] = acc;
  }
  // up the tree: the last block of each group of kGroup slots sums them, in
  // slot order, into one slot of the next level; the staging memory is free
  float* tot = smem + P;
  float* buf = tot + P;
  const int cap = (warps * per_warp - P) / P;
  while (count > 1) {
    const int group = idx / kGroup;
    const int first = group * kGroup;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned members = min(kGroup, count - first);
      last = atomicAdd(tickets + group, 1u) == members - 1;
      if (last) tickets[group] = 0;  // every block of the group has counted
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    sum_slots(level + static_cast<long long>(first) * P, min(kGroup, count - first), P, buf,
              cap, tot);
    float* next = level + static_cast<long long>(count) * P;
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
      next[static_cast<long long>(group) * P + i] = tot[i];
    }
    tickets += (count + kGroup - 1) / kGroup;
    count = (count + kGroup - 1) / kGroup;
    idx = group;
    level = next;
  }
  // one block is left, with the total in slot 0 of `level`
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float v = __ldcg(level + i);
    int j = i;
    if (j < n * n) {
      dw1[j] = v;
    } else if ((j -= n * n) < n) {
      db1[j] = v;
    } else if ((j -= n) < n * n) {
      dw2[j] = v;
    } else {
      db2[j - n * n] = v;
    }
  }
}

template <int DH, bool ONE>
int launch(const float* x, const int* lengths, const float* w1, const float* b1,
           const float* w2, const float* b2, const float* g, float* dx, float* slots,
           unsigned* tickets, float* dw1, float* db1, float* dw2, float* db2, int units,
           int S, int D, int H, int dh, int grid, int replicas, int replica_slots,
           int replica_tickets, int threads, int smem, cudaStream_t stream) {
  static int opted = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwa_bwd_kernel<DH, ONE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  fwa_bwd_kernel<DH, ONE><<<dim3(grid, replicas), threads, smem, stream>>>(
      x, lengths, w1, b1, w2, b2, g, dx, slots, tickets, dw1, db1, dw2, db2, units, S,
      D, H, dh, replica_slots, replica_tickets);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Launches K2 on `stream` with the geometry of ops/cuda/fwa.py::launch_plan
// (grid × replicas blocks of `threads` = 32 · warps threads, one warp a unit
// of a replica's B·H units, `smem` bytes of dynamic shared memory); the
// tensors hold `replicas` replicas one after the other; `slots` holds the
// plan's scratch floats and `tickets` its scratch integers, all 0,
// `replica_slots` and `replica_tickets` of them a replica.  Returns
// cudaGetLastError() (0 = launched).  The caller has checked shapes, types,
// devices, contiguity and dh <= 32.
int fwa_bwd_launch(const float* x, const int* lengths, const float* w1,
                   const float* b1, const float* w2, const float* b2,
                   const float* g, float* dx, float* slots, unsigned* tickets,
                   float* dw1, float* db1, float* dw2, float* db2, int units, int S,
                   int D, int H, int dh, int grid, int replicas, int replica_slots,
                   int replica_tickets, int threads, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool exact = dh == 8 && aligned16(x) && aligned16(g) && aligned16(dx);
  const bool one = S <= kWarp;
#define FWA_BWD_ARGS                                                                     \
  x, lengths, w1, b1, w2, b2, g, dx, slots, tickets, dw1, db1, dw2, db2, units, S, D, H, \
      dh, grid, replicas, replica_slots, replica_tickets, threads, smem, s
  if (exact) return one ? launch<8, true>(FWA_BWD_ARGS) : launch<8, false>(FWA_BWD_ARGS);
  return one ? launch<kMaxDh, true>(FWA_BWD_ARGS) : launch<kMaxDh, false>(FWA_BWD_ARGS);
#undef FWA_BWD_ARGS
}

const char* fwa_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
