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
// Dropout (train time) is the DROP variant, with K1's two keep masks and
// keep = 1 − rate: the forward is recomputed with them (fwa_common.cuh's
// forward_step_drop), and the chain rule applies them as the plain version
// (ops/feature_attention.py::fwa_backward_reference) does:
//   dm1 = (dm2 · W2ᵀ) ⊙ k2 / keep, dz1 = dm1 ⊙ [z1 > 0]   (m1_in > 0 holds
//                                   exactly where k2 keeps and z1 > 0)
//   dx  = soft ⊙ g + (dz1 · W1ᵀ) ⊙ k1 / keep
//   dW1 from x_in = x ⊙ k1 / keep,  dW2 from m1_in = m1 ⊙ k2 / keep
// ds = g ⊙ x reads the unmasked x.  The staged row holds m1_in in place of
// m1 and, once ds is formed, x_in in place of x.  Null mask pointers select
// the variant without dropout, whose code is that before the masks.
//
// Exactness: expf (not __expf), IEEE division, no fast-math, and the mask is
// the additive −1e30 of the reference.  A row of length 0 has every step
// masked; its softmax is uniform and its gradients are not zero (dm2 flows
// through the mask's addition), as in the JAX package, so nothing is
// skipped.

#include <cuda_runtime.h>

#include <cstdint>

#include "fwa_common.cuh"
#include "fwa_wide.cuh"

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

// backward_step under dropout: as it, with dm1 and the W1ᵀ term of dx
// masked and divided by keep, and x_in staged for dW1 once ds is formed.
template <int DH>
__device__ inline void backward_step_drop(float* row, const float (&soft)[DH],
                                          const float (&gv)[DH], const float (&sds)[DH],
                                          const float* sw, int dh, float* __restrict__ dxp,
                                          const Drop& drop, long long off) {
  const int n = features<DH>(dh);
  const float* w1 = sw;
  const float* w2 = sw + n * n;
  const unsigned k1 = load_keep<DH>(drop.k1 + off, n);
  float dm2[DH], dz1[DH], dxv[DH];
#pragma unroll
  for (int j = 0; j < n; ++j) dm2[j] = soft[j] * (__fmul_rn(gv[j], row[j]) - sds[j]);
#pragma unroll
  for (int d = 0; d < n; ++d) {
    float dm1 = 0.0f;  // (dm2 · W2ᵀ)[d]
#pragma unroll
    for (int e = 0; e < n; ++e) dm1 = fmaf(dm2[e], w2[d * n + e], dm1);
    dz1[d] = row[n + d] > 0.0f ? dm1 / drop.keep : 0.0f;  // m1_in > 0: kept, z1 > 0
  }
#pragma unroll
  for (int d = 0; d < n; ++d) {
    float acc = 0.0f;  // (dz1 · W1ᵀ)[d]
#pragma unroll
    for (int e = 0; e < n; ++e) acc = fmaf(dz1[e], w1[d * n + e], acc);
    dxv[d] = fmaf(soft[d], gv[d], k1 >> d & 1u ? acc / drop.keep : 0.0f);
  }
  store_row<DH>(dxp, n, dxv);
#pragma unroll
  for (int j = 0; j < n; ++j) {
    row[j] = k1 >> j & 1u ? row[j] / drop.keep : 0.0f;  // x_in
    row[2 * n + j] = dz1[j], row[3 * n + j] = dm2[j];
  }
}

// The backward of one valid step, from its staged x and m1, its softmax
// weights and the unit's statistics: writes dx and stages dz1 and dm2
// beside x and m1, so that `row` holds (x, m1, dz1, dm2, 1).  Under DROP,
// m1 is m1_in, the masks are applied (keep flags at `off` from the unit's)
// and x_in replaces x, so that `row` holds (x_in, m1_in, dz1, dm2, 1).
template <int DH, bool DROP>
__device__ inline void backward_step(float* row, const float (&soft)[DH],
                                     const float (&gv)[DH], const float (&sds)[DH],
                                     const float* sw, int dh, float* __restrict__ dxp,
                                     const Drop& drop, long long off) {
  const int n = features<DH>(dh);
  if constexpr (DROP) {
    backward_step_drop<DH>(row, soft, gv, sds, sw, n, dxp, drop, off);
    return;
  }
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

template <int DH, bool ONE, bool DROP>
__global__ void __launch_bounds__(kMaxThreads)
fwa_bwd_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ g, float* __restrict__ dx,
               float* __restrict__ slots, unsigned* __restrict__ tickets,
               float* __restrict__ dw1, float* __restrict__ db1,
               float* __restrict__ dw2, float* __restrict__ db2,
               int units, int S, int D, int H, int dh, int replica_slots,
               int replica_tickets, const std::uint8_t* __restrict__ k1,
               const std::uint8_t* __restrict__ k2, float keep) {
  extern __shared__ float smem[];
  __shared__ bool last;
  const int n = features<DH>(dh);
  {  // replica blockIdx.y's rows, weights, gradients and cross-block tree
    const long long r = blockIdx.y, rows = units / H;
    x += r * rows * S * D;
    g += r * rows * D;
    dx += r * rows * S * D;
    if constexpr (DROP) k1 += r * rows * S * D, k2 += r * rows * S * D;
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
  Drop drop{};
  if constexpr (DROP) drop = Drop{k1 + base, k2 + base, keep};
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
        maps<DH, DROP>(xv, sw, n, lane < len, drop, static_cast<long long>(lane) * D, m1, m2);
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
      if (in) {
        backward_step<DH, DROP>(row, m2, gv, sds, sw, n, dxb + static_cast<long long>(lane) * D,
                                drop, static_cast<long long>(lane) * D);
      }
      __syncwarp();
      sum_staged(stage, stride, min(S, kWarp), n, lane, wpart);
    } else {
      softmax_stats<DH, DROP>(xb, sw, n, S, D, len, lane, drop, mx, sm);
#pragma unroll
      for (int j = 0; j < n; ++j) sds[j] = 0.0f;
      for (int t = lane; t < S; t += kWarp) {
        load_row<DH>(xb + static_cast<long long>(t) * D, n, xv);
        maps<DH, DROP>(xv, sw, n, t < len, drop, static_cast<long long>(t) * D, m1, m2);
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
          maps<DH, DROP>(xv, sw, n, t < len, drop, static_cast<long long>(t) * D, m1, m2);
          stage_forward<DH>(xv, m1, n, row);
#pragma unroll
          for (int j = 0; j < n; ++j) m2[j] = expf(m2[j] - mx[j]) / sm[j];  // soft
          backward_step<DH, DROP>(row, m2, gv, sds, sw, n, dxb + static_cast<long long>(t) * D,
                                  drop, static_cast<long long>(t) * D);
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

// slots summed together at each level of the wide variant's cross-block
// tree: its slots are 2·dh² + 2·dh floats (2.1 MB at dh = 512), so the last
// block of a group reads few of them; ops/cuda/fwa.py::launch_plan sizes
// the scratch with the same number
constexpr int kWideGroup = 4;

// The wide variant (fwa_wide.cuh): heads of more than 32 features.  A block
// of kWideThreads threads takes the units blockIdx.x, blockIdx.x + grid,
// ... in turn (the grid bounded so that the slots stay small); for each it
// takes the softmax statistics in three passes over the steps (max, sum,
// Σ_t soft ⊙ ds), then the backward chunk by chunk: soft, dm2, dz1 =
// (dm2 · W2ᵀ) ⊙ [m1 > 0], dx = soft ⊙ g + dz1 · W1ᵀ (the masks and keep
// under dropout, as backward_step_drop applies them), and adds the chunk's
// weight-gradient sums to the block's slot in device memory: the thread of
// entry i adds Σ_t left · right over the chunk's steps in order, so the
// block's sums run over its units and steps in order.  Then the slots go up
// fwa_bwd_kernel's tree in groups of kWideGroup.  No float atomics: two
// calls agree bit for bit.
template <bool DROP>
__global__ void __launch_bounds__(kWideThreads)
fwa_bwd_wide_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ g, float* __restrict__ dx,
                    float* __restrict__ slots, unsigned* __restrict__ tickets,
                    float* __restrict__ dw1, float* __restrict__ db1,
                    float* __restrict__ dw2, float* __restrict__ db2,
                    int units, int S, int D, int H, int dh, int C, int replica_slots,
                    int replica_tickets, const std::uint8_t* __restrict__ k1,
                    const std::uint8_t* __restrict__ k2, float keep) {
  extern __shared__ float smem[];
  __shared__ bool last;
  {  // replica blockIdx.y's rows, weights, gradients and cross-block tree
    const long long r = blockIdx.y, rows = units / H;
    x += r * rows * S * D;
    g += r * rows * D;
    dx += r * rows * S * D;
    if constexpr (DROP) k1 += r * rows * S * D, k2 += r * rows * S * D;
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
  const int tid = threadIdx.x;
  const int nn = dh * dh;
  const int P = 2 * nn + 2 * dh;
  float* X = smem;           // [C][dh] x, then x_in under dropout
  float* A = X + C * dh;     // [C][dh] m2, then soft
  float* M1 = A + C * dh;    // [C][dh] m1 (m1_in)
  float* DM2 = M1 + C * dh;  // [C][dh] dm2
  float* DZ1 = DM2 + C * dh; // [C][dh] dz1
  float* mx = DZ1 + C * dh;  // [dh] each: the unit's statistics and g
  float* sm = mx + dh;
  float* sds = sm + dh;
  float* gv = sds + dh;
  float* slot = slots + static_cast<long long>(blockIdx.x) * P;
  const bool one = S <= C;

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const bool first_unit = unit == static_cast<int>(blockIdx.x);
    const int b = unit / H;
    const int h = unit - b * H;
    const long long base = static_cast<long long>(b) * S * D + static_cast<long long>(h) * dh;
    const float* xb = x + base;
    float* dxb = dx + base;
    const std::uint8_t* kb1 = DROP ? k1 + base : nullptr;
    const std::uint8_t* kb2 = DROP ? k2 + base : nullptr;
    const int len = lengths[b];
    __syncthreads();  // the previous unit's arrays are used up
    for (int e = tid; e < dh; e += blockDim.x) {
      mx[e] = -INFINITY, sm[e] = 0.0f, sds[e] = 0.0f;
      gv[e] = __ldg(g + static_cast<long long>(b) * D + static_cast<long long>(h) * dh + e);
    }
    for (int pass = 0; pass < 4; ++pass) {
      for (int t0 = 0; t0 < S; t0 += C) {
        const int nt = min(C, S - t0);
        if (!one || pass == 0) {
          __syncthreads();  // the chunk's arrays are free, gv written
          wide_maps<DROP>(xb, t0, nt, D, dh, len, w1, b1, w2, b2, kb1, kb2, keep, X, A, M1);
        }
        if (pass < 2) {
          wide_stats(pass, A, nt, dh, mx, sm);
          continue;
        }
        if (pass == 2) {  // Σ_t soft ⊙ ds, ds = g ⊙ x rounded as the reference does
          for (int e = tid; e < dh; e += blockDim.x) {
            float a = sds[e];
            const float m = mx[e], s = sm[e], ge = gv[e];
            for (int t = 0; t < nt; ++t)
              a = fmaf(expf(A[t * dh + e] - m) / s, __fmul_rn(ge, X[t * dh + e]), a);
            sds[e] = a;
          }
          if (one) __syncthreads();  // sds complete before pass 3 reads it
          continue;
        }
        // (past C the recomputed maps' barriers order sds before this)
        // soft and dm2 = soft ⊙ (ds − Σ_t soft ⊙ ds)
        for (int i = tid; i < nt * dh; i += blockDim.x) {
          const int e = i % dh;
          const float soft = expf(A[i] - mx[e]) / sm[e];
          A[i] = soft;
          DM2[i] = soft * (__fmul_rn(gv[e], X[i]) - sds[e]);
        }
        __syncthreads();
        // dz1 = (dm2 · W2ᵀ) ⊙ [m1 > 0] (m1_in > 0: kept and z1 > 0; / keep)
        chunk_product<true>(DM2, w2, nullptr, dh, nt, [&](int t, int d, float v) {
          DZ1[t * dh + d] = M1[t * dh + d] > 0.0f ? (DROP ? v / keep : v) : 0.0f;
        });
        __syncthreads();
        // dx = soft ⊙ g + dz1 · W1ᵀ (⊙ k1 / keep)
        chunk_product<true>(DZ1, w1, nullptr, dh, nt, [&](int t, int d, float v) {
          const long long off = static_cast<long long>(t0 + t) * D + d;
          if constexpr (DROP) v = kb1[off] ? v / keep : 0.0f;
          dxb[off] = fmaf(A[t * dh + d], gv[d], v);
        });
        if constexpr (DROP) {  // x_in for dW1 (dm2 has read x)
          for (int i = tid; i < nt * dh; i += blockDim.x) {
            const int t = i / dh, j = i - t * dh;
            X[i] = kb1[static_cast<long long>(t0 + t) * D + j] ? X[i] / keep : 0.0f;
          }
        }
        __syncthreads();
        // the chunk's weight-gradient sums into the block's slot: entry i of
        // dW1 | db1 | dW2 | db2 is Σ_t left · right (the biases' left is 1)
        const bool first = first_unit && t0 == 0;
        for (int i = tid; i < P; i += blockDim.x) {
          const float *left = nullptr, *right;
          int j = i, k = 0;
          if (j < nn) {
            k = j / dh, left = X, right = DZ1 + j % dh;
          } else if ((j -= nn) < dh) {
            right = DZ1 + j;
          } else if ((j -= dh) < nn) {
            k = j / dh, left = M1, right = DM2 + j % dh;
          } else {
            right = DM2 + j - nn;
          }
          float acc = first ? 0.0f : slot[i];
          if (left != nullptr) {
            for (int t = 0; t < nt; ++t) acc = fmaf(left[t * dh + k], right[t * dh], acc);
          } else {
            for (int t = 0; t < nt; ++t) acc += right[t * dh];
          }
          slot[i] = acc;
        }
      }
    }
  }

  // up the tree, as fwa_bwd_kernel: the last block of each group of
  // kWideGroup slots sums them, in slot order, into one slot of the next
  // level; each thread its entries, from L2
  int count = gridDim.x, idx = blockIdx.x;
  float* level = slots;
  while (count > 1) {
    const int group = idx / kWideGroup;
    const int first = group * kWideGroup;
    const int members = min(kWideGroup, count - first);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last = atomicAdd(tickets + group, 1u) == static_cast<unsigned>(members - 1);
      if (last) tickets[group] = 0;  // every block of the group has counted
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* src = level + static_cast<long long>(first) * P;
    float* next = level + static_cast<long long>(count) * P;
    for (int i = tid; i < P; i += blockDim.x) {
      float acc = __ldcg(src + i);
      for (int m = 1; m < members; ++m) acc += __ldcg(src + static_cast<long long>(m) * P + i);
      next[static_cast<long long>(group) * P + i] = acc;
    }
    tickets += (count + kWideGroup - 1) / kWideGroup;
    count = (count + kWideGroup - 1) / kWideGroup;
    idx = group;
    level = next;
  }
  // one block is left, with the total in slot 0 of `level`
  __threadfence();
  __syncthreads();
  for (int i = tid; i < P; i += blockDim.x) {
    const float v = __ldcg(level + i);
    int j = i;
    if (j < nn) {
      dw1[j] = v;
    } else if ((j -= nn) < dh) {
      db1[j] = v;
    } else if ((j -= dh) < nn) {
      dw2[j] = v;
    } else {
      db2[j - nn] = v;
    }
  }
}

template <int DH, bool ONE, bool DROP>
int launch(const float* x, const int* lengths, const float* w1, const float* b1,
           const float* w2, const float* b2, const float* g, float* dx, float* slots,
           unsigned* tickets, float* dw1, float* db1, float* dw2, float* db2, int units,
           int S, int D, int H, int dh, int grid, int replicas, int replica_slots,
           int replica_tickets, int threads, int smem, const std::uint8_t* k1,
           const std::uint8_t* k2, float keep, cudaStream_t stream) {
  static int opted = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwa_bwd_kernel<DH, ONE, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  fwa_bwd_kernel<DH, ONE, DROP><<<dim3(grid, replicas), threads, smem, stream>>>(
      x, lengths, w1, b1, w2, b2, g, dx, slots, tickets, dw1, db1, dw2, db2, units, S,
      D, H, dh, replica_slots, replica_tickets, k1, k2, keep);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool DROP>
int launch_steps(bool one, const float* x, const int* lengths, const float* w1,
                 const float* b1, const float* w2, const float* b2, const float* g,
                 float* dx, float* slots, unsigned* tickets, float* dw1, float* db1,
                 float* dw2, float* db2, int units, int S, int D, int H, int dh, int grid,
                 int replicas, int replica_slots, int replica_tickets, int threads,
                 int smem, const std::uint8_t* k1, const std::uint8_t* k2, float keep,
                 cudaStream_t stream) {
#define FWA_BWD_ARGS                                                                     \
  x, lengths, w1, b1, w2, b2, g, dx, slots, tickets, dw1, db1, dw2, db2, units, S, D, H, \
      dh, grid, replicas, replica_slots, replica_tickets, threads, smem, k1, k2, keep, stream
  return one ? launch<DH, true, DROP>(FWA_BWD_ARGS) : launch<DH, false, DROP>(FWA_BWD_ARGS);
#undef FWA_BWD_ARGS
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }
bool aligned8(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 8 == 0; }

}  // namespace

extern "C" {

// Launches K2 on `stream` with the geometry of ops/cuda/fwa.py::launch_plan
// (grid × replicas blocks of `threads` = 32 · warps threads, one warp a unit
// of a replica's B·H units, `smem` bytes of dynamic shared memory); the
// tensors hold `replicas` replicas one after the other; `slots` holds the
// plan's scratch floats and `tickets` its scratch integers, all 0,
// `replica_slots` and `replica_tickets` of them a replica.  Returns
// cudaGetLastError() (0 = launched).  The caller has checked shapes, types,
// devices, contiguity and dh <= 32 (fwa_bwd_wide_launch takes wider heads).
// `k1` and `k2` are K1's dropout keep masks (bytes laid out as x) and
// `keep` = 1 − rate; null masks run the variant without dropout.
int fwa_bwd_launch(const float* x, const int* lengths, const float* w1,
                   const float* b1, const float* w2, const float* b2,
                   const float* g, float* dx, float* slots, unsigned* tickets,
                   float* dw1, float* db1, float* dw2, float* db2, int units, int S,
                   int D, int H, int dh, int grid, int replicas, int replica_slots,
                   int replica_tickets, int threads, int smem, const std::uint8_t* k1,
                   const std::uint8_t* k2, float keep, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = k1 != nullptr;
  const bool exact = dh == 8 && aligned16(x) && aligned16(g) && aligned16(dx) &&
                     (!drop || (aligned8(k1) && aligned8(k2)));
  const bool one = S <= kWarp;
#define FWA_BWD_ARGS                                                                        \
  one, x, lengths, w1, b1, w2, b2, g, dx, slots, tickets, dw1, db1, dw2, db2, units, S, D, \
      H, dh, grid, replicas, replica_slots, replica_tickets, threads, smem, k1, k2, keep, s
  if (drop) {
    return exact ? launch_steps<8, true>(FWA_BWD_ARGS) : launch_steps<kMaxDh, true>(FWA_BWD_ARGS);
  }
  return exact ? launch_steps<8, false>(FWA_BWD_ARGS) : launch_steps<kMaxDh, false>(FWA_BWD_ARGS);
#undef FWA_BWD_ARGS
}

// Launches K2's wide variant (heads of more than kMaxDh features) on
// `stream` with the geometry of ops/cuda/fwa.py::launch_plan: grid ×
// replicas blocks of `threads` = kWideThreads threads, block i taking the
// units i, i + grid, ... of its replica's B·H, steps in chunks of `chunk`,
// `smem` bytes of dynamic shared memory; `slots` and `tickets` the plan's
// scratch (tickets all 0), `replica_slots` and `replica_tickets` of them a
// replica.  Otherwise as fwa_bwd_launch.
int fwa_bwd_wide_launch(const float* x, const int* lengths, const float* w1,
                        const float* b1, const float* w2, const float* b2,
                        const float* g, float* dx, float* slots, unsigned* tickets,
                        float* dw1, float* db1, float* dw2, float* db2, int units, int S,
                        int D, int H, int dh, int chunk, int grid, int replicas,
                        int replica_slots, int replica_tickets, int threads, int smem,
                        const std::uint8_t* k1, const std::uint8_t* k2, float keep,
                        void* stream) {
  static int opted[2][kWideMaxDevices];
  if (threads != kWideThreads || dh <= kMaxDh || chunk < 1 || grid < 1 ||
      grid > units)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = k1 != nullptr;
  const int err = drop ? opt_in(fwa_bwd_wide_kernel<true>, smem, opted[1])
                       : opt_in(fwa_bwd_wide_kernel<false>, smem, opted[0]);
  if (err != 0) return err;
#define FWA_BWD_WIDE_ARGS                                                                    \
  x, lengths, w1, b1, w2, b2, g, dx, slots, tickets, dw1, db1, dw2, db2, units, S, D, H, dh, \
      chunk, replica_slots, replica_tickets, k1, k2, keep
  if (drop) {
    fwa_bwd_wide_kernel<true><<<dim3(grid, replicas), threads, smem, s>>>(FWA_BWD_WIDE_ARGS);
  } else {
    fwa_bwd_wide_kernel<false><<<dim3(grid, replicas), threads, smem, s>>>(FWA_BWD_WIDE_ARGS);
  }
#undef FWA_BWD_WIDE_ARGS
  return static_cast<int>(cudaGetLastError());
}

const char* fwa_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
