// Device code shared by the feature-wise attention kernels K1 (fwa_fwd.cu)
// and K2 (fwa_bwd.cu), f32 for Hopper (sm_90a).
//
// Both map one warp to one (batch row b, head h) unit and put lane t on
// time step t (steps t, t + 32, ... when S > 32).  A lane holds the dh
// features of its step: x, m1 = relu(x · W1 + b1) and
// m2 = m1 · W2 + b2 with the additive −1e30 mask at t >= len[b].  The
// weights (W1 | W2 | b1 | b2, 2·dh² + 2·dh floats) sit in shared memory,
// loaded once a block; every lane reads the same word, a broadcast.  The
// softmax over time is a max and a sum across lanes, in a fixed order after
// which every lane holds the same, bitwise repeatable, value.
//
// Templates: DH is 8, the head width of every reference configuration
// (with dh = 8 and 16-byte aligned rows: float4 loads and stores, loops
// unrolled into registers, and reductions by halving exchanges), or
// kMaxDh, the generic width, which takes any dh <= 32 with plain loops over
// per-thread arrays (slower, and quick to compile).  ONE says S <= 32, so
// that a lane's only step stays in registers; beyond 32 steps the passes
// re-read x (from L2) and recompute the maps.
//
// Dropout is a compile-time variant (DROP): the keep flags of both dense
// maps' inputs come from device memory as two masks laid out as x ([B, S,
// D] bytes, 1 = keep), and `forward_step_drop` computes x_in = x / keep
// where kept (else 0), m1 = relu(x_in · W1 + b1), m1_in = m1 / keep where
// kept and m2 = m1_in · W2 + b2, as the plain version does.  The weighted
// sum over time reads the unmasked x.  The variant without dropout is the
// code before it, untouched.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace fwa {

constexpr float kVeryNegative = -1e30f;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDh = 32;        // the widest head the kernels take
constexpr int kMaxThreads = 256;  // the launch plans use at most 8 warps a block

// The trip count of loops over a head's features: the constant 8 at DH = 8
// (where dh == 8), so that `#pragma unroll` unrolls them into registers, and
// dh at the generic width, where `#pragma unroll` leaves the loop a loop.
template <int DH>
__device__ inline int features(int dh) { return DH == 8 ? 8 : dh; }

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// W1 | W2 | b1 | b2 of the head maps, from device memory into `s`.
__device__ inline void load_weights(float* s, const float* w1, const float* b1,
                                    const float* w2, const float* b2, int dh) {
  const int n = dh * dh;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s[i] = w1[i];
    s[n + i] = w2[i];
  }
  for (int i = threadIdx.x; i < dh; i += blockDim.x) {
    s[2 * n + i] = b1[i];
    s[2 * n + dh + i] = b2[i];
  }
}

// dh floats at p into v.
template <int DH>
__device__ inline void load_row(const float* __restrict__ p, int dh, float (&v)[DH]) {
  if constexpr (DH == 8) {
#pragma unroll
    for (int j = 0; j < DH; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
    }
  } else {
    for (int j = 0; j < dh; ++j) v[j] = p[j];
  }
}

template <int DH>
__device__ inline void store_row(float* __restrict__ p, int dh, const float (&v)[DH]) {
  if constexpr (DH == 8) {
#pragma unroll
    for (int j = 0; j < DH; j += 4) {
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  } else {
    for (int j = 0; j < dh; ++j) p[j] = v[j];
  }
}

// One step of the forward maps: m1 = relu(x · W1 + b1) and the masked m2
// from x.  `sw` holds W1 | W2 | b1 | b2.  (m1 > 0 exactly where z1 > 0, so
// the backward's ReLU mask needs no z1.)
template <int DH>
__device__ inline void forward_step(const float (&x)[DH], const float* sw, int dh,
                                    bool in_len, float (&m1)[DH], float (&m2)[DH]) {
  const int n = features<DH>(dh);
  const float* w1 = sw;
  const float* w2 = sw + n * n;
  const float* b1 = sw + 2 * n * n;
  const float* b2 = b1 + n;
#pragma unroll
  for (int e = 0; e < n; ++e) {
    float z = b1[e];
#pragma unroll
    for (int k = 0; k < n; ++k) z = fmaf(x[k], w1[k * n + e], z);
    m1[e] = fmaxf(z, 0.0f);
  }
  const float mask = in_len ? 0.0f : kVeryNegative;
#pragma unroll
  for (int e = 0; e < n; ++e) {
    float z = b2[e];
#pragma unroll
    for (int k = 0; k < n; ++k) z = fmaf(m1[k], w2[k * n + e], z);
    m2[e] = z + mask;
  }
}

// The keep masks of dropout at one unit: `k1` (x's) and `k2` (m1's) point
// at the unit's (b, h) entries, step t `D` bytes further; `keep` = 1 − rate.
struct Drop {
  const std::uint8_t* k1;
  const std::uint8_t* k2;
  float keep;
};

// The dh keep flags at p as bits (bit j = feature j kept); at DH = 8 one
// 8-byte load (the rows are 8-byte aligned there).
template <int DH>
__device__ inline unsigned load_keep(const std::uint8_t* __restrict__ p, int dh) {
  if constexpr (DH == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const unsigned lo = (v.x & 1u) | (v.x >> 7 & 2u) | (v.x >> 14 & 4u) | (v.x >> 21 & 8u);
    const unsigned hi = (v.y & 1u) | (v.y >> 7 & 2u) | (v.y >> 14 & 4u) | (v.y >> 21 & 8u);
    return lo | hi << 4;
  } else {
    unsigned bits = 0;
    for (int j = 0; j < dh; ++j) bits |= (p[j] ? 1u : 0u) << j;
    return bits;
  }
}

// forward_step under dropout at step t (the masks' offset `off`): m1 holds
// m1_in, the dropped map1 that map2 reads (m1_in > 0 exactly where z1 > 0
// and the flag keeps it).  Divides by keep, as the plain version does.
template <int DH>
__device__ inline void forward_step_drop(const float (&x)[DH], const float* sw, int dh,
                                         bool in_len, const Drop& drop, long long off,
                                         float (&m1)[DH], float (&m2)[DH]) {
  const int n = features<DH>(dh);
  const float* w1 = sw;
  const float* w2 = sw + n * n;
  const float* b1 = sw + 2 * n * n;
  const float* b2 = b1 + n;
  const unsigned k1 = load_keep<DH>(drop.k1 + off, n);
  const unsigned k2 = load_keep<DH>(drop.k2 + off, n);
  float xin[DH];
#pragma unroll
  for (int k = 0; k < n; ++k) xin[k] = k1 >> k & 1u ? x[k] / drop.keep : 0.0f;
#pragma unroll
  for (int e = 0; e < n; ++e) {
    float z = b1[e];
#pragma unroll
    for (int k = 0; k < n; ++k) z = fmaf(xin[k], w1[k * n + e], z);
    m1[e] = k2 >> e & 1u ? fmaxf(z, 0.0f) / drop.keep : 0.0f;
  }
  const float mask = in_len ? 0.0f : kVeryNegative;
#pragma unroll
  for (int e = 0; e < n; ++e) {
    float z = b2[e];
#pragma unroll
    for (int k = 0; k < n; ++k) z = fmaf(m1[k], w2[k * n + e], z);
    m2[e] = z + mask;
  }
}

// forward_step, or forward_step_drop at step t under DROP.
template <int DH, bool DROP>
__device__ inline void maps(const float (&x)[DH], const float* sw, int dh, bool in_len,
                            const Drop& drop, long long off, float (&m1)[DH],
                            float (&m2)[DH]) {
  if constexpr (DROP) {
    forward_step_drop<DH>(x, sw, dh, in_len, drop, off, m1, m2);
  } else {
    forward_step<DH>(x, sw, dh, in_len, m1, m2);
  }
}

// The feature whose total lane `lane` holds after reduce8, and a lane that
// holds feature j's.
__device__ inline int feature8(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}
__device__ inline int holder8(int j) {
  return ((j >> 2) & 1) << 4 | ((j >> 1) & 1) << 3 | (j & 1) << 2;
}

// v[0..7] reduced across the warp by halving exchanges: at xor distances 16,
// 8 and 4 each lane keeps half of its features and sends the other half to
// its partner, then distances 2 and 1 finish one feature: 9 shuffles, not
// the 40 of eight butterflies.  Lane L ends with the total of feature8(L).
// Both partners of an exchange form op(a, b) of the same two values, so
// every holder of a feature holds the same bits.
template <class Op>
__device__ inline float reduce8(const float (&v)[8], int lane, Op op) {
  float a[4], b[2];
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    a[q] = op(h16 ? v[q + 4] : v[q], __shfl_xor_sync(kFull, h16 ? v[q] : v[q + 4], 16));
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    b[q] = op(h8 ? a[q + 2] : a[q], __shfl_xor_sync(kFull, h8 ? a[q] : a[q + 2], 8));
  }
  float r = op(h4 ? b[1] : b[0], __shfl_xor_sync(kFull, h4 ? b[0] : b[1], 4));
  r = op(r, __shfl_xor_sync(kFull, r, 2));
  return op(r, __shfl_xor_sync(kFull, r, 1));
}

// v reduced across the warp, every lane ending with every feature's total.
template <int DH, class Op>
__device__ inline void warp_allreduce(float (&v)[DH], int dh, int lane, Op op) {
  if constexpr (DH == 8) {
    const float r = reduce8(reinterpret_cast<const float(&)[8]>(v), lane, op);
#pragma unroll
    for (int j = 0; j < DH; ++j) v[j] = __shfl_sync(kFull, r, holder8(j));
  } else {
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      for (int j = 0; j < dh; ++j) v[j] = op(v[j], __shfl_xor_sync(kFull, v[j], off));
    }
  }
}

// The softmax statistics of a unit over all S steps, each lane's steps
// t = lane, lane + 32, ... recomputed from x: the max of m2 and the sum of
// exp(m2 − max), per feature, on every lane.
template <int DH, bool DROP>
__device__ inline void softmax_stats(const float* __restrict__ xb, const float* sw,
                                     int dh, int S, int D, int len, int lane,
                                     const Drop& drop, float (&mx)[DH], float (&sm)[DH]) {
  const int n = features<DH>(dh);
  float x[DH], m1[DH], m2[DH];
#pragma unroll
  for (int j = 0; j < n; ++j) mx[j] = -INFINITY, sm[j] = 0.0f;
  for (int t = lane; t < S; t += kWarp) {
    load_row<DH>(xb + static_cast<long long>(t) * D, dh, x);
    maps<DH, DROP>(x, sw, dh, t < len, drop, static_cast<long long>(t) * D, m1, m2);
#pragma unroll
    for (int j = 0; j < n; ++j) mx[j] = fmaxf(mx[j], m2[j]);
  }
  warp_allreduce<DH>(mx, dh, lane, Max());
  for (int t = lane; t < S; t += kWarp) {
    load_row<DH>(xb + static_cast<long long>(t) * D, dh, x);
    maps<DH, DROP>(x, sw, dh, t < len, drop, static_cast<long long>(t) * D, m1, m2);
#pragma unroll
    for (int j = 0; j < n; ++j) sm[j] += expf(m2[j] - mx[j]);
  }
  warp_allreduce<DH>(sm, dh, lane, Sum());
}

}  // namespace fwa
