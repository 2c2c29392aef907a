// Device code of the wide variants of the feature-wise attention kernels K1
// (fwa_fwd.cu) and K2 (fwa_bwd.cu): heads of more than 32 features, where the
// one-warp-per-(row, head) variants of fwa_common.cuh would hold 3·dh
// floats a lane (x, m1 and m2: 192 at dh = 64) and spill.
//
// What bounds them on the H100.  The head maps share W1 and W2 across every
// head and batch row, so a call's maps are two [B·S·H, dh] × [dh, dh]
// products (K2: six), 2·B·S·D·dh operations each: 0.67 GFLOP at B = 32,
// S = 10, dh = 1024, 10 µs at the card's 67 TFLOP/s f32 peak, against 1.3 MB
// of x.  TF32 is off by contract, so the tensor cores are out: f32 FMA on
// the SMs' cores bounds them, and the design's task is to keep those cores
// busy on every SM with few shared-memory reads an FMA.
//
// Design: tiled products over every step of the batch.  x [B, S, D] is the
// row-major matrix X [B·S·H, dh] (step (b, t, h) is row (b·S + t)·H + h), so
// both maps are products of all B·S·H rows at once, tiled kWideBM rows ×
// kWideBN output features a CTA (160 CTAs at B = 32, S = 10, dh = 1024, 400
// at S = 25), by tile_product.cuh's product, which K3's wide variant
// shares.  A CTA stages kWideBK-deep slices of its rows and of the
// weight columns in shared memory, two buffers deep (the next slice loads
// into registers while the present one is multiplied), and each thread
// keeps a 4 × 4 register tile of outputs: two 16-byte shared-memory reads
// for every 16 FMAs, and every weight staged serves the tile's 32 rows.
// The intermediates ([rows, dh] each: m1_in, m2 and, in K2, dm2 and dz1)
// go to a scratch in device memory between the phases (1.3 MB each at
// B = 32, S = 10, dh = 1024; in L2), so the maps are computed once whatever
// S is.  The softmax over time is per feature: one thread a (row, head,
// feature) takes the max, the sum and Σ_t soft·x (K1) or Σ_t soft·ds and
// dm2 (K2) over its S steps in a fixed order, so it is bitwise
// repeatable; a block's warps split a column's steps and combine their
// partials in warp order, so that the column's chain of exponentials and
// divisions is a few steps long.  K2's weight gradients [dW; db] = Σ_rows [x_in | 1]ᵀ · dz1
// (and m1_in, dm2) are a third kind of tile: a CTA takes a kWideBM × kWideBN
// block of entries and sums the rows of its split in order (the bias is the
// product's row dh, a constant 1 column of the left factor); where a shape
// gives few such tiles (small dh) the rows are split in a fixed way and a
// last launch adds the splits in order.  No float atomics anywhere: two
// calls agree bit for bit, and so do a replica and its single launch.
//
// K1's fused path.  At narrow heads of short rows (dh <= 64, S·H <= 32) the
// three launches' own latency, not the products, would set the time: one
// launch runs them instead, a CTA of kWideRowThreads a batch row, its m1_in
// and m2 in shared memory.
//
// Passes.  The scratch holds the rows of `nb` whole batch rows at a time
// (ops/cuda/fwa.py::launch_plan bounds it); larger batches run the phases
// once a pass, K2's weight-gradient sums going on from where the pass before
// left them.  Each launch's grid has the replicas on its y axis.
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
#include "tile_product.cuh"

namespace fwa {

constexpr int kWideBM = 32;         // a product tile's rows
constexpr int kWideBN = 64;         // a product tile's output features
constexpr int kWideBK = 16;         // the depth the tiled path stages at once
constexpr int kWideThreads = 128;   // a tile's CTA: 8 × 16 threads of 4 × 4 outputs
constexpr int kWideRowThreads = 256;  // the per-feature passes' blocks, K1's fused CTA
// A product tile's geometry (tile_product.cuh): T threads, kWideBM ×
// kWideBN outputs, 16 across its features (4 each) and T / 16 down its rows.
template <int T, int BK>
using Tiling = tile::Tiling<T, BK, kWideBM, kWideBN, kWideBM * 16 / T, 4>;
template <class C>
using Acc = tile::Acc<C>;
using tile::wide_product;
using tile::wide_store;

// One launch's view of a call (ops/cuda/fwa.py::fwa_forward / fwa_backward):
// the tensors of replica 0, the pass's batch rows and the scratch's arrays.
struct WideArgs {
  const float* x;          // [B, S, D]: rows of dh
  const int* lengths;      // [B]
  const float *w1, *b1, *w2, *b2;
  const float* g;          // K2: dL/dout [B, D]
  float* out;              // K1: out [B, D]; K2: dx [B, S, D]
  const std::uint8_t *k1, *k2;  // dropout's keep masks, laid out as x, or null
  float keep;
  float* m1;               // [pass rows][dh] m1_in
  float* a;                // [pass rows][dh] m2 with the mask; K2: then soft
  float* dm2;              // K2: [pass rows][dh]
  float* dz1;              // K2: [pass rows][dh]
  float* part;             // K2: splits × [dW1; db1 | dW2; db2], or null
  float *dw1, *db1, *dw2, *db2;
  int B, S, H, dh;
  int b0, nb;              // the pass: batch rows b0 .. b0 + nb − 1
  int first;               // 1 on the first pass: the weight-gradient sums start at 0
  int splits, split_rows;  // K2: the weight gradients' split of a pass's rows
  long long scratch;       // floats of one replica's scratch
};

// Moves `a` to replica blockIdx.y: its rows, lengths, weights, gradient,
// outputs and scratch.
__device__ inline void to_replica(WideArgs& a, bool backward) {
  const long long r = blockIdx.y;
  const long long D = static_cast<long long>(a.H) * a.dh;
  const long long xs = static_cast<long long>(a.B) * a.S * D;
  const long long ws = static_cast<long long>(a.dh) * a.dh;
  a.x += r * xs;
  if (a.k1 != nullptr) a.k1 += r * xs, a.k2 += r * xs;
  a.lengths += r * a.B;
  a.w1 += r * ws;
  a.w2 += r * ws;
  a.b1 += r * a.dh;
  a.b2 += r * a.dh;
  a.out += r * (backward ? xs : a.B * D);
  a.m1 += r * a.scratch;
  a.a += r * a.scratch;
  if (!backward) return;
  a.g += r * a.B * D;
  a.dm2 += r * a.scratch;
  a.dz1 += r * a.scratch;
  if (a.part != nullptr) a.part += r * a.scratch;
  a.dw1 += r * ws;
  a.dw2 += r * ws;
  a.db1 += r * a.dh;
  a.db2 += r * a.dh;
}

// The pass's rows (nb·S·H) and its first row's index among the call's.
__device__ inline int pass_rows(const WideArgs& a) { return a.nb * a.S * a.H; }
__device__ inline long long pass_row0(const WideArgs& a) {
  return static_cast<long long>(a.b0) * a.S * a.H;
}

// The tiled path's products: 4 × 4 outputs a thread, 16-deep slices.
using Tiled = Tiling<kWideThreads, kWideBK>;

// A pass row's offset in a [rows][dh] array.
struct RowOffset {
  int dh;
  __device__ long long operator()(int m) const { return static_cast<long long>(m) * dh; }
};

// The output tiles of a pass's [rows, dh] product.
__host__ __device__ inline int wide_tiles_n(int dh) { return (dh + kWideBN - 1) / kWideBN; }

// acc[i][j] = bias of the thread's output feature j of the tile at n0 (0
// past dh, or everywhere without a bias).
template <class C>
__device__ inline void wide_init(Acc<C>& acc, const float* __restrict__ bias, int n0, int dh) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + C::col(j);
    const float v = bias != nullptr && n < dh ? bias[n] : 0.0f;
#pragma unroll
    for (int i = 0; i < C::kRows; ++i) acc[i][j] = v;
  }
}

// The first map of the pass's tile `tile`: m1_in = relu(x_in · W1 + b1)
// (⊙ k2 / keep under DROP), x_in = x (⊙ k1 / keep under DROP), into a.m1.
template <class C, bool DROP>
__device__ inline void wide_map1(const WideArgs& a, int tile, float* smem) {
  const int dh = a.dh, rows = pass_rows(a);
  const int m0 = tile / wide_tiles_n(dh) * kWideBM;
  const int n0 = tile % wide_tiles_n(dh) * kWideBN;
  const long long base = pass_row0(a) * dh;
  const float* __restrict__ x = a.x + base;
  const std::uint8_t* k1 = DROP ? a.k1 + base : nullptr;
  const std::uint8_t* k2 = DROP ? a.k2 + base : nullptr;
  const float* __restrict__ w1 = a.w1;
  Acc<C> acc;
  wide_init<C>(acc, a.b1, n0, dh);
  wide_product<C, true, false>(
      dh,
      [&](int m, int k) {
        m += m0;
        if (m >= rows) return 0.0f;
        const long long o = static_cast<long long>(m) * dh + k;
        const float v = x[o];
        if constexpr (DROP) return k1[o] ? v / a.keep : 0.0f;
        return v;
      },
      [&](int k, int n) {
        n += n0;
        return n < dh ? w1[static_cast<long long>(k) * dh + n] : 0.0f;
      },
      smem, acc);
  wide_store<C>(acc, m0, n0, rows, dh, RowOffset{dh}, [&](int, int e, float z, long long row) {
    const long long o = row + e;
    float v = fmaxf(z, 0.0f);
    if constexpr (DROP) v = k2[o] ? v / a.keep : 0.0f;
    a.m1[o] = v;
  });
}

// The second map of the pass's tile `tile`: m2 = m1_in · W2 + b2 with
// −1e30 added at t >= len[b], into a.a.
template <class C>
__device__ inline void wide_map2(const WideArgs& a, int tile, float* smem) {
  const int dh = a.dh, rows = pass_rows(a);
  const int m0 = tile / wide_tiles_n(dh) * kWideBM;
  const int n0 = tile % wide_tiles_n(dh) * kWideBN;
  const float* __restrict__ m1 = a.m1;
  const float* __restrict__ w2 = a.w2;
  Acc<C> acc;
  wide_init<C>(acc, a.b2, n0, dh);
  wide_product<C, true, false>(
      dh,
      [&](int m, int k) {
        m += m0;
        return m < rows ? m1[static_cast<long long>(m) * dh + k] : 0.0f;
      },
      [&](int k, int n) {
        n += n0;
        return n < dh ? w2[static_cast<long long>(k) * dh + n] : 0.0f;
      },
      smem, acc);
  // a row's mask: the pass's row m is step t of batch row b0 + bl
  auto mask = [&](int m) {
    const int bt = m / a.H;  // bl·S + t
    const int bl = bt / a.S;
    return bt - bl * a.S < a.lengths[a.b0 + bl] ? 0.0f : kVeryNegative;
  };
  wide_store<C>(acc, m0, n0, rows, dh, mask, [&](int m, int e, float z, float add) {
    a.a[static_cast<long long>(m) * dh + e] = z + add;
  });
}

// Column `idx` of the pass's nb·H·dh (batch row, head, feature) columns of
// a per-feature pass: false past them.  `A` is then the offset of its step
// 0 in a pass array, `X` in x (steps H·dh floats apart), `O` in [B, D]
// (K1's out, K2's g).
struct Column {
  long long A, X, O;
};
__device__ inline bool wide_column(const WideArgs& a, long long idx, Column& c) {
  const long long units = static_cast<long long>(a.nb) * a.H;
  if (idx >= units * a.dh) return false;
  const int i = static_cast<int>(idx);  // a pass's columns fit an int
  const int e = i % a.dh, u = i / a.dh;  // u = bl·H + h
  const long long bl = u / a.H, h = u - bl * a.H;
  c.A = (bl * a.S * a.H + h) * a.dh + e;
  c.X = pass_row0(a) * a.dh + c.A;
  c.O = (a.b0 + bl) * a.H * a.dh + h * a.dh + e;
  return true;
}

// The per-feature passes: a block takes G columns (G divides blockDim.x;
// thread i column col0 + i % G) and splits each column's steps over its
// W = blockDim.x / G threads, thread group w = i / G the steps t = w,
// w + W, ...; each statistic is a group's partial over its steps in order,
// then the W partials combined in group order through shared memory (`red`,
// blockDim.x floats), so every thread of a column holds the same, bitwise
// repeatable value.  Every thread of the block calls them.

// The W partials of this thread's column combined in group order, by `op`.
template <class Op>
__device__ inline float wide_combine(float v, float* red, int G, Op op) {
  const int c = threadIdx.x % G, W = blockDim.x / G;
  red[threadIdx.x] = v;
  __syncthreads();
  float r = red[c];
  for (int i = 1; i < W; ++i) r = op(r, red[i * G + c]);
  __syncthreads();
  return r;
}

// K1's softmax over time and weighted sum of the columns col0 .. col0 + G − 1:
// out = Σ_t exp(m2 − max) / sum · x.
__device__ inline void wide_softmax_forward(const WideArgs& a, long long col0, int G, float* red) {
  const int w = threadIdx.x / G, W = blockDim.x / G;
  Column c;
  const bool in = wide_column(a, col0 + threadIdx.x % G, c);
  const long long st = static_cast<long long>(a.H) * a.dh;
  const float* A = a.a + c.A;
  const float* X = a.x + c.X;
  const int S = in ? a.S : 0;
  float mx = -INFINITY, sm = 0.0f, acc = 0.0f;
#pragma unroll 4
  for (int t = w; t < S; t += W) mx = fmaxf(mx, A[t * st]);
  mx = wide_combine(mx, red, G, Max());
#pragma unroll 4
  for (int t = w; t < S; t += W) sm += expf(A[t * st] - mx);
  sm = wide_combine(sm, red, G, Sum());
#pragma unroll 4
  for (int t = w; t < S; t += W) acc = fmaf(expf(A[t * st] - mx) / sm, X[t * st], acc);
  acc = wide_combine(acc, red, G, Sum());
  if (in && w == 0) a.out[c.O] = acc;
}

// K2's softmax backward of the columns col0 .. col0 + G − 1: soft (in place of
// m2), Σ_t soft ⊙ ds and dm2 = soft ⊙ (ds − Σ_t soft ⊙ ds), ds = g ⊙ x
// rounded as the reference rounds it (__fmul_rn is never contracted into
// an fma).
__device__ inline void wide_softmax_backward(const WideArgs& a, long long col0, int G, float* red) {
  const int w = threadIdx.x / G, W = blockDim.x / G;
  Column c;
  const bool in = wide_column(a, col0 + threadIdx.x % G, c);
  const long long st = static_cast<long long>(a.H) * a.dh;
  float* A = a.a + c.A;
  float* DM2 = a.dm2 + c.A;
  const float* X = a.x + c.X;
  const float ge = in ? a.g[c.O] : 0.0f;
  const int S = in ? a.S : 0;
  float mx = -INFINITY, sm = 0.0f, sds = 0.0f;
#pragma unroll 4
  for (int t = w; t < S; t += W) mx = fmaxf(mx, A[t * st]);
  mx = wide_combine(mx, red, G, Max());
#pragma unroll 4
  for (int t = w; t < S; t += W) sm += expf(A[t * st] - mx);
  sm = wide_combine(sm, red, G, Sum());
#pragma unroll 4
  for (int t = w; t < S; t += W) {
    const float soft = expf(A[t * st] - mx) / sm;
    A[t * st] = soft;
    sds = fmaf(soft, __fmul_rn(ge, X[t * st]), sds);
  }
  sds = wide_combine(sds, red, G, Sum());
#pragma unroll 4
  for (int t = w; t < S; t += W) DM2[t * st] = A[t * st] * (__fmul_rn(ge, X[t * st]) - sds);
}

// dz1 = (dm2 · W2ᵀ) ⊙ [m1 > 0] of the pass's tile `tile` (m1_in > 0: kept
// and z1 > 0; / keep under DROP), into a.dz1.
template <class C, bool DROP>
__device__ inline void wide_dm1(const WideArgs& a, int tile, float* smem) {
  const int dh = a.dh, rows = pass_rows(a);
  const int m0 = tile / wide_tiles_n(dh) * kWideBM;
  const int n0 = tile % wide_tiles_n(dh) * kWideBN;
  const float* __restrict__ dm2 = a.dm2;
  const float* __restrict__ w2 = a.w2;
  Acc<C> acc;
  wide_init<C>(acc, nullptr, n0, dh);
  wide_product<C, true, true>(
      dh,
      [&](int m, int k) {
        m += m0;
        return m < rows ? dm2[static_cast<long long>(m) * dh + k] : 0.0f;
      },
      [&](int k, int n) {
        n += n0;
        return n < dh ? w2[static_cast<long long>(n) * dh + k] : 0.0f;
      },
      smem, acc);
  wide_store<C>(acc, m0, n0, rows, dh, RowOffset{dh}, [&](int, int d, float v, long long row) {
    const long long o = row + d;
    a.dz1[o] = a.m1[o] > 0.0f ? (DROP ? v / a.keep : v) : 0.0f;
  });
}

// dx = soft ⊙ g + dz1 · W1ᵀ (the product ⊙ k1 / keep under DROP) of the
// pass's tile `tile`.
template <class C, bool DROP>
__device__ inline void wide_dx(const WideArgs& a, int tile, float* smem) {
  const int dh = a.dh, rows = pass_rows(a);
  const int m0 = tile / wide_tiles_n(dh) * kWideBM;
  const int n0 = tile % wide_tiles_n(dh) * kWideBN;
  const long long row0 = pass_row0(a);
  const float* __restrict__ dz1 = a.dz1;
  const float* __restrict__ w1 = a.w1;
  Acc<C> acc;
  wide_init<C>(acc, nullptr, n0, dh);
  wide_product<C, true, true>(
      dh,
      [&](int m, int k) {
        m += m0;
        return m < rows ? dz1[static_cast<long long>(m) * dh + k] : 0.0f;
      },
      [&](int k, int n) {
        n += n0;
        return n < dh ? w1[static_cast<long long>(n) * dh + k] : 0.0f;
      },
      smem, acc);
  // a row's offsets: in the pass's arrays, in x (and dx, the masks) and in g
  // (the pass's row m is head h of a step of batch row b0 + bl)
  struct Offsets {
    long long m, x, g;
  };
  auto offsets = [&](int m) {
    const int bl = m / (a.S * a.H), h = m % a.H;
    return Offsets{static_cast<long long>(m) * dh, (row0 + m) * dh,
                   ((static_cast<long long>(a.b0) + bl) * a.H + h) * dh};
  };
  wide_store<C>(acc, m0, n0, rows, dh, offsets, [&](int, int d, float v, const Offsets& r) {
    if constexpr (DROP) v = a.k1[r.x + d] ? v / a.keep : 0.0f;
    a.out[r.x + d] = fmaf(a.a[r.m + d], a.g[r.g + d], v);
  });
}

// The weight-gradient tile `w` of a pass: of matrix q (0: [dW1; db1] =
// Σ_rows [x_in | 1]ᵀ · dz1; 1: [dW2; db2] = Σ_rows [m1_in | 1]ᵀ · dm2, each
// (dh + 1) × dh with the bias as row dh), of split p (the pass's rows
// p·split_rows .. (p + 1)·split_rows − 1), entries (d0.., e0..).  The sums
// run over the split's rows in order, from 0 on the first pass and from
// the value the pass before left otherwise, into split p's slot of a.part
// or, with one split, into the gradients themselves.
template <class C, bool DROP>
__device__ inline void wide_dw(const WideArgs& a, int w, float* smem) {
  const int dh = a.dh, rows = pass_rows(a);
  const int tiles_e = wide_tiles_n(dh);
  const int per = (dh + 1 + kWideBM - 1) / kWideBM * tiles_e;
  const int q = w / (a.splits * per);
  w -= q * a.splits * per;
  const int p = w / per;
  w -= p * per;
  const int d0 = w / tiles_e * kWideBM, e0 = w % tiles_e * kWideBN;
  const int r0 = p * a.split_rows;
  const int K = max(0, min(rows, r0 + a.split_rows) - r0);
  const long long entries = static_cast<long long>(dh + 1) * dh;
  float* slot = a.part != nullptr ? a.part + (2LL * p + q) * entries : nullptr;
  float* dw = q ? a.dw2 : a.dw1;
  float* db = q ? a.db2 : a.db1;
  auto dest = [&](int d, int e) -> float& {
    if (slot != nullptr) return slot[static_cast<long long>(d) * dh + e];
    return d < dh ? dw[static_cast<long long>(d) * dh + e] : db[e];
  };
  Acc<C> acc;
  {
#pragma unroll
    for (int i = 0; i < C::kRows; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + C::row(i), e = e0 + C::col(j);
        acc[i][j] = !a.first && d <= dh && e < dh ? dest(d, e) : 0.0f;
      }
    }
  }
  const long long base = (pass_row0(a) + r0) * dh;  // the split's first row in x
  const float* __restrict__ left = q ? a.m1 + static_cast<long long>(r0) * dh : a.x + base;
  const std::uint8_t* k1 = DROP && q == 0 ? a.k1 + base : nullptr;
  const float* __restrict__ right = (q ? a.dm2 : a.dz1) + static_cast<long long>(r0) * dh;
  wide_product<C, false, false>(
      K,
      [&](int m, int k) {
        const int d = d0 + m;
        if (d >= dh) return d == dh ? 1.0f : 0.0f;
        const long long o = static_cast<long long>(k) * dh + d;
        const float v = left[o];
        if constexpr (DROP) {
          if (q == 0) return k1[o] ? v / a.keep : 0.0f;
        }
        return v;
      },
      [&](int k, int n) {
        const int e = e0 + n;
        return e < dh ? right[static_cast<long long>(k) * dh + e] : 0.0f;
      },
      smem, acc);
  wide_store<C>(acc, d0, e0, dh + 1, dh, [](int) { return 0; },
             [&](int d, int e, float v, int) { dest(d, e) = v; });
}

// The splits' slots summed in split order into dW1, db1, dW2 and db2, one
// thread an entry.
__device__ inline void wide_sum_splits(const WideArgs& a) {
  const long long entries = static_cast<long long>(a.dh + 1) * a.dh;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 2 * entries) return;
  float acc = a.part[i];
  for (int p = 1; p < a.splits; ++p) acc += a.part[2 * entries * p + i];
  const int q = static_cast<int>(i / entries);
  const long long j = i - q * entries;
  if (j < static_cast<long long>(a.dh) * a.dh) {
    (q ? a.dw2 : a.dw1)[j] = acc;
  } else {
    (q ? a.db2 : a.db1)[j - static_cast<long long>(a.dh) * a.dh] = acc;
  }
}

// K1's fused path: narrow heads (dh <= kWideFuseDh) of short rows (S·H <=
// kWideFuseRows), where the three launches' own latency, not the products,
// would set the time.  A CTA takes one batch row, keeps its m1_in and m2 in
// shared memory after the staging buffers, and runs the three phases on
// them in turn, the same tiles one after the other; its H·dh columns' steps
// split over as many threads as the block holds.  Its shared memory, at
// most 29.7 KB, needs no opt-in.
constexpr int kWideFuseDh = 64;
constexpr int kWideFuseRows = 32;
// its products: 2 × 4 outputs a thread, 16-deep slices
using Fused = Tiling<kWideRowThreads, kWideBK>;

template <bool DROP>
__device__ inline void wide_fused_forward(WideArgs a, float* smem) {
  a.b0 = static_cast<int>(blockIdx.x);
  a.nb = 1;
  a.m1 = smem + Fused::kSmemFloats;
  a.a = a.m1 + a.S * a.H * a.dh;
  const int tiles = (pass_rows(a) + kWideBM - 1) / kWideBM * wide_tiles_n(a.dh);
  for (int t = 0; t < tiles; ++t) wide_map1<Fused, DROP>(a, t, smem);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) wide_map2<Fused>(a, t, smem);
  __syncthreads();
  const int columns = a.H * a.dh;
  int G = kWarp;  // the fewest columns a round, as a power of two, that hold them all
  while (G < columns && G < static_cast<int>(blockDim.x)) G *= 2;
  for (int c = 0; c < columns; c += G) wide_softmax_forward(a, c, G, smem);
}

}  // namespace fwa
