// Multi-head attention (ATRank) forward, K3, for Hopper (sm_90a), f32.
//
// Replaces: tlsan_tpu/ops/pallas/mha.py::_mha_kernel (launched by
// _mha_forward).  Semantics are those of
// tlsan_tpu/ops/multihead_attention.py::multihead_attention, for each batch
// row b:
//
//   Q = relu(q·Wq + bq), K = relu(k·Wk + bk), V = relu(k·Wv + bv);
//   per head h (columns h·dh .. h·dh+dh-1 of each projection):
//     scores = Q_h·K_hᵀ / √dh, keys at t >= k_len[b] set to −2³²+1,
//     softmax over all Tk keys, query rows at t >= q_len[b] zeroed,
//     o_h = soft·V_h;
//   out = LayerNorm(concat_h o_h + q) with γ, β and eps 1e-8 (biased
//   variance).
//
// What bounds it on the H100: operations.  One row does (Tq + 2·Tk)·D²
// multiply-adds in the projections and 2·Tq·Tk·D in the attention: at
// B = 128, D = 64, Tq = Tk = 96 that is 0.60 GFLOP (9.0 µs at the 67 TFLOP/s
// f32 peak outside the tensor cores) against 9.4 MB of inputs and output
// (2.8 µs at 3.35 TB/s).  TF32 is off by contract, so the tensor cores are
// not an option.  At the main-path sizes the batch, not the card, is small
// (B = 32 rows of one block each would leave 100 of 132 SMs empty), and a
// CTA's time is a chain of dependent steps, so the design spreads a row
// over several SMs and keeps every step's loads in flight together.
//
// Design.  A thread-block cluster of cs CTAs (1, 2, 4 or 8, chosen by
// ops/cuda/mha.py::launch_plan: the largest whose B clusters the card runs
// in one wave) shares one batch row; CTA r takes the r-th slice of the key
// rows and, for Tq > 1, the r-th slice of the query rows.
//
//   1. Each CTA issues all of its loads from device memory at once into
//      shared memory: its slices of q and k, the biases, γ and β, and the
//      three weights (for D > 64 in chunks of rows).  It then projects its slices: a thread computes a tile of 4
//      rows × 4 columns (K and V together, sharing the x loads), reading x
//      and W as float4s from shared memory.  Every key row is projected once
//      per batch row, and Q is stored already scaled by 1/√dh.
//   2. Tq > 1 (self-attention, or cross-attention with several queries):
//      after a cluster barrier, each CTA gathers every CTA's K and V rows
//      into its own full copy through distributed shared memory (8 loads in
//      flight a thread; the copy overwrites the weights, no longer needed),
//      so the attention reads only local shared memory.  A group
//      of g lanes (a power of two, g·8 >= Tk) takes two query rows of one
//      head; each lane computes the scores of its keys once, keeps them in
//      registers, and takes the max, exp(s − m), the sum and the weighted V
//      from them: one pass over the scores, each K and V row loaded once for
//      both rows.  The group's reductions run level by level for both rows
//      at once, and at dh = 8 its eight sums are folded by halving
//      exchanges (8 shuffles, not 8·log2 g), each of eight lanes dividing
//      and writing one feature.  The output overwrites Q in place, and each
//      CTA takes the LayerNorm of its own query rows, two a warp.
//   3. Tq = 1 (the readout): the cluster splits the keys.  Each CTA scores
//      the query against its keys (kept in shared memory), the cluster
//      takes the global max per head first (each CTA reads every CTA's
//      local max in rank order), then each CTA computes exp(s − m), its
//      partial sum and partial soft·V; CTA 0 adds the partials in rank
//      order, divides and takes the LayerNorm.  With the true max first,
//      every exp argument is the reference's; only the order of the sums
//      differs.  No partial softmax is rescaled.
//
// Replicas.  A replica axis of weights (R parameter sets, each with its own
// rows: queries, keys and out [R·B, T, D], the lengths [R·B], wq, wk, wv
// [R, D, D], the biases, γ and β [R, D]) folds into the batch rows: the
// cluster of row b takes replica b / B's weights (B = `rows`, the rows a
// replica), so R replicas are one launch, as jax.vmap of the pallas_call
// adds a grid axis.  A row's arithmetic is that of one replica's launch;
// replica r's output is bit for bit a launch's on its slice alone wherever
// launch_plan picks the same cluster size for R·B rows as for B.
//
// Dropout (train time) is the DROP variant: a keep mask on the attention
// probabilities after the query mask ([B, H, Tq, Tk] bytes, or R·B rows;
// 1 = keep) and keep = 1 − rate, as the plain version applies it
// (ops/multihead_attention.py::multihead_attention_reference).  The softmax's
// sum takes every key; the weighted sum of V takes the kept ones, and the
// output is divided by keep: o = Σ_kept e·v / Σ e / keep.  A lane reads the
// flag of each of its scores from device memory, B·H·Tq·Tk bytes in all; the
// shared-memory layout does not change.  A null mask selects the variant
// without dropout, whose code is that before the mask.
//
// dh = 8 (the reference's 64 / 8) is specialised with the head's q, scores
// and sums in registers; any other dh <= 32 runs a generic variant with
// plain loops.  D <= 256 and a multiple of 4, Tk <= 256 (a group of 32
// lanes holds 8 scores each); Tq and Tk are otherwise bounded by the
// shared memory of one CTA (232,448 bytes): at D = 64 both reach 256.  The
// wide variant (below) takes every other shape.
//
// Exactness: expf (not __expf), IEEE division and sqrtf, no fast math;
// the scores are q·k with q scaled once by 1/√dh, as the Pallas kernel
// does (the reference divides each score by √dh: the two differ in the
// last bit).  The key mask is the reference's finite −2³²+1 (−4294967296
// in f32), not −inf, and no masked key is skipped in the softmax: a row
// with k_len = 0 gets a softmax uniform over all Tk keys, padding included,
// as in the JAX package.  Query rows at t >= q_len get o = 0, so out =
// LayerNorm(q).  Every sum runs in a fixed order with no float atomics:
// two calls on the same inputs and the same plan agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <type_traits>

#include "tile_product.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kKeyMask = -4294967296.0f;  // -(2^32) + 1 rounded to f32
constexpr float kLnEps = 1e-8f;
constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxDh = 32;
constexpr int kPerLane = 8;       // scores a lane holds: Tk <= 32 · 8
constexpr int kUnitRows = 2;      // query rows of one head a group takes at once
constexpr int kMaxLnPerLane = 8;  // D <= 256 = 32 lanes x 8
constexpr int kRows = 4;          // projection rows a thread's tile has
constexpr int kWChunk = 12288;    // floats of weights staged at once
constexpr int kMaxDevices = 64;
// Q, K and V rows are D + kPad floats apart, so that lanes reading
// different rows as float4 hit different banks
constexpr int kPad = 4;

struct Params {
  const float* queries;
  const float* keys;
  const int* q_len;
  const int* k_len;
  const float* wq;
  const float* bq;
  const float* wk;
  const float* bk;
  const float* wv;
  const float* bv;
  const float* gamma;
  const float* beta;
  float* out;
  const std::uint8_t* keep_mask;  // dropout's keep flags, or null
  int Tq, Tk, D, H, dh, cs, group, rows;
  float inv_scale;
  float keep;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Rows of the weights staged at once: all D for D <= 64, else a multiple
// of 4 such that the three chunks fill kWChunk floats
__host__ __device__ constexpr int weight_chunk(int D) {
  return D < kWChunk / (3 * D) / 4 * 4 ? D : kWChunk / (3 * D) / 4 * 4;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The cluster's barrier, split: arrive (release) after this CTA's last
// write or read of shared memory that a peer needs, wait (acquire) before
// the next step that needs the peers'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// Rows kb .. kb+kc-1 of wq, wk and wv into Wc ([3][kc_max][D]), four
// loads in flight a thread; `wo` is the replica's offset into the weights.
__device__ __forceinline__ void load_weights(const Params& p, float* Wc, int kb,
                                             int kc, int kc_max, long long wo) {
  const int D4 = p.D / 4, per = kc * D4;
#pragma unroll 4
  for (int i = threadIdx.x; i < 3 * per; i += kThreads) {
    const int m = i / per, j = i - m * per;
    const float* w = (m == 0 ? p.wq : m == 1 ? p.wk : p.wv) + wo;
    st4(Wc + m * kc_max * p.D + j * 4, ldg4(w + kb * p.D + j * 4));
  }
}

// One chunk of rows kb .. kb+kc-1 of the weights (w_m, chunk-local, rows D
// apart) into o_m[r·ld + c .. c+3] for the kRows rows from r0 below R, NM
// matrices sharing x: the first chunk starts from 0, the others from o_m;
// the last applies relu(· + b_m) · scale.
template <int NM>
__device__ __forceinline__ void project_tile(
    const float* x, int R, int D, int ld, int r0, int c, int kb, int kc,
    bool first, bool last, float scale, const float* w0, const float* b0,
    float* o0, const float* w1, const float* b1, float* o1) {
  const float* w[2] = {w0, w1};
  const float* bias[2] = {b0, b1};
  float* o[2] = {o0, o1};
  float acc[NM][kRows][4];
  const float* xr[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    xr[i] = x + min(r0 + i, R - 1) * D + kb;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const float4 a = first || r0 + i >= R ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                                            : ld4(o[m] + (r0 + i) * ld + c);
      acc[m][i][0] = a.x, acc[m][i][1] = a.y, acc[m][i][2] = a.z, acc[m][i][3] = a.w;
    }
  }
#pragma unroll 4
  for (int k = 0; k < kc; k += 4) {
    float4 xv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) xv[i] = ld4(xr[i] + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 wv[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m) wv[m] = ld4(w[m] + (k + kk) * D + c);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float x = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          acc[m][i][0] = fmaf(x, wv[m].x, acc[m][i][0]);
          acc[m][i][1] = fmaf(x, wv[m].y, acc[m][i][1]);
          acc[m][i][2] = fmaf(x, wv[m].z, acc[m][i][2]);
          acc[m][i][3] = fmaf(x, wv[m].w, acc[m][i][3]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const float4 bv = ld4(bias[m] + c);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (r0 + i < R) {
        float4 y = make_float4(acc[m][i][0], acc[m][i][1], acc[m][i][2], acc[m][i][3]);
        if (last) {
          y.x = fmaxf(y.x + bv.x, 0.0f) * scale;
          y.y = fmaxf(y.y + bv.y, 0.0f) * scale;
          y.z = fmaxf(y.z + bv.z, 0.0f) * scale;
          y.w = fmaxf(y.w + bv.w, 0.0f) * scale;
        }
        st4(o[m] + (r0 + i) * ld + c, y);
      }
    }
  }
}

// A head's row of K or V: at dh = 8 in two float4 registers, loaded once
// for every query row that uses it; otherwise where it lies.
template <int DH>
struct HeadRow {
  const float* r;
  __device__ __forceinline__ explicit HeadRow(const float* row) : r(row) {}
};

template <>
struct HeadRow<8> {
  float4 a, c;
  __device__ __forceinline__ explicit HeadRow(const float* row)
      : a(ld4(row)), c(ld4(row + 4)) {}
};

// A head's score of q (already scaled by 1/√dh) against key row k.
template <int DH>
__device__ __forceinline__ float dot(const float* q, const HeadRow<DH>& k, int n) {
  float s = 0.0f;
  if constexpr (DH == 8) {
    s = fmaf(q[0], k.a.x, s);
    s = fmaf(q[1], k.a.y, s);
    s = fmaf(q[2], k.a.z, s);
    s = fmaf(q[3], k.a.w, s);
    s = fmaf(q[4], k.c.x, s);
    s = fmaf(q[5], k.c.y, s);
    s = fmaf(q[6], k.c.z, s);
    s = fmaf(q[7], k.c.w, s);
  } else {
    for (int j = 0; j < n; ++j) s = fmaf(q[j], k.r[j], s);
  }
  return s;
}

// acc += e · (value row v)
template <int DH>
__device__ __forceinline__ void axpy(float e, const HeadRow<DH>& v, float* acc, int n) {
  if constexpr (DH == 8) {
    acc[0] = fmaf(e, v.a.x, acc[0]);
    acc[1] = fmaf(e, v.a.y, acc[1]);
    acc[2] = fmaf(e, v.a.z, acc[2]);
    acc[3] = fmaf(e, v.a.w, acc[3]);
    acc[4] = fmaf(e, v.c.x, acc[4]);
    acc[5] = fmaf(e, v.c.y, acc[5]);
    acc[6] = fmaf(e, v.c.z, acc[6]);
    acc[7] = fmaf(e, v.c.w, acc[7]);
  } else {
    for (int j = 0; j < n; ++j) acc[j] = fmaf(e, v.r[j], acc[j]);
  }
}

// The max over the g lanes of a group, for R rows at once: each level's R
// exchanges are independent, so their latencies overlap.
template <int R>
__device__ __forceinline__ void group_max(float (&m)[R], int g) {
  for (int off = g / 2; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], off));
}

// One halving exchange at offset `off`: the lane with the bit set keeps
// the upper half of a[0 .. 2h), its partner the lower, each adding the
// other's copy of the half it keeps.
template <int HALF>
__device__ __forceinline__ void halve(const float* a, float* b, int lane, int off) {
  const bool up = lane & off;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = up ? a[j] : a[j + HALF];
    b[j] = (up ? a[j + HALF] : a[j]) + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// Sums over the g lanes of a group, for R rows at once, level by level:
// sum[r] and acc[r][0 .. n).  Calls put(r, j, total_rj, total_sum_r) for
// the features this lane writes: the first lane of the group, or at dh = 8
// and g >= 8 one lane a feature.  Both partners of an exchange add the same
// two values, so the result does not depend on the lane.
template <int DH, int R, typename Acc, typename Put>
__device__ __forceinline__ void group_finish(float (&sum)[R], Acc& acc, int n, int g,
                                             int lane, Put put) {
  for (int off = g / 2; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
  if constexpr (DH == 8) {
    if (g >= 8) {
      float b[R][4], c[R][2], d[R];
#pragma unroll
      for (int r = 0; r < R; ++r) halve<4>(acc[r], b[r], lane, g / 2);
#pragma unroll
      for (int r = 0; r < R; ++r) halve<2>(b[r], c[r], lane, g / 4);
#pragma unroll
      for (int r = 0; r < R; ++r) halve<1>(c[r], &d[r], lane, g / 8);
      for (int off = g / 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r) d[r] += __shfl_xor_sync(0xffffffffu, d[r], off);
      const int f = (lane & (g / 2) ? 4 : 0) + (lane & (g / 4) ? 2 : 0) + (lane & (g / 8) ? 1 : 0);
      if ((lane & (g / 8 - 1)) == 0)
#pragma unroll
        for (int r = 0; r < R; ++r) put(r, f, d[r], sum[r]);
      return;
    }
  }
  for (int off = g / 2; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
      for (int j = 0; j < n; ++j) acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], off);
  if ((lane & (g - 1)) == 0)
#pragma unroll
    for (int r = 0; r < R; ++r)
      for (int j = 0; j < n; ++j) put(r, j, acc[r][j], sum[r]);
}

// The head's q in registers (dh = 8) or where it lies (generic).
template <int DH>
__device__ __forceinline__ const float* head_q(const float* qrow, float* q) {
  if constexpr (DH == 8) {
    const float4 a = ld4(qrow), c = ld4(qrow + 4);
    q[0] = a.x, q[1] = a.y, q[2] = a.z, q[3] = a.w;
    q[4] = c.x, q[5] = c.y, q[6] = c.z, q[7] = c.w;
    return q;
  } else {
    return qrow;
  }
}

// Tq > 1: every (own query row, head) against the CTA's full copy of K
// and V (rows ld apart); the head outputs overwrite Qs.  Query row t of
// this CTA is row q0 + t of the batch row.  A unit is kUnitRows query rows
// of one head, so that each K and V row a lane loads serves them all, and
// their reductions overlap; a lane holds kPerLane scores of each.  Under
// DROP, `km` holds the batch row's keep flags [H, Tq, Tk].
template <int DH, bool DROP>
__device__ void attend_rows(const Params& p, float* Qs, const float* Ks,
                            const float* Vs, int nq, int q0, int q_live,
                            int k_live, int lane, int warp, const std::uint8_t* km) {
  const int H = p.H, n = DH ? DH : p.dh, g = p.group, Tk = p.Tk;
  const int ld = p.D + kPad;
  const int sub = lane & (g - 1);
  const int per_warp = kWarp / g;
  constexpr int R = kUnitRows, KPL = kPerLane;
  const int units = (nq + R - 1) / R * H;
  for (int base = warp * per_warp; base < units; base += kWarps * per_warp) {
    const int mine = base + lane / g;
    const int u = min(mine, units - 1);
    const int t0 = u / H * R, h = u % H;
    float qreg[R][DH ? DH : 1];
    const float* q[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      q[r] = head_q<DH>(Qs + min(t0 + r, nq - 1) * ld + h * n, qreg[r]);
    float s[R][KPL], m[R];
    // DROP: bit r·KPL + i keeps score s[r][i]; flags read with the scores,
    // so that only these bits stay live through the weighted sum
    unsigned kept = 0;
    int flags[R];
    if constexpr (DROP) {
#pragma unroll
      for (int r = 0; r < R; ++r) flags[r] = (h * p.Tq + q0 + min(t0 + r, nq - 1)) * Tk;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int k = sub + g * i;
      if (k < Tk && k < k_live) {
        const HeadRow<DH> kr(Ks + k * ld + h * n);
#pragma unroll
        for (int r = 0; r < R; ++r) s[r][i] = dot<DH>(q[r], kr, n);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) s[r][i] = k < Tk ? kKeyMask : -INFINITY;
      }
      if constexpr (DROP) {
        if (k < Tk) {
#pragma unroll
          for (int r = 0; r < R; ++r) kept |= (__ldg(km + flags[r] + k) ? 1u : 0u) << (r * KPL + i);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) m[r] = fmaxf(m[r], s[r][i]);
    }
    group_max(m, g);
    float sum[R], acc[R][DH ? DH : kMaxDh];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sum[r] = 0.0f;
      for (int j = 0; j < n; ++j) acc[r][j] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int k = sub + g * i;
      if (k < Tk) {
        const HeadRow<DH> vr(Vs + k * ld + h * n);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float e = expf(s[r][i] - m[r]);
          sum[r] += e;
          if constexpr (DROP) {
            axpy<DH>(kept >> (r * KPL + i) & 1u ? e : 0.0f, vr, acc[r], n);
          } else {
            axpy<DH>(e, vr, acc[r], n);
          }
        }
      }
    }
    group_finish<DH>(sum, acc, n, g, lane, [&](int r, int j, float a, float total) {
      const int t = t0 + r;
      if (mine < units && t < nq) {  // query-mask zeroing at t >= q_len
        if constexpr (DROP) {
          Qs[t * ld + h * n + j] = q0 + t < q_live ? a / total / p.keep : 0.0f;
        } else {
          Qs[t * ld + h * n + j] = q0 + t < q_live ? a / total : 0.0f;
        }
      }
    });
  }
}

// Tq = 1: this CTA's nk keys (local rows of Ks, Vs; key k0 + i) against
// the one query row Qs; `red` holds [H] local maxima, [H] partial sums and
// [D] partial soft·V sums, `sc` [H, nk_max] the scores.  Leaves CTA 0's
// head outputs in Qs.  Under DROP, `km` holds the batch row's keep flags
// [H, 1, Tk].
template <int DH, bool DROP>
__device__ void attend_split(const Params& p, cg::cluster_group& cluster,
                             float* Qs, const float* Ks, const float* Vs,
                             float* red, float* sc, int nk, int nk_max, int k0,
                             int q_live, int k_live, int rank, int lane, int warp,
                             const std::uint8_t* km) {
  const int H = p.H, n = DH ? DH : p.dh, g = p.group, D = p.D;
  const int ld = D + kPad;
  const int sub = lane & (g - 1);
  const int per_warp = kWarp / g;
  for (int base = warp * per_warp; base < H; base += kWarps * per_warp) {
    const int mine = base + lane / g;
    const int h = min(mine, H - 1);
    float qreg[DH ? DH : 1];
    const float* q = head_q<DH>(Qs + h * n, qreg);
    float m[1] = {-INFINITY};
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int k = sub + g * i;
      if (k < nk) {
        const float s =
            k0 + k < k_live ? dot<DH>(q, HeadRow<DH>(Ks + k * ld + h * n), n) : kKeyMask;
        sc[h * nk_max + k] = s;
        m[0] = fmaxf(m[0], s);
      }
    }
    group_max(m, g);
    if (sub == 0 && mine < H) red[h] = m[0];
  }
  cluster_sync();  // every CTA's local maxima

  for (int base = warp * per_warp; base < H; base += kWarps * per_warp) {
    const int mine = base + lane / g;
    const int h = min(mine, H - 1);
    float m = -INFINITY;
    for (int r = 0; r < p.cs; ++r) m = fmaxf(m, cluster.map_shared_rank(red, r)[h]);
    float sum[1] = {0.0f};
    float acc[1][DH ? DH : kMaxDh];
    for (int j = 0; j < n; ++j) acc[0][j] = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int k = sub + g * i;
      if (k < nk) {
        const float e = expf(sc[h * nk_max + k] - m);
        sum[0] += e;
        if constexpr (DROP) {
          axpy<DH>(__ldg(km + static_cast<long long>(h) * p.Tk + k0 + k) ? e : 0.0f,
                   HeadRow<DH>(Vs + k * ld + h * n), acc[0], n);
        } else {
          axpy<DH>(e, HeadRow<DH>(Vs + k * ld + h * n), acc[0], n);
        }
      }
    }
    group_finish<DH>(sum, acc, n, g, lane, [&](int, int j, float a, float total) {
      if (mine >= H) return;
      red[2 * H + h * n + j] = a;
      if (j == 0) red[H + h] = total;
    });
  }
  cluster_sync();  // every CTA's partial sums

  if (rank == 0) {
    for (int c = threadIdx.x; c < D; c += kThreads) {
      const int h = c / n;
      float sum = 0.0f, acc = 0.0f;
      for (int r = 0; r < p.cs; ++r) {
        const float* rr = cluster.map_shared_rank(red, r);
        sum += rr[H + h];
        acc += rr[2 * H + c];
      }
      if constexpr (DROP) {
        Qs[c] = 0 < q_live ? acc / sum / p.keep : 0.0f;
      } else {
        Qs[c] = 0 < q_live ? acc / sum : 0.0f;
      }
    }
  }
  cluster_sync();  // CTA 0 has read the peers' partials; they may exit
}

// dst_r = LayerNorm(o_r + x_r) over D for the rows r < `rows` of o (ld
// apart), x (D apart) and dst (D apart), at most kLnRows, one warp,
// butterfly sums in a fixed order; the rows' chains interleave.  gamma and
// beta lie in shared memory.
constexpr int kLnRows = 2;

__device__ void layer_norm_rows(const float* o, int ld, const float* x,
                                const float* gamma, const float* beta,
                                float* dst, int rows, int D, int lane) {
  float y[kLnRows][kMaxLnPerLane], sum[kLnRows], sq[kLnRows], mean[kLnRows];
#pragma unroll
  for (int r = 0; r < kLnRows; ++r) {
    const int row = min(r, rows - 1);
    sum[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxLnPerLane; ++i) {
      const int c = lane + kWarp * i;
      y[r][i] = c < D ? o[row * ld + c] + x[row * D + c] : 0.0f;
      sum[r] += y[r][i];
    }
  }
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < kLnRows; ++r) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
#pragma unroll
  for (int r = 0; r < kLnRows; ++r) {
    mean[r] = sum[r] / D;
    sq[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxLnPerLane; ++i) {
      y[r][i] = lane + kWarp * i < D ? y[r][i] - mean[r] : 0.0f;
      sq[r] = fmaf(y[r][i], y[r][i], sq[r]);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < kLnRows; ++r) sq[r] += __shfl_xor_sync(0xffffffffu, sq[r], off);
#pragma unroll
  for (int r = 0; r < kLnRows; ++r) {
    const float denom = sqrtf(sq[r] / D + kLnEps);
#pragma unroll
    for (int i = 0; i < kMaxLnPerLane; ++i) {
      const int c = lane + kWarp * i;
      if (r < rows && c < D) dst[r * D + c] = gamma[c] * y[r][i] / denom + beta[c];
    }
  }
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(kThreads, 2) mha_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = p.cs, D = p.D, H = p.H, ld = D + kPad, D4 = D / 4;
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / cs;
  // the replica's offsets into the weights and into the vectors
  const long long wo = static_cast<long long>(b / p.rows) * D * D;
  const int vo = b / p.rows * D;
  // the batch row's dropout keep flags [H, Tq, Tk]
  const std::uint8_t* km = nullptr;
  if constexpr (DROP) km = p.keep_mask + static_cast<long long>(b) * H * p.Tq * p.Tk;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  // this CTA's rows: the r-th slice of the keys and, for Tq > 1, of the
  // queries; for Tq = 1 every CTA projects the one query row
  const bool split = p.Tq == 1;
  const int nq_max = split ? 1 : (p.Tq + cs - 1) / cs;
  const int nk_max = (p.Tk + cs - 1) / cs;
  const int q0 = split ? 0 : rank * p.Tq / cs;
  const int nq = split ? 1 : (rank + 1) * p.Tq / cs - q0;
  const int k0 = rank * p.Tk / cs;
  const int nk = (rank + 1) * p.Tk / cs - k0;
  // self-attention (queries is keys): the query and key slices coincide
  const bool alias = !split && p.queries == p.keys && p.Tq == p.Tk;
  const int kc_max = weight_chunk(D);

  // shared memory (floats), as ops/cuda/mha.py::_smem counts it: bq, bk,
  // bv, γ, β [5, D]; the q slice [nq_max, D] and the k slice [nk_max, D]
  // (none when aliased); Q [nq_max, ld]; this CTA's K and V rows
  // [nk_max, ld] each; then for Tq > 1 the full K and V [Tk, ld] each,
  // whose space holds the staged weights [3, kc_max, D] until the copy,
  // and for Tq = 1 the cluster's exchange (red), the scores (sc) and the
  // weights
  float* par = smem;
  float* qin = par + 5 * D;
  float* kin = alias ? qin : qin + nq_max * D;
  float* Qs = kin + nk_max * D;
  float* Ko = Qs + nq_max * ld;
  float* Vo = Ko + nk_max * ld;
  float* rest = Vo + nk_max * ld;
  float* red = rest;
  float* sc = red + 2 * H + D;
  float* Wc = split ? rest + round4(2 * H + D + H * nk_max) : rest;
  const float* end = split ? Wc + 3 * kc_max * D
                           : rest + max(2 * p.Tk * ld, 3 * kc_max * D);
  if (tid == 0) {
    unsigned have;
    asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(have));
    if (4 * (end - smem) > have) __trap();  // the plan and this layout disagree
  }

  // every load from device memory at once: biases, γ, β, the q and k
  // slices and the first chunk of the weights
  for (int i = tid; i < 5 * D4; i += kThreads) {
    const int m = i / D4, j = i - m * D4;
    const float* src = m == 0 ? p.bq : m == 1 ? p.bk : m == 2 ? p.bv : m == 3 ? p.gamma : p.beta;
    st4(par + i * 4, ldg4(src + vo + j * 4));
  }
  const float* qg = p.queries + (static_cast<long long>(b) * p.Tq + q0) * D;
#pragma unroll 4
  for (int i = tid; i < nq * D4; i += kThreads) st4(qin + i * 4, ldg4(qg + i * 4));
  if (!alias) {
    const float* kg = p.keys + (static_cast<long long>(b) * p.Tk + k0) * D;
#pragma unroll 4
    for (int i = tid; i < nk * D4; i += kThreads) st4(kin + i * 4, ldg4(kg + i * 4));
  }
  load_weights(p, Wc, 0, min(kc_max, D), kc_max, wo);
  const int q_live = p.q_len[b], k_live = p.k_len[b];
  __syncthreads();

  // projections: Q of the own query rows (scaled by 1/√dh), K and V of the
  // own key rows, chunk by chunk of the weights' rows
  const int qjobs = (nq + kRows - 1) / kRows * D4;
  const int kjobs = (nk + kRows - 1) / kRows * D4;
  for (int kb = 0; kb < D; kb += kc_max) {
    const int kc = min(kc_max, D - kb);
    if (kb > 0) {
      __syncthreads();  // the previous chunk is used up
      load_weights(p, Wc, kb, kc, kc_max, wo);
      __syncthreads();
    }
    const bool first = kb == 0, last = kb + kc == D;
    for (int j = tid; j < qjobs + kjobs; j += kThreads) {
      if (j < qjobs) {
        project_tile<1>(qin, nq, D, ld, j / D4 * kRows, j % D4 * 4, kb, kc, first,
                        last, p.inv_scale, Wc, par, Qs, nullptr, nullptr, nullptr);
      } else {
        const int jk = j - qjobs;
        project_tile<2>(kin, nk, D, ld, jk / D4 * kRows, jk % D4 * 4, kb, kc, first,
                        last, 1.0f, Wc + kc_max * D, par + D, Ko,
                        Wc + 2 * kc_max * D, par + 2 * D, Vo);
      }
    }
  }
  const float* gamma = par + 3 * D;
  const float* beta = par + 4 * D;

  if (split) {
    __syncthreads();
    attend_split<DH, DROP>(p, cluster, Qs, Ko, Vo, red, sc, nk, nk_max, k0, q_live,
                           k_live, rank, lane, warp, km);
    if (rank == 0 && warp == 0)
      layer_norm_rows(Qs, ld, qin, gamma, beta, p.out + static_cast<long long>(b) * D, 1, D,
                      lane);
    return;
  }

  cluster_sync();  // every CTA's K and V rows are projected
  // gather every CTA's rows into the full copies (over the weights): a
  // thread keeps one column of float4s and takes every step-th row, 8 loads
  // in flight; key row t lies in the CTA whose slice [r·Tk/cs,
  // (r+1)·Tk/cs) holds it
  float* Kf = rest;
  float* Vf = rest + p.Tk * ld;
  const int step = kThreads / D4;
  if (tid < step * D4) {
    const int c = tid % D4 * 4;
    for (int t0 = tid / D4; t0 < p.Tk; t0 += 4 * step) {
      float4 kv[4], vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u * step;
        if (t < p.Tk) {
          const int r = ((t + 1) * cs - 1) / p.Tk;
          const int off = (t - r * p.Tk / cs) * ld + c;
          kv[u] = ld4(cluster.map_shared_rank(Ko, r) + off);
          vv[u] = ld4(cluster.map_shared_rank(Vo, r) + off);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u * step;
        if (t < p.Tk) {
          st4(Kf + t * ld + c, kv[u]);
          st4(Vf + t * ld + c, vv[u]);
        }
      }
    }
  }
  cluster_arrive();  // done reading the peers; waited for before exiting
  __syncthreads();

  attend_rows<DH, DROP>(p, Qs, Kf, Vf, nq, q0, q_live, k_live, lane, warp, km);
  __syncthreads();
  float* ob = p.out + (static_cast<long long>(b) * p.Tq + q0) * D;
  for (int t = warp * kLnRows; t < nq; t += kWarps * kLnRows)
    layer_norm_rows(Qs + t * ld, ld, qin + t * D, gamma, beta, ob + t * D,
                    min(kLnRows, nq - t), D, lane);
  cluster_wait();
}

// ------------------------------------------------------------ wide variant
//
// The wide variant takes what the variants above refuse: heads of more
// than 32 features, D past 256 or not a multiple of 4, more than 256 keys,
// and rows whose full copies of K and V do not fit one CTA's shared memory
// (at D = 256, (96, 96) self-attention).
//
// What bounds it: the projections' operations.  A row does (Tq + 2·Tk)·D²
// multiply-adds in them against 2·Tq·Tk·D in the attention: at B = 32,
// (96, 96), D = 512 that is 4.8 GFLOP against 0.6, 81 µs at the 67 TFLOP/s
// f32 peak outside the tensor cores (TF32 is off by contract).  So the
// projections are tiled products over every row of the batch, and the
// attention is spread over enough CTAs to fill the card.
//
// Design.  The batch runs in passes of `nb` whole rows (and, where one row
// alone passes the scratch's cap, of some replicas at a time;
// ops/cuda/mha.py::_wide_plan bounds them by WIDE_SCRATCH_FLOATS), three
// launches a pass, the replicas on the grid's y axis, so that no tile mixes
// the rows of two replicas:
//   1. mha_fwd_wide_project_kernel: Q = relu(xq·Wq + bq) · (1/√dh) over
//      [nb·Tq, D] × [D, D], K and V likewise over [nb·Tk, D] (all three from
//      xq where keys is queries); tile_product.cuh's tiled product staged
//      by cp.async, each tile in one matrix's columns, 64 × 128 tiles of
//      8 × 8 outputs a thread where D >= 128 and they give every SM a CTA,
//      else 32 × 64 tiles of 4 × 4 (the template argument BM, 64 or 32);
//      the bias, ReLU and the scale in the epilogue.  Q, K and V go to a
//      per-device scratch ([nb·Tq, D], [nb·Tk, D] twice a replica), read
//      back from L2.
//   2. mha_fwd_wide_attend_kernel: a CTA a (batch row, block of qb <= 32
//      query rows, head).  Its steps, the scores then P·V, each over fc
//      features and kc keys at a time, stage their tiles by cp.async one
//      step ahead into the other of two buffers.  The scores are a small
//      tiled product (a thread 2 queries × 4 keys, 16-byte reads of rows
//      fc + 4 floats apart: conflict-free), kept in shared memory for all Tk
//      keys; a warp two query rows then takes the true max, exp and the sum
//      in a fixed order (lane l the keys l, l + 32, ..., then a butterfly)
//      and writes the probabilities over the scores (0 where dropped); P·V
//      is a second small product (a task 4 query rows × 4 features, its
//      copies splitting the keys, their partial sums added in copy order),
//      divided by the sum and written over the head's columns of Q in the
//      scratch, 0 at t >= q_len.  A head's steps are a chain of dependent
//      phases, so the heads run on CTAs of their own, side by side, rather
//      than one after the other in one CTA (on the card the latter left
//      the SMs waiting on each phase's latency).
//   3. mha_fwd_wide_norm_kernel: LayerNorm(o + q) of every row, a warp a row.
// Every output's sums run in a fixed order that depends on the shape alone
// (a score over the head's features in order, the softmax's sum by the
// butterfly, P·V's copies by fc, kc and Tk, LayerNorm by the butterfly), so
// two calls agree bit for bit, and so do a replica and its single launch:
// no tile, block or pass changes a row's arithmetic.  Exactness as above:
// expf, IEEE division and sqrtf, Q scaled by 1/√dh once, the finite key
// mask on every key past k_len (never skipped: k_len = 0 gives a uniform
// softmax), query rows at t >= q_len zeroed before the residual.

using ProjBig = tile::Tiling<128, 16, 64, 128, 8, 8>;
using ProjSmall = tile::Tiling<128, 16, 32, 64, 4, 4>;
constexpr int kProjThreads = 128;
constexpr int kProjCtas = 3;  // CTAs an SM holds by registers: at most 168 a thread
constexpr int kAttThreads = 256;
constexpr int kAttCtas = 2;  // CTAs an SM holds by registers: at most 128 a thread
constexpr int kAttWarps = kAttThreads / kWarp;
constexpr int kMaxQb = 32;   // query rows an attention CTA
constexpr int kMaxFc = 64;   // features staged at once (a power of two)
constexpr int kMaxKc = 128;  // keys staged at once (a multiple of 32)
constexpr int kMaxGridY = 65535;

struct WideParams {
  const float* queries;
  const float* keys;
  const int* q_len;
  const int* k_len;
  const float* wq;
  const float* bq;
  const float* wk;
  const float* bk;
  const float* wv;
  const float* bv;
  const float* gamma;
  const float* beta;
  float* out;
  const std::uint8_t* keep_mask;  // dropout's keep flags, or null
  float* work;                    // the scratch: Q, K, V of a pass, a replica after another
  long long scratch;              // floats of a replica's scratch
  int Tq, Tk, D, H, dh;
  int rows;                       // batch rows a replica
  int rep0, b0, nb;               // the pass: replicas rep0 + y, their rows b0 .. b0 + nb − 1
  int qb, kc, fc;                 // query rows a CTA, keys and features staged at once
  float inv_scale;
  float keep;
};

__host__ __device__ constexpr int cdiv(long long n, int d) {
  return static_cast<int>((n + d - 1) / d);
}

// The projections of a pass of nb rows in tiles of bm × bn, each tile in
// one matrix's columns: the first product (xq rows × Q's columns, or Q's,
// K's and V's where keys is queries) and the second (xk rows × K's and V's,
// none for self-attention), a matrix's columns cdiv(D, bn) tiles.
struct ProjGeometry {
  int rq, mq, tq;  // the first product's rows, matrices and tiles
  int rk, tk;      // the second's rows and tiles (two matrices)
};

__host__ __device__ inline ProjGeometry proj_geometry(int nb, int Tq, int Tk, int D, bool self,
                                                      int bm, int bn) {
  ProjGeometry g;
  g.rq = nb * Tq;
  g.mq = self ? 3 : 1;
  g.tq = cdiv(g.rq, bm) * g.mq * cdiv(D, bn);
  g.rk = self ? 0 : nb * Tk;
  g.tk = self ? 0 : cdiv(g.rk, bm) * 2 * cdiv(D, bn);
  return g;
}

__host__ __device__ inline bool self_attention(const WideParams& p) {
  return p.queries == p.keys && p.Tq == p.Tk;
}

template <int BM>
__global__ void __launch_bounds__(kProjThreads, kProjCtas) mha_fwd_wide_project_kernel(
    const __grid_constant__ WideParams p) {
  using C = typename std::conditional<BM == ProjBig::kBM, ProjBig, ProjSmall>::type;
  __shared__ __align__(16) float smem[C::kAsyncSmemFloats];
  const int D = p.D, rep = p.rep0 + static_cast<int>(blockIdx.y);
  const ProjGeometry g = proj_geometry(p.nb, p.Tq, p.Tk, D, self_attention(p), C::kBM, C::kBN);
  int tile = blockIdx.x;
  const bool first = tile < g.tq;
  if (!first) tile -= g.tq;
  const long long row0 = static_cast<long long>(rep) * p.rows + p.b0;  // the pass's first row
  const float* __restrict__ x =
      first ? p.queries + row0 * p.Tq * D : p.keys + row0 * p.Tk * D;
  const int R = first ? g.rq : g.rk;
  // the tile: rows m0 .., columns c0 .. of matrix mat (0 Q, 1 K, 2 V)
  const int tn = cdiv(D, C::kBN), mats = first ? g.mq : 2;
  const int m0 = tile / (mats * tn) * C::kBM;
  const int mat = tile / tn % mats + (first ? 0 : 1), c0 = tile % tn * C::kBN;
  const float* w = (mat == 0 ? p.wq : mat == 1 ? p.wk : p.wv) + static_cast<long long>(rep) * D * D;
  tile::Acc<C> acc;
#pragma unroll
  for (int i = 0; i < C::kRows; ++i)
#pragma unroll
    for (int j = 0; j < C::kCols; ++j) acc[i][j] = 0.0f;
  tile::wide_product_async<C>(D, x + static_cast<long long>(m0) * D, D, R - m0, w + c0, D,
                              D - c0, smem, acc);
  // the epilogue: relu(· + b) (· 1/√dh for Q) into the scratch
  float* dst = p.work + static_cast<long long>(blockIdx.y) * p.scratch +
               (mat == 0 ? 0 : static_cast<long long>(p.nb) * (p.Tq + (mat - 1) * p.Tk) * D);
  const float* bias = (mat == 0 ? p.bq : mat == 1 ? p.bk : p.bv) + rep * D;
  const float scale = mat == 0 ? p.inv_scale : 1.0f;
#pragma unroll
  for (int i = 0; i < C::kRows; ++i) {
    const int m = m0 + C::row(i);
    if (m >= R) continue;
    float* row = dst + static_cast<long long>(m) * D;
#pragma unroll
    for (int h = 0; h < C::kCols / 4; ++h) {
      const int c = c0 + C::col(4 * h);
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = c + j < D ? fmaxf(acc[i][4 * h + j] + bias[c + j], 0.0f) * scale : 0.0f;
      if (D % 4 == 0) {  // the four columns on 16 bytes, all inside or all past D
        if (c < D) st4(row + c, make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < D) row[c + j] = v[j];
      }
    }
  }
}

// A thread's share of staging a tile by cp.async: rows 0 .. n − 1 of src
// (rows D apart), its columns 0 .. nf − 1 (0 past them, up to fc, a power
// of two of at most kMaxFc), into dst's rows (ld apart): the thread's
// column of four floats (threadIdx.x % (fc / 4)) of the rows threadIdx.x /
// (fc / 4) + i · kAttThreads / (fc / 4).  VEC: src's rows and columns lie
// on 16 bytes.
template <bool VEC>
__device__ __forceinline__ void tile_stage(float* dst, const float* src, int n, int nf, int fc,
                                           int D, int ld) {
  const int fq = fc / 4, f = threadIdx.x % fq * 4;
  for (int r = threadIdx.x / fq; r < n; r += kAttThreads / fq) {
    const float* s = src + static_cast<long long>(r) * D + f;
    float* d = dst + r * ld + f;
    if constexpr (VEC) {
      tile::cp_async(d, f < nf ? s : nullptr, 16, src);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) tile::cp_async(d + j, f + j < nf ? s + j : nullptr, 4, src);
    }
  }
}

// One step of a CTA's walk over its head: the scores (kind 0) or P·V
// (kind 1) over the head's features f0 .. f0 + fc − 1 and the keys k0 ..
// k0 + kc − 1, the scores before P·V, within a kind the features' chunks in
// order and, in each, the keys'.
struct Step {
  int kind, f0, k0;
};

__device__ __forceinline__ bool next_step(Step& s, int dh, int Tk, int fc, int kc) {
  s.k0 += kc;
  if (s.k0 < Tk) return true;
  s.k0 = 0;
  s.f0 += fc;
  if (s.f0 < dh) return true;
  s.f0 = 0;
  return ++s.kind < 2;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A thread's scores: queries qh + ty + 4·i (i < kScoreQ) against the keys
// kb + tx + 8·j (j < kScoreK), lane = 8·ty + tx, a warp a block of 8
// queries (from qh) × 32 keys (from kb): a key's 16-byte read serves 2
// queries and a query's 4 keys, the 8 keys of a read on 8 rows (fc + 4
// floats apart: 8 banks), the 4 queries likewise.
constexpr int kScoreQ = 2, kScoreK = 4, kScoreRows = 8, kScoreKeys = 32;
// P·V: a task is 4 query rows × 4 features, kMaxQb / 4 groups of rows ×
// fc / 4 columns of features whatever the block's rows; the CTA's threads
// split each chunk's keys between the kAttThreads / tasks copies of a task,
// whose partial sums are added in copy order: the sums' order depends on
// fc, kc and Tk alone, not on the block, the pass or the replicas.
constexpr int kPvTasks = kMaxQb / 4 * (kMaxFc / 4);

// The attention of one head for a block of query rows: o over the head's
// columns of the block's Q in the scratch.
template <bool DROP, bool VEC>
__device__ __forceinline__ void attend(const WideParams& p, float* smem) {
  const int D = p.D, H = p.H, dh = p.dh, Tq = p.Tq, Tk = p.Tk;
  const int qb = p.qb, kc = p.kc, fc = p.fc;
  const int blocks = cdiv(Tq, qb), h = blockIdx.x % H, rb = blockIdx.x / H;
  const int bl = rb / blocks, t0 = rb % blocks * qb, nq = min(qb, Tq - t0);
  const int rep = p.rep0 + static_cast<int>(blockIdx.y);
  const long long b = static_cast<long long>(rep) * p.rows + p.b0 + bl;  // among all R·B
  float* base = p.work + static_cast<long long>(blockIdx.y) * p.scratch;
  // the block's rows of Q (then o), the row's K and V, at the head's columns
  float* Qw = base + (static_cast<long long>(bl) * Tq + t0) * D + h * dh;
  const float* Kw = base + static_cast<long long>(p.nb) * Tq * D +
                    static_cast<long long>(bl) * Tk * D + h * dh;
  const float* Vw = Kw + static_cast<long long>(p.nb) * Tk * D;
  const int q_live = p.q_len[b], k_live = p.k_len[b];
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  // shared memory (ops/cuda/mha.py::_wide_smem): two buffers of the
  // block's Q columns [qb][fc + 4] and two of a tile of K or V [kc][fc + 4]
  // (one staged while the other is read), the scores, then the
  // probabilities [qb][ldp], the rows' sums [qb], P·V's partial sums
  // [kAttThreads][16]
  const int ldf = fc + 4, ldp = round4(Tk) + 4;
  float* Qbuf = smem;
  float* KVbuf = Qbuf + 2 * qb * ldf;
  float* S = KVbuf + 2 * kc * ldf;
  float* sums = S + qb * ldp;
  float* part = sums + round4(qb);
  if (tid == 0) {
    unsigned have;
    asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(have));
    if (4 * (part + kAttThreads * 16 - smem) > have) __trap();  // the plan and this layout disagree
  }
  // the step's tiles, staged one step ahead into the other buffers: at a
  // scores step Q's columns (at its first keys) and K's tile, at a P·V step
  // V's tile
  int qbuf = 0, kvbuf = 0;
  auto stage = [&](const Step& s) {
    const int nf = min(fc, dh - s.f0);
    if (s.kind == 0 && s.k0 == 0) {
      qbuf ^= 1;
      tile_stage<VEC>(Qbuf + qbuf * qb * ldf, Qw + s.f0, nq, nf, fc, D, ldf);
    }
    kvbuf ^= 1;
    tile_stage<VEC>(KVbuf + kvbuf * kc * ldf,
                    (s.kind == 0 ? Kw : Vw) + static_cast<long long>(s.k0) * D + s.f0,
                    min(kc, Tk - s.k0), nf, fc, D, ldf);
    tile::cp_async_commit();
  };
  // P·V: task `task` (query rows 4·pg .. 4·pg + 3, features pc .. pc + 3)
  // of `tasks`, its copy `copy` of `copies` taking the chunk's keys from
  // copy·nk / copies on; thread tid sums outputs tid, tid + kAttThreads, ..
  // of the tasks' 16 each over the copies, across the chunks in `total`
  const int fq = fc / 4, tasks = kMaxQb / 4 * fq, copies = kAttThreads / tasks;
  const int task = tid % tasks, copy = tid / tasks;
  const int pg = task / fq, pc = (task - pg * fq) * 4;
  float total[kPvTasks * 16 / kAttThreads];
  // the scores' warp blocks
  const int tx = lane % 8, ty = lane / 8;
  const int qblocks = cdiv(nq, kScoreRows);
  Step s{0, 0, 0};
  stage(s);
  for (;;) {
    tile::cp_async_wait<0>();  // this step's tiles
    __syncthreads();           // for every thread; the buffers of the step before are free
    const float* Qs = Qbuf + qbuf * qb * ldf;
    const float* KVs = KVbuf + kvbuf * kc * ldf;
    Step t = s;
    const bool more = next_step(t, dh, Tk, fc, kc);
    if (more) stage(t);
    const int nf = min(fc, dh - s.f0), nk = min(kc, Tk - s.k0);
    if (s.kind == 0) {
      // the scores of the block against keys k0 .. k0 + nk − 1 over the
      // features f0 .. f0 + nf − 1, from the sums of the features before
      for (int wb = warp; wb < qblocks * cdiv(nk, kScoreKeys); wb += kAttWarps) {
        const int qh = wb % qblocks * kScoreRows, kb = wb / qblocks * kScoreKeys;
        float acc[kScoreQ][kScoreK];
        const float* qr[kScoreQ];
        const float* kr[kScoreK];
#pragma unroll
        for (int i = 0; i < kScoreQ; ++i) {
          const int q = qh + ty + 4 * i;
          qr[i] = Qs + min(q, qb - 1) * ldf;
#pragma unroll
          for (int j = 0; j < kScoreK; ++j) {
            const int k = s.k0 + kb + tx + 8 * j;
            acc[i][j] = s.f0 > 0 && q < nq && k < Tk ? S[q * ldp + k] : 0.0f;
          }
        }
#pragma unroll
        for (int j = 0; j < kScoreK; ++j) kr[j] = KVs + (kb + tx + 8 * j) * ldf;
        for (int f = 0; f < nf; f += 4) {
          float4 kv[kScoreK];
#pragma unroll
          for (int j = 0; j < kScoreK; ++j) kv[j] = ld4(kr[j] + f);
#pragma unroll
          for (int i = 0; i < kScoreQ; ++i) {
            const float4 qv = ld4(qr[i] + f);
#pragma unroll
            for (int j = 0; j < kScoreK; ++j) {
              acc[i][j] = fmaf(qv.x, kv[j].x, acc[i][j]);
              acc[i][j] = fmaf(qv.y, kv[j].y, acc[i][j]);
              acc[i][j] = fmaf(qv.z, kv[j].z, acc[i][j]);
              acc[i][j] = fmaf(qv.w, kv[j].w, acc[i][j]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kScoreQ; ++i) {
#pragma unroll
          for (int j = 0; j < kScoreK; ++j) {
            const int q = qh + ty + 4 * i, k = s.k0 + kb + tx + 8 * j;
            if (q < nq && k < Tk) S[q * ldp + k] = acc[i][j];
          }
        }
      }
      if (s.f0 + fc >= dh && s.k0 + kc >= Tk) {
        // the last scores: the softmax of each query row, a warp two rows
        // at once, the true max first, then exp and the sum, the
        // probabilities over the scores
        __syncthreads();
        for (int r0 = warp; r0 < nq; r0 += 2 * kAttWarps) {
          const bool two = r0 + kAttWarps < nq;
          const int r1 = two ? r0 + kAttWarps : r0;  // past the rows r0 again, not written
          float* sr[2] = {S + r0 * ldp, S + r1 * ldp};
          float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
          for (int k = lane; k < Tk; k += kWarp) {
#pragma unroll
            for (int u = 0; u < 2; ++u) m[u] = fmaxf(m[u], k < k_live ? sr[u][k] : kKeyMask);
          }
          for (int off = kWarp / 2; off > 0; off >>= 1) {
#pragma unroll
            for (int u = 0; u < 2; ++u) m[u] = fmaxf(m[u], __shfl_xor_sync(0xffffffffu, m[u], off));
          }
          const std::uint8_t* km[2] = {nullptr, nullptr};
          if constexpr (DROP) {
            km[0] = p.keep_mask + ((b * H + h) * Tq + t0 + r0) * Tk;
            km[1] = p.keep_mask + ((b * H + h) * Tq + t0 + r1) * Tk;
          }
          // a lane reads and writes its own keys alone
          for (int k = lane; k < Tk; k += kWarp) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float e = expf((k < k_live ? sr[u][k] : kKeyMask) - m[u]);
              sum[u] += e;
              float w = e;
              if constexpr (DROP) w = __ldg(km[u] + k) ? e : 0.0f;
              if (u == 0 || two) sr[u][k] = w;
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) sum[u] = warp_sum(sum[u]);
          if (lane == 0) {
            sums[r0] = sum[0];
            if (two) sums[r1] = sum[1];
          }
        }
      }
    } else {
      // P·V of this chunk's keys: each copy its share, in key order
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.0f;
      if (4 * pg < nq) {
        const float* prow[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) prow[i] = S + min(4 * pg + i, qb - 1) * ldp + s.k0;
        const int ke = (copy + 1) * nk / copies;
        for (int k = copy * nk / copies; k < ke; ++k) {
          const float4 v = ld4(KVs + k * ldf + pc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pk = prow[i][k];
            a[i][0] = fmaf(pk, v.x, a[i][0]);
            a[i][1] = fmaf(pk, v.y, a[i][1]);
            a[i][2] = fmaf(pk, v.z, a[i][2]);
            a[i][3] = fmaf(pk, v.w, a[i][3]);
          }
        }
        float* mine = part + (copy * tasks + task) * 16;
#pragma unroll
        for (int i = 0; i < 4; ++i) st4(mine + 4 * i, make_float4(a[i][0], a[i][1], a[i][2], a[i][3]));
      }
      __syncthreads();
      // the copies' partials added in copy order, then across the chunks
#pragma unroll
      for (int u = 0; u < kPvTasks * 16 / kAttThreads; ++u) {
        const int o = tid + u * kAttThreads;  // output o % 16 of task o / 16
        if (o >= tasks * 16 || o / 16 / fq * 4 >= nq) break;
        float v = part[o];
        for (int c = 1; c < copies; ++c) v += part[c * tasks * 16 + o];
        total[u] = s.k0 == 0 ? v : total[u] + v;
        if (s.k0 + kc >= Tk) {  // the features' last keys: o over Q
          const int ot = o / 16, i = o % 16 / 4, j = o % 4;
          const int r = ot / fq * 4 + i, f = (ot % fq) * 4 + j;
          if (r < nq && f < nf) {
            float out = 0.0f;
            if (t0 + r < q_live) out = DROP ? total[u] / sums[r] / p.keep : total[u] / sums[r];
            Qw[static_cast<long long>(r) * D + s.f0 + f] = out;
          }
        }
      }
    }
    if (!more) break;
    s = t;
  }
}

template <bool DROP>
__global__ void __launch_bounds__(kAttThreads, kAttCtas) mha_fwd_wide_attend_kernel(
    const __grid_constant__ WideParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if (p.D % 4 == 0 && p.dh % 4 == 0) {
    attend<DROP, true>(p, smem);
  } else {
    attend<DROP, false>(p, smem);
  }
}

// LayerNorm(o + x) of every query row of the pass, a warp a row, the sums in
// lane order (lane l the columns l, l + 32, ...) and by the butterfly.
__global__ void __launch_bounds__(kAttThreads) mha_fwd_wide_norm_kernel(
    const __grid_constant__ WideParams p) {
  const int D = p.D, lane = threadIdx.x % kWarp;
  const int r = blockIdx.x * kAttWarps + threadIdx.x / kWarp;  // the pass's row
  if (r >= p.nb * p.Tq) return;
  const int rep = p.rep0 + static_cast<int>(blockIdx.y), vo = rep * D;
  const long long row = (static_cast<long long>(rep) * p.rows + p.b0) * p.Tq + r;
  const float* o = p.work + static_cast<long long>(blockIdx.y) * p.scratch +
                   static_cast<long long>(r) * D;
  const float* x = p.queries + row * D;
  float* dst = p.out + row * D;
  const float* gamma = p.gamma + vo;
  const float* beta = p.beta + vo;
  float sy = 0.0f;
  for (int c = lane; c < D; c += kWarp) sy += o[c] + __ldg(x + c);
  const float mean = warp_sum(sy) / D;
  float sq = 0.0f;
  for (int c = lane; c < D; c += kWarp) {
    const float y = o[c] + __ldg(x + c) - mean;
    sq = fmaf(y, y, sq);
  }
  const float denom = sqrtf(warp_sum(sq) / D + kLnEps);
  for (int c = lane; c < D; c += kWarp) {
    const float y = o[c] + __ldg(x + c) - mean;
    dst[c] = __ldg(gamma + c) * y / denom + __ldg(beta + c);
  }
}

template <int DH, bool DROP>
int launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  // the dynamic shared memory each device's variant is opted in to
  static int opted[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > opted[device]) {
    err = cudaFuncSetAttribute(mha_fwd_kernel<DH, DROP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[device] = smem;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, mha_fwd_kernel<DH, DROP>, p);
  // read (and clear) the launch's error either way, so that a refused
  // launch is not reported again by a later one
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// One pass's three launches: the projections, the attention with `smem`
// bytes (opted in on this device) and LayerNorm.
template <bool DROP>
int launch_wide_pass(const WideParams& p, int nr, bool big, int smem, cudaStream_t stream) {
  static int opted[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > opted[device]) {
    err = cudaFuncSetAttribute(mha_fwd_wide_attend_kernel<DROP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[device] = smem;
  }
  const bool self = self_attention(p);
  const ProjGeometry g = proj_geometry(p.nb, p.Tq, p.Tk, p.D, self,
                                       big ? ProjBig::kBM : ProjSmall::kBM,
                                       big ? ProjBig::kBN : ProjSmall::kBN);
  const dim3 proj(g.tq + g.tk, nr);
  if (big) {
    mha_fwd_wide_project_kernel<ProjBig::kBM><<<proj, kProjThreads, 0, stream>>>(p);
  } else {
    mha_fwd_wide_project_kernel<ProjSmall::kBM><<<proj, kProjThreads, 0, stream>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_fwd_wide_attend_kernel<DROP>
      <<<dim3(p.nb * cdiv(p.Tq, p.qb) * p.H, nr), kAttThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_fwd_wide_norm_kernel<<<dim3(cdiv(p.nb * p.Tq, kAttWarps), nr), kAttThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K3 on `stream` with the geometry of
// ops/cuda/mha.py::launch_plan: `grid` = B·cs CTAs of `threads` threads in
// clusters of `cs`, `group` lanes a (query row, head), `smem` bytes of
// dynamic shared memory; the B batch rows are B / `rows` replicas of `rows`
// rows, each with its own weights; `keep_mask` holds dropout's keep flags
// ([B, H, Tq, Tk] bytes) and `keep` = 1 − rate, a null mask runs the variant
// without dropout.  Returns the launch's CUDA error (0 = launched); a
// refused cluster launch (cudaErrorClusterOutOfResources among others) is
// returned, never retried with another cluster size.  The caller has
// checked shapes, types, devices, contiguity, 16-byte alignment and the
// limits.
int mha_fwd_launch(const float* queries, const float* keys, const int* q_len,
                   const int* k_len, const float* wq, const float* bq,
                   const float* wk, const float* bk, const float* wv,
                   const float* bv, const float* gamma, const float* beta,
                   float* out, int Tq, int Tk, int D, int H, int dh, int cs,
                   int group, int rows, int grid, int threads, int smem,
                   const std::uint8_t* keep_mask, float keep, void* stream) {
  if (threads != kThreads || dh > kMaxDh || D != dh * H || D % 4 != 0 ||
      Tk > kWarp * kPerLane || group < 1 || group > kWarp || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{queries, keys, q_len, k_len, wq, bq, wk, bk, wv, bv, gamma,
                 beta, out, keep_mask, Tq, Tk, D, H, dh, cs, group, rows,
                 1.0f / sqrtf(static_cast<float>(dh)), keep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keep_mask != nullptr) {
    return dh == 8 ? launch<8, true>(p, grid, smem, s) : launch<0, true>(p, grid, smem, s);
  }
  return dh == 8 ? launch<8, false>(p, grid, smem, s) : launch<0, false>(p, grid, smem, s);
}

// Launches K3's wide variant on `stream` with the geometry of
// ops/cuda/mha.py::launch_plan: the `replicas` × `rows` batch rows (each
// replica with its own weights) in passes of `pass_reps` replicas ×
// `pass_rows` rows, each pass a projection launch (64 × 128 tiles where
// `big`, else 32 × 64) and an attention launch of a CTA a (row, block of
// `qb` query rows, head) with `smem` bytes of dynamic shared memory, staging
// `kc` keys and `fc` features at once, o over Q in `work`, then a
// LayerNorm launch of a warp a query row; `work` holds a pass's Q, K and V,
// pass_reps · pass_rows · (Tq + 2·Tk) · D floats.  `keep_mask` and `keep`
// as mha_fwd_launch's.  Returns the first launch's CUDA error (0 = all
// launched).  The caller has checked shapes, types, devices, contiguity
// and, for D a multiple of 4, 16-byte alignment.
int mha_fwd_wide_launch(const float* queries, const float* keys, const int* q_len,
                        const int* k_len, const float* wq, const float* bq,
                        const float* wk, const float* bk, const float* wv,
                        const float* bv, const float* gamma, const float* beta,
                        float* out, float* work, int Tq, int Tk, int D, int H, int dh,
                        int rows, int replicas, int pass_rows, int pass_reps, int qb, int kc,
                        int fc, int big, int threads, int smem,
                        const std::uint8_t* keep_mask, float keep, void* stream) {
  const int ldf = fc + 4, ldp = round4(Tk) + 4;
  if (threads != kAttThreads || dh < 1 || D != dh * H || rows < 1 || replicas < 1 ||
      pass_rows < 1 || pass_rows > rows || pass_reps < 1 || pass_reps > replicas ||
      pass_reps > kMaxGridY || qb < 1 || qb > kMaxQb || fc < 4 || fc > kMaxFc ||
      (fc & (fc - 1)) != 0 || kc < 32 || kc > kMaxKc || kc % 32 != 0 || work == nullptr ||
      4LL * (2 * qb * ldf + 2 * kc * ldf + static_cast<long long>(qb) * ldp + round4(qb) +
             kAttThreads * 16) > smem)
    return static_cast<int>(cudaErrorInvalidValue);
  WideParams p{queries, keys, q_len, k_len, wq, bq, wk, bk, wv, bv, gamma, beta, out, keep_mask,
               work, static_cast<long long>(pass_rows) * (Tq + 2LL * Tk) * D, Tq, Tk, D, H, dh,
               rows, 0, 0, 0, qb, kc, fc, 1.0f / sqrtf(static_cast<float>(dh)), keep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int r0 = 0; r0 < replicas; r0 += pass_reps) {
    for (int b0 = 0; b0 < rows; b0 += pass_rows) {
      p.rep0 = r0;
      p.b0 = b0;
      p.nb = min(pass_rows, rows - b0);
      const int nr = min(pass_reps, replicas - r0);
      const int err = keep_mask != nullptr ? launch_wide_pass<true>(p, nr, big != 0, smem, s)
                                           : launch_wide_pass<false>(p, nr, big != 0, smem, s);
      if (err != 0) return err;
    }
  }
  return 0;
}

// The clusters of `cs` CTAs with `smem` bytes each that the current device
// runs at once (cudaOccupancyMaxActiveClusters), into *clusters; returns
// the CUDA error.  ops/cuda/mha.py's ACTIVE_CLUSTERS is checked against it.
int mha_fwd_active_clusters(int cs, int smem, int* clusters) {
  // raise the opt-in only: launch() assumes it never falls
  cudaFuncAttributes attrs;
  cudaError_t err = cudaFuncGetAttributes(&attrs, mha_fwd_kernel<8, false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > attrs.maxDynamicSharedSizeBytes) {
    err = cudaFuncSetAttribute(mha_fwd_kernel<8, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cs);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(mha_fwd_kernel<8, false>), &config));
}

const char* mha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
