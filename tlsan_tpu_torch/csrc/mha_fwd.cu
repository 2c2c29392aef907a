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
// (at D = 256, (96, 96) self-attention).  Its design is K3b's
// (csrc/mha_bwd.cu): a cluster of cs CTAs takes a batch row, CTA c owning
// heads c·H/cs .. (c+1)·H/cs − 1, i.e. Dc = D/cs columns of each
// projection, so that a CTA holds only its columns of Q, K and V
// ((Tq + 2·Tk)·(Dc + 4) floats).  The layout lies in shared memory where it
// fits, else in a slice of device memory that the CTA alone uses
// (ops/cuda/mha.py::launch_plan decides; the code is the same).  The grid
// is persistent: cluster i takes the rows i, i + clusters, ...  For each
// row a CTA
//   1. projects its columns, Q = relu(q·Wq[:, c] + bq[c]) / √dh and K, V
//      likewise, a thread a tile of 4 rows × 4 columns (K and V together),
//      x and W read as float4s from device memory (the L1 and L2 caches
//      hold them; W is 3 MB at D = 512, above any CTA's shared memory), or
//      one float at a time where D is not a multiple of 4 (the VEC = false
//      variant; a CTA's columns are then padded to a multiple of 4);
//   2. takes each (query row, own head) on one warp: lane l scores the keys
//      l, l + 32, ... over the head's dh features in order into the warp's
//      slice of shared memory (Tk floats: any number of keys), takes the
//      max, then exp and the sum over its own scores in order, both folded
//      by butterflies, and writes the probabilities (0 where dropped) over
//      the scores; then lane l sums features l, l + 32, ... of P·V over the
//      keys in order, so no register array grows with dh or Tk.  The output
//      overwrites the row's Q in place;
//   3. LayerNorm couples the heads: per block of kWideLnRows rows each CTA
//      sums its columns of y = o + q, the cluster exchanges the sums
//      through distributed shared memory and every CTA adds them in rank
//      order, then likewise Σ (y − mean)²; each CTA writes its columns.
// Every sum runs in a fixed order and the cluster size depends on (D, H)
// alone, so two calls agree bit for bit and a replica's rows are those of a
// launch on its slice.  Exactness as above: expf, IEEE division and sqrtf,
// Q scaled by 1/√dh once, the finite key mask, query rows at t >= q_len
// zeroed before the residual.

constexpr int kWideLnRows = 64;   // rows of a LayerNorm exchange

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
  float* work;  // the arrays' slices in device memory, or null for shared memory
  int Tq, Tk, D, H, dh, cs, clusters, rows, total, ldc, arrays, tk4;
  float inv_scale;
  float keep;
};

// Four floats from device memory: a float4 (VEC), else one at a time, 0
// from the n-th on.
template <bool VEC>
__device__ __forceinline__ float4 ldg_part(const float* p, int n) {
  if constexpr (VEC) {
    return ldg4(p);
  } else {
    return make_float4(n > 0 ? __ldg(p) : 0.0f, n > 1 ? __ldg(p + 1) : 0.0f,
                       n > 2 ? __ldg(p + 2) : 0.0f, n > 3 ? __ldg(p + 3) : 0.0f);
  }
}

// Rows r0 .. r0+3 (below R) of x (device memory, rows D apart) times NM
// column slices of the weights (columns c0 + c .. +3, rows D apart; those
// from Dc on read as 0): relu(x·w + b) · scale into o (rows ldc apart,
// columns c .. c+3).
template <int NM, bool VEC>
__device__ __forceinline__ void wide_project(const float* __restrict__ x, int R, int D,
                                             int r0, int c0, int c, int Dc, float scale,
                                             const float* __restrict__ w0,
                                             const float* __restrict__ b0, float* o0,
                                             const float* __restrict__ w1,
                                             const float* __restrict__ b1, float* o1,
                                             int ldc) {
  const float* w[2] = {w0, w1};
  const float* bias[2] = {b0, b1};
  float* o[2] = {o0, o1};
  float acc[NM][kRows][4];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.0f;
  const float* xr[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) xr[i] = x + static_cast<long long>(min(r0 + i, R - 1)) * D;
  const int nc = Dc - c;  // the own columns from c on
  for (int k = 0; k < D; k += 4) {
    float4 xv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) xv[i] = ldg_part<VEC>(xr[i] + k, D - k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (!VEC && k + kk >= D) break;
      float4 wv[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m)
        wv[m] = ldg_part<VEC>(w[m] + static_cast<long long>(k + kk) * D + c0 + c, nc);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float xs = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          acc[m][i][0] = fmaf(xs, wv[m].x, acc[m][i][0]);
          acc[m][i][1] = fmaf(xs, wv[m].y, acc[m][i][1]);
          acc[m][i][2] = fmaf(xs, wv[m].z, acc[m][i][2]);
          acc[m][i][3] = fmaf(xs, wv[m].w, acc[m][i][3]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const float4 bv = ldg_part<VEC>(bias[m] + c0 + c, nc);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (r0 + i < R) {
        st4(o[m] + (r0 + i) * ldc + c,
            make_float4(fmaxf(acc[m][i][0] + bv.x, 0.0f) * scale,
                        fmaxf(acc[m][i][1] + bv.y, 0.0f) * scale,
                        fmaxf(acc[m][i][2] + bv.z, 0.0f) * scale,
                        fmaxf(acc[m][i][3] + bv.w, 0.0f) * scale));
      }
    }
  }
}

// The cluster's sums of v[t] over the ranks, in rank order (v in shared
// memory at the same offset in every CTA).
__device__ __forceinline__ float rank_sum(cg::cluster_group& cluster, float* v, int t,
                                          int cs) {
  if (cs == 1) return v[t];
  float s = 0.0f;
  for (int r = 0; r < cs; ++r) s += cluster.map_shared_rank(v, r)[t];
  return s;
}

__device__ __forceinline__ void wide_cluster_sync(int cs) {
  if (cs > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
}

template <bool DROP, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) mha_fwd_wide_kernel(const __grid_constant__ WideParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = p.cs, D = p.D, H = p.H, dh = p.dh, Tq = p.Tq, Tk = p.Tk, ldc = p.ldc;
  const int rank = cs > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int cid = blockIdx.x / cs;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int hc = H / cs, Dc = D / cs, c0 = rank * Dc;
  // shared memory (ops/cuda/mha.py::_wide_plan): the warps' probabilities
  // [kWarps][tk4], LayerNorm's exchange (row sums, squares) and means
  // [kWideLnRows] each; then, unless they lie in device memory, the arrays
  // Q [Tq][ldc] (the head outputs over it), K and V [Tk][ldc]
  float* probs = smem;
  float* exs = probs + kWarps * p.tk4;
  float* exq = exs + kWideLnRows;
  float* means = exq + kWideLnRows;
  float* arrays = p.work != nullptr ? p.work + static_cast<long long>(blockIdx.x) * p.arrays
                                    : means + kWideLnRows;
  float* Qs = arrays;
  float* Ks = Qs + Tq * ldc;
  float* Vs = Ks + Tk * ldc;
  float* P = probs + warp * p.tk4;

  for (int b = cid; b < p.total; b += p.clusters) {
    const int rep = b / p.rows;  // the replica whose weights the row takes
    const long long wo = static_cast<long long>(rep) * D * D;
    const int vo = rep * D;
    const float* xq = p.queries + static_cast<long long>(b) * Tq * D;
    const float* xk = p.keys + static_cast<long long>(b) * Tk * D;
    const int q_live = p.q_len[b], k_live = p.k_len[b];
    __syncthreads();  // the previous row's arrays are used up

    // 1. the projections of the own columns
    {
      const int nc4 = (Dc + 3) / 4;
      const int qj = (Tq + kRows - 1) / kRows * nc4, kj = (Tk + kRows - 1) / kRows * nc4;
      for (int j = tid; j < qj + kj; j += kThreads) {
        if (j < qj) {
          wide_project<1, VEC>(xq, Tq, D, j / nc4 * kRows, c0, j % nc4 * 4, Dc, p.inv_scale,
                               p.wq + wo, p.bq + vo, Qs, nullptr, nullptr, nullptr, ldc);
        } else {
          const int jk = j - qj;
          wide_project<2, VEC>(xk, Tk, D, jk / nc4 * kRows, c0, jk % nc4 * 4, Dc, 1.0f,
                               p.wk + wo, p.bk + vo, Ks, p.wv + wo, p.bv + vo, Vs, ldc);
        }
      }
    }
    __syncthreads();

    // 2. each (query row, own head) on one warp
    for (int task = warp; task < Tq * hc; task += kWarps) {
      const int t = task / hc, hl = task - t * hc, h = rank * hc + hl;
      const float* q = Qs + t * ldc + hl * dh;
      float m = -INFINITY;
      for (int k = lane; k < Tk; k += kWarp) {
        float v = kKeyMask;
        if (k < k_live) {
          const float* kr = Ks + k * ldc + hl * dh;
          float d = 0.0f;
          for (int f = 0; f < dh; ++f) d = fmaf(q[f], kr[f], d);
          v = d;
        }
        P[k] = v;  // the lane's own scores, read back by the lane alone
        m = fmaxf(m, v);
      }
      for (int off = kWarp / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float sum = 0.0f;
      const std::uint8_t* km = nullptr;
      if constexpr (DROP)
        km = p.keep_mask + ((static_cast<long long>(b) * H + h) * Tq + t) * Tk;
      for (int k = lane; k < Tk; k += kWarp) {
        const float e = expf(P[k] - m);
        sum += e;
        float w = e;
        if constexpr (DROP) w = __ldg(km + k) ? e : 0.0f;
        P[k] = w;
      }
      for (int off = kWarp / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      float* o = Qs + t * ldc + hl * dh;  // this head's q is used up
      for (int f = lane; f < dh; f += kWarp) {
        float a = 0.0f;
        for (int k = 0; k < Tk; ++k) a = fmaf(P[k], Vs[k * ldc + hl * dh + f], a);
        float v = 0.0f;
        if (t < q_live) v = DROP ? a / sum / p.keep : a / sum;
        o[f] = v;
      }
      __syncwarp();  // P is free for the warp's next task
    }
    __syncthreads();

    // 3. LayerNorm of y = o + q over all D columns, kWideLnRows rows at a
    // time: the cluster's row sums, then its sums of squares about the
    // mean.  The two barriers order every exchange: a CTA writes the next
    // block's row sums only after the second barrier, which no peer passes
    // before it has read them, and the squares only after the next first.
    float* ob = p.out + static_cast<long long>(b) * Tq * D;
    for (int r0 = 0; r0 < Tq; r0 += kWideLnRows) {
      const int nr = min(kWideLnRows, Tq - r0);
      for (int r = warp; r < nr; r += kWarps) {
        const float* orow = Qs + (r0 + r) * ldc;
        const float* xrow = xq + static_cast<long long>(r0 + r) * D + c0;
        float sy = 0.0f;
        for (int c = lane; c < Dc; c += kWarp) sy += orow[c] + __ldg(xrow + c);
        for (int off = kWarp / 2; off > 0; off >>= 1) sy += __shfl_xor_sync(0xffffffffu, sy, off);
        if (lane == 0) exs[r] = sy;
      }
      wide_cluster_sync(cs);
      for (int r = warp; r < nr; r += kWarps) {
        const float mean = rank_sum(cluster, exs, r, cs) / D;
        const float* orow = Qs + (r0 + r) * ldc;
        const float* xrow = xq + static_cast<long long>(r0 + r) * D + c0;
        float sq = 0.0f;
        for (int c = lane; c < Dc; c += kWarp) {
          const float y = orow[c] + __ldg(xrow + c) - mean;
          sq = fmaf(y, y, sq);
        }
        for (int off = kWarp / 2; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
        if (lane == 0) exq[r] = sq, means[r] = mean;
      }
      wide_cluster_sync(cs);
      for (int r = warp; r < nr; r += kWarps) {
        const float mean = means[r];
        const float denom = sqrtf(rank_sum(cluster, exq, r, cs) / D + kLnEps);
        const float* orow = Qs + (r0 + r) * ldc;
        const float* xrow = xq + static_cast<long long>(r0 + r) * D + c0;
        float* orow_out = ob + static_cast<long long>(r0 + r) * D + c0;
        for (int c = lane; c < Dc; c += kWarp) {
          const float y = orow[c] + __ldg(xrow + c) - mean;
          orow_out[c] = __ldg(p.gamma + vo + c0 + c) * y / denom + __ldg(p.beta + vo + c0 + c);
        }
      }
    }
  }
  wide_cluster_sync(cs);  // no CTA leaves while a peer reads its sums
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

template <bool DROP, bool VEC>
int launch_wide(const WideParams& p, int smem, cudaStream_t stream) {
  static int opted[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > opted[device]) {
    err = cudaFuncSetAttribute(mha_fwd_wide_kernel<DROP, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[device] = smem;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.clusters * p.cs);
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
  err = cudaLaunchKernelEx(&config, mha_fwd_wide_kernel<DROP, VEC>, p);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
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
// ops/cuda/mha.py::launch_plan: `clusters` clusters of `cs` CTAs of
// `threads` threads, cluster i taking the rows i, i + clusters, ... of the
// `total` batch rows (`rows` a replica, each replica with its own weights);
// CTA c of a cluster owns heads c·H/cs .. (c+1)·H/cs − 1; `smem` bytes of
// dynamic shared memory; the arrays, `arrays` floats a CTA (rows of the
// CTA's columns padded to a multiple of 4, plus 4), in shared memory or,
// with `work` not null, in `work` (clusters·cs·arrays floats).  D not a
// multiple of 4 runs the variant that reads x and the weights one float at
// a time.  `keep_mask` and `keep` as mha_fwd_launch's.  Returns the
// launch's CUDA error (0 = launched).  The caller has checked shapes,
// types, devices, contiguity and, for D a multiple of 4, 16-byte
// alignment.
int mha_fwd_wide_launch(const float* queries, const float* keys, const int* q_len,
                        const int* k_len, const float* wq, const float* bq,
                        const float* wk, const float* bk, const float* wv,
                        const float* bv, const float* gamma, const float* beta,
                        float* out, float* work, int Tq, int Tk, int D, int H, int dh,
                        int cs, int clusters, int rows, int total, int arrays, int threads,
                        int smem, const std::uint8_t* keep_mask, float keep, void* stream) {
  const bool vec = D % 4 == 0;
  if (threads != kThreads || dh < 1 || D != dh * H ||
      (cs != 1 && cs != 2 && cs != 4 && cs != 8) || H % cs != 0 || (vec && (D / cs) % 4 != 0) ||
      clusters < 1 || rows < 1 || total < rows || total % rows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ldc = round4(D / cs) + kPad, tk4 = round4(Tk);
  const int fixed = kWarps * tk4 + 3 * kWideLnRows;
  if (arrays != (Tq + 2 * Tk) * ldc ||
      4 * (fixed + (work != nullptr ? 0 : arrays)) > smem)
    return static_cast<int>(cudaErrorInvalidValue);
  const WideParams p{queries, keys, q_len, k_len, wq, bq, wk, bk, wv, bv, gamma, beta, out,
                     keep_mask, work, Tq, Tk, D, H, dh, cs, clusters, rows, total, ldc,
                     arrays, tk4, 1.0f / sqrtf(static_cast<float>(dh)), keep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return keep_mask != nullptr ? launch_wide<true, true>(p, smem, s)
                                       : launch_wide<false, true>(p, smem, s);
  return keep_mask != nullptr ? launch_wide<true, false>(p, smem, s)
                              : launch_wide<false, false>(p, smem, s);
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
