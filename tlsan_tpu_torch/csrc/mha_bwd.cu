// Multi-head attention (ATRank) backward, K3b, for Hopper (sm_90a), f32.
//
// Replaces: tlsan_tpu/ops/pallas/mha.py::_mha_bwd, which is jax.vjp of the
// jnp reference (the JAX package has no backward kernel).  Given the
// forward's inputs (queries [Tq, D], keys [Tk, D], q_len, k_len, the three
// projections, γ and β) and the incoming gradient g = dL/dout [Tq, D] of a
// batch row, it recomputes the forward of csrc/mha_fwd.cu and returns
//
//   dγ = Σ g⊙ŷ, dβ = Σ g,  dy = (dŷ − mean dŷ − ŷ·mean(dŷ⊙ŷ)) / σ  (dŷ = g⊙γ)
//   per head h, with P₀ the softmax before the query mask and P′ the
//   masked, dropped-out probabilities:
//     dV = P′ᵀ·dy,  dP₀ = (dy·Vᵀ) ⊙ qmask ⊙ keep/kp,
//     dS = P₀ ⊙ (dP₀ − D), D = rowsum(dP₀⊙P₀) = dy·O (O = P′·V, the head's
//     output), zero at masked keys,  dQ = dS·K/√dh,  dK = dSᵀ·Q/√dh;
//   the ReLU masks: dQpre = dQ ⊙ [Q > 0], likewise dKpre and dVpre;
//   d_queries = dy + dQpre·Wqᵀ,  d_keys = dKpre·Wkᵀ + dVpre·Wvᵀ,
//   dW = xᵀ·dpre and db = Σ dpre, summed over every row of the batch.
//
// Its plain version is ops/multihead_attention.py::
// multihead_attention_backward_reference.  For self-attention (queries is
// keys) d_queries and d_keys are written apart and autograd adds them.
//
// What bounds it on the H100: operations.  A row recomputes the forward,
// (Tq + 2·Tk)·D² + 2·Tq·Tk·D multiply-adds, and does twice that backward:
// at B = 32, D = 64, Tq = Tk = 96 some 0.45 GFLOP (6.7 µs at the 67 TFLOP/s
// f32 peak outside the tensor cores; TF32 stays off) against 1.6 MB of
// inputs and gradients (0.5 µs at 3.35 TB/s).  At the training shapes the
// batch is small (32 rows), so a row's chain of dependent steps sets the
// time; this first design keeps every step simple.
//
// Design.  A fixed number of CTAs (ops/cuda/mha.py::backward_plan: one an
// SM, 132, or the batch where it is smaller; a thread takes some 170
// registers) each take the batch rows blockIdx.x, blockIdx.x + gridDim.x,
// ... in order.  A row's intermediates (Q, K, V, the head outputs O, dy,
// g⊙ŷ and the softmax's per-(row, head) max, sum and D) live in a
// workspace: the CTA's shared memory when they fit (at D = 64, Tq = Tk =
// 96: 157 KB), else a slice of device memory that the CTA alone uses (L1
// and L2 hold it).  The steps of a row, each
// after a barrier:
//   1. the projections Q, K, V (a thread a tile of 4 rows × 4 columns, K
//      and V together), weights read through the read-only cache;
//   2. the forward per (query row, head), one thread each: the scores
//      twice (their max, then exp, sum and the weighted V), O and the
//      max and sum kept;
//   3. LayerNorm's backward per query row, one warp each: dy and g⊙ŷ;
//   4. D = dy·O per (query row, head), and the row's dγ and dβ per column;
//   5. dQ per (query row, head) from recomputed scores, into O's place;
//   6. dK and dV per (key row, head), summing over the query rows in order,
//      written over K and V;
//   7. d_queries and d_keys (4 × 4 tiles of dpre times the weights'
//      transposes), and the row's weight gradients (4 × 4 tiles summing
//      xᵀ·dpre over the rows in order) added to the CTA's slot.
//
// The weight gradients (3·D² + 5·D floats a replica) are summed in a fixed
// order, without float atomics, so that two calls agree bit for bit: over
// a CTA's rows in row order, into the CTA's slot in device memory; then
// over the CTAs by a tree of groups of kGroup slots (csrc/fwa_bwd.cu's):
// each CTA takes a ticket (an atomic integer increment after a
// __threadfence); the last CTA of a group sums the group's slots in slot
// order into one slot of the next level and resets the group's ticket,
// until one group is left, whose last CTA writes the gradients.  The
// tickets start at 0 and are 0 again when the launch ends.  The scratch
// depends on the grid, not on B.
//
// Replicas.  A replica axis of weights (every tensor [R·B, ...] or [R,
// ...]) is the grid's y axis: CTAs (·, r) take replica r's rows with its
// weights, into its own slots, tickets and workspace, with the grid of one
// replica's launch, so replica r's gradients are bit for bit those of a
// launch on its slice alone.
//
// Dropout (train time) is the DROP variant: the forward's keep mask ([B, H,
// Tq, Tk] bytes) and keep = 1 − rate, read where a probability is used; a
// null mask selects the variant without dropout, whose code is that before
// the mask.
//
// dh = 8, 16 and 32 are specialised with a head's rows in registers; any
// other dh <= 32 runs a generic variant.  D <= 256 and a multiple of 4; Tq
// and Tk are bounded by nothing but memory (the workspace moves to device
// memory past the shared memory).
//
// Exactness: expf (not __expf), IEEE division and sqrtf, no fast math.  The
// scores are q·k scaled by 1/√dh (the reference divides by √dh: the two
// differ in the last bit); the key mask is the reference's finite −2³²+1,
// so a row with k_len = 0 has a softmax uniform over all Tk keys and a
// non-zero dV at every key, and dS = 0 at masked keys.  Query rows at
// t >= q_len pass dy to the queries through the residual alone.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr float kKeyMask = -4294967296.0f;  // -(2^32) + 1 rounded to f32
constexpr float kLnEps = 1e-8f;
constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxDh = 32;
constexpr int kMaxLnPerLane = 8;  // D <= 256 = 32 lanes x 8
constexpr int kRows = 4;          // rows of a thread's tile
// slots summed together at each level of the cross-CTA tree;
// ops/cuda/mha.py::backward_plan sizes the scratch with the same number
constexpr int kGroup = 16;
constexpr int kMaxDevices = 64;

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
  const float* g;
  const std::uint8_t* keep_mask;  // dropout's keep flags, or null
  float* dq;
  float* dk;
  float* dwq;
  float* dbq;
  float* dwk;
  float* dbk;
  float* dwv;
  float* dbv;
  float* dgamma;
  float* dbeta;
  float* slots;
  unsigned* tickets;
  float* work;  // the workspace in device memory, or null when in shared memory
  int Tq, Tk, D, H, dh, rows;  // rows: the batch rows a replica
  int replica_slots, replica_tickets, per_row;
  float inv_scale;
  float keep;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A head's slice of a row, n features, into registers (a[0 .. n)).
template <int DH>
__device__ __forceinline__ void load_head(const float* src, float* a, int n) {
#pragma unroll
  for (int j = 0; j < (DH ? DH : n); ++j) a[j] = src[j];
}

template <int DH>
__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < (DH ? DH : n); ++j) s = fmaf(a[j], b[j], s);
  return s;
}

// acc += e · v
template <int DH>
__device__ __forceinline__ void axpy(float e, const float* v, float* acc, int n) {
#pragma unroll
  for (int j = 0; j < (DH ? DH : n); ++j) acc[j] = fmaf(e, v[j], acc[j]);
}

// 1. Rows r0 .. r0+3 (below R) of x [R, D] (device memory) times NM weight
// matrices w_m [D, D] (device memory), columns c .. c+3: o_m = relu(x·w_m +
// b_m) into the workspace, rows D apart.
template <int NM>
__device__ __forceinline__ void project_tile(const float* x, int R, int D, int r0, int c,
                                             const float* w0, const float* b0, float* o0,
                                             const float* w1, const float* b1, float* o1) {
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
  for (int k = 0; k < D; k += 4) {
    float4 xv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) xv[i] = ldg4(x + min(r0 + i, R - 1) * D + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const float4 wv = ldg4(w[m] + (k + kk) * D + c);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float xs = comp(xv[i], kk);
          acc[m][i][0] = fmaf(xs, wv.x, acc[m][i][0]);
          acc[m][i][1] = fmaf(xs, wv.y, acc[m][i][1]);
          acc[m][i][2] = fmaf(xs, wv.z, acc[m][i][2]);
          acc[m][i][3] = fmaf(xs, wv.w, acc[m][i][3]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const float4 bv = ldg4(bias[m] + c);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (r0 + i < R) {
        st4(o[m] + (r0 + i) * D + c,
            make_float4(fmaxf(acc[m][i][0] + bv.x, 0.0f), fmaxf(acc[m][i][1] + bv.y, 0.0f),
                        fmaxf(acc[m][i][2] + bv.z, 0.0f), fmaxf(acc[m][i][3] + bv.w, 0.0f)));
      }
    }
  }
}

// 7a. Rows r0 .. r0+3 (below R) of Σ_m dpre_m · w_mᵀ (dpre_m [R, D] in the
// workspace, w_m [D, D] in device memory), columns a .. a+3, plus `add`
// (rows D apart, or null), into out (device memory).
template <int NM>
__device__ __forceinline__ void input_grad_tile(const float* d0, const float* w0,
                                                const float* d1, const float* w1,
                                                const float* add, float* out, int R, int D,
                                                int r0, int a) {
  const float* dp[2] = {d0, d1};
  const float* w[2] = {w0, w1};
  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    for (int c = 0; c < D; c += 4) {
      float4 dv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dv[i] = ld4(dp[m] + min(r0 + i, R - 1) * D + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 wv = ldg4(w[m] + (a + j) * D + c);  // w[a + j][c .. c+3]
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          float s = acc[i][j];
          s = fmaf(dv[i].x, wv.x, s);
          s = fmaf(dv[i].y, wv.y, s);
          s = fmaf(dv[i].z, wv.z, s);
          s = fmaf(dv[i].w, wv.w, s);
          acc[i][j] = s;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (r0 + i < R) {
      float4 y = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (add != nullptr) {
        const float4 e = ld4(add + (r0 + i) * D + a);
        y.x = e.x + y.x, y.y = e.y + y.y, y.z = e.z + y.z, y.w = e.w + y.w;
      }
      st4(out + (r0 + i) * D + a, y);
    }
  }
}

// 7b. Rows a .. a+3, columns c .. c+3 of Σ_t x[t]ᵀ · dpre_m[t] over the R
// rows in order (x [R, D] in device memory, dpre_m in the workspace), and
// for a = 0 the columns' Σ_t dpre_m[t]; added to the slot's entries (`wslot_m`
// the matrix, `bslot_m` the bias), or written for the CTA's first row.
template <int NM>
__device__ __forceinline__ void weight_grad_tile(const float* x, const float* d0,
                                                 const float* d1, float* wslot0,
                                                 float* wslot1, float* bslot0, float* bslot1,
                                                 int R, int D, int a, int c, bool first) {
  const float* dp[2] = {d0, d1};
  float* ws[2] = {wslot0, wslot1};
  float* bs[2] = {bslot0, bslot1};
  float acc[NM][4][4], bacc[NM][4];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bacc[m][j] = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][i][j] = 0.0f;
    }
  for (int t = 0; t < R; ++t) {
    const float4 xv = ldg4(x + t * D + a);
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const float4 dv = ld4(dp[m] + t * D + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xs = comp(xv, i);
        acc[m][i][0] = fmaf(xs, dv.x, acc[m][i][0]);
        acc[m][i][1] = fmaf(xs, dv.y, acc[m][i][1]);
        acc[m][i][2] = fmaf(xs, dv.z, acc[m][i][2]);
        acc[m][i][3] = fmaf(xs, dv.w, acc[m][i][3]);
      }
      bacc[m][0] += dv.x, bacc[m][1] += dv.y, bacc[m][2] += dv.z, bacc[m][3] += dv.w;
    }
  }
#pragma unroll
  for (int m = 0; m < NM; ++m) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* e = ws[m] + (a + i) * D + c;
      float4 v = make_float4(acc[m][i][0], acc[m][i][1], acc[m][i][2], acc[m][i][3]);
      if (!first) {
        const float4 o = ld4(e);
        v.x = o.x + v.x, v.y = o.y + v.y, v.z = o.z + v.z, v.w = o.w + v.w;
      }
      st4(e, v);
    }
    if (a == 0) {
      float* e = bs[m] + c;
      float4 v = make_float4(bacc[m][0], bacc[m][1], bacc[m][2], bacc[m][3]);
      if (!first) {
        const float4 o = ld4(e);
        v.x = o.x + v.x, v.y = o.y + v.y, v.z = o.z + v.z, v.w = o.w + v.w;
      }
      st4(e, v);
    }
  }
}

template <int DH, bool DROP>
__global__ void __launch_bounds__(kThreads, 1) mha_bwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  __shared__ bool last;
  constexpr int NR = DH ? DH : kMaxDh;  // register arrays of a head's features
  const int Tq = p.Tq, Tk = p.Tk, D = p.D, H = p.H;
  const int n = DH ? DH : p.dh;
  const int D4 = D / 4;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int r = blockIdx.y;  // the replica
  const float inv_scale = p.inv_scale;

  // the row's workspace, as ops/cuda/mha.py::_bwd_floats counts it: Q [Tq,
  // D], K and V [Tk, D], O (then dQpre) [Tq, D], dy [Tq, D], g⊙ŷ [Tq, D],
  // then the max, sum and D of each (query row, head) [Tq·H] each
  float* ws = p.work == nullptr
                  ? reinterpret_cast<float*>(smem4)
                  : p.work + (static_cast<long long>(r) * gridDim.x + blockIdx.x) * p.per_row;
  float* Qw = ws;
  float* Kw = Qw + Tq * D;
  float* Vw = Kw + Tk * D;
  float* Ow = Vw + Tk * D;
  float* DYw = Ow + Tq * D;
  float* GYw = DYw + Tq * D;
  const int th = round4(Tq * H);
  float* Mw = GYw + Tq * D;
  float* Lw = Mw + th;
  float* Dw = Lw + th;

  // the replica's weights, and its gradients' slots
  const long long wo = static_cast<long long>(r) * D * D;
  const int vo = r * D;
  const float* wq = p.wq + wo;
  const float* wk = p.wk + wo;
  const float* wv = p.wv + wo;
  const float* bq = p.bq + vo;
  const float* bk = p.bk + vo;
  const float* bv = p.bv + vo;
  const float* gamma = p.gamma + vo;
  const int P = 3 * D * D + 5 * D;
  float* slots = p.slots + static_cast<long long>(r) * p.replica_slots * P;
  float* slot = slots + static_cast<long long>(blockIdx.x) * P;
  float* sw = slot;                // dWq | dWk | dWv
  float* sb = slot + 3 * D * D;    // dbq | dbk | dbv | dγ | dβ

  for (int j = blockIdx.x; j < p.rows; j += gridDim.x) {
    const bool first = j == static_cast<int>(blockIdx.x);
    const long long b = static_cast<long long>(r) * p.rows + j;
    const float* xq = p.queries + b * Tq * D;
    const float* xk = p.keys + b * Tk * D;
    const float* gb = p.g + b * Tq * D;
    const std::uint8_t* km = nullptr;
    if constexpr (DROP) km = p.keep_mask + b * H * Tq * Tk;
    const int q_live = max(0, min(p.q_len[b], Tq));
    const int k_live = max(0, min(p.k_len[b], Tk));

    // 1. the projections
    {
      const int qjobs = (Tq + kRows - 1) / kRows * D4;
      const int kjobs = (Tk + kRows - 1) / kRows * D4;
      for (int jb = tid; jb < qjobs + kjobs; jb += kThreads) {
        if (jb < qjobs) {
          project_tile<1>(xq, Tq, D, jb / D4 * kRows, jb % D4 * 4, wq, bq, Qw, nullptr,
                          nullptr, nullptr);
        } else {
          const int jk = jb - qjobs;
          project_tile<2>(xk, Tk, D, jk / D4 * kRows, jk % D4 * 4, wk, bk, Kw, wv, bv, Vw);
        }
      }
    }
    __syncthreads();

    // 2. the forward per (query row, head): O, and the softmax's max and sum
    for (int i = tid; i < Tq * H; i += kThreads) {
      const int t = i / H, h = i - t * H;
      float* orow = Ow + t * D + h * n;
      if (t >= q_live) {  // query-masked: O = 0, and no later step reads M, L
        for (int f = 0; f < n; ++f) orow[f] = 0.0f;
        Mw[i] = 0.0f, Lw[i] = 1.0f;
        continue;
      }
      float q[NR];
      load_head<DH>(Qw + t * D + h * n, q, n);
      float m = -INFINITY;
      for (int k = 0; k < Tk; ++k) {
        const float s = k < k_live ? dot<DH>(q, Kw + k * D + h * n, n) * inv_scale : kKeyMask;
        m = fmaxf(m, s);
      }
      float l = 0.0f, acc[NR];
#pragma unroll
      for (int f = 0; f < NR; ++f) acc[f] = 0.0f;
      const std::uint8_t* kr = nullptr;
      if constexpr (DROP) kr = km + (static_cast<long long>(h) * Tq + t) * Tk;
      for (int k = 0; k < Tk; ++k) {
        const float s = k < k_live ? dot<DH>(q, Kw + k * D + h * n, n) * inv_scale : kKeyMask;
        const float e = expf(s - m);
        l += e;
        if constexpr (DROP) {
          if (__ldg(kr + k)) axpy<DH>(e, Vw + k * D + h * n, acc, n);
        } else {
          axpy<DH>(e, Vw + k * D + h * n, acc, n);
        }
      }
#pragma unroll
      for (int f = 0; f < (DH ? DH : n); ++f) {
        if constexpr (DROP) {
          orow[f] = acc[f] / l / p.keep;
        } else {
          orow[f] = acc[f] / l;
        }
      }
      Mw[i] = m, Lw[i] = l;
    }
    __syncthreads();

    // 3. LayerNorm's backward per query row, a warp each: dy and g⊙ŷ
    for (int t = warp; t < Tq; t += kWarps) {
      float y[kMaxLnPerLane], gv[kMaxLnPerLane], sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxLnPerLane; ++i) {
        const int c = lane + kWarp * i;
        y[i] = c < D ? Ow[t * D + c] + __ldg(xq + t * D + c) : 0.0f;
        gv[i] = c < D ? __ldg(gb + t * D + c) : 0.0f;
        sum += y[i];
      }
      const float mean = warp_sum(sum) / D;
      float sq = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxLnPerLane; ++i) {
        y[i] = lane + kWarp * i < D ? y[i] - mean : 0.0f;
        sq = fmaf(y[i], y[i], sq);
      }
      const float denom = sqrtf(warp_sum(sq) / D + kLnEps);
      float s1 = 0.0f, s2 = 0.0f, dyh[kMaxLnPerLane];
#pragma unroll
      for (int i = 0; i < kMaxLnPerLane; ++i) {
        const int c = lane + kWarp * i;
        y[i] = y[i] / denom;  // ŷ
        dyh[i] = c < D ? gv[i] * __ldg(gamma + c) : 0.0f;
        s1 += dyh[i];
        s2 = fmaf(dyh[i], y[i], s2);
      }
      const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll
      for (int i = 0; i < kMaxLnPerLane; ++i) {
        const int c = lane + kWarp * i;
        if (c < D) {
          DYw[t * D + c] = (dyh[i] - m1 - y[i] * m2) / denom;
          GYw[t * D + c] = gv[i] * y[i];
        }
      }
    }
    __syncthreads();

    // 4. D = dy·O per (query row, head); the row's dγ and dβ per column
    for (int i = tid; i < Tq * H + D; i += kThreads) {
      if (i < Tq * H) {
        const int t = i / H, h = i - t * H;
        Dw[i] = dot<DH>(DYw + t * D + h * n, Ow + t * D + h * n, n);
      } else {
        const int c = i - Tq * H;
        float sg = 0.0f, sbeta = 0.0f;
        for (int t = 0; t < Tq; ++t) {
          sg += GYw[t * D + c];
          sbeta += __ldg(gb + t * D + c);
        }
        float* e = sb + 3 * D + c;
        e[0] = first ? sg : e[0] + sg;
        e[D] = first ? sbeta : e[D] + sbeta;
      }
    }
    __syncthreads();

    // 5. dQ per (query row, head) from the recomputed scores; dQpre over O
    for (int i = tid; i < Tq * H; i += kThreads) {
      const int t = i / H, h = i - t * H;
      float* orow = Ow + t * D + h * n;
      float q[NR], dy[NR], acc[NR];
      load_head<DH>(Qw + t * D + h * n, q, n);
#pragma unroll
      for (int f = 0; f < NR; ++f) acc[f] = 0.0f;
      if (t < q_live) {
        load_head<DH>(DYw + t * D + h * n, dy, n);
        const float m = Mw[i], l = Lw[i], dd = Dw[i];
        const std::uint8_t* kr = nullptr;
        if constexpr (DROP) kr = km + (static_cast<long long>(h) * Tq + t) * Tk;
        for (int k = 0; k < k_live; ++k) {  // dS = 0 at masked keys
          const float* krow = Kw + k * D + h * n;
          const float pr = expf(dot<DH>(q, krow, n) * inv_scale - m) / l;
          float dp = dot<DH>(dy, Vw + k * D + h * n, n);
          if constexpr (DROP) dp = __ldg(kr + k) ? dp / p.keep : 0.0f;
          axpy<DH>(pr * (dp - dd), krow, acc, n);
        }
      }
#pragma unroll
      for (int f = 0; f < (DH ? DH : n); ++f) orow[f] = q[f] > 0.0f ? acc[f] * inv_scale : 0.0f;
    }
    __syncthreads();

    // 6. dK and dV per (key row, head), over the live query rows in order;
    // dKpre and dVpre over K and V
    for (int i = tid; i < Tk * H; i += kThreads) {
      const int k = i / H, h = i - k * H;
      float* krow = Kw + k * D + h * n;
      float* vrow = Vw + k * D + h * n;
      float kv[NR], vv[NR], dkacc[NR], dvacc[NR];
      load_head<DH>(krow, kv, n);
      load_head<DH>(vrow, vv, n);
#pragma unroll
      for (int f = 0; f < NR; ++f) dkacc[f] = 0.0f, dvacc[f] = 0.0f;
      const bool valid = k < k_live;
      for (int t = 0; t < q_live; ++t) {  // rows at t >= q_len: P′ = 0, dS = 0
        const int u = t * H + h;
        const float* qrow = Qw + t * D + h * n;
        const float* dyrow = DYw + t * D + h * n;
        const float s = valid ? dot<DH>(qrow, kv, n) * inv_scale : kKeyMask;
        const float pr = expf(s - Mw[u]) / Lw[u];
        bool kept = true;
        if constexpr (DROP) kept = __ldg(km + (static_cast<long long>(h) * Tq + t) * Tk + k) != 0;
        if constexpr (DROP) {
          if (kept) axpy<DH>(pr / p.keep, dyrow, dvacc, n);
        } else {
          axpy<DH>(pr, dyrow, dvacc, n);
        }
        if (valid) {
          float dp = dot<DH>(dyrow, vv, n);
          if constexpr (DROP) dp = kept ? dp / p.keep : 0.0f;
          axpy<DH>(pr * (dp - Dw[u]), qrow, dkacc, n);
        }
      }
#pragma unroll
      for (int f = 0; f < (DH ? DH : n); ++f) {
        krow[f] = kv[f] > 0.0f ? dkacc[f] * inv_scale : 0.0f;
        vrow[f] = vv[f] > 0.0f ? dvacc[f] : 0.0f;
      }
    }
    __syncthreads();

    // 7. d_queries, d_keys and the row's weight gradients
    {
      const int ja = (Tq + kRows - 1) / kRows * D4;
      const int jb = (Tk + kRows - 1) / kRows * D4;
      const int jc = D4 * D4;
      for (int jj = tid; jj < ja + jb + 2 * jc; jj += kThreads) {
        if (jj < ja) {
          input_grad_tile<1>(Ow, wq, nullptr, nullptr, DYw, p.dq + b * Tq * D, Tq, D,
                             jj / D4 * kRows, jj % D4 * 4);
        } else if (jj < ja + jb) {
          const int u = jj - ja;
          input_grad_tile<2>(Kw, wk, Vw, wv, nullptr, p.dk + b * Tk * D, Tk, D,
                             u / D4 * kRows, u % D4 * 4);
        } else if (jj < ja + jb + jc) {
          const int u = jj - ja - jb;
          weight_grad_tile<1>(xq, Ow, nullptr, sw, nullptr, sb, nullptr, Tq, D, u / D4 * 4,
                              u % D4 * 4, first);
        } else {
          const int u = jj - ja - jb - jc;
          weight_grad_tile<2>(xk, Kw, Vw, sw + D * D, sw + 2 * D * D, sb + D, sb + 2 * D, Tk,
                              D, u / D4 * 4, u % D4 * 4, first);
        }
      }
    }
    __syncthreads();  // the workspace is free for the next row
  }

  // up the tree: the last CTA of each group of kGroup slots sums them, in
  // slot order, into one slot of the next level
  unsigned* tickets = p.tickets + static_cast<long long>(r) * p.replica_tickets;
  float* level = slots;
  int count = gridDim.x, idx = blockIdx.x;
  while (count > 1) {
    const int group = idx / kGroup;
    const int first = group * kGroup;
    const int members = min(kGroup, count - first);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last = atomicAdd(tickets + group, 1u) == static_cast<unsigned>(members - 1);
      if (last) tickets[group] = 0;  // every CTA of the group has counted
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    float* next = level + static_cast<long long>(count) * P;
    const float* src = level + static_cast<long long>(first) * P;
    for (int i = tid * 4; i < P; i += kThreads * 4) {
      float4 acc = __ldcg(reinterpret_cast<const float4*>(src + i));
      for (int s = 1; s < members; ++s) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(src + static_cast<long long>(s) * P + i));
        acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
      }
      st4(next + static_cast<long long>(group) * P + i, acc);
    }
    tickets += (count + kGroup - 1) / kGroup;
    count = (count + kGroup - 1) / kGroup;
    idx = group;
    level = next;
  }
  // one CTA is left, with the total in slot 0 of `level`
  __threadfence();
  __syncthreads();
  for (int i = tid; i < P; i += kThreads) {
    const float v = __ldcg(level + i);
    if (i < 3 * D * D) {
      const int m = i / (D * D), e = i - m * D * D;
      (m == 0 ? p.dwq : m == 1 ? p.dwk : p.dwv)[wo + e] = v;
    } else {
      const int m = (i - 3 * D * D) / D, c = i - 3 * D * D - m * D;
      float* dst = m == 0 ? p.dbq : m == 1 ? p.dbk : m == 2 ? p.dbv : m == 3 ? p.dgamma : p.dbeta;
      dst[vo + c] = v;
    }
  }
}

template <int DH, bool DROP>
int launch(const Params& p, int grid, int replicas, int smem, cudaStream_t stream) {
  // the dynamic shared memory each device's variant is opted in to
  static int opted[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > opted[device]) {
    err = cudaFuncSetAttribute(mha_bwd_kernel<DH, DROP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[device] = smem;
  }
  mha_bwd_kernel<DH, DROP><<<dim3(grid, replicas), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool DROP>
int launch_heads(const Params& p, int grid, int replicas, int smem, cudaStream_t stream) {
  switch (p.dh) {
    case 8:
      return launch<8, DROP>(p, grid, replicas, smem, stream);
    case 16:
      return launch<16, DROP>(p, grid, replicas, smem, stream);
    case 32:
      return launch<32, DROP>(p, grid, replicas, smem, stream);
    default:
      return launch<0, DROP>(p, grid, replicas, smem, stream);
  }
}

}  // namespace

extern "C" {

// Launches K3b on `stream` with the geometry of
// ops/cuda/mha.py::backward_plan: grid × replicas CTAs of `threads` threads,
// each taking the rows blockIdx.x, blockIdx.x + grid, ... of its replica's
// `rows`; `smem` bytes of dynamic shared memory hold a row's workspace, or,
// with `work` not null, `per_row` floats of `work` a CTA do.  `slots` and
// `tickets` are the plan's scratch (tickets all 0), `replica_slots` slots of
// 3·D² + 5·D floats and `replica_tickets` tickets a replica.  `keep_mask`
// holds dropout's keep flags ([rows·replicas, H, Tq, Tk] bytes) and `keep`
// = 1 − rate; a null mask runs the variant without dropout.  Returns the
// launch's CUDA error (0 = launched).  The caller has checked shapes,
// types, devices, contiguity, 16-byte alignment and the limits.
int mha_bwd_launch(const float* queries, const float* keys, const int* q_len,
                   const int* k_len, const float* wq, const float* bq, const float* wk,
                   const float* bk, const float* wv, const float* bv, const float* gamma,
                   const float* beta, const float* g, const std::uint8_t* keep_mask,
                   float* dq, float* dk, float* dwq, float* dbq, float* dwk, float* dbk,
                   float* dwv, float* dbv, float* dgamma, float* dbeta, float* slots,
                   unsigned* tickets, float* work, int Tq, int Tk, int D, int H, int dh,
                   int rows, int grid, int replicas, int replica_slots, int replica_tickets,
                   int per_row, int threads, int smem, float keep, void* stream) {
  if (threads != kThreads || dh < 1 || dh > kMaxDh || D != dh * H || D % 4 != 0 ||
      D > kWarp * kMaxLnPerLane || rows < 1 || grid < 1 || grid > rows || replicas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{queries, keys, q_len, k_len, wq, bq, wk, bk, wv, bv, gamma, beta, g,
                 keep_mask, dq, dk, dwq, dbq, dwk, dbk, dwv, dbv, dgamma, dbeta, slots,
                 tickets, work, Tq, Tk, D, H, dh, rows, replica_slots, replica_tickets,
                 per_row, 1.0f / sqrtf(static_cast<float>(dh)), keep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keep_mask != nullptr) return launch_heads<true>(p, grid, replicas, smem, s);
  return launch_heads<false>(p, grid, replicas, smem, s);
}

const char* mha_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
