// Multi-head attention (ATRank) forward for Hopper (sm_90a), f32.
//
// Replaces: tlsan_tpu/ops/pallas/mha.py::_mha_kernel (launched by
// _mha_forward).  Semantics are those of
// tlsan_tpu/ops/multihead_attention.py::multihead_attention, for each batch
// row b:
//
//   Q = relu(q·Wq + bq), K = relu(k·Wk + bk), V = relu(k·Wv + bv);
//   per head h (columns h·dh .. h·dh+dh-1 of each projection):
//     scores = Q_h·K_hᵀ / √dh, keys at t >= k_len[b] set to −2³²+1,
//     softmax over the keys, query rows at t >= q_len[b] zeroed,
//     o_h = soft·V_h;
//   out = LayerNorm(concat_h o_h + q) with γ, β and eps 1e-8 (biased
//   variance).
//
// What bounds it on the H100: operations.  At the ATRank main-path shapes
// (D = 64, H = 8, T = 96) one row does (Tq + 2·Tk)·D² multiply-adds in the
// projections and 2·Tq·Tk·D in the attention: at B = 128 that is 0.60
// GFLOP for the self-attention block (Tq = Tk = 96; 9.0 µs at the 67
// TFLOP/s f32 peak outside the tensor cores) against 9.4 MB of inputs and
// output (2.8 µs at 3.35 TB/s), and 0.21 GFLOP for the readout (Tq = 1).
// TF32 is off by contract, so the tensor cores are not an option.
//
// Design.  One block of 512 threads holds one batch row: its q and k
// tiles, the three [D, D] weights, and Q, K and V, all in shared memory
// (dynamic, opted in above 48 KB: 177,920 bytes at Tq = Tk = 96, and
// 220,416 bytes at the largest shapes it takes, Tq = Tk = 128 at D = 64),
// so only q, k, the weights and out touch device memory.  Q, K and V rows
// are padded by 4 floats, so lanes reading different rows as float4 hit
// different banks.  The projections are a register-tiled product: each
// thread owns one output column and 6 rows, reading the row of x as float4
// (a broadcast within a warp) and the column of W once per 6 multiply-adds.
// Attention gives each query row to a group of lanes (one lane at Tq >= 32,
// the whole warp at Tq = 1, where the group splits the keys and reduces by
// shuffles) and deals the (head, 32 / group rows) units to the 16 warps in
// turn; each group makes two passes over the keys (the max, then exp, sum
// and the weighted V), so no [Tq, Tk] score tile is stored, and the key
// loops are unrolled by 4 for independent work between the shared-memory
// loads.  The output overwrites Q in place (each group reads and writes
// only its own head's columns of its row), and LayerNorm takes one warp a
// row with a butterfly reduction.  Every sum runs in a fixed order: two
// calls on the same inputs agree bit for bit.  With one block a row and one
// block an SM, a batch of B rows fills min(B, 132) SMs with 16 warps each;
// splitting the query rows across blocks is the next step.
//
// Exactness: expf (not __expf), IEEE division and sqrtf, no fast math;
// the scores are q·k with q scaled once by 1/√dh, as the Pallas kernel
// does (the reference divides each score by √dh: the two differ in the
// last bit).
// The key mask is the reference's finite −2³²+1 (−4294967296 in f32), not
// −inf, and no masked key is skipped in the softmax: a row with k_len = 0
// gets a softmax uniform over all Tk keys, padding included, as in the JAX
// package.  Query rows at t >= q_len get o = 0, so out = LayerNorm(q).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kKeyMask = -4294967296.0f;  // -(2^32) + 1 rounded to f32
constexpr float kLnEps = 1e-8f;
constexpr int kThreads = 512;
constexpr int kHeadWidth = 8;  // dh = D / H, the reference's 64 / 8 (the only one taken)
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 6;       // projection rows a thread owns per pass
constexpr int kMaxLnPerLane = 8;  // D <= 256 = 32 lanes x 8
constexpr int kMaxSmem = 232448;  // the H100's per-block opt-in limit
constexpr int kDefaultSmem = 48 * 1024;
// Q, K and V rows are D + kPad floats apart, so that lanes reading
// different rows as float4 hit different banks
constexpr int kPad = 4;

// out[r·ld + c] = relu(x[r, :]·w[:, c] + b[c]) for r < R, all in shared
// memory.
__device__ void project_relu(const float* x, const float* w, const float* b,
                             float* out, int R, int D, int ld) {
  const int groups = kThreads / D;
  const int c = threadIdx.x % D;
  const int g = threadIdx.x / D;
  for (int r0 = 0; r0 < R; r0 += groups * kRowTile) {
    float acc[kRowTile];
    const float* xr[kRowTile];
#pragma unroll
    for (int i = 0; i < kRowTile; ++i) {
      acc[i] = 0.0f;
      xr[i] = x + min(r0 + g + groups * i, R - 1) * D;
    }
    for (int k = 0; k < D; k += 4) {
      const float w0 = w[(k + 0) * D + c];
      const float w1 = w[(k + 1) * D + c];
      const float w2 = w[(k + 2) * D + c];
      const float w3 = w[(k + 3) * D + c];
#pragma unroll
      for (int i = 0; i < kRowTile; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(xr[i] + k);
        acc[i] = fmaf(xv.x, w0, acc[i]);
        acc[i] = fmaf(xv.y, w1, acc[i]);
        acc[i] = fmaf(xv.z, w2, acc[i]);
        acc[i] = fmaf(xv.w, w3, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowTile; ++i) {
      const int r = r0 + g + groups * i;
      if (r < R) out[r * ld + c] = fmaxf(acc[i] + b[c], 0.0f);
    }
  }
}

// One head's score of query row q (already scaled by 1/√dh) against key
// row kr, both dh wide.
__device__ __forceinline__ float score(const float (&q)[kHeadWidth], const float* kr) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kHeadWidth; j += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(kr + j);
    s = fmaf(q[j], kv.x, s);
    s = fmaf(q[j + 1], kv.y, s);
    s = fmaf(q[j + 2], kv.z, s);
    s = fmaf(q[j + 3], kv.w, s);
  }
  return s;
}

// Attention of every (head, query row): reads Qs, Ks, Vs (rows ld apart)
// and writes the head outputs over Qs.  `group` lanes (a power of two)
// share a row; a warp takes 32 / group rows of one head at a time, and the
// (head, rows) units are dealt to the warps in turn.
__device__ void attend(float* Qs, const float* Ks, const float* Vs, int Tq,
                       int Tk, int ld, int H, int q_len, int k_len, int group,
                       float inv_scale) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % group;
  const int rows_per_warp = 32 / group;
  const int units = H * ((Tq + rows_per_warp - 1) / rows_per_warp);
  for (int unit = warp; unit < units; unit += kWarps) {
    const int h = unit % H;
    const int t = (unit / H) * rows_per_warp + lane / group;
    float* qrow = Qs + min(t, Tq - 1) * ld + h * kHeadWidth;
    float q[kHeadWidth];
#pragma unroll
    for (int j = 0; j < kHeadWidth; j += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + j);
      q[j] = qv.x;
      q[j + 1] = qv.y;
      q[j + 2] = qv.z;
      q[j + 3] = qv.w;
    }
#pragma unroll
    for (int j = 0; j < kHeadWidth; ++j) q[j] *= inv_scale;

    float m = -INFINITY;
#pragma unroll 4
    for (int k = sub; k < Tk; k += group) {
      const float s = k < k_len ? score(q, Ks + k * ld + h * kHeadWidth) : kKeyMask;
      m = fmaxf(m, s);
    }
    for (int off = group / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

    float sum = 0.0f;
    float acc[kHeadWidth];
#pragma unroll
    for (int j = 0; j < kHeadWidth; ++j) acc[j] = 0.0f;
#pragma unroll 4
    for (int k = sub; k < Tk; k += group) {
      const float s = k < k_len ? score(q, Ks + k * ld + h * kHeadWidth) : kKeyMask;
      const float e = expf(s - m);
      sum += e;
      const float* vr = Vs + k * ld + h * kHeadWidth;
#pragma unroll
      for (int j = 0; j < kHeadWidth; j += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + j);
        acc[j] = fmaf(e, vv.x, acc[j]);
        acc[j + 1] = fmaf(e, vv.y, acc[j + 1]);
        acc[j + 2] = fmaf(e, vv.z, acc[j + 2]);
        acc[j + 3] = fmaf(e, vv.w, acc[j + 3]);
      }
    }
    for (int off = group / 2; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
      for (int j = 0; j < kHeadWidth; ++j)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
    if (sub == 0 && t < Tq) {
      const bool live = t < q_len;  // query-mask zeroing
#pragma unroll
      for (int j = 0; j < kHeadWidth; ++j) qrow[j] = live ? acc[j] / sum : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const float* __restrict__ queries, const float* __restrict__ keys,
               const int* __restrict__ q_len, const int* __restrict__ k_len,
               const float* __restrict__ wq, const float* __restrict__ bq,
               const float* __restrict__ wk, const float* __restrict__ bk,
               const float* __restrict__ wv, const float* __restrict__ bv,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               float* __restrict__ out, int Tq, int Tk, int D, int H,
               int group, float inv_scale) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // wq, wk, wv [D, D] each
  float* bs = ws + 3 * D * D;                   // bq, bk, bv, gamma, beta
  float* qin = bs + 5 * D;                      // [Tq, D]
  float* kin = qin + Tq * D;                    // [Tk, D]
  const int ld = D + kPad;
  float* Qs = kin + Tk * D;                     // [Tq, ld], then the head outputs
  float* Ks = Qs + Tq * ld;                     // [Tk, ld]
  float* Vs = Ks + Tk * ld;                     // [Tk, ld]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  // unrolled so that each thread keeps several device-memory loads in flight
#pragma unroll 4
  for (int i = tid; i < D * D; i += kThreads) {
    ws[i] = wq[i];
    ws[D * D + i] = wk[i];
    ws[2 * D * D + i] = wv[i];
  }
  for (int i = tid; i < D; i += kThreads) {
    bs[i] = bq[i];
    bs[D + i] = bk[i];
    bs[2 * D + i] = bv[i];
    bs[3 * D + i] = gamma[i];
    bs[4 * D + i] = beta[i];
  }
  const float* qb = queries + static_cast<long long>(b) * Tq * D;
  const float* kb = keys + static_cast<long long>(b) * Tk * D;
#pragma unroll 4
  for (int i = tid; i < Tq * D; i += kThreads) qin[i] = qb[i];
#pragma unroll 4
  for (int i = tid; i < Tk * D; i += kThreads) kin[i] = kb[i];
  __syncthreads();

  project_relu(qin, ws, bs, Qs, Tq, D, ld);
  project_relu(kin, ws + D * D, bs + D, Ks, Tk, D, ld);
  project_relu(kin, ws + 2 * D * D, bs + 2 * D, Vs, Tk, D, ld);
  __syncthreads();

  attend(Qs, Ks, Vs, Tq, Tk, ld, H, q_len[b], k_len[b], group, inv_scale);
  __syncthreads();

  // out = LayerNorm(o + q), one warp a row, butterfly sums (fixed order)
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* ob = out + static_cast<long long>(b) * Tq * D;
  for (int t = warp; t < Tq; t += kWarps) {
    float y[kMaxLnPerLane];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxLnPerLane; ++i) {
      const int c = lane + 32 * i;
      y[i] = c < D ? Qs[t * ld + c] + qin[t * D + c] : 0.0f;
      sum += y[i];
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mean = sum / D;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxLnPerLane; ++i) {
      y[i] = lane + 32 * i < D ? y[i] - mean : 0.0f;
      sq = fmaf(y[i], y[i], sq);
    }
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float denom = sqrtf(sq / D + kLnEps);
#pragma unroll
    for (int i = 0; i < kMaxLnPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < D) ob[t * D + c] = bs[3 * D + c] * y[i] / denom + bs[4 * D + c];
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs; the wrapper refuses shapes above
// mha_fwd_max_smem_bytes().
int mha_fwd_smem_bytes(int Tq, int Tk, int D) {
  return static_cast<int>(sizeof(float)) *
         (3 * D * D + 5 * D + (Tq + Tk) * D + (Tq + 2 * Tk) * (D + kPad));
}

int mha_fwd_max_smem_bytes() { return kMaxSmem; }

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
// The caller has checked shapes, types, devices and contiguity, that
// D = 8·H divides 256, and that mha_fwd_smem_bytes fits.
int mha_fwd_launch(const float* queries, const float* keys, const int* q_len,
                   const int* k_len, const float* wq, const float* bq,
                   const float* wk, const float* bk, const float* wv,
                   const float* bv, const float* gamma, const float* beta,
                   float* out, int B, int Tq, int Tk, int D, int H,
                   void* stream) {
  if (D != kHeadWidth * H) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = mha_fwd_smem_bytes(Tq, Tk, D);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        mha_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int rows = 1;  // query rows a warp takes at once: Tq rounded up to 2^n, at most 32
  while (rows < Tq && rows < 32) rows <<= 1;
  const float inv_scale = 1.0f / sqrtf(static_cast<float>(kHeadWidth));
  mha_fwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      queries, keys, q_len, k_len, wq, bq, wk, bk, wv, bv, gamma, beta, out,
      Tq, Tk, D, H, 32 / rows, inv_scale);
  return static_cast<int>(cudaGetLastError());
}

const char* mha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
