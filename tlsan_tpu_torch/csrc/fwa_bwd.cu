// Feature-wise attention (FWA) backward for Hopper (sm_90a), f32.
//
// Replaces: tlsan_tpu/ops/pallas/fwa.py::_fwa_bwd_kernel (launched by
// _fwa_backward) and the _block_diag_extract fold after it.  Given the
// forward's inputs and the incoming gradient g = dL/dout [B, D], it
// recomputes the forward (as csrc/fwa_fwd.cu does) and returns
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
// and at these sizes launch latency, not the card, sets its time.
//
// Design.  As in the forward, the TPU kernel's block-diagonal lift is not
// carried over: 8×8 maps are below any tensor-core tile, so each head's maps
// run on CUDA cores in f32.  One thread owns one feature d of one batch row;
// a block holds `rows` rows (blockDim = (D, rows)).  Per row, shared memory
// holds five [S, D] tiles — x, m1, soft, dm2, dz1 — since dm2 · W2ᵀ and
// dz1 · W1ᵀ read the dh features of the thread's head.  Only dx leaves the
// first kernel per row.
//
// Determinism: no float atomics.  Each block writes its partial sums of
// the [2·dh² + 2·dh] weight gradients to its own slot of a scratch buffer,
// each entry summed by one thread in a fixed order (rows, then t, then
// heads); a second kernel sums the slots in block order.  Two calls on the
// same inputs give bitwise-equal outputs.
//
// Exactness: expf (not __expf), no fast-math, and the mask is the additive
// −1e30 of the reference.  A row of length 0 has every step masked; its
// softmax is uniform and its gradients are not zero (dm2 flows through the
// mask's addition), as in the JAX package, so nothing is skipped.  Rows past
// B are never read and never enter a partial sum.

#include <cuda_runtime.h>

namespace {

constexpr float kVeryNegative = -1e30f;
// per-block shared-memory budget that needs no opt-in
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxRows = 8;
// [S, D] tiles a row keeps in shared memory, in this order
enum Tile { kX, kM1, kSoft, kDm2, kDz1, kTiles };
constexpr int kReduceThreads = 256;

__global__ void fwa_bwd_kernel(const float* __restrict__ x,
                               const int* __restrict__ lengths,
                               const float* __restrict__ w1,
                               const float* __restrict__ b1,
                               const float* __restrict__ w2,
                               const float* __restrict__ b2,
                               const float* __restrict__ g,
                               float* __restrict__ dx,
                               float* __restrict__ partial,
                               int B, int S, int D, int dh) {
  extern __shared__ float smem[];
  const int rows = blockDim.y;
  const int d = threadIdx.x;
  const int r = threadIdx.y;
  const int tid = r * D + d;
  const int nthreads = rows * D;
  const int b = blockIdx.x * rows + r;
  const bool active = b < B;
  const int SD = S * D;

  float* w1s = smem;
  float* w2s = w1s + dh * dh;
  float* b1s = w2s + dh * dh;
  float* b2s = b1s + dh;
  float* tiles = b2s + dh;  // rows × kTiles × [S, D]
  float* row = tiles + r * kTiles * SD;
  float* xs = row + kX * SD;
  float* m1s = row + kM1 * SD;
  float* ss = row + kSoft * SD;  // m2, then soft (each thread its own column)
  float* dm2s = row + kDm2 * SD;
  float* dz1s = row + kDz1 * SD;

  for (int i = tid; i < dh * dh; i += nthreads) {
    w1s[i] = w1[i];
    w2s[i] = w2[i];
  }
  for (int i = tid; i < dh; i += nthreads) {
    b1s[i] = b1[i];
    b2s[i] = b2[i];
  }
  if (active) {
    const float* xb = x + static_cast<long long>(b) * SD;
    for (int t = 0; t < S; ++t) xs[t * D + d] = xb[t * D + d];
  }
  __syncthreads();

  const int h0 = (d / dh) * dh;  // first feature of this thread's head
  const int e = d - h0;          // this thread's column of the head map
  if (active) {
    for (int t = 0; t < S; ++t) {
      float z = b1s[e];
      for (int k = 0; k < dh; ++k) z = fmaf(xs[t * D + h0 + k], w1s[k * dh + e], z);
      m1s[t * D + d] = fmaxf(z, 0.0f);  // m1 > 0 exactly where z1 > 0
    }
  }
  __syncthreads();

  float gd = 0.0f;
  if (active) {
    const int len = lengths[b];
    gd = g[static_cast<long long>(b) * D + d];
    float mx = kVeryNegative;
    for (int t = 0; t < S; ++t) {
      float z = b2s[e];
      for (int k = 0; k < dh; ++k) z = fmaf(m1s[t * D + h0 + k], w2s[k * dh + e], z);
      z = z + (t < len ? 0.0f : kVeryNegative);
      ss[t * D + d] = z;
      mx = t == 0 ? z : fmaxf(mx, z);
    }
    float sum = 0.0f;
    for (int t = 0; t < S; ++t) {
      const float ev = expf(ss[t * D + d] - mx);
      ss[t * D + d] = ev;
      sum += ev;
    }
    float sds = 0.0f;  // Σ_t soft ⊙ ds
    for (int t = 0; t < S; ++t) {
      const float s = ss[t * D + d] / sum;
      ss[t * D + d] = s;
      sds = fmaf(s, gd * xs[t * D + d], sds);
    }
    for (int t = 0; t < S; ++t) {
      dm2s[t * D + d] = ss[t * D + d] * (gd * xs[t * D + d] - sds);
    }
  }
  __syncthreads();

  if (active) {
    for (int t = 0; t < S; ++t) {
      float dm1 = 0.0f;  // (dm2 · W2ᵀ)[e]
      for (int j = 0; j < dh; ++j) dm1 = fmaf(dm2s[t * D + h0 + j], w2s[e * dh + j], dm1);
      dz1s[t * D + d] = m1s[t * D + d] > 0.0f ? dm1 : 0.0f;
    }
  }
  __syncthreads();

  if (active) {
    float* dxb = dx + static_cast<long long>(b) * SD;
    for (int t = 0; t < S; ++t) {
      float acc = 0.0f;  // (dz1 · W1ᵀ)[e]
      for (int j = 0; j < dh; ++j) acc = fmaf(dz1s[t * D + h0 + j], w1s[e * dh + j], acc);
      dxb[t * D + d] = fmaf(ss[t * D + d], gd, acc);
    }
  }

  // This block's partial sums over its valid rows, each entry by one
  // thread in a fixed order.  Layout: dW1 [dh·dh] | db1 [dh] | dW2 [dh·dh] |
  // db2 [dh].
  const int nrows = min(rows, B - static_cast<int>(blockIdx.x) * rows);
  const int heads = D / dh;
  const int P = 2 * dh * dh + 2 * dh;
  float* out = partial + static_cast<long long>(blockIdx.x) * P;
  for (int i = tid; i < P; i += nthreads) {
    // entry i is Σ left[k] · right[col] over (row, t, head), or Σ right[col]
    // where there is no left factor
    int left = -1, right, k = 0, col, j = i;
    if (j < dh * dh) {
      left = kX, right = kDz1, k = j / dh, col = j % dh;
    } else if ((j -= dh * dh) < dh) {
      right = kDz1, col = j;
    } else if ((j -= dh) < dh * dh) {
      left = kM1, right = kDm2, k = j / dh, col = j % dh;
    } else {
      right = kDm2, col = j - dh * dh;
    }
    float acc = 0.0f;
    for (int rr = 0; rr < nrows; ++rr) {
      for (int t = 0; t < S; ++t) {
        for (int h = 0; h < heads; ++h) {
          const float* at = tiles + rr * kTiles * SD + t * D + h * dh;
          const float cv = at[right * SD + col];
          acc = left < 0 ? acc + cv : fmaf(at[left * SD + k], cv, acc);
        }
      }
    }
    out[i] = acc;
  }
}

// out[i] = Σ over blocks, in block order, of partial[blk, i]; then split
// into the four gradients.
__global__ void fwa_bwd_reduce_kernel(const float* __restrict__ partial,
                                      int nblocks, int dh,
                                      float* __restrict__ dw1,
                                      float* __restrict__ db1,
                                      float* __restrict__ dw2,
                                      float* __restrict__ db2) {
  const int P = 2 * dh * dh + 2 * dh;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  float acc = 0.0f;
  for (int blk = 0; blk < nblocks; ++blk) acc += partial[static_cast<long long>(blk) * P + i];
  if (i < dh * dh) {
    dw1[i] = acc;
  } else if ((i -= dh * dh) < dh) {
    db1[i] = acc;
  } else if ((i -= dh) < dh * dh) {
    dw2[i] = acc;
  } else {
    db2[i - dh * dh] = acc;
  }
}

// Shared memory one block needs for `rows` batch rows.
int fwa_bwd_smem_bytes(int S, int D, int dh, int rows) {
  return static_cast<int>(sizeof(float)) *
         (2 * dh * dh + 2 * dh + rows * kTiles * S * D);
}

int fwa_bwd_rows(int S, int D, int dh) {
  int rows = kMaxRows;
  while (rows > 1 && (rows * D > 1024 || fwa_bwd_smem_bytes(S, D, dh, rows) > kDefaultSmem)) {
    --rows;
  }
  return rows;
}

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for `fwa_bwd_launch`'s partials.
long long fwa_bwd_scratch_floats(int B, int S, int D, int dh) {
  const int rows = fwa_bwd_rows(S, D, dh);
  const long long nblocks = (B + rows - 1) / rows;
  return nblocks * (2 * dh * dh + 2 * dh);
}

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = both
// launched).  The caller has checked shapes, types, devices and contiguity,
// and allocated `partial` with fwa_bwd_scratch_floats(B, S, D, dh) floats.
int fwa_bwd_launch(const float* x, const int* lengths, const float* w1,
                   const float* b1, const float* w2, const float* b2,
                   const float* g, float* dx, float* partial, float* dw1,
                   float* db1, float* dw2, float* db2, int B, int S, int D,
                   int dh, void* stream) {
  const int rows = fwa_bwd_rows(S, D, dh);
  const int smem = fwa_bwd_smem_bytes(S, D, dh, rows);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwa_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = (B + rows - 1) / rows;
  fwa_bwd_kernel<<<nblocks, dim3(D, rows), smem, s>>>(
      x, lengths, w1, b1, w2, b2, g, dx, partial, B, S, D, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = 2 * dh * dh + 2 * dh;
  fwa_bwd_reduce_kernel<<<(P + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      partial, nblocks, dh, dw1, db1, dw2, db2);
  return static_cast<int>(cudaGetLastError());
}

const char* fwa_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
