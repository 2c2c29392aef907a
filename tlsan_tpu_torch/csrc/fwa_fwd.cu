// Feature-wise attention (FWA) forward for Hopper (sm_90a), f32.
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
// S = 25, D = 64) the kernel reads x once (0.33 MB and 0.82 MB, which is
// 0.10 and 0.25 µs at 3.35 TB/s) and does about 3 and 9 MFLOP (0.05 and
// 0.13 µs at 67 TFLOP/s f32): bytes bound it, and at these sizes launch
// latency, not the card, sets its time.
//
// Design.  The TPU kernel lifted the 8×8 per-head maps to a block-diagonal
// [D, D] matrix to feed its 128×128 matrix unit; that lift is not carried
// over: 8×8 maps are below any tensor-core tile, so each head's maps run on
// CUDA cores in f32.  One thread owns one feature d of one batch row; a
// block holds `rows` rows (blockDim = (D, rows)).  The row's [S, D] x tile
// and the block's weights live in shared memory, m1 goes through shared
// memory (map2 needs the dh features of the head), and m2 stays in the
// thread's own shared-memory column for the two-pass max/sum softmax.
// x is read from device memory once, and only out is written.
//
// Exactness: expf (not __expf), no fast-math, and the mask is the additive
// −1e30 of the reference, so a row of length 0 gets a uniform softmax over
// all S and returns the mean of x, as in the JAX package (−inf, or skipping
// masked steps, would give NaN or another answer).

#include <cuda_runtime.h>

namespace {

constexpr float kVeryNegative = -1e30f;
// per-block shared-memory budget that needs no opt-in
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxRows = 8;

__global__ void fwa_fwd_kernel(const float* __restrict__ x,
                               const int* __restrict__ lengths,
                               const float* __restrict__ w1,
                               const float* __restrict__ b1,
                               const float* __restrict__ w2,
                               const float* __restrict__ b2,
                               float* __restrict__ out,
                               int B, int S, int D, int dh) {
  extern __shared__ float smem[];
  const int rows = blockDim.y;
  const int d = threadIdx.x;
  const int r = threadIdx.y;
  const int tid = r * D + d;
  const int nthreads = rows * D;
  const int b = blockIdx.x * rows + r;
  const bool active = b < B;

  float* w1s = smem;
  float* w2s = w1s + dh * dh;
  float* b1s = w2s + dh * dh;
  float* b2s = b1s + dh;
  float* xs = b2s + dh + r * 3 * S * D;  // this row's [S, D] tiles
  float* m1s = xs + S * D;
  float* m2s = m1s + S * D;

  for (int i = tid; i < dh * dh; i += nthreads) {
    w1s[i] = w1[i];
    w2s[i] = w2[i];
  }
  for (int i = tid; i < dh; i += nthreads) {
    b1s[i] = b1[i];
    b2s[i] = b2[i];
  }
  if (active) {
    const float* xb = x + static_cast<long long>(b) * S * D;
    for (int t = 0; t < S; ++t) xs[t * D + d] = xb[t * D + d];
  }
  __syncthreads();

  const int h0 = (d / dh) * dh;  // first feature of this thread's head
  const int e = d - h0;          // this thread's column of the head map
  if (active) {
    for (int t = 0; t < S; ++t) {
      float z = b1s[e];
      for (int k = 0; k < dh; ++k) z = fmaf(xs[t * D + h0 + k], w1s[k * dh + e], z);
      m1s[t * D + d] = fmaxf(z, 0.0f);
    }
  }
  __syncthreads();
  if (!active) return;

  const int len = lengths[b];
  float mx = kVeryNegative;
  for (int t = 0; t < S; ++t) {
    float z = b2s[e];
    for (int k = 0; k < dh; ++k) z = fmaf(m1s[t * D + h0 + k], w2s[k * dh + e], z);
    z = z + (t < len ? 0.0f : kVeryNegative);
    m2s[t * D + d] = z;
    mx = t == 0 ? z : fmaxf(mx, z);
  }
  float sum = 0.0f;
  for (int t = 0; t < S; ++t) {
    const float ev = expf(m2s[t * D + d] - mx);
    m2s[t * D + d] = ev;
    sum += ev;
  }
  float acc = 0.0f;
  for (int t = 0; t < S; ++t) acc = fmaf(m2s[t * D + d] / sum, xs[t * D + d], acc);
  out[static_cast<long long>(b) * D + d] = acc;
}

// Shared memory one block needs for `rows` batch rows.
int fwa_fwd_smem_bytes(int S, int D, int dh, int rows) {
  return static_cast<int>(sizeof(float)) * (2 * dh * dh + 2 * dh + rows * 3 * S * D);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
// The caller has checked shapes, types, devices and contiguity.
int fwa_fwd_launch(const float* x, const int* lengths, const float* w1,
                   const float* b1, const float* w2, const float* b2,
                   float* out, int B, int S, int D, int dh, void* stream) {
  int rows = kMaxRows;
  while (rows > 1 && (rows * D > 1024 || fwa_fwd_smem_bytes(S, D, dh, rows) > kDefaultSmem)) {
    --rows;
  }
  const int smem = fwa_fwd_smem_bytes(S, D, dh, rows);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwa_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(D, rows);
  const dim3 grid((B + rows - 1) / rows);
  fwa_fwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      x, lengths, w1, b1, w2, b2, out, B, S, D, dh);
  return static_cast<int>(cudaGetLastError());
}

const char* fwa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
