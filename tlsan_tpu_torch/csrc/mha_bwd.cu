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
// What bounds it on the H100: operations, in f32 on the CUDA cores.  TF32
// is off by contract (docs/design.md, Numerics), so the tensor cores are
// not used and the ceiling is the 67 TFLOP/s f32 FMA rate.  A row
// recomputes the forward, (Tq + 2·Tk)·D² + 2·Tq·Tk·D multiply-adds, and
// does twice that backward: at B = 32, D = 64, Tq = Tk = 96 some 0.45
// GFLOP (6.7 µs at the f32 peak) against 1.6 MB of inputs and gradients
// (0.5 µs at 3.35 TB/s).  At the training batch (32 rows) one CTA a row
// would leave 100 of 132 SMs idle, so the design spreads a row over
// several SMs, computes each score (and each dP) once, keeps the
// probabilities in shared memory, and gives the products register tiles
// or lane groups with independent accumulators.
//
// Design.
//   A thread-block cluster of cs CTAs (1, 2, 4 or 8; ops/cuda/mha.py::
//   backward_plan: the largest whose clusters hold the batch in one wave)
//   takes a batch row; CTA c owns heads c·H/cs .. (c+1)·H/cs − 1, i.e. the
//   columns of those heads in every projection.  256 threads, at most 128
//   registers each, so that two CTAs fit an SM.  Each CTA
//     1. projects its own columns, Q_c = relu(xq·Wq[:, c] + bq[c]) and K_c,
//        V_c likewise (4 × 4 register tiles over the full D-wide x rows,
//        a tile's rows a quarter of the rows apart);
//     2. for each block of qb query rows (the plan sizes qb so that the
//        block's probabilities fit in shared memory with everything else),
//        a group of lanes a (row, own head), the keys strided over the
//        group as in K3's readout: the scores once, into shared memory;
//        their max, expf and sum folded over the group by shuffles; P₀
//        written over them and kept (under dropout a dropped P₀ is stored
//        negative: its sign is the keep flag); O = P′·V, folded likewise.
//        The readout's single query row so runs on 32 lanes a head;
//     3. LayerNorm's backward over the block's rows: its per-row sums
//        couple the heads, so each CTA sums its own columns, centred at
//        their own mean (Σy, Σ(y − mean_c)², Σdŷ, Σdŷ·(y − mean_c)), the
//        cluster exchanges these once through distributed shared memory,
//        and each CTA combines them in rank order (Chan's parallel
//        variance); dy on the own columns; then D = dy·O per row and head,
//        dγ and dβ per column, beside dV += P′ᵀ·dy (4 keys × 4 columns
//        register tiles, the rows split over a group of lanes);
//     4. dS = P₀ ⊙ (dP₀ − D) over P and dQ = dS·K in one group pass as in
//        2, then dK += dSᵀ·Q as in dV's tiles; dK and dV accumulate across
//        blocks in the CTA's own memory;
//     5. after the last block: the ReLU masks, then the weight gradients of
//        its columns, dW[:, c] = xᵀ·dpre and db, added to its slot; then
//        its partial input gradients dQpre_c·Wq[:, c]ᵀ and dKpre_c·Wk[:,
//        c]ᵀ + dVpre_c·Wv[:, c]ᵀ, [T, D] each, which the cluster exchanges
//        through distributed shared memory: CTA c adds the peers' partials
//        of its own D/cs output columns in rank order (plus dy for the
//        queries) and writes them.
//   A CTA's column slices of Wq, Wk and Wv (3·D·D/cs floats), the biases
//   and γ go into shared memory once a launch, by cp.async, and stay; the
//   layout's offsets come from constant memory (computed on the host).
//   The grid is persistent and of fixed size: cluster i takes the rows i,
//   i + clusters, ... of its replica, so the scratch does not grow with B.
//   The own columns of the next row's xq and g are prefetched by cp.async
//   while the current row finishes.  A row's x rows (xq and xk, one copy
//   for self-attention) are loaded by cp.async into the block region for
//   the projections and reloaded there for the weight gradients.  The
//   keep mask is read where P₀ is stored.  Shapes whose buffers do not fit
//   one CTA's shared memory run at cs = 1 with the same layout in a slice
//   of device memory that the CTA alone uses (x read where it lies; the
//   generic variant), so every shape K3 takes runs.  Every row of a CTA's
//   own-column arrays is padded by 4 floats, so lanes reading consecutive
//   rows as float4 hit distinct banks; a head's columns are padded to a
//   multiple of 4 (zeros) for a width that is not one.
//
// Cluster barriers: every exchange is a barrier.cluster arrive (release)
// and wait (acquire) on both sides.  LayerNorm's exchange buffer is double
// buffered by the query block's parity: a CTA writes a block's sums only
// after the barrier of the block before, which no peer passes before it
// has read the sums of the block before that, in the other buffer.  The
// input gradients' exchange of a row ends in one more barrier, so no CTA
// overwrites its region (nor its exchange buffer at the next row's first
// block) or leaves while a peer still reads them.
//
// The weight gradients are summed in a fixed order, without float atomics,
// so that two calls agree bit for bit: over a CTA's rows in row order, into
// its slot in device memory (one slot per CTA: the columns of its rank);
// then, for each rank, over the clusters by a tree of groups of kGroup
// slots (csrc/fwa_bwd.cu's): each CTA takes a ticket (an atomic integer
// increment after a __threadfence) after all of its rows; the last CTA of
// a group sums the group's slots in slot order into one slot of the next
// level and resets the group's ticket, until one group is left, whose last
// CTA writes its rank's columns of the gradients.  The tickets start at 0
// and are 0 again when the launch ends.
//
// Replicas.  A replica axis of weights (every tensor [R·B, ...] or [R,
// ...]) is the grid's y axis: CTAs (·, r) take replica r's rows with its
// weights, into its own slots, tickets and workspace, with the geometry of
// one replica's launch, so replica r's gradients are bit for bit those of
// a launch on its slice alone.
//
// Dropout (train time) is the DROP variant: the forward's keep mask ([B, H,
// Tq, Tk] bytes) and keep = 1 − rate, read once, where P₀ is stored; a null
// mask selects the variant without dropout.
//
// dh = 8, 16 and 32 are specialised (a head's columns as float4s, loops
// unrolled); any other dh <= 32 at D <= 256 runs a generic variant.  The
// wide variant (WIDE) takes heads of any width and D up to 512 (a multiple
// of 4): it is the generic one but for the two passes that hold a head's
// features in registers (2 and 4a), which read a dot product's operands
// from the layout and sum O = P′·V and dQ = dS·K 32 features at a time, so
// no register array grows with dh.  Tq and Tk are bounded by nothing but
// memory.
//
// Exactness: expf (not __expf), IEEE division and sqrtf, no fast math.  The
// scores are q·k scaled by 1/√dh (the reference divides by √dh: the two
// differ in the last bit); the key mask is the reference's finite −2³²+1,
// so a row with k_len = 0 has a softmax uniform over all Tk keys and a
// non-zero dV at every key, and dS = 0 at masked keys.  Query rows at
// t >= q_len pass dy to the queries through the residual alone.  The
// LayerNorm sums and the input gradients are summed per CTA and then over
// the ranks, an order of f32 sums other than the plain version's.

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
constexpr int kMaxDh = 32;
constexpr int kMaxD = 256;
constexpr int kWideMaxD = 512;  // the wide variant's
constexpr int kWideChunk = 32;  // its features summed at once
constexpr int kPad = 4;  // floats after each row of a shared array
constexpr int kMaxCs = 8;  // the largest cluster
// slots summed together at each level of the cross-CTA tree;
// ops/cuda/mha.py::backward_plan sizes the scratch with the same number
constexpr int kGroup = 16;
constexpr int kMaxDevices = 64;
// where a row's x rows live (ops/cuda/mha.py's X_REGION, X_GLOBAL): the
// block region, reloaded for the weight gradients; device memory, read
// where they lie (the device-memory workspace)
constexpr int kXRegion = 0, kXGlobal = 1;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// A CTA's arrays, offsets in floats (ops/cuda/mha.py::_bwd_layout mirrors
// it): the column slices of the weights [3][D][ldc], the biases and γ; Q,
// O (then dQ, then dQpre), dy, and the own columns of xq and g [Tq4][ldc];
// K, V, dK and dV [Tk4][ldc]; the
// block's D per (row, head), its rows' mean and σ, and the exchange of
// LayerNorm's sums [2][qb][4] (by the block's parity); dγ and dβ of the
// row; the region (the block's P, x, the partial input gradients).
struct Layout {
  int hc, dhp, Dcp, Dc, ldc, ldx, ldp, Tq4, Tk4, xrows, region;
  int w, bias, q, o, dy, xr, gs, k, v, dk, dv, drow, rowst, ex, dgb, reg, total;
};

inline Layout make_layout(int Tq, int Tk, int D, int H, int dh, int cs,
                                              int qb, int xmode, int alias) {
  Layout L;
  L.hc = H / cs;
  L.dhp = round4(dh);
  L.Dcp = L.hc * L.dhp;
  L.Dc = L.hc * dh;
  L.ldc = L.Dcp + kPad;
  L.ldx = D + kPad;
  L.Tq4 = round4(Tq);
  L.Tk4 = round4(Tk);
  L.ldp = L.Tk4 + kPad;
  L.xrows = Tq + (alias ? 0 : Tk);
  int off = 0;
  L.w = off, off += 3 * D * L.ldc;
  L.bias = off, off += 4 * L.Dcp;
  L.q = off, off += L.Tq4 * L.ldc;
  L.o = off, off += L.Tq4 * L.ldc;
  L.dy = off, off += L.Tq4 * L.ldc;
  L.xr = off, off += L.Tq4 * L.ldc;
  L.gs = off, off += L.Tq4 * L.ldc;
  L.k = off, off += L.Tk4 * L.ldc;
  L.v = off, off += L.Tk4 * L.ldc;
  L.dk = off, off += L.Tk4 * L.ldc;
  L.dv = off, off += L.Tk4 * L.ldc;
  L.drow = off, off += round4(qb * L.hc);
  L.rowst = off, off += round4(2 * qb);
  L.ex = off, off += 2 * 4 * qb;
  L.dgb = off, off += round4(2 * L.Dc);
  const int maxT = Tq > Tk ? Tq : Tk;
  int region = L.hc * qb * L.ldp;
  region = region > maxT * L.ldx ? region : maxT * L.ldx;
  if (xmode == kXRegion) region = region > L.xrows * L.ldx ? region : L.xrows * L.ldx;
  L.reg = off;
  L.region = region;
  off += region;
  L.total = off;
  return L;
}

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
  float* work;  // the workspace in device memory, or null for shared memory
  int Tq, Tk, D, H, dh, rows;  // rows: the batch rows a replica
  int cs, clusters, qb, xmode, alias;
  int tree_slots, tree_tickets;
  float inv_scale;
  float keep;
  Layout L;  // computed on the host: offsets the kernel reads from constant memory
};

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

// acc[i][j] += a[i]·b[j] over the four components, in order
__device__ __forceinline__ void dot4_tile(float (&acc)[4][4], const float4 (&a)[4],
                                          const float4 (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = acc[i][j];
      s = fmaf(a[i].x, b[j].x, s);
      s = fmaf(a[i].y, b[j].y, s);
      s = fmaf(a[i].z, b[j].z, s);
      s = fmaf(a[i].w, b[j].w, s);
      acc[i][j] = s;
    }
}

__device__ __forceinline__ void zero_tile(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

// Folds a tile over the G lanes of a group (G a power of two <= 32,
// aligned in the warp): every lane ends with the group's sum, in a fixed
// order.  Every lane of the warp calls it.
__device__ __forceinline__ void group_sum(float (&acc)[4][4], int G) {
  for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
}

__device__ __forceinline__ float group_fold_sum(float v, int G) {
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float group_fold_max(float v, int G) {
  for (int off = G / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The largest power of two G <= min(32, cap) with tiles·G <= threads (at
// least 1): the groups' shuffles fold lanes a power of two apart.
__device__ __forceinline__ int group_size(int tiles, int threads, int cap = kWarp) {
  int G = 1;
  while (G < kWarp && 2 * G <= cap && tiles * G * 2 <= threads) G *= 2;
  return G;
}

// The cluster's barrier: arrive (release) after this CTA's last write of
// shared memory a peer reads, wait (acquire) before reading the peers'.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 16 bytes from device memory into the layout: by cp.async into shared
// memory, by a plain copy into the device-memory workspace.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool async) {
  if (async) {
    cp_async16(dst, src);
  } else {
    st4(dst, ldg4(src));
  }
}

// A row's x rows (xq's Tq, then xk's Tk unless they alias) into X, rows
// ldx apart, by cp.async; the caller commits and waits.
__device__ __forceinline__ void load_x(const float* xq, const float* xk, int Tq, int Tk, int D,
                                       bool alias, float* X, int ldx) {
  const int D4 = D / 4;
  const int n = (Tq + (alias ? 0 : Tk)) * D4;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int row = i / D4, c = i % D4 * 4;
    const float* src = row < Tq ? xq + row * D + c : xk + (row - Tq) * D + c;
    cp_async16(X + row * ldx + c, src);
  }
}

// The own columns of a row's xq and g (device memory, rows D apart, from
// column c0) into XR and GS (rows ldc apart, padded columns): by cp.async
// into shared memory (g 4 bytes at a time: it need not be 16-byte
// aligned), by plain copies into the device-memory workspace; padding is
// never read.
template <int DH>
__device__ __forceinline__ void load_own(const float* xq, const float* g, int Tq, int D, int c0,
                                         int Dc, int dh, int dhp, int ldc, float* XR, float* GS,
                                         bool async) {
  for (int i = threadIdx.x; i < Tq * Dc; i += kThreads) {
    const int t = i / Dc, c = i % Dc;
    const int pc = DH ? c : c / dh * dhp + c % dh;
    if (async) {
      cp_async4(GS + t * ldc + pc, g + t * D + c0 + c);
      if (DH != 0 && c % 4 == 0) cp_async16(XR + t * ldc + pc, xq + t * D + c0 + c);
      if (DH == 0) cp_async4(XR + t * ldc + pc, xq + t * D + c0 + c);
    } else {
      GS[t * ldc + pc] = __ldg(g + t * D + c0 + c);
      XR[t * ldc + pc] = __ldg(xq + t * D + c0 + c);
    }
  }
}

// The own column of padded column pc (heads of dhp columns, dh of them
// real), or -1 for padding.
template <int DH>
__device__ __forceinline__ int true_col(int pc, int dh, int dhp) {
  if constexpr (DH != 0) {
    return pc;
  } else {
    const int f = pc % dhp;
    return f < dh ? pc / dhp * dh + f : -1;
  }
}

// 1. Rows rq + i·nr (i < 4; nr = round4(T) / 4) of x [T, D] (rows ldx
// apart) times a column slice w [D][ldc], columns c .. c+3: relu(x·w + b)
// into o, rows ldc apart; rows from T up to round4(T) get 0.
__device__ __forceinline__ void project_tile(const float* x, int ldx, int T, int D, int rq,
                                             int nr, int c, const float* w, const float* bias,
                                             float* o, int ldc) {
  float acc[4][4];
  zero_tile(acc);
  const float* xr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) xr[i] = x + min(rq + i * nr, T - 1) * ldx;
  for (int k = 0; k < D; k += 4) {
    float4 xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = ld4(xr[i] + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 wv = ld4(w + (k + kk) * ldc + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xs = comp(xv[i], kk);
        acc[i][0] = fmaf(xs, wv.x, acc[i][0]);
        acc[i][1] = fmaf(xs, wv.y, acc[i][1]);
        acc[i][2] = fmaf(xs, wv.z, acc[i][2]);
        acc[i][3] = fmaf(xs, wv.w, acc[i][3]);
      }
    }
  }
  const float4 bv = ld4(bias + c);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool live = rq + i * nr < T;
    st4(o + (rq + i * nr) * ldc + c,
        make_float4(live ? fmaxf(acc[i][0] + bv.x, 0.0f) : 0.0f,
                    live ? fmaxf(acc[i][1] + bv.y, 0.0f) : 0.0f,
                    live ? fmaxf(acc[i][2] + bv.z, 0.0f) : 0.0f,
                    live ? fmaxf(acc[i][3] + bv.w, 0.0f) : 0.0f));
  }
}

// A head's dhp features of a row (n4 float4s) into a[0 .. NR), the rest 0.
template <int NR>
__device__ __forceinline__ void load_head(const float* src, float (&a)[NR], int n4) {
#pragma unroll
  for (int f4 = 0; f4 < NR / 4; ++f4) {
    const float4 v = f4 < n4 ? ld4(src + 4 * f4) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    a[4 * f4] = v.x, a[4 * f4 + 1] = v.y, a[4 * f4 + 2] = v.z, a[4 * f4 + 3] = v.w;
  }
}

// a · b over a head's features (b in shared memory), in feature order
template <int NR>
__device__ __forceinline__ float dot_head(const float (&a)[NR], const float* b, int n4) {
  float s = 0.0f;
#pragma unroll
  for (int f4 = 0; f4 < NR / 4; ++f4) {
    if (f4 < n4) {
      const float4 v = ld4(b + 4 * f4);
      s = fmaf(a[4 * f4], v.x, s);
      s = fmaf(a[4 * f4 + 1], v.y, s);
      s = fmaf(a[4 * f4 + 2], v.z, s);
      s = fmaf(a[4 * f4 + 3], v.w, s);
    }
  }
  return s;
}

// acc += e · v over a head's features
template <int NR>
__device__ __forceinline__ void axpy_head(float e, const float* v, float (&acc)[NR], int n4) {
#pragma unroll
  for (int f4 = 0; f4 < NR / 4; ++f4) {
    if (f4 < n4) {
      const float4 w = ld4(v + 4 * f4);
      acc[4 * f4] = fmaf(e, w.x, acc[4 * f4]);
      acc[4 * f4 + 1] = fmaf(e, w.y, acc[4 * f4 + 1]);
      acc[4 * f4 + 2] = fmaf(e, w.z, acc[4 * f4 + 2]);
      acc[4 * f4 + 3] = fmaf(e, w.w, acc[4 * f4 + 3]);
    }
  }
}

// a · b over a head's features, both in the layout, in feature order
__device__ __forceinline__ float dot_rows(const float* a, const float* b, int n4) {
  float s = 0.0f;
  for (int f4 = 0; f4 < n4; ++f4) {
    const float4 u = ld4(a + 4 * f4), v = ld4(b + 4 * f4);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
    s = fmaf(u.z, v.z, s);
    s = fmaf(u.w, v.w, s);
  }
  return s;
}

// Folds a head's sums over the G lanes of a group (every lane of the warp
// calls it; n4 is the same for the whole warp).
template <int NR>
__device__ __forceinline__ void fold_head(float (&acc)[NR], int n4, int G) {
  for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
    for (int f4 = 0; f4 < NR / 4; ++f4)
      if (f4 < n4)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[4 * f4 + j] += __shfl_xor_sync(0xffffffffu, acc[4 * f4 + j], off);
}

// acc · mul into dst, a head's features
template <int NR>
__device__ __forceinline__ void store_head(float* dst, const float (&acc)[NR], float mul,
                                           int n4) {
#pragma unroll
  for (int f4 = 0; f4 < NR / 4; ++f4)
    if (f4 < n4)
      st4(dst + 4 * f4, make_float4(acc[4 * f4] * mul, acc[4 * f4 + 1] * mul,
                                    acc[4 * f4 + 2] * mul, acc[4 * f4 + 3] * mul));
}

// The wide variant's weighted sums: dst[f] = mul · Σ_k w(S[k]) · M[k][f]
// over the keys k = part, part + G, ... < T folded over the group, for
// the head's features (n4 float4s) kWideChunk at a time; S holds this
// lane's own entries (the ones it wrote), M's rows are ldc apart.  Under
// PROB and DROP a weight is P′ (a dropped probability, stored negative,
// counts 0).  Every lane of the warp calls it; the group's first lane
// writes.
template <bool DROP, bool PROB>
__device__ __forceinline__ void wide_weighted(const float* S, const float* M, int ldc, int T,
                                              int part, int G, int n4, bool write, float* dst,
                                              float mul) {
  for (int f0 = 0; f0 < n4; f0 += kWideChunk / 4) {
    const int c4 = min(kWideChunk / 4, n4 - f0);
    float a[kWideChunk];
#pragma unroll
    for (int f = 0; f < kWideChunk; ++f) a[f] = 0.0f;
    for (int k = part; k < T; k += G) {
      float w = S[k];
      if constexpr (DROP && PROB) w = fmaxf(w, 0.0f);
      axpy_head<kWideChunk>(w, M + k * ldc + 4 * f0, a, c4);
    }
    fold_head<kWideChunk>(a, c4, G);
    if (write) store_head<kWideChunk>(dst + 4 * f0, a, mul, c4);
  }
}

// A probability as the products read it: P′·kp (the dropped ones, stored
// negative, read as 0) or dS as stored.
template <bool DROP, bool PROB>
__device__ __forceinline__ float4 decode(float4 v) {
  if constexpr (DROP && PROB) {
    v.x = fmaxf(v.x, 0.0f), v.y = fmaxf(v.y, 0.0f), v.z = fmaxf(v.z, 0.0f), v.w = fmaxf(v.w, 0.0f);
  }
  return v;
}

// 3b and 4b. out[k][hoff + f] (+)= mul · Σ_t A_h[t][k]·B[t0 + t][hoff + f]
// over the block's nb rows, for every key k < Tk4 and own head: dV = P′ᵀ·dy
// (mul 1/keep under dropout) or dK = dSᵀ·Q.  Tiles of 4 keys × 4 columns;
// the rows split over a group of G lanes.  The block at t0 = 0 writes, the
// others add.  Run by threads [base, base + n).
template <bool DROP, bool PROB>
__device__ __forceinline__ void keys_times_rows(const float* P, int ldp, int qb, const float* B,
                                                int ldc, float* out, int t0, int nb, int Tk4,
                                                int hc, int dhp, float mul, int base,
                                                int n) {
  if (threadIdx.x < base || threadIdx.x >= base + n) return;  // whole warps
  const int nk = Tk4 / 4, nf = dhp / 4;
  const int tiles = hc * nk * nf;
  const int G = group_size(tiles, n);
  const int me = threadIdx.x - base;
  for (int u0 = 0; u0 < tiles * G; u0 += n) {
    const int u = u0 + me;
    const bool valid = u < tiles * G;
    const int tile = (valid ? u : tiles * G - 1) / G, part = u % G;
    const int kq = tile % nk, rest = tile / nk, fq = rest % nf, hl = rest / nf;
    const int hoff = hl * dhp + 4 * fq;
    const float* A = P + hl * qb * ldp + 4 * kq;
    float acc[4][4];
    zero_tile(acc);
#pragma unroll 2
    for (int t = part; t < nb; t += G) {
      const float4 a = decode<DROP, PROB>(ld4(A + t * ldp));
      const float4 bv = ld4(B + (t0 + t) * ldc + hoff);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float as = comp(a, i);
        acc[i][0] = fmaf(as, bv.x, acc[i][0]);
        acc[i][1] = fmaf(as, bv.y, acc[i][1]);
        acc[i][2] = fmaf(as, bv.z, acc[i][2]);
        acc[i][3] = fmaf(as, bv.w, acc[i][3]);
      }
    }
    group_sum(acc, G);
    if (valid && part == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* e = out + (4 * kq + i) * ldc + hoff;
        float4 v = make_float4(acc[i][0] * mul, acc[i][1] * mul, acc[i][2] * mul,
                               acc[i][3] * mul);
        if (t0 != 0) {
          const float4 o = ld4(e);
          v.x = o.x + v.x, v.y = o.y + v.y, v.z = o.z + v.z, v.w = o.w + v.w;
        }
        st4(e, v);
      }
    }
  }
}

// 5a. Rows a .. a+3 of xᵀ·dpre, padded columns c .. c+3, summed over the T
// rows (x rows ldx apart, dpre rows ldc apart; the rows split over a group
// of G lanes), and for a = 0 the columns' Σ_t dpre: added to the slot's
// own-column entries (`ws` [D][Dc] the matrix, `bs` [Dc] the bias), or
// written at the CTA's first row.
template <int DH>
__device__ __forceinline__ void weight_grad_tile(const float* x, int ldx, const float* dpre,
                                                 int ldc, int T, int a, int c, int part, int G,
                                                 bool valid, float* ws, float* bs, int Dc,
                                                 int dh, int dhp, bool first) {
  float acc[4][4], bacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  zero_tile(acc);
#pragma unroll 4
  for (int t = part; t < T; t += G) {
    const float4 xv = ld4(x + t * ldx + a);
    const float4 dv = ld4(dpre + t * ldc + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xs = comp(xv, i);
      acc[i][0] = fmaf(xs, dv.x, acc[i][0]);
      acc[i][1] = fmaf(xs, dv.y, acc[i][1]);
      acc[i][2] = fmaf(xs, dv.z, acc[i][2]);
      acc[i][3] = fmaf(xs, dv.w, acc[i][3]);
    }
    bacc[0] += dv.x, bacc[1] += dv.y, bacc[2] += dv.z, bacc[3] += dv.w;
  }
  group_sum(acc, G);
  for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) bacc[j] += __shfl_xor_sync(0xffffffffu, bacc[j], off);
  if (!valid || part != 0) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cc = true_col<DH>(c + j, dh, dhp);
    if (cc < 0) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* e = ws + (a + i) * Dc + cc;
      *e = first ? acc[i][j] : *e + acc[i][j];
    }
    if (a == 0) bs[cc] = first ? bacc[j] : bs[cc] + bacc[j];
  }
}

// 5b. Rows t .. t+3 (below T) of Σ_m dpre_m·w_mᵀ (dpre_m [T][ldc], w_m the
// column slice [D][ldc]; NM = 1 or 2 matrices), output columns aq + j·nA4,
// into out (rows ldx apart): the CTA's partial input gradients.
template <int NM>
__device__ __forceinline__ void partial_tile(const float* d0, const float* w0, const float* d1,
                                             const float* w1, int ldc, int Dcp, int T, int t,
                                             int aq, int nA4, float* out, int ldx) {
  const float* dp[2] = {d0, d1};
  const float* w[2] = {w0, w1};
  float acc[4][4];
  zero_tile(acc);
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    for (int j = 0; j < Dcp; j += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(dp[m] + min(t + i, T - 1) * ldc + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) b[jj] = ld4(w[m] + (aq + jj * nA4) * ldc + j);
      dot4_tile(acc, a, b);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (t + i < T) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) out[(t + i) * ldx + aq + jj * nA4] = acc[i][jj];
    }
  }
}

template <int DH, bool DROP, bool WIDE = false>
__global__ void __launch_bounds__(kThreads, 2) mha_bwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  __shared__ bool last;
  cg::cluster_group cluster = cg::this_cluster();
  const Layout& L = p.L;  // constant memory: no registers held
  const int cs = p.cs;
  const int rank = cs > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int cid = blockIdx.x / cs;  // the cluster
  const int r = blockIdx.y;         // the replica
  const int tid = threadIdx.x;
  const int Tq = p.Tq, Tk = p.Tk, D = p.D, H = p.H, qb = p.qb;
  const int dh = DH ? DH : p.dh;
  // the specialised variants run from shared memory alone; the generic one
  // also from the device-memory workspace
  const bool smem = DH != 0 || p.work == nullptr;
  const bool alias = p.alias != 0;
  const float inv_scale = p.inv_scale;
  constexpr int NR = DH ? DH : kMaxDh;  // registers of a head's features
  const int n4 = L.dhp / 4;

  float* base = smem ? reinterpret_cast<float*>(smem4)
                     : p.work + (static_cast<long long>(r) * gridDim.x + blockIdx.x) * L.total;
  float* Ws = base + L.w;  // [3][D][ldc]: wq, wk, wv
  float* Bs = base + L.bias;  // [4][Dcp]: bq, bk, bv, γ
  const float* gam = Bs + 3 * L.Dcp;
  float* Qs = base + L.q;
  float* Os = base + L.o;
  float* DYs = base + L.dy;
  float* XR = base + L.xr;  // the own columns of xq
  float* GS = base + L.gs;  // the own columns of g
  float* Ks = base + L.k;
  float* Vs = base + L.v;
  float* DKs = base + L.dk;
  float* DVs = base + L.dv;
  float* Drow = base + L.drow;  // [hc][qb]
  float* mean_s = base + L.rowst;
  float* sigma_s = mean_s + qb;
  float* ex2 = base + L.ex;  // [2][qb][4]: LayerNorm's sums the cluster exchanges
  float* dgb = base + L.dgb;   // [2][Dc]: the row's dγ, dβ
  float* region = base + L.reg;
  float* X = region;  // the x rows, unless they lie in device memory

  // the replica's weights, and the slot of this CTA (its rank's columns)
  const long long wo = static_cast<long long>(r) * D * D;
  const int vo = r * D;
  const int c0 = rank * L.Dc;  // the first own column
  const int Pc = 3 * D * L.Dc + 5 * L.Dc;
  const int tree = r * cs + rank;

  // the column slices of wq, wk, wv and the biases, once a launch
  {
    const int nc4 = L.Dcp / 4;
    for (int i = tid; i < 3 * D * nc4; i += kThreads) {
      const int m = i / (D * nc4), e = i % (D * nc4), k = e / nc4, j = e % nc4 * 4;
      const float* w = (m == 0 ? p.wq : m == 1 ? p.wk : p.wv) + wo + k * D + c0;
      float* dst = Ws + (m * D + k) * L.ldc + j;
      if constexpr (DH != 0) {
        copy16(dst, w + j, smem);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int cc = true_col<DH>(j + jj, dh, L.dhp);
          dst[jj] = cc < 0 ? 0.0f : __ldg(w + cc);
        }
      }
    }
    for (int i = tid; i < 4 * L.Dcp; i += kThreads) {
      const int m = i / L.Dcp, cc = true_col<DH>(i % L.Dcp, dh, L.dhp);
      const float* b = (m == 0 ? p.bq : m == 1 ? p.bk : m == 2 ? p.bv : p.gamma) + vo + c0;
      Bs[i] = cc < 0 ? 0.0f : __ldg(b + cc);
    }
  }

  for (int j = cid; j < p.rows; j += p.clusters) {
    const bool first = j == cid;
    const long long b = static_cast<long long>(r) * p.rows + j;
    const int q_live = max(0, min(p.q_len[b], Tq));
    const int k_live = max(0, min(p.k_len[b], Tk));

    // this row's x rows, and its own columns of xq and g (prefetched at the
    // previous row's end)
    if (first)
      load_own<DH>(p.queries + b * Tq * D, p.g + b * Tq * D, Tq, D, c0, L.Dc, dh, L.dhp, L.ldc,
                   XR, GS, smem);
    if (p.xmode != kXGlobal) {
      load_x(p.queries + b * Tq * D, p.keys + b * Tk * D, Tq, Tk, D, alias, X, L.ldx);
      cp_async_wait_all();
    }
    __syncthreads();

    // 1. the projections of the own columns, a tile of Q, K or V a job: 4
    // rows strided by a quarter of the rows (consecutive lanes, consecutive
    // rows) × 4 columns
    {
      const bool glob = p.xmode == kXGlobal;
      const int ldx = glob ? D : L.ldx;
      const int nc4 = L.Dcp / 4, nq = L.Tq4 / 4, nk = L.Tk4 / 4;
      const int qj = nq * nc4, kj = nk * nc4;
      for (int jb = tid; jb < qj + 2 * kj; jb += kThreads) {
        if (jb < qj) {
          project_tile(glob ? p.queries + b * Tq * D : X, ldx, Tq, D, jb % nq, nq,
                       jb / nq * 4, Ws, Bs, Qs, L.ldc);
        } else {
          const int m = (jb - qj) / kj + 1, v = (jb - qj) % kj;
          const float* xk = glob ? p.keys + b * Tk * D : alias ? X : X + Tq * L.ldx;
          project_tile(xk, ldx, Tk, D, v % nk, nk, v / nk * 4, Ws + m * D * L.ldc,
                       Bs + m * L.Dcp, m == 1 ? Ks : Vs, L.ldc);
        }
      }
    }
    __syncthreads();

    for (int t0 = 0; t0 < Tq; t0 += qb) {
      const int nb = min(qb, Tq - t0);
      float* ex = ex2 + ((t0 / qb) & 1) * 4 * qb;  // this block's exchange buffer

      // 2. each own head's scores, softmax and output for the block's rows,
      // a group of G lanes a (row, head), the keys strided over the group:
      // the scores once, into the region ([hc][qb][ldp]); their max, expf
      // and sum; P₀ over them (0 at padded keys and query-masked rows; under
      // dropout a dropped P₀ stored negative, its sign the keep flag), and O
      // = P′·V over the rows' O.  Every lane runs its group's shuffles
      // (groups lie whole in a warp); lanes past the last group write nothing.
      {
        const int tasks = L.hc * nb;
        const int G = group_size(tasks, kThreads);
        for (int u0 = 0; u0 < tasks * G; u0 += kThreads) {
          const int u = u0 + tid;
          const bool valid = u < tasks * G;
          const int task = (valid ? u : tasks * G - 1) / G, part = u % G;
          const int hl = task / nb, t = task % nb, tg = t0 + t, hoff = hl * L.dhp;
          float* S = region + (hl * qb + t) * L.ldp;
          if constexpr (WIDE) {
            const float* qrow = Qs + tg * L.ldc + hoff;
            float m = -INFINITY;
            for (int k = part; k < Tk; k += G) {
              const float sc =
                  k < k_live ? dot_rows(qrow, Ks + k * L.ldc + hoff, n4) * inv_scale : kKeyMask;
              if (valid) S[k] = sc;
              m = fmaxf(m, sc);
            }
            m = group_fold_max(m, G);
            float l = 0.0f;
            for (int k = part; k < Tk; k += G) {
              const float e = expf(S[k] - m);
              if (valid) S[k] = e;
              l += e;
            }
            l = group_fold_sum(l, G);
            const bool live = tg < q_live;
            const std::uint8_t* kr = nullptr;
            if constexpr (DROP)
              kr = p.keep_mask + ((b * H + rank * L.hc + hl) * Tq + tg) * static_cast<long long>(Tk);
            for (int k = part; k < L.Tk4; k += G) {
              float v = 0.0f;
              if (live && k < Tk) {
                v = S[k] / l;
                if constexpr (DROP)
                  if (__ldg(kr + k) == 0) v = -v;
              }
              if (valid) S[k] = v;
            }
            wide_weighted<DROP, true>(S, Vs + hoff, L.ldc, Tk, part, G, n4, valid && part == 0,
                                      Os + tg * L.ldc + hoff, DROP ? 1.0f / p.keep : 1.0f);
            continue;
          }
          float a[NR];
          load_head<NR>(Qs + tg * L.ldc + hoff, a, n4);
          float m = -INFINITY;
#pragma unroll 4
          for (int k = part; k < Tk; k += G) {
            const float sc =
                k < k_live ? dot_head<NR>(a, Ks + k * L.ldc + hoff, n4) * inv_scale : kKeyMask;
            if (valid) S[k] = sc;
            m = fmaxf(m, sc);
          }
          m = group_fold_max(m, G);
          float l = 0.0f;
#pragma unroll 4
          for (int k = part; k < Tk; k += G) {
            const float e = expf(S[k] - m);
            if (valid) S[k] = e;
            l += e;
          }
          l = group_fold_sum(l, G);
          const bool live = tg < q_live;
          const std::uint8_t* kr = nullptr;
          if constexpr (DROP)
            kr = p.keep_mask + ((b * H + rank * L.hc + hl) * Tq + tg) * static_cast<long long>(Tk);
#pragma unroll
          for (int f = 0; f < NR; ++f) a[f] = 0.0f;  // now O's sums
#pragma unroll 2
          for (int k = part; k < L.Tk4; k += G) {
            float v = 0.0f;
            if (live && k < Tk) {
              v = S[k] / l;
              bool kept = true;
              if constexpr (DROP) kept = __ldg(kr + k) != 0;
              if (kept) axpy_head<NR>(v, Vs + k * L.ldc + hoff, a, n4);
              if (!kept) v = -v;
            }
            if (valid) S[k] = v;
          }
          fold_head<NR>(a, n4, G);
          if (valid && part == 0)
            store_head<NR>(Os + tg * L.ldc + hoff, a, DROP ? 1.0f / p.keep : 1.0f, n4);
        }
      }
      __syncthreads();

      // 3. LayerNorm's backward over the block's rows, a group of G lanes a
      // row: each CTA sums its own columns, centred at their own mean (Σy,
      // M2, Σdŷ, Σdŷ·(y − own mean)); one exchange; each CTA combines the
      // cluster's sums in rank order (Chan's parallel variance: M2 = Σ_c M2_c
      // + Dc·(mean_c − mean)²), then writes dy on its own columns
      {
        const int G = group_size(nb, kThreads, L.Dcp / 4);
        const float dc = static_cast<float>(L.Dc);
        for (int u0 = 0; u0 < nb * G; u0 += kThreads) {
          const int u = u0 + tid;
          const bool valid = u < nb * G;
          const int t = (valid ? u : nb * G - 1) / G, part = u % G, tg = t0 + t;
          const float* orow = Os + tg * L.ldc;
          const float* xrow = XR + tg * L.ldc;
          const float* grow = GS + tg * L.ldc;
          float sy = 0.0f, sd = 0.0f;
          for (int pc = part; pc < L.Dcp; pc += G) {
            if (true_col<DH>(pc, dh, L.dhp) < 0) continue;
            sy += orow[pc] + xrow[pc];
            sd += grow[pc] * gam[pc];
          }
          sy = group_fold_sum(sy, G), sd = group_fold_sum(sd, G);
          const float mc = sy / dc;
          float m2 = 0.0f, sdy = 0.0f;
          for (int pc = part; pc < L.Dcp; pc += G) {
            if (true_col<DH>(pc, dh, L.dhp) < 0) continue;
            const float d = orow[pc] + xrow[pc] - mc;
            m2 = fmaf(d, d, m2);
            sdy = fmaf(grow[pc] * gam[pc], d, sdy);
          }
          m2 = group_fold_sum(m2, G), sdy = group_fold_sum(sdy, G);
          if (valid && part == 0) st4(ex + 4 * t, make_float4(sy, m2, sd, sdy));
        }
      }
      if (cs > 1) cluster_sync(); else __syncthreads();
      {
        const int G = group_size(nb, kThreads, L.Dcp / 4);
        const float dc = static_cast<float>(L.Dc);
        for (int u = tid; u < nb * G; u += kThreads) {
          const int t = u / G, part = u % G, tg = t0 + t;
          float sy = 0.0f, sd = 0.0f;
          for (int rr = 0; rr < cs; ++rr) {
            const float4 e = ld4((cs > 1 ? cluster.map_shared_rank(ex, rr) : ex) + 4 * t);
            sy += e.x, sd += e.z;
          }
          const float mean = sy / D, m1 = sd / D;
          float m2 = 0.0f, sdy = 0.0f;
          for (int rr = 0; rr < cs; ++rr) {
            const float4 e = ld4((cs > 1 ? cluster.map_shared_rank(ex, rr) : ex) + 4 * t);
            const float dm = e.x / dc - mean;
            m2 += e.y + dc * dm * dm;
            sdy += e.w + dm * e.z;
          }
          const float sigma = sqrtf(m2 / D + kLnEps);
          const float mdy = sdy / sigma / D;  // mean(dŷ⊙ŷ)
          const float* orow = Os + tg * L.ldc;
          const float* xrow = XR + tg * L.ldc;
          const float* grow = GS + tg * L.ldc;
          for (int pc = part; pc < L.Dcp; pc += G) {
            float v = 0.0f;
            if (true_col<DH>(pc, dh, L.dhp) >= 0) {
              const float yh = (orow[pc] + xrow[pc] - mean) / sigma;
              v = (grow[pc] * gam[pc] - m1 - yh * mdy) / sigma;
            }
            DYs[tg * L.ldc + pc] = v;
          }
          if (part == 0) mean_s[t] = mean, sigma_s[t] = sigma;
        }
      }
      __syncthreads();

      // 3b. dV += P′ᵀ·dy on half the threads, beside 3a on the other half
      keys_times_rows<DROP, true>(region, L.ldp, qb, DYs, L.ldc, DVs, t0, nb, L.Tk4, L.hc,
                                  L.dhp, DROP ? 1.0f / p.keep : 1.0f, 0, kThreads / 2);
      // 3a. D = dy·O per (row, head); the block's dγ and dβ per own column
      for (int i = tid - kThreads / 2; tid >= kThreads / 2 && i < L.hc * nb + L.Dc;
           i += kThreads / 2) {
        if (i < L.hc * nb) {
          const int hl = i / nb, t = i % nb;
          const float* dyr = DYs + (t0 + t) * L.ldc + hl * L.dhp;
          const float* orow = Os + (t0 + t) * L.ldc + hl * L.dhp;
          float d = 0.0f;
#pragma unroll
          for (int f = 0; f < (DH ? DH : L.dhp); ++f) d = fmaf(dyr[f], orow[f], d);
          Drow[hl * qb + t] = d;
        } else {
          const int c = i - L.hc * nb;
          const int pc = DH ? c : c / dh * L.dhp + c % dh;
          float sg = 0.0f, sbeta = 0.0f;
          for (int t = 0; t < nb; ++t) {
            const int tg = t0 + t;
            const float gv = GS[tg * L.ldc + pc];
            const float yh = (Os[tg * L.ldc + pc] + XR[tg * L.ldc + pc] - mean_s[t]) / sigma_s[t];
            sg = fmaf(gv, yh, sg);
            sbeta += gv;
          }
          dgb[c] = t0 == 0 ? sg : dgb[c] + sg;
          dgb[L.Dc + c] = t0 == 0 ? sbeta : dgb[L.Dc + c] + sbeta;
        }
      }
      __syncthreads();

      // 4a. dS = P₀ ⊙ (dP₀ − D) over P (zero at masked keys) and dQ = dS·K/√dh
      // over the rows' O, a group of G lanes a (row, head) as in 2
      {
        const int tasks = L.hc * nb;
        const int G = group_size(tasks, kThreads);
        for (int u0 = 0; u0 < tasks * G; u0 += kThreads) {
          const int u = u0 + tid;
          const bool valid = u < tasks * G;
          const int task = (valid ? u : tasks * G - 1) / G, part = u % G;
          const int hl = task / nb, t = task % nb, tg = t0 + t, hoff = hl * L.dhp;
          float* S = region + (hl * qb + t) * L.ldp;
          const bool live = tg < q_live;
          const float dd = Drow[hl * qb + t];
          if constexpr (WIDE) {
            const float* dyrow = DYs + tg * L.ldc + hoff;
            for (int k = part; k < L.Tk4; k += G) {
              float ds = 0.0f;
              if (live && k < k_live) {
                const float v = S[k];
                float dp = dot_rows(dyrow, Vs + k * L.ldc + hoff, n4);
                if constexpr (DROP) dp = v > 0.0f ? dp / p.keep : 0.0f;
                ds = (DROP ? fabsf(v) : v) * (dp - dd);
              }
              if (valid) S[k] = ds;
            }
            wide_weighted<DROP, false>(S, Ks + hoff, L.ldc, Tk, part, G, n4, valid && part == 0,
                                       Os + tg * L.ldc + hoff, inv_scale);
            continue;
          }
          float dy[NR], dq[NR];
          load_head<NR>(DYs + tg * L.ldc + hoff, dy, n4);
#pragma unroll
          for (int f = 0; f < NR; ++f) dq[f] = 0.0f;
#pragma unroll 2
          for (int k = part; k < L.Tk4; k += G) {
            float ds = 0.0f;
            if (live && k < k_live) {
              const float v = S[k];
              float dp = dot_head<NR>(dy, Vs + k * L.ldc + hoff, n4);
              if constexpr (DROP) dp = v > 0.0f ? dp / p.keep : 0.0f;
              ds = (DROP ? fabsf(v) : v) * (dp - dd);
              axpy_head<NR>(ds, Ks + k * L.ldc + hoff, dq, n4);
            }
            if (valid) S[k] = ds;
          }
          fold_head<NR>(dq, n4, G);
          if (valid && part == 0) store_head<NR>(Os + tg * L.ldc + hoff, dq, inv_scale, n4);
        }
      }
      __syncthreads();

      // 4b. dK += dSᵀ·Q
      keys_times_rows<DROP, false>(region, L.ldp, qb, Qs, L.ldc, DKs, t0, nb, L.Tk4, L.hc,
                                   L.dhp, 1.0f, 0, kThreads);
      __syncthreads();
    }

    // 5. the region is free: reload x (region mode) while the ReLU masks
    // run; the next row's own columns of xq and g
    if (p.xmode == kXRegion)
      load_x(p.queries + b * Tq * D, p.keys + b * Tk * D, Tq, Tk, D, alias, X, L.ldx);
    if (j + p.clusters < p.rows) {
      const long long bn = b + p.clusters;
      load_own<DH>(p.queries + bn * Tq * D, p.g + bn * Tq * D, Tq, D, c0, L.Dc, dh, L.dhp,
                   L.ldc, XR, GS, smem);
    }
    {
      const int nc4 = L.Dcp / 4;
      const int qn = Tq * nc4, kn = Tk * nc4;
      for (int i = tid; i < qn + kn; i += kThreads) {
        if (i < qn) {
          const int e = i / nc4 * L.ldc + i % nc4 * 4;
          const float4 q = ld4(Qs + e);
          float4 d = ld4(Os + e);
          d.x = q.x > 0.0f ? d.x : 0.0f, d.y = q.y > 0.0f ? d.y : 0.0f;
          d.z = q.z > 0.0f ? d.z : 0.0f, d.w = q.w > 0.0f ? d.w : 0.0f;
          st4(Os + e, d);
        } else {
          const int u = i - qn, e = u / nc4 * L.ldc + u % nc4 * 4;
          const float4 kv = ld4(Ks + e), vv = ld4(Vs + e);
          float4 dk = ld4(DKs + e), dv = ld4(DVs + e);
          dk.x = kv.x > 0.0f ? dk.x * inv_scale : 0.0f, dk.y = kv.y > 0.0f ? dk.y * inv_scale : 0.0f;
          dk.z = kv.z > 0.0f ? dk.z * inv_scale : 0.0f, dk.w = kv.w > 0.0f ? dk.w * inv_scale : 0.0f;
          dv.x = vv.x > 0.0f ? dv.x : 0.0f, dv.y = vv.y > 0.0f ? dv.y : 0.0f;
          dv.z = vv.z > 0.0f ? dv.z : 0.0f, dv.w = vv.w > 0.0f ? dv.w : 0.0f;
          st4(DKs + e, dk);
          st4(DVs + e, dv);
        }
      }
    }
    if (p.xmode == kXRegion) cp_async_wait_all();
    __syncthreads();

    // 5a. the weight gradients of the own columns, into the slot: a tile
    // of dWq, dWk or dWv a job (the rows split over a group where there are
    // few jobs); the row's dγ and dβ
    {
      float* slot = p.slots + (static_cast<long long>(tree) * p.tree_slots + cid) * Pc;
      const int nc4 = L.Dcp / 4, D4 = D / 4;
      const int wt = D4 * nc4;
      const int G = group_size(3 * wt, kThreads);
      for (int u0 = 0; u0 < 3 * wt * G; u0 += kThreads) {
        const int u = u0 + tid;
        const bool valid = u < 3 * wt * G;
        const int job = (valid ? u : 3 * wt * G - 1) / G, part = u % G;
        const int m = job / wt, e = job % wt, a = e / nc4 * 4, c = e % nc4 * 4;
        const bool glob = p.xmode == kXGlobal;
        const float* x = glob ? (m == 0 ? p.queries + b * Tq * D : p.keys + b * Tk * D)
                              : (m == 0 || alias ? X : X + Tq * L.ldx);
        weight_grad_tile<DH>(x, glob ? D : L.ldx, m == 0 ? Os : m == 1 ? DKs : DVs, L.ldc,
                             m == 0 ? Tq : Tk, a, c, part, G, valid, slot + m * D * L.Dc,
                             slot + 3 * D * L.Dc + m * L.Dc, L.Dc, dh, L.dhp, first);
      }
      for (int c = tid; c < 2 * L.Dc; c += kThreads) {
        float* e = slot + 3 * D * L.Dc + 3 * L.Dc + c;
        *e = first ? dgb[c] : *e + dgb[c];
      }
    }
    __syncthreads();

    // 5b. the partial input gradients [T][D] into the region, then each
    // CTA adds the cluster's partials of its own columns in rank order: the
    // queries' and the keys' at once where the region holds both
    const bool both = (Tq + Tk) * L.ldx <= L.region;
    for (int pass = 0; pass < (both ? 1 : 2); ++pass) {
      const bool do_q = pass == 0, do_k = both || pass == 1;
      const int koff = both ? Tq : 0;  // the keys' first region row
      const int nA4 = D / 4;
      const int qj = do_q ? (Tq + 3) / 4 * nA4 : 0, kj = do_k ? (Tk + 3) / 4 * nA4 : 0;
      for (int jb = tid; jb < qj + kj; jb += kThreads) {
        if (jb < qj) {
          partial_tile<1>(Os, Ws, nullptr, nullptr, L.ldc, L.Dcp, Tq, jb / nA4 * 4, jb % nA4, nA4,
                          region, L.ldx);
        } else {
          const int u = jb - qj;
          partial_tile<2>(DKs, Ws + D * L.ldc, DVs, Ws + 2 * D * L.ldc, L.ldc, L.Dcp, Tk, u / nA4 * 4,
                          u % nA4, nA4, region + koff * L.ldx, L.ldx);
        }
      }
      if (cs > 1) cluster_sync(); else __syncthreads();
      const int dc4 = L.Dc / 4;
      const int qn = do_q ? Tq * dc4 : 0, kn = do_k ? Tk * dc4 : 0;
      for (int i = tid; i < qn + kn; i += kThreads) {
        const bool isq = i < qn;
        const int u = isq ? i : i - qn, t = u / dc4, c = u % dc4 * 4;
        const int row = isq ? t : koff + t;
        float4 v[kMaxCs];
#pragma unroll
        for (int rr = 0; rr < kMaxCs; ++rr)
          if (rr < cs)
            v[rr] = ld4((cs > 1 ? cluster.map_shared_rank(region, rr) : region) + row * L.ldx +
                        c0 + c);
        float4 s = v[0];
#pragma unroll
        for (int rr = 1; rr < kMaxCs; ++rr)
          if (rr < cs) s.x += v[rr].x, s.y += v[rr].y, s.z += v[rr].z, s.w += v[rr].w;
        if (isq) {
          float dyv[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int cc = c + jj;
            dyv[jj] = DYs[t * L.ldc + (DH ? cc : cc / dh * L.dhp + cc % dh)];
          }
          s.x = dyv[0] + s.x, s.y = dyv[1] + s.y, s.z = dyv[2] + s.z, s.w = dyv[3] + s.w;
          st4(p.dq + (b * Tq + t) * D + c0 + c, s);
        } else {
          st4(p.dk + (b * Tk + t) * D + c0 + c, s);
        }
      }
      // the peers have read this CTA's partials before anything overwrites them
      if (cs > 1) cluster_sync(); else __syncthreads();
    }
  }

  // up the rank's tree: the last CTA of each group of kGroup slots sums
  // them, in slot order, into one slot of the next level
  unsigned* tickets = p.tickets + static_cast<long long>(tree) * p.tree_tickets;
  float* level = p.slots + static_cast<long long>(tree) * p.tree_slots * Pc;
  int count = p.clusters, idx = cid;
  while (count > 1) {
    const int group = idx / kGroup;
    const int firsts = group * kGroup;
    const int members = min(kGroup, count - firsts);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last = atomicAdd(tickets + group, 1u) == static_cast<unsigned>(members - 1);
      if (last) tickets[group] = 0;  // every CTA of the group has counted
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    float* next = level + static_cast<long long>(count) * Pc;
    const float* src = level + static_cast<long long>(firsts) * Pc;
    for (int i = tid; i < Pc; i += kThreads) {
      float acc = __ldcg(src + i);
      for (int s = 1; s < members; ++s) acc += __ldcg(src + static_cast<long long>(s) * Pc + i);
      next[static_cast<long long>(group) * Pc + i] = acc;
    }
    tickets += (count + kGroup - 1) / kGroup;
    count = (count + kGroup - 1) / kGroup;
    idx = group;
    level = next;
  }
  // one CTA of the rank is left, with the total in slot 0 of `level`
  __threadfence();
  __syncthreads();
  for (int i = tid; i < Pc; i += kThreads) {
    const float v = __ldcg(level + i);
    if (i < 3 * D * L.Dc) {
      const int m = i / (D * L.Dc), e = i - m * D * L.Dc, k = e / L.Dc, c = e - k * L.Dc;
      (m == 0 ? p.dwq : m == 1 ? p.dwk : p.dwv)[wo + k * D + c0 + c] = v;
    } else {
      const int m = (i - 3 * D * L.Dc) / L.Dc, c = i - 3 * D * L.Dc - m * L.Dc;
      float* dst = m == 0 ? p.dbq : m == 1 ? p.dbk : m == 2 ? p.dbv : m == 3 ? p.dgamma : p.dbeta;
      dst[vo + c0 + c] = v;
    }
  }
}

template <int DH, bool DROP, bool WIDE = false>
int launch(const Params& p, int replicas, int smem, cudaStream_t stream) {
  // the dynamic shared memory each device's variant is opted in to
  static int opted[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > opted[device]) {
    err = cudaFuncSetAttribute(mha_bwd_kernel<DH, DROP, WIDE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[device] = smem;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.clusters * p.cs, replicas);
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
  err = cudaLaunchKernelEx(&config, mha_bwd_kernel<DH, DROP, WIDE>, p);
  // read (and clear) the launch's error either way, so that a refused
  // launch is not reported again by a later one
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <bool DROP>
int launch_heads(const Params& p, int replicas, int smem, cudaStream_t stream) {
  // heads past kMaxDh features or D past kMaxD run the wide variant
  if (p.dh > kMaxDh || p.D > kMaxD) return launch<0, DROP, true>(p, replicas, smem, stream);
  // the specialised variants assume shared memory; the workspace in device
  // memory runs the generic one
  if (p.work != nullptr) return launch<0, DROP>(p, replicas, smem, stream);
  switch (p.dh) {
    case 8:
      return launch<8, DROP>(p, replicas, smem, stream);
    case 16:
      return launch<16, DROP>(p, replicas, smem, stream);
    case 32:
      return launch<32, DROP>(p, replicas, smem, stream);
    default:
      return launch<0, DROP>(p, replicas, smem, stream);
  }
}

}  // namespace

extern "C" {

// Launches K3b on `stream` with the geometry of
// ops/cuda/mha.py::backward_plan: `clusters` clusters of `cs` CTAs of
// `threads` threads for each of `replicas` replicas (grid y), cluster i
// taking the rows i, i + clusters, ... of its replica's `rows`; query
// blocks of `qb` rows; `xmode` and `alias` as the plan's; `smem` bytes of
// dynamic shared memory hold a CTA's layout of `per_cta` floats or, with
// `work` not null, `per_cta` floats of `work` a CTA do (then cs is 1).
// `slots` and `tickets` are the plan's scratch (tickets all 0): per
// replica and rank, `tree_slots` slots of 3·D·D/cs + 5·D/cs floats and
// `tree_tickets` tickets.  `keep_mask` holds dropout's keep flags
// ([rows·replicas, H, Tq, Tk] bytes) and `keep` = 1 − rate; a null mask
// runs the variant without dropout.  Returns the launch's CUDA error (0 =
// launched); a refused cluster launch is returned, never retried with
// another geometry.  The caller has checked shapes, types, devices,
// contiguity, 16-byte alignment and the limits.
int mha_bwd_launch(const float* queries, const float* keys, const int* q_len,
                   const int* k_len, const float* wq, const float* bq, const float* wk,
                   const float* bk, const float* wv, const float* bv, const float* gamma,
                   const float* /*beta: the backward does not read it*/, const float* g,
                   const std::uint8_t* keep_mask, float* dq, float* dk,
                   float* dwq, float* dbq, float* dwk, float* dbk, float* dwv, float* dbv,
                   float* dgamma, float* dbeta, float* slots, unsigned* tickets, float* work,
                   int Tq, int Tk, int D, int H, int dh, int rows, int cs, int clusters,
                   int replicas, int qb, int xmode, int alias, int tree_slots,
                   int tree_tickets, int per_cta, int threads, int smem, float keep,
                   void* stream) {
  if (threads != kThreads || dh < 1 || D != dh * H || D % 4 != 0 ||
      D > kWideMaxD || rows < 1 || clusters < 1 || clusters > rows || replicas < 1 ||
      (cs != 1 && cs != 2 && cs != 4 && cs != 8) || H % cs != 0 || (D / cs) % 4 != 0 ||
      qb < 1 || qb > Tq || xmode < kXRegion || xmode > kXGlobal ||
      (xmode == kXGlobal) != (work != nullptr) || (work != nullptr && cs != 1) ||
      (alias && (Tq != Tk || queries != keys)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(Tq, Tk, D, H, dh, cs, qb, xmode, alias);
  if (L.total != per_cta || (work == nullptr && 4 * per_cta > smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{queries, keys, q_len, k_len, wq, bq, wk, bk, wv, bv, gamma, g, keep_mask,
                 dq, dk, dwq, dbq, dwk, dbk, dwv, dbv, dgamma, dbeta, slots, tickets, work,
                 Tq, Tk, D, H, dh, rows, cs, clusters, qb, xmode, alias, tree_slots,
                 tree_tickets, 1.0f / sqrtf(static_cast<float>(dh)), keep, L};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keep_mask != nullptr) return launch_heads<true>(p, replicas, smem, s);
  return launch_heads<false>(p, replicas, smem, s);
}

// The floats of a CTA's layout (ops/cuda/mha.py::_bwd_layout is checked
// against it on the card).
int mha_bwd_layout_floats(int Tq, int Tk, int D, int H, int dh, int cs, int qb, int xmode,
                          int alias) {
  return make_layout(Tq, Tk, D, H, dh, cs, qb, xmode, alias).total;
}

// The clusters of `cs` CTAs with `smem` bytes each that the current device
// runs at once (cudaOccupancyMaxActiveClusters), into *clusters; returns
// the CUDA error.  ops/cuda/mha.py's ACTIVE_CLUSTERS is checked against it.
int mha_bwd_active_clusters(int cs, int smem, int* clusters) {
  // raise the opt-in only: launch() assumes it never falls
  cudaFuncAttributes attrs;
  cudaError_t err = cudaFuncGetAttributes(&attrs, mha_bwd_kernel<8, false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > attrs.maxDynamicSharedSizeBytes) {
    err = cudaFuncSetAttribute(mha_bwd_kernel<8, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // so that no later launch reports it
      return static_cast<int>(err);
    }
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
      clusters, reinterpret_cast<const void*>(mha_bwd_kernel<8, false>), &config));
}

const char* mha_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
