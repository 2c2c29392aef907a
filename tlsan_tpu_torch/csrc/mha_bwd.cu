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
//   keep mask is read where P₀ is stored.  Every row of a CTA's
//   own-column arrays is padded by 4 floats, so lanes reading consecutive
//   rows as float4 hit distinct banks; a head's columns are padded to a
//   multiple of 4 (zeros) for a width that is not one.  This is the
//   resident design; shapes whose layout it cannot fit in one CTA's
//   shared memory run the streamed one (below).
//
// The streamed design (STREAM; ops/cuda/mha.py::backward_plan takes it
// where the resident layout fits no cluster size, and for D not a multiple
// of 4).  What bounds it: operations, as above, but at D = 512 a row is
// 255 M multiply-adds (0.243 ms for B = 32 at the f32 peak), three
// quarters of them in three [T, D]·[D, D] products (the projections, the
// weight gradients, the input gradients).  Resident weight columns cost
// 3·D·D/cs floats a CTA, so the layout holds none of them, nor copies of x
// or g:
//   - the weights stay where they lie (3 MB at D = 512, L2-resident and
//     shared by every CTA).  The projections, the input gradients and the
//     weight gradients are products staged through shared memory k-tiles:
//     a block of up to kTileRows rows (or features of x) × kTileN columns,
//     of all three matrices at once in the projections (and of both sides
//     in the input gradients), a thread taking 4 rows × 4 (or 8) columns
//     of a product, the sums in registers over the k-loop; x and g are
//     read where they lie;
//   - the stage is double-buffered: while a k-tile is summed, the next one
//     (a block's first: during the block before's last) loads into the
//     other buffer, by cp.async from device memory and through registers
//     from the layout, so the products wait on no load but the first.  Two
//     buffers of kTileK = 8 columns fit beside the layout at D = 512 with
//     query blocks of 32 rows; a k-tile of 16 would not;
//   - a row is split over a cluster of cs CTAs either by heads (HEADS, CTA
//     c owning heads c·H/cs ..: the resident design's split) or, where the
//     heads do not divide, by rows (ROWS: CTA c owning query rows and key
//     rows c·⌈T/cs⌉ .., all heads; its K and V rows projected once and
//     gathered by every CTA through distributed shared memory; dK and dV
//     partial over its query rows, summed for its key rows across the
//     cluster in rank order; LayerNorm local, since a CTA holds whole rows);
//   - the input gradients are pulled, not exchanged: after the ReLU masks a
//     CTA passes the cluster's barrier, computes its weight gradients from
//     its own dpre, waits at the barrier, and then sums, for its D/cs input
//     columns, dy + Σ_c' dQpre_c'·Wq[own, c']ᵀ over the columns in order
//     (and d_keys, dKpre·Wkᵀ in the same pass, dVpre·Wvᵀ in a second),
//     reading rank c''s dpre columns through distributed shared memory
//     (under ROWS a CTA holds every column of its rows: all its own); no
//     [T, D] partial is exchanged, and dpre never leaves the layout;
//   - where no cluster size fits shared memory (Tk or D in the thousands)
//     the same layout lies in device memory, a slice a CTA, the peers' read
//     there past L1 (ld.cg) after a fence and the cluster barrier; the
//     stage stays in shared memory.  The weights are never copied.
//   The plan takes the split and cluster size that give the fewest waves of
//   rows a CTA of the cluster (⌈B / active clusters⌉ / cs).  The weight
//   gradients go up the resident design's ticket tree (ROWS: a leaf a CTA,
//   one tree a replica, since every rank holds every column), a CTA's slot
//   read and written back at each of its rows.  What holds it above its
//   bound (D = 512, H = 8, B = 32, (96, 96): some 12×): the products' 4 × 4
//   register tiles take two shared-memory loads for every eight FMAs, with
//   8 warps an SM to hide their latency, and the 8-column k-tiles that two
//   buffers leave room for pass twice the barriers of a 16-column tile;
//   hiding the k-tiles' loads does not pay for that (a single-buffered stage
//   of 16-column tiles measured faster at every width but D = 128, H = 2:
//   PERF.md §6); the attention
//   phases are latency chains over the query blocks; and 32 rows on 15
//   clusters of 8 take three rounds, the last with 2 clusters busy.

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
// wide variant (WIDE) takes heads of any width and any D: it is the
// generic one but for the two passes that hold a head's features in
// registers (2 and 4a), which read a dot product's operands from the
// layout and sum O = P′·V and dQ = dS·K 32 features at a time, so no
// register array grows with dh.  The streamed design runs the generic and
// wide variants only, and reads x, g and the weights as single floats
// where D or dh is not a multiple of 4.  Tq, Tk and D are bounded by
// nothing but memory.
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
constexpr int kWideChunk = 32;  // the wide variant's features summed at once
constexpr int kPad = 4;  // floats after each row of a shared array
constexpr int kMaxCs = 8;  // the largest cluster
// slots summed together at each level of the cross-CTA tree;
// ops/cuda/mha.py::backward_plan sizes the scratch with the same number
constexpr int kGroup = 16;
constexpr int kMaxDevices = 64;
// the designs (ops/cuda/mha.py's RESIDENT, HEADS, ROWS): the weights'
// columns resident; streamed, a row split by heads; streamed, split by rows
constexpr int kResident = 0, kHeads = 1, kRows = 2;
// the streamed products' tiles: k-columns staged at once, output columns
// and rows (or features of x) at a time, and the weight gradients' steps
// staged at once (ops/cuda/mha.py's TILE_K, TILE_N, TILE_ROWS, STEP_K)
constexpr int kTileK = 8, kTileN = 64, kTileRows = 128, kStepK = 16;
constexpr int kLdt = kTileK + kPad;  // rows of a staged x or dpre tile
constexpr int kLds = kStepK + kPad;  // rows of the weight gradients' xᵀ tile

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// A CTA's arrays, offsets in floats (ops/cuda/mha.py::_bwd_layout mirrors
// it): the column slices of the weights [3][D][ldc], the biases and γ; Q,
// O (then dQ, then dQpre), dy, and the own columns of xq and g [Tq4][ldc];
// K, V, dK and dV [Tk4][ldc]; the
// block's D per (row, head), its rows' mean and σ, and the exchange of
// LayerNorm's sums [2][qb][4] (by the block's parity); dγ and dβ of the
// row; the region (the block's P, x, the partial input gradients).  The
// streamed design's (make_stream_layout) has no weights, xq, g or x, its
// region holds P alone, and `stage` floats of shared memory follow it.
struct Layout {
  int hc, dhp, Dcp, Dc, ldc, ldx, ldp, Tq4, Tk4, xrows, region;
  int w, bias, q, o, dy, xr, gs, k, v, dk, dv, drow, rowst, ex, dgb, reg, total;
  // streamed: the stage (two buffers of buf floats), a buffer's query and
  // key rows, x's features (the weight gradients') and output columns
  int stage, ra, rk, rw, nc, buf;
};

inline Layout make_layout(int Tq, int Tk, int D, int H, int dh, int cs,
                          int qb, int alias) {
  Layout L = {};
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
  region = region > L.xrows * L.ldx ? region : L.xrows * L.ldx;
  L.reg = off;
  L.region = region;
  off += region;
  L.total = off;
  return L;
}

// The streamed design's layout (ops/cuda/mha.py::_stream_layout mirrors
// it): under ROWS a CTA holds every head (hc = H) and its rows' share of
// the query rows, nq = ⌈Tq/cs⌉ (the arrays keep all Tq rows: row indices
// stay the batch row's); the stage is two buffers, each the larger of a
// product's tiles: the projections' kTileK columns of ra query rows and rk
// key rows of x and three weight tiles [kTileK][nc + kPad]; the input
// gradients' as many of dpre and two weight tiles [nc][kLdt]; the weight
// gradients' xᵀ [rw][kLds] and dpre [kStepK][nc + kPad]; in the query
// blocks it holds the block's own columns of xq and g [2][qb][ldc].
inline Layout make_stream_layout(int Tq, int Tk, int D, int H, int dh, int cs, int qb,
                                 bool rows) {
  Layout L = {};
  L.hc = rows ? H : H / cs;
  L.dhp = round4(dh);
  L.Dcp = L.hc * L.dhp;
  L.Dc = L.hc * dh;
  L.ldc = L.Dcp + kPad;
  L.Tq4 = round4(Tq);
  L.Tk4 = round4(Tk);
  L.ldp = L.Tk4 + kPad;
  int off = 0;
  L.bias = off, off += 4 * L.Dcp;
  L.q = off, off += L.Tq4 * L.ldc;
  L.o = off, off += L.Tq4 * L.ldc;
  L.dy = off, off += L.Tq4 * L.ldc;
  L.k = off, off += L.Tk4 * L.ldc;
  L.v = off, off += L.Tk4 * L.ldc;
  L.dk = off, off += L.Tk4 * L.ldc;
  L.dv = off, off += L.Tk4 * L.ldc;
  L.drow = off, off += round4(qb * L.hc);
  L.rowst = off, off += round4(2 * qb);
  L.ex = off, off += 2 * 4 * qb;
  L.dgb = off, off += round4(2 * L.Dc);
  L.reg = off;
  L.region = L.hc * qb * L.ldp;
  off += L.region;
  L.total = off;
  const int nq = rows ? (Tq + cs - 1) / cs : Tq, nk = rows ? (Tk + cs - 1) / cs : Tk;
  L.ra = round4(nq < kTileRows ? nq : kTileRows);
  L.rk = round4(nk < kTileRows ? nk : kTileRows);
  L.rw = round4(D < kTileRows ? D : kTileRows);
  L.nc = L.Dcp < kTileN ? L.Dcp : kTileN;
  const int proj = (L.ra + L.rk) * kLdt + 3 * kTileK * (L.nc + kPad);
  const int grad = (L.ra + L.rk) * kLdt + 2 * L.nc * kLdt;
  const int wgrad = L.rw * kLds + kStepK * (L.nc + kPad);
  L.buf = proj > grad ? proj : grad;
  L.buf = L.buf > wgrad ? L.buf : wgrad;
  // between the products the stage holds a query block's own columns of xq and g
  L.stage = 2 * L.buf > 2 * qb * L.ldc ? 2 * L.buf : 2 * qb * L.ldc;
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
  float* work;  // the streamed layout in device memory, or null for shared memory
  int Tq, Tk, D, H, dh, rows;  // rows: the batch rows a replica
  int cs, clusters, qb, mode, alias;
  int vec;  // streamed: x, g and the weights' rows read as float4 (D, dh multiples of 4)
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
// column c0) into XR and GS (rows ldc apart, padded columns) by cp.async
// (g 4 bytes at a time: it need not be 16-byte aligned); padding is never
// read.
template <int DH>
__device__ __forceinline__ void load_own(const float* xq, const float* g, int Tq, int D, int c0,
                                         int Dc, int dh, int dhp, int ldc, float* XR, float* GS) {
  for (int i = threadIdx.x; i < Tq * Dc; i += kThreads) {
    const int t = i / Dc, c = i % Dc;
    const int pc = DH ? c : c / dh * dhp + c % dh;
    cp_async4(GS + t * ldc + pc, g + t * D + c0 + c);
    if (DH != 0 && c % 4 == 0) cp_async16(XR + t * ldc + pc, xq + t * D + c0 + c);
    if (DH == 0) cp_async4(XR + t * ldc + pc, xq + t * D + c0 + c);
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
// the rows split over a group of G lanes.  The first block writes, the
// others `add`.  Run by threads [base, base + n).
template <bool DROP, bool PROB>
__device__ __forceinline__ void keys_times_rows(const float* P, int ldp, int qb, const float* B,
                                                int ldc, float* out, int t0, int nb, bool add,
                                                int Tk4, int hc, int dhp, float mul, int base,
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
        if (add) {
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

// ------------------------------------------------- the streamed design

// acc[i][·] += Σ_k A[i·sa + k] · B[k·ldb + 0 .. 3] over a staged k-tile, k
// in order: 4 rows of a staged x or dpre tile times 4 columns of a staged
// weight tile.
__device__ __forceinline__ void tile_kt(float (&acc)[4][4], const float* A, int sa,
                                        const float* B, int ldb) {
#pragma unroll
  for (int kk = 0; kk < kTileK; kk += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + i * sa + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b = ld4(B + (kk + q) * ldb);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = comp(a[i], q);
        acc[i][0] = fmaf(x, b.x, acc[i][0]);
        acc[i][1] = fmaf(x, b.y, acc[i][1]);
        acc[i][2] = fmaf(x, b.z, acc[i][2]);
        acc[i][3] = fmaf(x, b.w, acc[i][3]);
      }
    }
  }
}

// A product's 4 × 4 sums, rows rq + i·n4 (below `rows`) of C (rows ldc
// apart): loaded, or 0 with `fresh`.
__device__ __forceinline__ void tile_load(float (&acc)[4][4], const float* C, int ldc, int rq,
                                          int n4, int rows, bool fresh) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = rq + i * n4;
    const float4 v = fresh || t >= rows ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : ld4(C + t * ldc);
    acc[i][0] = v.x, acc[i][1] = v.y, acc[i][2] = v.z, acc[i][3] = v.w;
  }
}

// acc[i][j] += Σ_k A[i·sa + k] · B[j·kLdt + k] over a staged k-tile, k in
// order: 4 rows of a dpre tile times 4 of a weight's own rows (the input
// gradients' products, W read as it lies).
__device__ __forceinline__ void tile_nt(float (&acc)[4][4], const float* A, int sa,
                                        const float* B) {
#pragma unroll
  for (int kk = 0; kk < kTileK; kk += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + i * sa + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(B + j * kLdt + kk);
    dot4_tile(acc, a, b);
  }
}

// Four floats of a row of x or a weight into the stage: by cp.async where
// they are 16 aligned bytes (`vec`), else one at a time, both from L2
// (.cg); 0 past the row (`left` floats of it remain) and for a row past the
// tile's (`live` false).
__device__ __forceinline__ void stage_row4(float* dst, const float* src, bool live, int left,
                                           bool vec) {
  if (live && vec && left >= 4) {
    cp_async16(dst, src);
    return;
  }
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live) {
    if (left > 0) v.x = __ldcg(src);
    if (left > 1) v.y = __ldcg(src + 1);
    if (left > 2) v.z = __ldcg(src + 2);
    if (left > 3) v.w = __ldcg(src + 3);
  }
  st4(dst, v);
}

// A thread's tiles of one block of a streamed product, at most: the sums
// stay in registers over the block's k-loop.  A block of the projections
// holds 3 · kTileRows/4 · kTileN/4 tiles of 4 × 4 (Q's, K's and V's), one
// of the input gradients 2 · (a side's rows each), one of the weight
// gradients kTileRows/4 · kTileN/8 of 4 × 8 (one matrix's).
constexpr int kProjJobs = 3 * (kTileRows / 4) * (kTileN / 4) / kThreads;
constexpr int kGradJobs = 2 * (kTileRows / 4) * (kTileN / 4) / kThreads;
constexpr int kWgradJobs = (kTileRows / 4) * (kTileN / 8) / kThreads;
// a thread's float4s of the input gradients' dpre tiles (both sides'
// rows) and of the weight gradients' xᵀ tile, at most
constexpr int kItems = 2 * kTileRows * kTileK / 4 / kThreads;
constexpr int kXtItems = kTileRows * kStepK / 4 / kThreads;

// acc[i][0 .. 7] += Σ_t A[i·sa + t] · B[t·ldb + 0 .. 7] over kStepK staged
// steps, t in order: 4 rows times 8 columns, each A load serving both
// halves; the second half (`two` false) is 0 past the tile's columns.
__device__ __forceinline__ void tile_kt8(float (&acc)[4][8], const float* A, int sa,
                                         const float* B, int ldb, bool two) {
#pragma unroll
  for (int kk = 0; kk < kStepK; kk += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + i * sa + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b = ld4(B + (kk + q) * ldb);
      const float4 b2 = two ? ld4(B + (kk + q) * ldb + 4) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = comp(a[i], q);
        acc[i][0] = fmaf(x, b.x, acc[i][0]);
        acc[i][1] = fmaf(x, b.y, acc[i][1]);
        acc[i][2] = fmaf(x, b.z, acc[i][2]);
        acc[i][3] = fmaf(x, b.w, acc[i][3]);
        acc[i][4] = fmaf(x, b2.x, acc[i][4]);
        acc[i][5] = fmaf(x, b2.y, acc[i][5]);
        acc[i][6] = fmaf(x, b2.z, acc[i][6]);
        acc[i][7] = fmaf(x, b2.w, acc[i][7]);
      }
    }
  }
}

// Four floats of a layout array (shared memory, a peer's through
// distributed shared memory, or device memory past L1 with `dev`), the
// padded columns pc .. pc + 3 of a row: 0 at a column that is padding
// (`vec` false: dh not a multiple of 4).
__device__ __forceinline__ float4 layout4(const float* src, bool dev, bool vec, int pc, int dh,
                                          int dhp) {
  float4 v = dev ? __ldcg(reinterpret_cast<const float4*>(src)) : ld4(src);
  if (!vec) {
    if (true_col<0>(pc, dh, dhp) < 0) v.x = 0.0f;
    if (true_col<0>(pc + 1, dh, dhp) < 0) v.y = 0.0f;
    if (true_col<0>(pc + 2, dh, dhp) < 0) v.z = 0.0f;
    if (true_col<0>(pc + 3, dh, dhp) < 0) v.w = 0.0f;
  }
  return v;
}

// A streamed block: rows from rb (of the own query and key rows alike) and
// padded columns from j0, and its rows and column quads.
struct Block {
  int rb, j0, mq, mk, nq4, nk4, nc4;
};

__device__ __forceinline__ Block block_at(int b, int ncb, int nqr, int nkr, int Dcp) {
  Block k;
  k.rb = b / ncb * kTileRows;
  k.j0 = b % ncb * kTileN;
  k.mq = min(max(nqr - k.rb, 0), kTileRows);
  k.mk = min(max(nkr - k.rb, 0), kTileRows);
  k.nq4 = (k.mq + 3) / 4;
  k.nk4 = (k.mk + 3) / 4;
  k.nc4 = min(kTileN, Dcp - k.j0) / 4;
  return k;
}

// Streamed 1.  Q = relu(xq·Wq[:, own] + bq), K and V likewise from xk, for
// the query rows [q0, q1) and the key rows [k0, k1): x's rows D apart in
// device memory, the weights' own columns c0 + true column (rows D apart,
// the replica's).  For each block of kTileRows rows and kTileN padded
// columns the k-loop stages kTileK columns of x (a tile of xq's rows, one
// of xk's) and kTileK rows of each weight by cp.async into one of the
// stage's two buffers while the other's are summed, so that each k-tile's
// loads (a block's first: during the block before's last) are in flight
// during the product before it.  A thread keeps up to kProjJobs tiles of 4
// rows × 4 columns of the three products, k in order, and writes relu(· +
// b); the lanes of a warp run along the columns, so that they read x's
// tile as broadcasts.  The padded rows are zero.
__device__ void stream_project(const float* xq, const float* xk, const float* wq,
                               const float* wk, const float* wv, int Tq, int Tk, int D, int dh,
                               int c0, int q0, int q1, int k0, int k1, bool vec, const Layout& L,
                               float* stage, const float* Bs, float* Qs, float* Ks, float* Vs) {
  const int tid = threadIdx.x;
  const int ldb = L.nc + kPad;
  const int nqr = q1 - q0, nkr = k1 - k0;
  const int ncb = (L.Dcp + kTileN - 1) / kTileN;
  const int nblk = (max(nqr, nkr) + kTileRows - 1) / kTileRows * ncb;
  const int wo = (L.ra + L.rk) * kLdt;  // the weight tiles, [3][kTileK][ldb]
  constexpr int kq = kTileK / 4;
  auto issue = [&](int b, int kb, float* buf) {
    const Block k = block_at(b, ncb, nqr, nkr, L.Dcp);
    for (int i = tid; i < 4 * (k.nq4 + k.nk4) * kq; i += kThreads) {
      const int row = i / kq, c = i % kq * 4;
      const bool isq = row < 4 * k.nq4;
      const int t = isq ? row : row - 4 * k.nq4, mr = isq ? k.mq : k.mk;
      const float* src = (isq ? xq + static_cast<long long>(q0 + k.rb) * D
                              : xk + static_cast<long long>(k0 + k.rb) * D) +
                         static_cast<long long>(max(min(t, mr - 1), 0)) * D + kb + c;
      stage_row4(buf + ((isq ? 0 : L.ra) + t) * kLdt + c, src, t < mr, D - kb - c, vec);
    }
    for (int i = tid; i < 3 * kTileK * k.nc4; i += kThreads) {
      const int m = i / (kTileK * k.nc4), e = i % (kTileK * k.nc4);
      const int kk = e / k.nc4, jj = e % k.nc4 * 4;
      const float* w = (m == 0 ? wq : m == 1 ? wk : wv) + static_cast<long long>(kb + kk) * D + c0;
      float* dst = buf + wo + (m * kTileK + kk) * ldb + jj;
      if (kb + kk < D && vec) {
        cp_async16(dst, w + k.j0 + jj);
      } else {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int cc = true_col<0>(k.j0 + jj + q, dh, L.dhp);
          v[q] = kb + kk < D && cc >= 0 ? __ldg(w + cc) : 0.0f;
        }
        st4(dst, make_float4(v[0], v[1], v[2], v[3]));
      }
    }
  };
  if (nblk > 0) issue(0, 0, stage);
  int it = 0;
  for (int b = 0; b < nblk; ++b) {
    const Block k = block_at(b, ncb, nqr, nkr, L.Dcp);
    const int jq = k.nq4 * k.nc4, jk = k.nk4 * k.nc4, jobs = jq + 2 * jk;
    // a thread's jobs: a tile of Q, K or V, 4 rows strided by a quarter of
    // the block's rows × 4 columns; its A and B offsets in a buffer
    int ao[kProjJobs], bo[kProjJobs], sa[kProjJobs];
    float acc[kProjJobs][4][4];
#pragma unroll
    for (int jj = 0; jj < kProjJobs; ++jj) {
      const int job = min(tid + jj * kThreads, jobs - 1);
      const int m = job < jq ? 0 : 1 + (job - jq) / jk;
      const int u = job < jq ? job : (job - jq) % jk;
      ao[jj] = ((m == 0 ? 0 : L.ra) + u / k.nc4) * kLdt;
      sa[jj] = (m == 0 ? k.nq4 : k.nk4) * kLdt;
      bo[jj] = wo + m * kTileK * ldb + u % k.nc4 * 4;
      zero_tile(acc[jj]);
    }
    for (int kb = 0; kb < D; kb += kTileK, ++it) {
      cp_async_wait_all();
      __syncthreads();  // k-tile it has landed, and no thread reads the other buffer
      float* next = stage + ((it + 1) & 1) * L.buf;
      if (kb + kTileK < D) {
        issue(b, kb + kTileK, next);
      } else if (b + 1 < nblk) {
        issue(b + 1, 0, next);
      }
      const float* buf = stage + (it & 1) * L.buf;
#pragma unroll
      for (int jj = 0; jj < kProjJobs; ++jj) {
        if (tid + jj * kThreads >= jobs) break;
        tile_kt(acc[jj], buf + ao[jj], sa[jj], buf + bo[jj], ldb);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kProjJobs; ++jj) {
      const int job = tid + jj * kThreads;
      if (job >= jobs) break;
      const int m = job < jq ? 0 : 1 + (job - jq) / jk;
      const int u = job < jq ? job : (job - jq) % jk;
      const int n4 = m == 0 ? k.nq4 : k.nk4, rows = m == 0 ? k.mq : k.mk;
      const int rq = u / k.nc4, c = k.j0 + u % k.nc4 * 4;
      float* C = m == 0 ? Qs + (q0 + k.rb) * L.ldc : (m == 1 ? Ks : Vs) + (k0 + k.rb) * L.ldc;
      const float4 bv = ld4(Bs + m * L.Dcp + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (rq + i * n4 < rows)
          st4(C + (rq + i * n4) * L.ldc + c,
              make_float4(fmaxf(acc[jj][i][0] + bv.x, 0.0f), fmaxf(acc[jj][i][1] + bv.y, 0.0f),
                          fmaxf(acc[jj][i][2] + bv.z, 0.0f), fmaxf(acc[jj][i][3] + bv.w, 0.0f)));
    }
  }
  // the padded rows of Q, K and V
  const int n4c = L.Dcp / 4;
  const int qn = (L.Tq4 - Tq) * n4c, kn = (L.Tk4 - Tk) * n4c;
  for (int i = tid; i < qn + 2 * kn; i += kThreads) {
    const int m = i < qn ? 0 : 1 + (i - qn) / kn;
    const int u = i < qn ? i : (i - qn) % kn;
    float* C = m == 0 ? Qs + Tq * L.ldc : (m == 1 ? Ks : Vs) + Tk * L.ldc;
    st4(C + u / n4c * L.ldc + u % n4c * 4, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  }
  __syncthreads();
}

// Streamed 5b.  The own input columns (c0 + true column) of d_queries = dy
// + dQpre·Wq[own, :]ᵀ for the query rows [q0, q1), into DYs (which holds
// dy), and of d_keys = dKpre·Wk[own, :]ᵀ + dVpre·Wv[own, :]ᵀ for the key
// rows [k0, k1), into Ks (free after the ReLU masks).  dpre is the layout's
// O, dK and dV (dQpre, dKpre, dVpre) of the `ranks` CTAs that hold its
// columns: under HEADS rank c' those of its heads, read through
// distributed shared memory (`peer`) or, in device memory, past L1; under
// ROWS (ranks = 1) the CTA's own, every column.  Two passes over dpre's
// padded columns in order (the ranks' in rank order): the first sums
// dQpre·Wqᵀ and dKpre·Wkᵀ, the second adds dVpre·Wvᵀ to d_keys.  For each
// block of kTileRows rows and kTileN own input columns, a k-tile of kTileK
// columns of each side's dpre rows and of the weights' own rows (W_m[own,
// true column], 0 at a padded column) is staged in one of the stage's two
// buffers while the other's are summed: the weights by cp.async, dpre
// loaded into registers before the product and stored after it.  A thread
// keeps up to kGradJobs tiles' sums in registers.
template <class Peer>
__device__ void stream_input_grads(float* Os, float* DKs, float* DVs, Peer peer, int me,
                                   int ranks, bool dev, const float* wq, const float* wk,
                                   const float* wv, int D, int dh, int c0, int q0, int q1, int k0,
                                   int k1, bool vec, const Layout& L, float* stage, float* DYs,
                                   float* Ks) {
  const int tid = threadIdx.x;
  const int ncols = ranks * L.Dcp;  // dpre's padded columns
  const int nqr = q1 - q0, nkr = k1 - k0;
  const int ncb = (L.Dcp + kTileN - 1) / kTileN;
  const int nblk = (max(nqr, nkr) + kTileRows - 1) / kTileRows * ncb;
  const int wo = (L.ra + L.rk) * kLdt;  // the weights' own rows, [2][nc][kLdt]
  constexpr int kq = kTileK / 4;
  float4 va[kItems];  // the next dpre tiles, between their loads and their stores
  for (int pass = 0; pass < 2; ++pass) {
    const bool with_q = pass == 0;  // the second pass has no query rows
    float* Ak = pass == 0 ? DKs : DVs;
    const float* Wk = pass == 0 ? wk : wv;
    auto at = [&](int b) {
      Block k = block_at(b, ncb, with_q ? nqr : 0, nkr, L.Dcp);
      return k;
    };
    auto load = [&](int b, int kb) {
      const Block k = at(b);
#pragma unroll
      for (int s = 0; s < kItems; ++s) {
        const int i = tid + s * kThreads, row = i / kq, kc = kb + i % kq * 4;
        const bool isq = row < 4 * k.nq4;
        const int t = isq ? row : row - 4 * k.nq4;
        va[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (row < 4 * (k.nq4 + k.nk4) && t < (isq ? k.mq : k.mk) && kc < ncols) {
          const int o = ranks == 1 ? me : kc / L.Dcp, pc = ranks == 1 ? kc : kc % L.Dcp;
          float* arr = isq ? Os : Ak;
          const int r0 = (isq ? q0 : k0) + k.rb + t;
          va[s] = layout4((o == me ? arr : peer(arr, o)) + r0 * L.ldc + pc, dev, vec, pc, dh,
                          L.dhp);
        }
      }
    };
    auto store = [&](int b, float* buf) {
      const Block k = at(b);
#pragma unroll
      for (int s = 0; s < kItems; ++s) {
        const int i = tid + s * kThreads, row = i / kq;
        if (row >= 4 * (k.nq4 + k.nk4)) break;
        const bool isq = row < 4 * k.nq4;
        st4(buf + ((isq ? 0 : L.ra) + (isq ? row : row - 4 * k.nq4)) * kLdt + i % kq * 4, va[s]);
      }
    };
    // the weights' own rows (input features c0 + true(j0 + ii)) over dpre's
    // k-tile of columns: as they lie where dpre's padded columns are the true ones
    auto issue = [&](int b, int kb, float* buf) {
      const Block k = at(b);
      const int nc = 4 * k.nc4, sides = with_q ? 2 : 1;
      for (int i = tid; i < sides * nc * kq; i += kThreads) {
        const int side = with_q ? i / (nc * kq) : 1, e = with_q ? i % (nc * kq) : i;
        const int ii = e / kq, o = e % kq * 4;
        const int ci = true_col<0>(k.j0 + ii, dh, L.dhp);
        const float* w = (side == 0 ? wq : Wk) + static_cast<long long>(c0 + max(ci, 0)) * D;
        float* dst = buf + wo + (side * L.nc + ii) * kLdt + o;
        if (vec) {
          stage_row4(dst, w + kb + o, ci >= 0, D - kb - o, true);
          continue;
        }
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kc = kb + o + q;
          const int cc = kc >= ncols ? -1
                         : ranks == 1 ? true_col<0>(kc, dh, L.dhp)
                                      : kc / L.Dcp * L.Dc + true_col<0>(kc % L.Dcp, dh, L.dhp);
          v[q] = ci >= 0 && cc >= 0 ? __ldg(w + cc) : 0.0f;
        }
        st4(dst, make_float4(v[0], v[1], v[2], v[3]));
      }
    };
    if (nblk > 0) {
      load(0, 0);
      issue(0, 0, stage);
      store(0, stage);
    }
    int it = 0;
    for (int b = 0; b < nblk; ++b) {
      const Block k = at(b);
      const int jq = k.nq4 * k.nc4, jk = k.nk4 * k.nc4, jobs = jq + jk;
      // a thread's jobs: a tile of d_queries or d_keys, 4 rows strided by a
      // quarter of the side's rows × 4 columns; its A and B offsets in a
      // buffer; its sums from dy (d_queries), 0 (d_keys' first pass) or
      // the first pass's
      int ao[kGradJobs], bo[kGradJobs], sa[kGradJobs];
      float acc[kGradJobs][4][4];
#pragma unroll
      for (int jj = 0; jj < kGradJobs; ++jj) {
        const int job = tid + jj * kThreads;
        if (job >= jobs) break;
        const bool isq = job < jq;
        const int u = isq ? job : job - jq, n4 = isq ? k.nq4 : k.nk4;
        ao[jj] = ((isq ? 0 : L.ra) + u % n4) * kLdt;
        sa[jj] = n4 * kLdt;
        bo[jj] = wo + ((isq ? 0 : L.nc) + u / n4 * 4) * kLdt;
        float* C = (isq ? DYs + (q0 + k.rb) * L.ldc : Ks + (k0 + k.rb) * L.ldc) + k.j0;
        tile_load(acc[jj], C + u / n4 * 4, L.ldc, u % n4, n4, isq ? k.mq : k.mk,
                  !isq && pass == 0);
      }
      for (int kb = 0; kb < ncols; kb += kTileK, ++it) {
        cp_async_wait_all();
        __syncthreads();  // k-tile it is staged, and no thread reads the other buffer
        float* next = stage + ((it + 1) & 1) * L.buf;
        const int nb = kb + kTileK < ncols ? b : b + 1, nkb = nb == b ? kb + kTileK : 0;
        const bool more = nb < nblk;
        if (more) {
          load(nb, nkb);
          issue(nb, nkb, next);
        }
        const float* buf = stage + (it & 1) * L.buf;
#pragma unroll
        for (int jj = 0; jj < kGradJobs; ++jj) {
          if (tid + jj * kThreads >= jobs) break;
          tile_nt(acc[jj], buf + ao[jj], sa[jj], buf + bo[jj]);
        }
        if (more) store(nb, next);
      }
#pragma unroll
      for (int jj = 0; jj < kGradJobs; ++jj) {
        const int job = tid + jj * kThreads;
        if (job >= jobs) break;
        const bool isq = job < jq;
        const int u = isq ? job : job - jq, n4 = isq ? k.nq4 : k.nk4, rows = isq ? k.mq : k.mk;
        const int rq = u % n4;
        float* C = (isq ? DYs + (q0 + k.rb) * L.ldc : Ks + (k0 + k.rb) * L.ldc) + k.j0 +
                   u / n4 * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (rq + i * n4 < rows)
            st4(C + (rq + i * n4) * L.ldc,
                make_float4(acc[jj][i][0], acc[jj][i][1], acc[jj][i][2], acc[jj][i][3]));
      }
    }
    __syncthreads();  // the pass's last tiles are read before the next pass stages
  }
}

// Streamed 5a.  dW_m[:, own] += x_mᵀ·dpre_m over the own time steps of
// each of the three matrices (x in device memory, rows D apart; dpre the
// layout's O, dK and dV, the own rows' own columns) and db_m = Σ dpre_m:
// added to the slot (`ws` [3][D][Dc], `bs` [3][Dc]) or written at the
// CTA's first row (`first`).  For each block of up to rw features of x and
// kTileN padded columns, the loop over the steps stages x's transposed tile
// [features][kStepK] and dpre's [kStepK][columns] (0 past the steps) in one
// of the stage's two buffers while the other's are summed, loading the next
// tile into registers before the product and storing it after; a thread
// keeps kWgradJobs tiles' sums in registers, and db's in a register, the
// steps in order.
__device__ void stream_weight_grads(const float* xq, const float* xk, const float* Os,
                                    const float* DKs, const float* DVs, bool dev, int D, int dh,
                                    int q0, int q1, int k0, int k1, bool vec, const Layout& L,
                                    float* stage, float* ws, float* bs, bool first) {
  const int tid = threadIdx.x;
  const int ldb = L.nc + kPad;
  const int nab = (D + L.rw - 1) / L.rw, ncb = (L.Dcp + kTileN - 1) / kTileN;
  const int per = nab * ncb;  // blocks a matrix
  const int dto = L.rw * kLds;  // dpre's tile in a buffer
  // block b: its matrix, first feature and features, first column and
  // column quads, first own step and steps
  struct WBlock {
    int m, a0, na, j0, nc4, t0, steps;
  };
  auto at = [&](int b) {
    WBlock k;
    k.m = b / per;
    const int e = b % per;
    k.a0 = e / ncb * L.rw;
    k.na = min(L.rw, D - k.a0);
    k.j0 = e % ncb * kTileN;
    k.nc4 = min(kTileN, L.Dcp - k.j0) / 4;
    k.t0 = k.m == 0 ? q0 : k0;
    k.steps = k.m == 0 ? q1 - q0 : k1 - k0;
    return k;
  };
  float4 vx[kXtItems], vd;  // the next tile, between its loads and its stores
  auto load = [&](int b, int ub) {
    const WBlock k = at(b);
    const int na4 = (k.na + 3) / 4, nt = max(0, min(kStepK, k.steps - ub));
    const float* x = (k.m == 0 ? xq : xk) + static_cast<long long>(k.t0 + ub) * D + k.a0;
#pragma unroll
    for (int s = 0; s < kXtItems; ++s) {
      const int i = tid + s * kThreads, t = i % kStepK, a = i / kStepK * 4;
      vx[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < kStepK * na4 && t < nt) {
        const float* src = x + static_cast<long long>(t) * D + a;
        if (vec) {
          vx[s] = ldg4(src);
        } else {
          vx[s].x = a < k.na ? __ldg(src) : 0.0f;
          vx[s].y = a + 1 < k.na ? __ldg(src + 1) : 0.0f;
          vx[s].z = a + 2 < k.na ? __ldg(src + 2) : 0.0f;
          vx[s].w = a + 3 < k.na ? __ldg(src + 3) : 0.0f;
        }
      }
    }
    vd = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (tid < kStepK * k.nc4 && tid / k.nc4 < nt) {
      const int pc = k.j0 + tid % k.nc4 * 4;
      const float* arr = k.m == 0 ? Os : k.m == 1 ? DKs : DVs;
      vd = layout4(arr + (k.t0 + ub + tid / k.nc4) * L.ldc + pc, dev, vec, pc, dh, L.dhp);
    }
  };
  // xᵀ: Xt[a][t] = x at step t, feature a0 + a (consecutive lanes on
  // consecutive steps: distinct banks); dpre's tile [kStepK][ldb]
  auto store = [&](int b, float* buf) {
    const WBlock k = at(b);
    const int na4 = (k.na + 3) / 4;
#pragma unroll
    for (int s = 0; s < kXtItems; ++s) {
      const int i = tid + s * kThreads, t = i % kStepK, a = i / kStepK * 4;
      if (i >= kStepK * na4) break;
      buf[a * kLds + t] = vx[s].x, buf[(a + 1) * kLds + t] = vx[s].y;
      buf[(a + 2) * kLds + t] = vx[s].z, buf[(a + 3) * kLds + t] = vx[s].w;
    }
    if (tid < kStepK * k.nc4) st4(buf + dto + tid / k.nc4 * ldb + tid % k.nc4 * 4, vd);
  };
  load(0, 0);
  store(0, stage);
  int it = 0;
  for (int b = 0; b < 3 * per; ++b) {
    const WBlock k = at(b);
    const int na4 = (k.na + 3) / 4, nc8 = (k.nc4 + 1) / 2, jobs = na4 * nc8;
    const int kt = max(1, (k.steps + kStepK - 1) / kStepK);  // one at least: a rank
    // without rows writes its zeros
    float acc[kWgradJobs][4][8];
    int xo[kWgradJobs], dof[kWgradJobs];
    bool two[kWgradJobs];
#pragma unroll
    for (int jj = 0; jj < kWgradJobs; ++jj) {
      const int job = tid + jj * kThreads, c = job % nc8 * 8;
      xo[jj] = job / nc8 * kLds;
      dof[jj] = dto + c;
      two[jj] = c + 4 < 4 * k.nc4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[jj][i][j] = 0.0f;
    }
    float db = 0.0f;  // a0 = 0: column tid's Σ dpre over the steps so far
    for (int s = 0; s < kt; ++s, ++it) {
      __syncthreads();  // tile it is staged, and no thread reads the other buffer
      const int nb = s + 1 < kt ? b : b + 1, nub = nb == b ? (s + 1) * kStepK : 0;
      const bool more = nb < 3 * per;
      if (more) load(nb, nub);
      const float* buf = stage + (it & 1) * L.buf;
      const int nt = max(0, min(kStepK, k.steps - s * kStepK));
      if (k.a0 == 0 && tid < 4 * k.nc4)
        for (int t = 0; t < nt; ++t) db += buf[dto + t * ldb + tid];
#pragma unroll
      for (int jj = 0; jj < kWgradJobs; ++jj) {
        if (tid + jj * kThreads >= jobs) break;
        tile_kt8(acc[jj], buf + xo[jj], na4 * kLds, buf + dof[jj], ldb, two[jj]);
      }
      if (more) store(nb, stage + ((it + 1) & 1) * L.buf);
    }
    const int m = k.m, a0 = k.a0, na = k.na, nc4 = k.nc4;
    if (a0 == 0 && tid < 4 * nc4) {  // db_m of the block's columns
      const int cc = true_col<0>(k.j0 + tid, dh, L.dhp);
      if (cc >= 0) bs[m * L.Dc + cc] = first ? db : bs[m * L.Dc + cc] + db;
    }
#pragma unroll
    for (int jj = 0; jj < kWgradJobs; ++jj) {
      const int job = tid + jj * kThreads;
      if (job >= jobs) break;
      const int aq = job / nc8, c8 = job % nc8 * 8, c = k.j0 + c8;
      float old[4][8] = {};  // the slot's sums so far, all loads in flight at once
      if (vec) {  // true columns are the padded ones: float4s along the slot's rows
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (first || aq + i * na4 >= na) continue;
          const float* e = ws + (static_cast<long long>(m) * D + a0 + aq + i * na4) * L.Dc + c;
          const float4 u = ld4(e), w = two[jj] ? ld4(e + 4) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          old[i][0] = u.x, old[i][1] = u.y, old[i][2] = u.z, old[i][3] = u.w;
          old[i][4] = w.x, old[i][5] = w.y, old[i][6] = w.z, old[i][7] = w.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (aq + i * na4 >= na) continue;
          float* e = ws + (static_cast<long long>(m) * D + a0 + aq + i * na4) * L.Dc + c;
          st4(e, make_float4(old[i][0] + acc[jj][i][0], old[i][1] + acc[jj][i][1],
                             old[i][2] + acc[jj][i][2], old[i][3] + acc[jj][i][3]));
          if (two[jj])
            st4(e + 4, make_float4(old[i][4] + acc[jj][i][4], old[i][5] + acc[jj][i][5],
                                   old[i][6] + acc[jj][i][6], old[i][7] + acc[jj][i][7]));
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = c8 + j < 4 * nc4 ? true_col<0>(c + j, dh, L.dhp) : -1;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!first && cc >= 0 && aq + i * na4 < na)
            old[i][j] = ws[(static_cast<long long>(m) * D + a0 + aq + i * na4) * L.Dc + cc];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = c8 + j < 4 * nc4 ? true_col<0>(c + j, dh, L.dhp) : -1;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (cc >= 0 && aq + i * na4 < na)
            ws[(static_cast<long long>(m) * D + a0 + aq + i * na4) * L.Dc + cc] =
                old[i][j] + acc[jj][i][j];
      }
    }
  }
  __syncthreads();
}

// The streamed design keeps its products' sums in registers (up to 255 a
// thread: one CTA an SM, as its shared memory mostly allows anyway).
template <int DH, bool DROP, bool WIDE = false, bool STREAM = false>
__global__ void __launch_bounds__(kThreads, STREAM ? 1 : 2) mha_bwd_kernel(const __grid_constant__ Params p) {
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
  const bool alias = p.alias != 0;
  const float inv_scale = p.inv_scale;
  constexpr int NR = DH ? DH : kMaxDh;  // registers of a head's features
  const int n4 = L.dhp / 4;
  // streamed: a row split by rows (every head a CTA), the layout in device memory
  const bool rows_split = STREAM && p.mode == kRows;
  const bool dev = STREAM && p.work != nullptr;
  const bool vec = STREAM && p.vec != 0;

  float* base = dev ? p.work + (static_cast<long long>(r) * gridDim.x + blockIdx.x) * L.total
                    : reinterpret_cast<float*>(smem4);
  float* stage = reinterpret_cast<float*>(smem4) + (dev ? 0 : L.total);  // streamed
  float* Ws = base + L.w;  // [3][D][ldc]: wq, wk, wv (resident)
  float* Bs = base + L.bias;  // [4][Dcp]: bq, bk, bv, γ
  const float* gam = Bs + 3 * L.Dcp;
  float* Qs = base + L.q;
  float* Os = base + L.o;
  float* DYs = base + L.dy;
  float* XR = base + L.xr;  // the own columns of xq (resident)
  float* GS = base + L.gs;  // the own columns of g (resident)
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
  float* X = region;  // the x rows (resident)

  // the replica's weights, and the slot of this CTA (its rank's columns;
  // under ROWS every column, a leaf of one tree a replica)
  const long long wo = static_cast<long long>(r) * D * D;
  const int vo = r * D;
  const int c0 = rows_split ? 0 : rank * L.Dc;  // the first own column
  const int h0 = rows_split ? 0 : rank * L.hc;  // the first own head
  const int lnc = rows_split ? 1 : cs;          // the CTAs a row's LayerNorm sums span
  const int Pc = 3 * D * L.Dc + 5 * L.Dc;
  const int tree = rows_split ? r : r * cs + rank;
  const int leaf = rows_split ? cid * cs + rank : cid;
  const int leaves = rows_split ? p.clusters * cs : p.clusters;
  // the own query and key rows (ROWS: the rank's share)
  int q0 = 0, q1 = Tq, k0 = 0, k1 = Tk;
  if (rows_split) {
    const int qs = (Tq + cs - 1) / cs, ks = (Tk + cs - 1) / cs;
    q0 = min(Tq, rank * qs), q1 = min(Tq, q0 + qs);
    k0 = min(Tk, rank * ks), k1 = min(Tk, k0 + ks);
  }
  // a peer's copy of a layout array, and its reads (past L1 from device memory)
  auto peer = [&](float* ptr, int rr) -> float* {
    if (dev) return ptr + static_cast<long long>(rr - rank) * L.total;
    return cs > 1 ? cluster.map_shared_rank(ptr, rr) : ptr;
  };
  auto peer4 = [&](const float* ptr) -> float4 {
    return dev ? __ldcg(reinterpret_cast<const float4*>(ptr)) : ld4(ptr);
  };
  auto sync_cluster = [&]() {
    if (dev) __threadfence();  // the workspace's writes, before the release
    cluster_sync();
  };

  // the column slices of wq, wk, wv (resident) and the biases, once a launch
  {
    const int nc4 = L.Dcp / 4;
    if constexpr (!STREAM) {
      for (int i = tid; i < 3 * D * nc4; i += kThreads) {
        const int m = i / (D * nc4), e = i % (D * nc4), k = e / nc4, j = e % nc4 * 4;
        const float* w = (m == 0 ? p.wq : m == 1 ? p.wk : p.wv) + wo + k * D + c0;
        float* dst = Ws + (m * D + k) * L.ldc + j;
        if constexpr (DH != 0) {
          cp_async16(dst, w + j);
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int cc = true_col<DH>(j + jj, dh, L.dhp);
            dst[jj] = cc < 0 ? 0.0f : __ldg(w + cc);
          }
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
    const float* xq = p.queries + b * Tq * D;
    const float* xk = p.keys + b * Tk * D;
    const float* gb = p.g + b * Tq * D;
    // the own columns of xq and g: resident in the layout, else the query
    // block's rows (from row blk) in the stage
    int blk = 0;
    auto XQ = [&](int t, int pc) -> float {
      if constexpr (STREAM) return stage[(t - blk) * L.ldc + pc];
      return XR[t * L.ldc + pc];
    };
    auto GQ = [&](int t, int pc) -> float {
      if constexpr (STREAM) return stage[(qb + t - blk) * L.ldc + pc];
      return GS[t * L.ldc + pc];
    };

    if constexpr (!STREAM) {
      // this row's x rows, and its own columns of xq and g (prefetched at
      // the previous row's end)
      if (first) load_own<DH>(xq, gb, Tq, D, c0, L.Dc, dh, L.dhp, L.ldc, XR, GS);
      load_x(xq, xk, Tq, Tk, D, alias, X, L.ldx);
      cp_async_wait_all();
      __syncthreads();

      // 1. the projections of the own columns, a tile of Q, K or V a job: 4
      // rows strided by a quarter of the rows (consecutive lanes,
      // consecutive rows) × 4 columns
      const int nc4 = L.Dcp / 4, nq = L.Tq4 / 4, nk = L.Tk4 / 4;
      const int qj = nq * nc4, kj = nk * nc4;
      for (int jb = tid; jb < qj + 2 * kj; jb += kThreads) {
        if (jb < qj) {
          project_tile(X, L.ldx, Tq, D, jb % nq, nq, jb / nq * 4, Ws, Bs, Qs, L.ldc);
        } else {
          const int m = (jb - qj) / kj + 1, v = (jb - qj) % kj;
          project_tile(alias ? X : X + Tq * L.ldx, L.ldx, Tk, D, v % nk, nk, v / nk * 4,
                       Ws + m * D * L.ldc, Bs + m * L.Dcp, m == 1 ? Ks : Vs, L.ldc);
        }
      }
      __syncthreads();
    } else {
      // 1. streamed: the own rows' projections, the weights from L2
      stream_project(xq, xk, p.wq + wo, p.wk + wo, p.wv + wo, Tq, Tk, D, dh, c0, q0, q1, k0,
                     k1, vec, L, stage, Bs, Qs, Ks, Vs);
      if (rows_split) {  // every CTA gathers the cluster's K and V rows
        sync_cluster();
        const int ks = (Tk + cs - 1) / cs, nc4 = L.Dcp / 4;
        for (int i = tid; i < Tk * nc4; i += kThreads) {
          const int t = i / nc4, owner = t / ks;
          if (owner == rank) continue;
          const int e = t * L.ldc + i % nc4 * 4;
          st4(Ks + e, peer4(peer(Ks, owner) + e));
          st4(Vs + e, peer4(peer(Vs, owner) + e));
        }
        __syncthreads();
      }
    }

    for (int t0 = q0; t0 < q1; t0 += qb) {
      const int nb = min(qb, q1 - t0);
      float* ex = ex2 + (((t0 - q0) / qb) & 1) * 4 * qb;  // this block's exchange buffer
      if constexpr (STREAM) {  // the block's own columns of xq and g, read by 3 and 3a
        blk = t0;
        for (int i = tid; i < nb * L.Dcp; i += kThreads) {
          const int t = i / L.Dcp, pc = i % L.Dcp, cc = true_col<DH>(pc, dh, L.dhp);
          if (cc < 0) continue;
          const long long e = static_cast<long long>(t0 + t) * D + c0 + cc;
          cp_async4(stage + t * L.ldc + pc, xq + e);
          cp_async4(stage + (qb + t) * L.ldc + pc, gb + e);
        }
      }

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
              kr = p.keep_mask + ((b * H + h0 + hl) * Tq + tg) * static_cast<long long>(Tk);
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
            kr = p.keep_mask + ((b * H + h0 + hl) * Tq + tg) * static_cast<long long>(Tk);
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
      if constexpr (STREAM) cp_async_wait_all();
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
          float sy = 0.0f, sd = 0.0f;
          for (int pc = part; pc < L.Dcp; pc += G) {
            if (true_col<DH>(pc, dh, L.dhp) < 0) continue;
            sy += orow[pc] + XQ(tg, pc);
            sd += GQ(tg, pc) * gam[pc];
          }
          sy = group_fold_sum(sy, G), sd = group_fold_sum(sd, G);
          const float mc = sy / dc;
          float m2 = 0.0f, sdy = 0.0f;
          for (int pc = part; pc < L.Dcp; pc += G) {
            if (true_col<DH>(pc, dh, L.dhp) < 0) continue;
            const float d = orow[pc] + XQ(tg, pc) - mc;
            m2 = fmaf(d, d, m2);
            sdy = fmaf(GQ(tg, pc) * gam[pc], d, sdy);
          }
          m2 = group_fold_sum(m2, G), sdy = group_fold_sum(sdy, G);
          if (valid && part == 0) st4(ex + 4 * t, make_float4(sy, m2, sd, sdy));
        }
      }
      if (lnc > 1) sync_cluster(); else __syncthreads();
      {
        const int G = group_size(nb, kThreads, L.Dcp / 4);
        const float dc = static_cast<float>(L.Dc);
        for (int u = tid; u < nb * G; u += kThreads) {
          const int t = u / G, part = u % G, tg = t0 + t;
          float sy = 0.0f, sd = 0.0f;
          for (int rr = 0; rr < lnc; ++rr) {
            const float4 e = peer4((lnc > 1 ? peer(ex, rr) : ex) + 4 * t);
            sy += e.x, sd += e.z;
          }
          const float mean = sy / D, m1 = sd / D;
          float m2 = 0.0f, sdy = 0.0f;
          for (int rr = 0; rr < lnc; ++rr) {
            const float4 e = peer4((lnc > 1 ? peer(ex, rr) : ex) + 4 * t);
            const float dm = e.x / dc - mean;
            m2 += e.y + dc * dm * dm;
            sdy += e.w + dm * e.z;
          }
          const float sigma = sqrtf(m2 / D + kLnEps);
          const float mdy = sdy / sigma / D;  // mean(dŷ⊙ŷ)
          const float* orow = Os + tg * L.ldc;
          for (int pc = part; pc < L.Dcp; pc += G) {
            float v = 0.0f;
            if (true_col<DH>(pc, dh, L.dhp) >= 0) {
              const float yh = (orow[pc] + XQ(tg, pc) - mean) / sigma;
              v = (GQ(tg, pc) * gam[pc] - m1 - yh * mdy) / sigma;
            }
            DYs[tg * L.ldc + pc] = v;
          }
          if (part == 0) mean_s[t] = mean, sigma_s[t] = sigma;
        }
      }
      __syncthreads();

      // 3b. dV += P′ᵀ·dy on half the threads, beside 3a on the other half
      keys_times_rows<DROP, true>(region, L.ldp, qb, DYs, L.ldc, DVs, t0, nb, t0 != q0, L.Tk4,
                                  L.hc, L.dhp, DROP ? 1.0f / p.keep : 1.0f, 0, kThreads / 2);
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
            const float gv = GQ(tg, pc);
            const float yh = (Os[tg * L.ldc + pc] + XQ(tg, pc) - mean_s[t]) / sigma_s[t];
            sg = fmaf(gv, yh, sg);
            sbeta += gv;
          }
          dgb[c] = t0 == q0 ? sg : dgb[c] + sg;
          dgb[L.Dc + c] = t0 == q0 ? sbeta : dgb[L.Dc + c] + sbeta;
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
      keys_times_rows<DROP, false>(region, L.ldp, qb, Qs, L.ldc, DKs, t0, nb, t0 != q0, L.Tk4,
                                   L.hc, L.dhp, 1.0f, 0, kThreads);
      __syncthreads();
    }

    if constexpr (STREAM) {
      if (q0 >= q1) {  // a rank with no query rows adds nothing to dK, dV, dγ, dβ
        for (int i = tid; i < L.Tk4 * L.ldc; i += kThreads) DKs[i] = 0.0f, DVs[i] = 0.0f;
        for (int i = tid; i < 2 * L.Dc; i += kThreads) dgb[i] = 0.0f;
        __syncthreads();
      }
      if (rows_split) {  // dK and dV of the own key rows: the cluster's partials in rank order
        sync_cluster();
        const int nc4 = L.Dcp / 4;
        for (int i = tid; i < (k1 - k0) * nc4; i += kThreads) {
          const int e = (k0 + i / nc4) * L.ldc + i % nc4 * 4;
          float4 sk = peer4(peer(DKs, 0) + e), sv = peer4(peer(DVs, 0) + e);
          for (int rr = 1; rr < cs; ++rr) {
            const float4 dk = peer4(peer(DKs, rr) + e), dv = peer4(peer(DVs, rr) + e);
            sk.x += dk.x, sk.y += dk.y, sk.z += dk.z, sk.w += dk.w;
            sv.x += dv.x, sv.y += dv.y, sv.z += dv.z, sv.w += dv.w;
          }
          st4(DKs + e, sk);
          st4(DVs + e, sv);
        }
        __syncthreads();
      }
    }

    // 5. the ReLU masks of the own rows (resident: the region is free, so x
    // is reloaded meanwhile, and the next row's own columns of xq and g)
    if constexpr (!STREAM) {
      load_x(xq, xk, Tq, Tk, D, alias, X, L.ldx);
      if (j + p.clusters < p.rows) {
        const long long bn = b + p.clusters;
        load_own<DH>(p.queries + bn * Tq * D, p.g + bn * Tq * D, Tq, D, c0, L.Dc, dh, L.dhp,
                     L.ldc, XR, GS);
      }
    }
    {
      const int nc4 = L.Dcp / 4;
      const int qn = (q1 - q0) * nc4, kn = (k1 - k0) * nc4;
      for (int i = tid; i < qn + kn; i += kThreads) {
        if (i < qn) {
          const int e = (q0 + i / nc4) * L.ldc + i % nc4 * 4;
          const float4 q = ld4(Qs + e);
          float4 d = ld4(Os + e);
          d.x = q.x > 0.0f ? d.x : 0.0f, d.y = q.y > 0.0f ? d.y : 0.0f;
          d.z = q.z > 0.0f ? d.z : 0.0f, d.w = q.w > 0.0f ? d.w : 0.0f;
          st4(Os + e, d);
        } else {
          const int u = i - qn, e = (k0 + u / nc4) * L.ldc + u % nc4 * 4;
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
    if constexpr (!STREAM) cp_async_wait_all();
    __syncthreads();
    // streamed, split by heads: the input gradients (5b) read the peers'
    // dpre columns, so the cluster's barrier is passed (arrive) here and
    // waited for after the weight gradients, which read the CTA's own
    const bool pull = STREAM && cs > 1 && !rows_split;
    if (pull) {
      if (dev) __threadfence();  // the workspace's writes, before the release
      cluster_arrive();
    }

    // 5a. the weight gradients of the own columns, into the slot (resident:
    // a tile of dWq, dWk or dWv a job, the rows split over a group where
    // there are few jobs); the row's dγ and dβ
    {
      float* slot = p.slots + (static_cast<long long>(tree) * p.tree_slots + leaf) * Pc;
      if constexpr (STREAM) {
        stream_weight_grads(xq, xk, Os, DKs, DVs, dev, D, dh, q0, q1, k0, k1, vec, L, stage, slot,
                            slot + 3 * D * L.Dc, first);
      } else {
        const int nc4 = L.Dcp / 4, D4 = D / 4;
        const int wt = D4 * nc4;
        const int G = group_size(3 * wt, kThreads);
        for (int u0 = 0; u0 < 3 * wt * G; u0 += kThreads) {
          const int u = u0 + tid;
          const bool valid = u < 3 * wt * G;
          const int job = (valid ? u : 3 * wt * G - 1) / G, part = u % G;
          const int m = job / wt, e = job % wt, a = e / nc4 * 4, c = e % nc4 * 4;
          weight_grad_tile<DH>(m == 0 || alias ? X : X + Tq * L.ldx, L.ldx,
                               m == 0 ? Os : m == 1 ? DKs : DVs, L.ldc, m == 0 ? Tq : Tk, a, c,
                               part, G, valid, slot + m * D * L.Dc,
                               slot + 3 * D * L.Dc + m * L.Dc, L.Dc, dh, L.dhp, first);
        }
      }
      for (int c = tid; c < 2 * L.Dc; c += kThreads) {
        float* e = slot + 3 * D * L.Dc + 3 * L.Dc + c;
        *e = first ? dgb[c] : *e + dgb[c];
      }
    }
    __syncthreads();

    if constexpr (STREAM) {
      // 5b. streamed: the own input columns of the own rows from the
      // cluster's dpre, once every rank has its own in place
      if (pull) cluster_wait();
      stream_input_grads(Os, DKs, DVs, peer, rank, rows_split ? 1 : cs, dev, p.wq + wo,
                         p.wk + wo, p.wv + wo, D, dh, c0, q0, q1, k0, k1, vec, L, stage, DYs, Ks);
      const int qn = (q1 - q0) * L.Dcp, kn = (k1 - k0) * L.Dcp;
      for (int i = tid; i < qn + kn; i += kThreads) {
        const bool isq = i < qn;
        const int u = isq ? i : i - qn, t = (isq ? q0 : k0) + u / L.Dcp, pc = u % L.Dcp;
        const int cc = true_col<DH>(pc, dh, L.dhp);
        if (cc < 0) continue;
        if (isq) {
          p.dq[(b * Tq + t) * D + c0 + cc] = DYs[t * L.ldc + pc];
        } else {
          p.dk[(b * Tk + t) * D + c0 + cc] = Ks[t * L.ldc + pc];
        }
      }
      // no peer reads this CTA's arrays any more, nor overwrites its own
      if (cs > 1) sync_cluster(); else __syncthreads();
      continue;
    }

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
  int count = leaves, idx = leaf;
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

template <int DH, bool DROP, bool WIDE = false, bool STREAM = false>
int launch(const Params& p, int replicas, int smem, cudaStream_t stream) {
  // the dynamic shared memory each device's variant is opted in to
  static int opted[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > opted[device]) {
    err = cudaFuncSetAttribute(mha_bwd_kernel<DH, DROP, WIDE, STREAM>,
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
  err = cudaLaunchKernelEx(&config, mha_bwd_kernel<DH, DROP, WIDE, STREAM>, p);
  // read (and clear) the launch's error either way, so that a refused
  // launch is not reported again by a later one
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <bool DROP>
int launch_heads(const Params& p, int replicas, int smem, cudaStream_t stream) {
  // heads past kMaxDh features or D past kMaxD run the wide variant
  const bool wide = p.dh > kMaxDh || p.D > kMaxD;
  if (p.mode != kResident) {
    return wide ? launch<0, DROP, true, true>(p, replicas, smem, stream)
                : launch<0, DROP, false, true>(p, replicas, smem, stream);
  }
  if (wide) return launch<0, DROP, true>(p, replicas, smem, stream);
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

Layout plan_layout(int Tq, int Tk, int D, int H, int dh, int cs, int qb, int mode, int alias) {
  return mode == kResident ? make_layout(Tq, Tk, D, H, dh, cs, qb, alias)
                           : make_stream_layout(Tq, Tk, D, H, dh, cs, qb, mode == kRows);
}

}  // namespace

extern "C" {

// Launches K3b on `stream` with the geometry of
// ops/cuda/mha.py::backward_plan: `clusters` clusters of `cs` CTAs of
// `threads` threads for each of `replicas` replicas (grid y), cluster i
// taking the rows i, i + clusters, ... of its replica's `rows`; query
// blocks of `qb` rows; `mode` the design (0 resident, 1 streamed split by
// heads, 2 streamed split by rows) and `alias` as the plan's; `smem` bytes
// of dynamic shared memory hold a CTA's layout of `per_cta` floats (and,
// streamed, its `stage` floats) or, with `work` not null (streamed only),
// the stage alone, the layout then `per_cta` floats of `work` a CTA.
// `slots` and `tickets` are the plan's scratch (tickets all 0): per
// replica, a tree of `tree_slots` slots (3·D·Dc + 5·Dc floats: Dc = D/cs,
// or D under ROWS) and `tree_tickets` tickets for each rank (one tree
// under ROWS).  `keep_mask` holds dropout's keep flags ([rows·replicas, H,
// Tq, Tk] bytes) and `keep` = 1 − rate; a null mask runs the variant
// without dropout.  Returns the launch's CUDA error (0 = launched); a
// refused cluster launch is returned, never retried with another geometry.
// The caller has checked shapes, types, devices, contiguity and, for D a
// multiple of 4, 16-byte alignment.
int mha_bwd_launch(const float* queries, const float* keys, const int* q_len,
                   const int* k_len, const float* wq, const float* bq, const float* wk,
                   const float* bk, const float* wv, const float* bv, const float* gamma,
                   const float* /*beta: the backward does not read it*/, const float* g,
                   const std::uint8_t* keep_mask, float* dq, float* dk,
                   float* dwq, float* dbq, float* dwk, float* dbk, float* dwv, float* dbv,
                   float* dgamma, float* dbeta, float* slots, unsigned* tickets, float* work,
                   int Tq, int Tk, int D, int H, int dh, int rows, int cs, int clusters,
                   int replicas, int qb, int mode, int alias, int tree_slots,
                   int tree_tickets, int per_cta, int stage, int threads, int smem, float keep,
                   void* stream) {
  const bool resident = mode == kResident;
  const int own = mode == kRows ? (Tq + cs - 1) / cs : Tq;  // a rank's query rows at most
  if (threads != kThreads || dh < 1 || D != dh * H || rows < 1 || clusters < 1 ||
      clusters > rows || replicas < 1 || (cs != 1 && cs != 2 && cs != 4 && cs != 8) ||
      mode < kResident || mode > kRows || (mode != kRows && H % cs != 0) ||
      (resident && (D % 4 != 0 || (D / cs) % 4 != 0 || work != nullptr)) ||
      qb < 1 ||
      qb > own || (alias && (Tq != Tk || queries != keys)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = plan_layout(Tq, Tk, D, H, dh, cs, qb, mode, alias);
  const int need = work != nullptr ? L.stage : L.total + L.stage;
  if (L.total != per_cta || L.stage != stage || 4 * need > smem)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{queries, keys, q_len, k_len, wq, bq, wk, bk, wv, bv, gamma, g, keep_mask,
                 dq, dk, dwq, dbq, dwk, dbk, dwv, dbv, dgamma, dbeta, slots, tickets, work,
                 Tq, Tk, D, H, dh, rows, cs, clusters, qb, mode, alias,
                 D % 4 == 0 && dh % 4 == 0, tree_slots, tree_tickets,
                 1.0f / sqrtf(static_cast<float>(dh)), keep, L};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keep_mask != nullptr) return launch_heads<true>(p, replicas, smem, s);
  return launch_heads<false>(p, replicas, smem, s);
}

// The floats of a CTA's layout and, streamed, of its stage, into *stage
// (ops/cuda/mha.py::_bwd_layout and _stream_layout are checked against
// them on the card).
int mha_bwd_layout_floats(int Tq, int Tk, int D, int H, int dh, int cs, int qb, int mode,
                          int alias, int* stage) {
  const Layout L = plan_layout(Tq, Tk, D, H, dh, cs, qb, mode, alias);
  *stage = L.stage;
  return L.total;
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
