// The tiled f32 product that the wide variants of K1, K2 (fwa_wide.cuh)
// and K3 (mha_fwd.cu) share.
//
// A CTA of T threads computes a BM × BN tile of outputs, Σ_k A(m, k) ·
// B(k, n) over k in order: the operands are staged BK deep in shared
// memory, two buffers deep (the next slice loads into registers while the
// present one is multiplied), and each thread keeps a TM × TN register tile
// of outputs (wide_product_async stages them by cp.async instead, three
// slices deep).  TF32 is off by contract, so the products run on the SMs'
// f32 FMA units; the tile's task is to keep them busy with few
// shared-memory reads an FMA: a 4 × 4 thread tile reads two 16-byte words
// for every 16 FMAs, an 8 × 8 tile four for every 64.  Every output's sum
// is one chain of fmaf over k from the value the caller put in it, so the
// result does not depend on the tiling: two geometries give the same bits.

#pragma once

#include <cuda_runtime.h>

namespace tile {

constexpr int kStages = 3;  // the slices wide_product_async keeps in flight

// A tile's geometry: T threads, BN / TN across its columns (tx) and BM / TM
// down its rows (ty), the operands staged BK deep, two buffers.  A thread's
// rows are TM·ty .. TM·ty + TM − 1 for TM <= 4, and for TM = 8 the four
// from 4·ty in each half of the tile; its columns likewise (TN = 4 or 8), so
// that a warp's reads of one k fall on consecutive 16-byte words.
template <int T, int BK, int BM, int BN, int TM, int TN>
struct Tiling {
  static_assert(BM / TM * (BN / TN) == T, "the threads cover the tile");
  static_assert((TM == 1 || TM == 2 || TM == 4 || TM == 8) && (TN == 4 || TN == 8),
                "register tiles of 1, 2, 4 or 8 rows by 4 or 8 columns");
  static constexpr int kThreads = T, kBK = BK, kBM = BM, kBN = BN, kRows = TM, kCols = TN;
  static constexpr int kLdA = BM + 4, kLdB = BN + 4;
  static constexpr int kSmemFloats = 2 * BK * (kLdA + kLdB);
  static constexpr int kAsyncSmemFloats = kStages * BK * (kLdA + kLdB);
  static constexpr int kTx = BN / TN;
  __device__ static int tx() { return static_cast<int>(threadIdx.x) % kTx; }
  __device__ static int ty() { return static_cast<int>(threadIdx.x) / kTx; }
  // the tile-local row of the thread's output row i, and column of its j
  __device__ static int row(int i) {
    return TM <= 4 ? TM * ty() + i : i / 4 * (BM / 2) + 4 * ty() + i % 4;
  }
  __device__ static int col(int j) {
    return TN == 4 ? 4 * tx() + j : j / 4 * (BN / 2) + 4 * tx() + j % 4;
  }
};

// A thread's outputs of a tile of geometry C.
template <class C>
using Acc = float[C::kRows][C::kCols];

// acc += the products of one staged slice: as [BK][LDA] (k, m) and bs
// [BK][LDB] (k, n), k in order.
template <class C>
__device__ __forceinline__ void multiply_slice(const float* As, const float* Bs, Acc<C>& acc) {
  constexpr int BK = C::kBK, BM = C::kBM, BN = C::kBN;
  constexpr int TM = C::kRows, TN = C::kCols, LDA = C::kLdA, LDB = C::kLdB;
  const float* as = As + C::row(0);
  const float* bs = Bs + C::col(0);
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float ai[TM], bj[TN];
    if constexpr (TM == 8) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * LDA);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * LDA + BM / 2);
      ai[0] = a0.x, ai[1] = a0.y, ai[2] = a0.z, ai[3] = a0.w;
      ai[4] = a1.x, ai[5] = a1.y, ai[6] = a1.z, ai[7] = a1.w;
    } else if constexpr (TM == 4) {
      const float4 av = *reinterpret_cast<const float4*>(as + k * LDA);
      ai[0] = av.x, ai[1] = av.y, ai[2] = av.z, ai[3] = av.w;
    } else if constexpr (TM == 2) {
      const float2 av = *reinterpret_cast<const float2*>(as + k * LDA);
      ai[0] = av.x, ai[1] = av.y;
    } else {
      ai[0] = as[k * LDA];
    }
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const float4 bv = *reinterpret_cast<const float4*>(bs + k * LDB + h * (BN / 2));
      bj[4 * h] = bv.x, bj[4 * h + 1] = bv.y, bj[4 * h + 2] = bv.z, bj[4 * h + 3] = bv.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
  }
}

// acc (this thread's outputs of a BM × BN tile of geometry C) += Σ_k A(m, k)
// · B(k, n) over k = 0 .. K − 1 in order.  la(m, k) and lb(k, n) give an
// operand's entry at tile-local m and n (0 outside the product); they are
// called for k < K only.  A_KFAST (B_KFAST): the operand's k is its
// contiguous index in device memory, so the threads staging it take
// consecutive k (else consecutive m or n) and the reads coalesce either
// way.  Every thread of the block calls it.
template <class C, bool A_KFAST, bool B_KFAST, class LA, class LB>
__device__ inline void wide_product(int K, LA la, LB lb, float* smem, Acc<C>& acc) {
  constexpr int T = C::kThreads, BK = C::kBK, BM = C::kBM, BN = C::kBN;
  constexpr int LDA = C::kLdA, LDB = C::kLdB;
  constexpr int NA = BK * BM / T;
  constexpr int NB = BK * BN / T;
  float* As = smem;                  // [2][BK][LDA]
  float* Bs = smem + 2 * BK * LDA;   // [2][BK][LDB]
  const int tid = threadIdx.x;
  float ra[NA], rb[NB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < NA; ++q) {
      const int i = tid + q * T;
      const int k = A_KFAST ? i % BK : i / BM;
      const int m = A_KFAST ? i / BK : i % BM;
      ra[q] = k0 + k < K ? la(m, k0 + k) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int i = tid + q * T;
      const int k = B_KFAST ? i % BK : i / BN;
      const int n = B_KFAST ? i / BK : i % BN;
      rb[q] = k0 + k < K ? lb(k0 + k, n) : 0.0f;
    }
  };
  auto put = [&](int buf) {
    float* as = As + buf * BK * LDA;
    float* bs = Bs + buf * BK * LDB;
#pragma unroll
    for (int q = 0; q < NA; ++q) {
      const int i = tid + q * T;
      const int k = A_KFAST ? i % BK : i / BM;
      const int m = A_KFAST ? i / BK : i % BM;
      as[k * LDA + m] = ra[q];
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int i = tid + q * T;
      const int k = B_KFAST ? i % BK : i / BN;
      const int n = B_KFAST ? i / BK : i % BN;
      bs[k * LDB + n] = rb[q];
    }
  };
  fetch(0);
  put(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) fetch(k0 + BK);  // in flight while this slice is multiplied
    multiply_slice<C>(As + buf * BK * LDA, Bs + buf * BK * LDB, acc);
    if (more) put(buf ^ 1);  // the other buffer was last read before the barrier
    __syncthreads();
    buf ^= 1;
  }
}

// cp.async: `bytes` (4 or 16) from src in device memory to dst in shared
// memory, or zeros where src is null (then nothing is read; `valid` is any
// address in device memory, for the instruction's operand); committed as a
// group, waited for by the thread that started it.
__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes,
                                         const float* valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const float* from = src != nullptr ? src : valid;
  const int n = src != nullptr ? bytes : 0;
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(from), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(from), "r"(n)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// As wide_product for two row-major operands in device memory, A [M, K]
// (rows lda apart) and B [K, N] (rows ldb apart), 0 past M, N and K: the
// slices staged by cp.async, kStages deep, so that no registers hold them
// on their way and a thread keeps one address of each operand.  The same
// sums as wide_product's.  Its shared memory: C::kAsyncSmemFloats.
template <class C>
__device__ inline void wide_product_async(int K, const float* A, int lda, int M, const float* B,
                                          int ldb, int N, float* smem, Acc<C>& acc) {
  constexpr int T = C::kThreads, BK = C::kBK, BM = C::kBM, BN = C::kBN;
  constexpr int LDA = C::kLdA, LDB = C::kLdB;
  static_assert(T % BK == 0 && T % BN == 0, "a thread stages one column of each operand");
  constexpr int NA = BK * BM / T, NB = BK * BN / T;
  constexpr int RA = T / BK, RB = T / BN;  // the rows of A, of B, a round of the threads
  float* As = smem;                         // [kStages][BK][LDA]
  float* Bs = smem + kStages * BK * LDA;    // [kStages][BK][LDB]
  const int tid = threadIdx.x;
  // A's entry (m, k) = (tid / BK + q·RA, k0 + tid % BK); B's (k, n) =
  // (k0 + tid / BN + q·RB, tid % BN)
  const int am = tid / BK, ak = tid % BK, bk = tid / BN, bn = tid % BN;
  const float* a = A + static_cast<long long>(am) * lda + ak;
  const float* b = B + static_cast<long long>(bk) * ldb + bn;
  auto stage = [&](int k0, int buf) {
    if (k0 < K) {
      float* as = As + buf * BK * LDA + ak * LDA + am;
      float* bs = Bs + buf * BK * LDB + bk * LDB + bn;
      const float* bk0 = b + static_cast<long long>(k0) * ldb;
#pragma unroll
      for (int q = 0; q < NA; ++q)
        cp_async(as + q * RA, am + q * RA < M && k0 + ak < K ? a + q * RA * lda + k0 : nullptr,
                 4, A);
#pragma unroll
      for (int q = 0; q < NB; ++q)
        cp_async(bs + q * RB * LDB, bn < N && k0 + bk + q * RB < K ? bk0 + q * RB * ldb : nullptr,
                 4, A);
    }
    cp_async_commit();  // a group a slice, empty past K, so that the counts hold
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) stage(st * BK, st);
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    cp_async_wait<kStages - 2>();  // this slice's group has landed
    __syncthreads();               // for every thread; the slice before is used up
    stage(k0 + (kStages - 1) * BK, (buf + kStages - 1) % kStages);
    multiply_slice<C>(As + buf * BK * LDA, Bs + buf * BK * LDB, acc);
    buf = (buf + 1) % kStages;
  }
}

// Calls epi(m, n, value, row(m)) for each of this thread's outputs of the
// tile at (m0, n0) that lies inside rows × cols: `row` is what the
// epilogue needs of a row (an offset, a mask), computed once a row.
template <class C, class Row, class Epi>
__device__ inline void wide_store(const Acc<C>& acc, int m0, int n0, int rows, int cols, Row row,
                                  Epi epi) {
#pragma unroll
  for (int i = 0; i < C::kRows; ++i) {
    const int m = m0 + C::row(i);
    if (m >= rows) continue;
    const auto r = row(m);
#pragma unroll
    for (int j = 0; j < C::kCols; ++j) {
      const int n = n0 + C::col(j);
      if (n < cols) epi(m, n, acc[i][j], r);
    }
  }
}

}  // namespace tile
