// What the flash forward (flash_fwd.cu) and backward (flash_bwd.cu) share:
// the block and tile shape, the mask predicates of the reference (the
// per-pair test, the whole-tile test and the segment skip), the
// special-function exponent, the product wrappers, and the bf16 store of
// an accumulator's rows.
//
// Every kernel here is one warpgroup (128 threads) on 64-row tiles; a
// thread holds rows `16 * warp + lane / 4` and that + 8 of a 64-row
// accumulator (wgmma.cuh has the fragment layout).
#pragma once

#include "wgmma.cuh"

constexpr int kThreads = 128;     // one warpgroup
constexpr int kTile = kTileRows;  // query rows and keys per tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static constexpr int kPad = D < 64 ? 64 : D;           // columns in smem
  static constexpr int kCols = kPad > 128 ? 128 : kPad;  // per output pass
  static constexpr int kPasses = kPad / kCols;
  static constexpr int kSteps = D / 16;  // k steps of the score products
  static constexpr uint32_t kTileBytes = kTile * kPad * 2;
};

// 2^x on the special-function unit (ex2.approx, relative error ~2^-22;
// subnormal results flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool pair_live(int row, int col, int Sq, int Sk,
                                          int causal, int window,
                                          const int* segb) {
  bool keep = row < Sq && col < Sk;
  if (causal) {
    keep = keep && row >= col;
    if (window > 0) keep = keep && col > row - window;
  }
  if (keep && segb != nullptr) keep = segb[row] == segb[col];
  return keep;
}

// True when every pair of rows [q0, q0 + 64) x keys [k0, k0 + 64) is live:
// the tile needs no per-pair mask.
__device__ __forceinline__ bool tile_full(int q0, int k0, int Sq, int Sk,
                                          int causal, int window,
                                          const int* segb) {
  if (q0 + kTile > Sq || k0 + kTile > Sk) return false;
  if (causal) {
    if (q0 < k0 + kTile - 1) return false;
    if (window > 0 && k0 <= q0 + kTile - 1 - window) return false;
  }
  if (segb != nullptr) {
    const int id = segb[q0];
    if (segb[q0 + kTile - 1] != id || segb[k0] != id ||
        segb[k0 + kTile - 1] != id)
      return false;
  }
  return true;
}

// The reference's segment skip: ids are non-decreasing, so the two tiles
// share a document only if their id ranges overlap.
__device__ __forceinline__ bool segments_meet(const int* segb, int q0, int k0,
                                              int Sq, int Sk) {
  if (segb == nullptr) return true;
  return segb[q0] <= segb[min(k0 + kTile, Sk) - 1] &&
         segb[k0] <= segb[min(q0 + kTile, Sq) - 1];
}

// The key tiles [k_begin, k_end) a causal (optionally banded) query tile
// at q0 can see, k_begin on a tile boundary; every tile when non-causal.
__device__ __forceinline__ void key_range(int q0, int Sk, int causal,
                                          int window, int& k_begin,
                                          int& k_end) {
  k_begin = 0;
  k_end = Sk;
  if (causal) {
    k_end = min(Sk, q0 + kTile);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  k_begin = (k_begin / kTile) * kTile;
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 128)
    wgmma_rs_m64n128_tb(d, a, b);
  else
    wgmma_rs_m64n64_tb(d, a, b);
}

// Issues x = A_x B_x^T over D (both operands K-major 64-row tiles in
// shared memory), without committing or waiting.
template <int D>
__device__ __forceinline__ void issue_scores(float (&x)[32], uint32_t a,
                                             uint32_t b) {
  wgmma_ss_m64n64_first(x, desc_kmajor(a, 0), desc_kmajor(b, 0));
#pragma unroll
  for (int kk = 1; kk < Shape<D>::kSteps; ++kk)
    wgmma_ss_m64n64(x, desc_kmajor(a, kk), desc_kmajor(b, kk));
}

// Rows `lo` and `lo + 8` of a 64 x N accumulator, columns [c0, c0 + N),
// to a row-major (rows, D) bf16 matrix; rows at or past `rows` and
// columns at or past D are not written.
template <int D, int N>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[N / 2],
                                           int lo, int rows, int c0,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = c0 + 8 * j + 2 * (lane % 4);
    if (col >= D) continue;
    if (lo < rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)lo * D + col) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    if (lo + 8 < rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(lo + 8) * D + col) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}
