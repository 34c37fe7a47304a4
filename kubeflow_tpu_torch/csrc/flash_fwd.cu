// Flash-attention forward on Hopper's tensor cores: tiled online-softmax
// attention with GQA, and the per-row logsumexp the backward reads.
//
// Replaces the Pallas kernel kubeflow_tpu/ops/attention.py `_flash_kernel`
// (driven by `_flash_forward` / `flash_attention`). q (B, H, Sq, D),
// k/v (B, Hkv, Sk, D) bf16; q head h reads kv head h / (H / Hkv) with no
// repetition. Causal with an optional window band, or non-causal; an
// optional segment-id document mask (ids non-decreasing along the
// sequence, self-attention). Per live (row, key) pair:
//   s = (q . k, f32 accumulation) * scale
// with the row max m and sum l of p = exp(s - m) kept online in f32, and
// o = sum bf16(p) v / l (p rounded to bf16 before the PV product, the
// reference's `p.astype(v.dtype)`). p is 0, set explicitly, on a masked
// pair, so a row with no live key (Sq > Sk under a window) gets l = 0,
// o = 0 and lse = -1e30 however the tiles fall. With a non-null `lse` the
// kernel also writes each row's m + log(l), (B, H, Sq) f32, in the
// natural log the backward (flash_bwd.cu) recomputes p from; inference
// passes null and stores nothing.
//
// Bound on the H100: operations. 4*D flops per live pair (the score and
// PV products) on 64 x 64 tiles that load 2 x 64 x D bf16: at D=128 some
// 64 flops per byte loaded, each K/V byte coming from L2 for all but its
// first reader.
//
// Design: the dq pass of flash_bwd.cu without dP, plus the online
// softmax, with the PV product of one tile running under the softmax of
// the next. A block is one warpgroup (128 threads) that owns 64 query
// rows of one (batch, head); Q is loaded once into 128-byte-swizzled
// shared memory, bf16 as stored. The block walks the live 64-key tiles
// with cp.async copies one tile ahead: K through a two-stage ring, V
// through a three-stage one (V of tile j-1 is still read while tile j+1
// lands). Per tile j:
//  * S_j = Q K_j^T, a wgmma with both operands K-major in shared memory,
//    issued together with O += bf16(P_{j-1}) V_{j-1} (P as the register
//    A operand: the accumulator layout is the A layout; V read MN-major
//    through the transpose bit); the block waits for S_j only;
//  * the mask, only on tiles that the band, a segment boundary or a
//    sequence end cuts (`tile_full`);
//  * the row max in the accumulator layout, four lanes to a row (two quad
//    shuffles, no shared memory), p = 2^(s * scale * log2e - m) on the
//    special-function unit; each thread keeps its share of the row sum
//    and the quad sums it once, in the epilogue;
//  * then it waits for the PV product, rescales O by 2^(m_old - m_new)
//    in registers and packs P_j for the next tile's product.
// The epilogue issues the last PV product and writes o = O / l in bf16
// and, on request, the lse. The operands of a product in flight are
// pinned (`fence_regs`) until its wait, so the compiler neither reads
// the accumulator early nor reuses the P registers.
// Head dims: D < 64 is padded to one 64-column block in shared memory
// (the padding never reaches a stored column). At D=256 the output
// columns are split into two passes of 128, as in the backward: each pass
// walks the tiles again and recomputes S, m and l (the same values, in
// the same order), so D=256 does the score product twice. Tiles outside
// the causal band or with disjoint segment-id ranges are skipped with the
// reference's predicates; blocks start heaviest first (the causal band's
// longest rows) to shorten the tail.
#include "flash_common.cuh"

namespace {

constexpr int kStagesK = 2;
constexpr int kStagesV = 3;

template <int D>
constexpr size_t fwd_smem_bytes() {
  // Q and the K and V rings; 1 KB to align the tiles.
  return (1 + kStagesK + kStagesV) * Shape<D>::kTileBytes + 1024;
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// O += bf16(P) V over one 64-key tile: four k steps of 16 keys.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[Shape<D>::kCols / 2],
                                         const uint32_t (&frag)[4][4],
                                         uint32_t sv, int pass) {
  using Sh = Shape<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<Sh::kCols>(
        acc, frag[kk],
        desc_mnmajor<Sh::kCols>(sv, pass * Sh::kCols / 64, kk));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 bf16* __restrict__ out, float* __restrict__ lse, int B,
                 int H, int Hkv, int Sq, int Sk, int causal, int window,
                 float scale) {
  using Sh = Shape<D>;
  constexpr uint32_t TB = Sh::kTileBytes;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t ring_k = sq + TB;                // stage s at + s*TB
  const uint32_t ring_v = ring_k + kStagesK * TB;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bhs = B * H;
  const int bh = blockIdx.x % bhs;
  const int qt = blockIdx.x / bhs;
  const int nq = (Sq + kTile - 1) / kTile;
  const int q0 = (causal ? nq - 1 - qt : qt) * kTile;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / Hkv);
  const bf16* kb = k + (size_t)(b * Hkv + kvh) * Sk * D;
  const bf16* vb = v + (size_t)(b * Hkv + kvh) * Sk * D;
  const int* segb = seg != nullptr ? seg + (size_t)b * Sq : nullptr;

  load_rows<D, kThreads>(sq, q + (size_t)bh * Sq * D, q0, Sq, tid);

  // This thread's two accumulator rows.
  const int r_lo = q0 + 16 * warp + lane / 4;
  const int r_hi = r_lo + 8;
  const float scale_log2 = scale * kLog2e;

  int k_begin, k_end;
  key_range(q0, Sk, causal, window, k_begin, k_end);
  auto next_live = [&](int k0) {  // the first live key tile at or past k0
    while (k0 < k_end && !segments_meet(segb, q0, k0, Sq, Sk)) k0 += kTile;
    return k0;
  };
  const int first = next_live(k_begin);
  // The t-th live tile lands in K stage t % 2 and V stage t % 3.
  auto load_kv = [&](int k0, int t) {
    load_rows<D, kThreads>(ring_k + (t % kStagesK) * TB, kb, k0, Sk, tid);
    load_rows<D, kThreads>(ring_v + (t % kStagesV) * TB, vb, k0, Sk, tid);
  };

  float s[32];
  uint32_t frag[4][4];
#pragma unroll 1
  for (int pass = 0; pass < Sh::kPasses; ++pass) {
    float acc[Sh::kCols / 2];
#pragma unroll
    for (int i = 0; i < Sh::kCols / 2; ++i) acc[i] = 0.f;
    // Running max (of s * scale * log2e) and this thread's share of the
    // running sum, for rows r_lo and r_hi.
    float m_lo = KFT_NEG_INF, m_hi = KFT_NEG_INF;
    float l_lo = 0.f, l_hi = 0.f;
    int k0 = first;
    int t = 0;
    uint32_t sv_prev = 0;  // V of the tile whose P waits in `frag`
    if (k0 < k_end) load_kv(k0, 0);
    cp_async_commit();
    while (k0 < k_end) {
      const int k_next = next_live(k0 + kTile);
      if (k_next < k_end) load_kv(k_next, t + 1);
      cp_async_commit();
      cp_async_wait<1>();  // this tile (and Q) landed
      fence_proxy_async();
      __syncthreads();

      wgmma_fence();
      issue_scores<D>(s, sq, ring_k + (t % kStagesK) * TB);
      wgmma_commit();
      if (t > 0) {
        issue_pv<D>(acc, frag, sv_prev, pass);
        wgmma_commit();
        wgmma_wait<1>();  // S only: the PV product runs on
      } else {
        wgmma_wait<0>();
      }
      fence_regs(s);

      // The mask runs only on a tile the band, a segment boundary or a
      // sequence end cuts: a branch per tile, not a predicate per pair.
      uint32_t dead = 0;  // bit i: pair i of this thread is masked
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
      if (!tile_full(q0, k0, Sq, Sk, causal, window, segb)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = (i & 2) ? r_hi : r_lo;
          const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          if (!pair_live(row, col, Sq, Sk, causal, window, segb))
            dead |= 1u << i;
        }
      }
      float mx_lo = KFT_NEG_INF, mx_hi = KFT_NEG_INF;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float x = (dead >> i) & 1u ? KFT_NEG_INF : s[i];
        if (i & 2)
          mx_hi = fmaxf(mx_hi, x);
        else
          mx_lo = fmaxf(mx_lo, x);
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      const float new_lo = fmaxf(m_lo, mx_lo);
      const float new_hi = fmaxf(m_hi, mx_hi);
      // 1 while a row has seen no live key (both maxima are -1e30), 0
      // when its first live key arrives (the sums so far are 0 anyway).
      const float alpha_lo = exp2_approx(m_lo - new_lo);
      const float alpha_hi = exp2_approx(m_hi - new_hi);
      m_lo = new_lo;
      m_hi = new_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = (i & 2) != 0;
        float p = exp2_approx(s[i] - (hi ? m_hi : m_lo));
        if ((dead >> i) & 1u) p = 0.f;
        s[i] = p;
        if (hi)
          sum_hi += p;
        else
          sum_lo += p;
      }
      l_lo = l_lo * alpha_lo + sum_lo;
      l_hi = l_hi * alpha_hi + sum_hi;

      if (t > 0) {
        wgmma_wait<0>();  // the previous tile's PV product
        fence_frags(frag);
      }
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < Sh::kCols / 8; ++j) {
        acc[4 * j] *= alpha_lo;
        acc[4 * j + 1] *= alpha_lo;
        acc[4 * j + 2] *= alpha_hi;
        acc[4 * j + 3] *= alpha_hi;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_fragment(frag[kk], s, kk);
      sv_prev = ring_v + (t % kStagesV) * TB;
      __syncthreads();  // everyone is done with the stages reloaded next
      k0 = k_next;
      ++t;
    }
    if (t > 0) {  // the last tile's PV product
      wgmma_fence();
      issue_pv<D>(acc, frag, sv_prev, pass);
      wgmma_commit();
      wgmma_wait<0>();
      fence_frags(frag);
      fence_regs(acc);
    }
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
    // A row with no live key has l = 0 and acc = 0: it stores 0.
    const float ls_lo = l_lo == 0.f ? 1.f : l_lo;
    const float ls_hi = l_hi == 0.f ? 1.f : l_hi;
#pragma unroll
    for (int j = 0; j < Sh::kCols / 8; ++j) {
      acc[4 * j] /= ls_lo;
      acc[4 * j + 1] /= ls_lo;
      acc[4 * j + 2] /= ls_hi;
      acc[4 * j + 3] /= ls_hi;
    }
    store_rows<D, Sh::kCols>(out + (size_t)bh * Sq * D, acc, r_lo, Sq,
                             pass * Sh::kCols, lane);
    if (pass == 0 && lse != nullptr && lane % 4 == 0) {
      float* lse_b = lse + (size_t)bh * Sq;
      if (r_lo < Sq)
        lse_b[r_lo] = l_lo == 0.f ? KFT_NEG_INF : m_lo / kLog2e + logf(l_lo);
      if (r_hi < Sq)
        lse_b[r_hi] = l_hi == 0.f ? KFT_NEG_INF : m_hi / kLog2e + logf(l_hi);
    }
    __syncthreads();  // the next pass reloads the rings from stage 0
  }
  cp_async_wait<0>();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg,
           void* out, void* lse, int B, int H, int Hkv, int Sq, int Sk,
           int causal, int window, float scale, cudaStream_t stream) {
  const size_t bytes = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Sq + kTile - 1) / kTile * B * H;
  if (blocks == 0) return 0;
  flash_fwd_kernel<D><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(seg),
      static_cast<bf16*>(out), static_cast<float*>(lse), B, H, Hkv, Sq, Sk,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out (B, H, Sq, D) bf16; k/v (B, Hkv, Sk, D) bf16; seg (B, Sq) int32
// or null (requires Sq == Sk); lse (B, H, Sq) f32 or null. window <= 0
// means none. D in {16, 32, 64, 128, 256}. Returns -1 on a head dim the
// kernel was not built for.
KFT_EXPORT int kft_flash_fwd(const void* q, const void* k, const void* v,
                             const void* seg, void* out, void* lse, int B,
                             int H, int Hkv, int Sq, int Sk, int D,
                             int causal, int window, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KFT_FWD(DIM)                                                       \
  case DIM:                                                                \
    return launch<DIM>(q, k, v, seg, out, lse, B, H, Hkv, Sq, Sk, causal, \
                       window, scale, s);
  switch (D) {
    KFT_FWD(16)
    KFT_FWD(32)
    KFT_FWD(64)
    KFT_FWD(128)
    KFT_FWD(256)
    default:
      return -1;
  }
#undef KFT_FWD
}
