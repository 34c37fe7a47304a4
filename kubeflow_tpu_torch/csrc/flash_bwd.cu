// Flash-attention backward on Hopper's tensor cores: the dq pass and the
// dk/dv pass, with GQA.
//
// Replaces the Pallas kernels kubeflow_tpu/ops/attention.py `_dq_kernel`
// and `_dkv_kernel` (driven by `_flash_backward`). q/do/dq (B, H, Sq, D),
// k/v/dk/dv (B, Hkv, Sk, D) bf16; lse and delta (B, H, Sq) f32, lse from
// the forward (kft_flash_fwd with a non-null lse), delta = rowsum(dO * O)
// computed by the caller. Per live (row, key) pair:
//   s  = (q . k, f32 accumulation) * scale
//   p  = exp(s - lse)            (0, set explicitly, on a masked pair)
//   dp = dO . v
//   ds = p * (dp - delta) * scale
//   dq += bf16(ds) k,   dk += bf16(ds) q,   dv += bf16(p) dO
// with the reference's rounding points (p and ds rounded to bf16 before
// their products, f32 accumulation, one final rounding). Masks are those
// of the forward: causal with an optional window band, or non-causal; an
// optional segment-id document mask (ids non-decreasing, self-attention).
//
// Bound on the H100: operations. The dq pass does 6*D flops per live
// pair (s, dp, dq), the dk/dv pass 8*D (s, dp, dv, dk), on 64 x 64 tiles
// that load 2 x 64 x D bf16 each: at D=128 some 100 flops per byte
// loaded, and each byte comes from L2 for all but its first reader.
//
// Design: FlashAttention-2's two-kernel dataflow on Hopper's wgmma. A
// block is one warpgroup (128 threads); every product is a wgmma with
// f32 accumulators in registers.
//  * dq: a block owns 64 query rows of one (batch, head). Q and dO are
//    loaded once into swizzled shared memory, bf16 as stored. The block
//    walks the live 64-key tiles; K and V stream through a two-stage
//    ring, the copies of tile j+1 in flight while tile j computes. Per
//    tile: S = Q K^T and dP = dO V^T (both operands from shared memory),
//    then p and ds elementwise in registers (lse and delta of the
//    thread's two rows held in registers), then dQ += bf16(dS) K with dS
//    as the register A operand (the accumulator layout is the A layout:
//    no shuffle) and K read MN-major through the descriptor's transpose
//    bit (no transposed copy). dQ stays in registers until the epilogue.
//  * dk/dv: a block owns 64 keys of one (batch, kv head); K and V are
//    loaded once. It walks every query head of the GQA group and, for
//    each, every live 64-row query tile: Q, dO, lse and delta stream
//    through the ring. Per tile: S^T = K Q^T and dP^T = V dO^T, then P^T
//    and dS^T, then dV += bf16(P^T) dO and dK += bf16(dS^T) Q. The group
//    sum stays in the accumulators; (B, Hkv, Sk, D) is written once.
// Copies are 16-byte cp.async copies, zero-filled past the sequence end,
// that every thread issues for its share, not TMA from a producer warp:
// no tensor map is built per call, and with two blocks on each SM at
// D=128 one block's loads and elementwise work run under the other's
// products. With no producer warpgroup there is nothing to rebalance
// with setmaxnreg: the one warpgroup may use 255 registers a thread.
// Head dims: D < 64 is padded to one 64-column block in shared memory;
// the padding never reaches a stored result (the score products run
// D/16 k steps, output columns past D are not stored). At D=256 the
// output columns are split into two passes of 128 (the dk/dv pass would
// otherwise hold 256 f32 accumulators a thread): each pass walks the
// tiles again and recomputes s and dp, so D=256 does the score products
// twice; the dq pass does the same for its 64 x 256 dQ.
// Tiles outside the causal band or with disjoint segment-id ranges are
// skipped with the reference's predicates; the per-pair mask runs only
// on tiles that the band, a segment boundary or a sequence end cuts. No
// atomics: each output element is owned by one block and summed in one
// fixed order, so two launches give the same bits. Blocks start heaviest
// first (the causal band's longest rows or keys) to shorten the tail.
#include "flash_common.cuh"

namespace {

// The two score products of a tile, x = A_x B_x^T and y = A_y B_y^T over
// D: both operands K-major 64-row tiles in shared memory; waits for both.
template <int D>
__device__ __forceinline__ void score_products(float (&x)[32], float (&y)[32],
                                               uint32_t ax, uint32_t bx,
                                               uint32_t ay, uint32_t by) {
  wgmma_fence();
  issue_scores<D>(x, ax, bx);
  issue_scores<D>(y, ay, by);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(x);
  fence_regs(y);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, and two ring stages of (K, V); 1 KB to align the tiles.
  return 6 * Shape<D>::kTileBytes + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ seg, bf16* __restrict__ dq, int B,
                int H, int Hkv, int Sq, int Sk, int causal, int window,
                float scale) {
  using Sh = Shape<D>;
  constexpr uint32_t TB = Sh::kTileBytes;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sdo = sq + TB;
  const uint32_t ring = sdo + TB;  // stage s: K at ring + 2*s*TB, V + TB

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
  load_rows<D, kThreads>(sdo, dout + (size_t)bh * Sq * D, q0, Sq, tid);

  // This thread's two accumulator rows, their lse (in log2 units) and
  // delta.
  const int r_lo = q0 + 16 * warp + lane / 4;
  const int r_hi = r_lo + 8;
  const float* lse_b = lse + (size_t)bh * Sq;
  const float* delta_b = delta + (size_t)bh * Sq;
  const float lse_lo = r_lo < Sq ? lse_b[r_lo] * kLog2e : 0.f;
  const float lse_hi = r_hi < Sq ? lse_b[r_hi] * kLog2e : 0.f;
  const float dl_lo = r_lo < Sq ? delta_b[r_lo] : 0.f;
  const float dl_hi = r_hi < Sq ? delta_b[r_hi] : 0.f;
  const float scale_log2 = scale * kLog2e;

  int k_begin, k_end;
  key_range(q0, Sk, causal, window, k_begin, k_end);
  auto next_live = [&](int k0) {  // the first live key tile at or past k0
    while (k0 < k_end && !segments_meet(segb, q0, k0, Sq, Sk)) k0 += kTile;
    return k0;
  };
  const int first = next_live(k_begin);

  float s[32], dp[32];
  uint32_t frag[4][4];
#pragma unroll 1
  for (int pass = 0; pass < Sh::kPasses; ++pass) {
    float acc[Sh::kCols / 2];
#pragma unroll
    for (int i = 0; i < Sh::kCols / 2; ++i) acc[i] = 0.f;
    int k0 = first;
    int stage = 0;
    if (k0 < k_end) {
      load_rows<D, kThreads>(ring, kb, k0, Sk, tid);
      load_rows<D, kThreads>(ring + TB, vb, k0, Sk, tid);
    }
    cp_async_commit();
    while (k0 < k_end) {
      const int k_next = next_live(k0 + kTile);
      if (k_next < k_end) {
        const uint32_t nk = ring + (stage ^ 1) * 2 * TB;
        load_rows<D, kThreads>(nk, kb, k_next, Sk, tid);
        load_rows<D, kThreads>(nk + TB, vb, k_next, Sk, tid);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this tile (and Q, dO) landed
      fence_proxy_async();
      __syncthreads();

      const uint32_t sk = ring + stage * 2 * TB;
      score_products<D>(s, dp, sq, sk, sdo, sk + TB);
      const bool full = tile_full(q0, k0, Sq, Sk, causal, window, segb);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const bool hi = e >= 2;
          const int col = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
          float p = exp2_approx(fmaf(s[i], scale_log2, -(hi ? lse_hi : lse_lo)));
          if (!full && !pair_live(hi ? r_hi : r_lo, col, Sq, Sk, causal,
                                  window, segb))
            p = 0.f;
          dp[i] = p * (dp[i] - (hi ? dl_hi : dl_lo)) * scale;  // ds
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_fragment(frag[kk], dp, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<Sh::kCols>(
            acc, frag[kk],
            desc_mnmajor<Sh::kCols>(sk, pass * Sh::kCols / 64, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncthreads();  // everyone is done with this stage
      k0 = k_next;
      stage ^= 1;
    }
    store_rows<D, Sh::kCols>(dq + (size_t)bh * Sq * D, acc,
                             q0 + 16 * warp + lane / 4, Sq,
                             pass * Sh::kCols, lane);
  }
  cp_async_wait<0>();
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, and two ring stages of (Q, dO, lse, delta); 1 KB to align.
  return 2 * Shape<D>::kTileBytes + 2 * (2 * Shape<D>::kTileBytes + 1024) +
         1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, const int* __restrict__ seg,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H,
                 int Hkv, int Sq, int Sk, int causal, int window,
                 float scale) {
  using Sh = Shape<D>;
  constexpr uint32_t TB = Sh::kTileBytes;
  constexpr uint32_t kStage = 2 * TB + 1024;  // Q, dO, lse[64], delta[64]
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sk = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sv = sk + TB;
  const uint32_t ring = sv + TB;
  const uint8_t* ring_ptr = smem + (ring - smem_u32(smem));

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bkvs = B * Hkv;
  const int bkv = blockIdx.x % bkvs;
  // Key tile 0 first: under a causal mask it sees the most query rows.
  const int k0 = (blockIdx.x / bkvs) * kTile;
  const int b = bkv / Hkv;
  const int kvh = bkv % Hkv;
  const int group = H / Hkv;
  const int* segb = seg != nullptr ? seg + (size_t)b * Sq : nullptr;

  load_rows<D, kThreads>(sk, k + (size_t)bkv * Sk * D, k0, Sk, tid);
  load_rows<D, kThreads>(sv, v + (size_t)bkv * Sk * D, k0, Sk, tid);

  // Query rows that can see a key of [k0, k0 + 64): row >= k0 when
  // causal, and row < (k0 + 63) + window under a window band.
  int q_begin = 0;
  int q_end = Sq;
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(Sq, k0 + kTile - 1 + window);
  }
  // The tiles run over (query head g of the group, query tile q0).
  auto advance = [&](int& g, int& q0) {
    do {
      q0 += kTile;
      if (q0 >= q_end) {
        q0 = q_begin;
        ++g;
      }
    } while (g < group && !segments_meet(segb, q0, k0, Sq, Sk));
  };
  int g_first = 0;
  int q_first = q_begin;
  if (q_begin >= q_end)
    g_first = group;
  else if (!segments_meet(segb, q_first, k0, Sq, Sk))
    advance(g_first, q_first);
  auto load_tile = [&](int g, int q0, int st) {
    const size_t bh = (size_t)b * H + kvh * group + g;
    const uint32_t dst = ring + st * kStage;
    load_rows<D, kThreads>(dst, q + bh * Sq * D, q0, Sq, tid);
    load_rows<D, kThreads>(dst + TB, dout + bh * Sq * D, q0, Sq, tid);
    const int i = tid % kTile;
    const bool valid = q0 + i < Sq;
    const float* src = (tid < kTile ? lse : delta) + bh * Sq + (valid ? q0 + i : 0);
    cp_async4(dst + 2 * TB + (tid < kTile ? 0 : 4 * kTile) + 4 * i, src,
              valid);
  };

  // This thread's two accumulator rows (keys).
  const int c_lo = k0 + 16 * warp + lane / 4;
  const int c_hi = c_lo + 8;
  const float scale_log2 = scale * kLog2e;
  float s[32], dp[32];
  uint32_t pf[4][4], df[4][4];
#pragma unroll 1
  for (int pass = 0; pass < Sh::kPasses; ++pass) {
    float acc_k[Sh::kCols / 2], acc_v[Sh::kCols / 2];
#pragma unroll
    for (int i = 0; i < Sh::kCols / 2; ++i) {
      acc_k[i] = 0.f;
      acc_v[i] = 0.f;
    }
    int g = g_first;
    int q0 = q_first;
    int stage = 0;
    if (g < group) load_tile(g, q0, 0);
    cp_async_commit();
    while (g < group) {
      int g_next = g;
      int q_next = q0;
      advance(g_next, q_next);
      if (g_next < group) load_tile(g_next, q_next, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // this tile (and K, V) landed
      fence_proxy_async();
      __syncthreads();

      const uint32_t sq = ring + stage * kStage;
      const uint32_t sdo = sq + TB;
      const float* lse_t =
          reinterpret_cast<const float*>(ring_ptr + stage * kStage + 2 * TB);
      const float* delta_t = lse_t + kTile;
      score_products<D>(s, dp, sk, sq, sv, sdo);  // S^T, dP^T
      const bool full = tile_full(q0, k0, Sq, Sk, causal, window, segb);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const int qc = 8 * j + 2 * (lane % 4) + (e & 1);
          float p = exp2_approx(fmaf(s[i], scale_log2, -lse_t[qc] * kLog2e));
          if (!full && !pair_live(q0 + qc, e >= 2 ? c_hi : c_lo, Sq, Sk,
                                  causal, window, segb))
            p = 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - delta_t[qc]) * scale;  // ds
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        a_fragment(pf[kk], s, kk);
        a_fragment(df[kk], dp, kk);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<Sh::kCols>(
            acc_v, pf[kk],
            desc_mnmajor<Sh::kCols>(sdo, pass * Sh::kCols / 64, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<Sh::kCols>(
            acc_k, df[kk],
            desc_mnmajor<Sh::kCols>(sq, pass * Sh::kCols / 64, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      __syncthreads();  // everyone is done with this stage
      g = g_next;
      q0 = q_next;
      stage ^= 1;
    }
    const size_t off = (size_t)bkv * Sk * D;
    store_rows<D, Sh::kCols>(dk + off, acc_k, c_lo, Sk, pass * Sh::kCols,
                             lane);
    store_rows<D, Sh::kCols>(dv + off, acc_v, c_lo, Sk, pass * Sh::kCols,
                             lane);
  }
  cp_async_wait<0>();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* seg, void* dq,
              int B, int H, int Hkv, int Sq, int Sk, int causal, int window,
              float scale, cudaStream_t stream) {
  const size_t bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Sq + kTile - 1) / kTile * B * H;
  if (blocks == 0) return 0;
  flash_dq_kernel<D><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<bf16*>(dq), B, H, Hkv, Sq,
      Sk, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* seg, void* dk,
               void* dv, int B, int H, int Hkv, int Sq, int Sk, int causal,
               int window, float scale, cudaStream_t stream) {
  const size_t bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Sk + kTile - 1) / kTile * B * Hkv;
  if (blocks == 0) return 0;
  flash_dkv_kernel<D><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, H, Hkv, Sq, Sk, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/do/dq (B, H, Sq, D) bf16; k/v (B, Hkv, Sk, D) bf16; lse/delta
// (B, H, Sq) f32; seg (B, Sq) int32 or null (requires Sq == Sk). window
// <= 0 means none. D in {16, 32, 64, 128, 256}; -1 on any other.
KFT_EXPORT int kft_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* seg, void* dq,
                            int B, int H, int Hkv, int Sq, int Sk, int D,
                            int causal, int window, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KFT_DQ(DIM)                                                          \
  case DIM:                                                                  \
    return launch_dq<DIM>(q, k, v, dout, lse, delta, seg, dq, B, H, Hkv, Sq, \
                          Sk, causal, window, scale, s);
  switch (D) {
    KFT_DQ(16)
    KFT_DQ(32)
    KFT_DQ(64)
    KFT_DQ(128)
    KFT_DQ(256)
    default:
      return -1;
  }
#undef KFT_DQ
}

// The same inputs; dk/dv (B, Hkv, Sk, D) bf16, each query head's
// contribution summed over its group inside the kernel.
KFT_EXPORT int kft_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* seg, void* dk,
                             void* dv, int B, int H, int Hkv, int Sq, int Sk,
                             int D, int causal, int window, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KFT_DKV(DIM)                                                      \
  case DIM:                                                               \
    return launch_dkv<DIM>(q, k, v, dout, lse, delta, seg, dk, dv, B, H,  \
                           Hkv, Sq, Sk, causal, window, scale, s);
  switch (D) {
    KFT_DKV(16)
    KFT_DKV(32)
    KFT_DKV(64)
    KFT_DKV(128)
    KFT_DKV(256)
    default:
      return -1;
  }
#undef KFT_DKV
}
