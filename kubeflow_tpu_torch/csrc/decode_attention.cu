// Flash-decode: one new token's q heads against the KV cache.
//
// Replaces the Pallas kernel kubeflow_tpu/ops/decode_attention.py
// `_decode_kernel` (driven by `decode_attention`). q (B, H, 1, hd) bf16
// against a (B, Hkv, capacity, hd) cache in bf16, or int8 with per-row
// f32 k/v scales; per-row positions pos (B,); an optional causal window;
// a linear or a rolling (ring) layout; any capacity.
//
// Bound on the H100: bytes. Each live cache row is read once (k and v,
// hd * itemsize each, plus two scales when int8) for G = H / Hkv query
// heads: about 4 operations a byte, far under the card's ridge (~295).
// At the serve shape (B = 8, Hkv = 2, ~700 live rows a row, hd = 128)
// that is ~6 MB, which the card streams in under 2 us only with tens of
// KB of loads in flight on every SM.
//
// Design against that bound:
// - The live range [lo, hi] of each (batch row, kv head) is cut into
//   kSplit equal slices, one block each, and the kSplit blocks form a
//   thread-block cluster: 16 rows x 8 slices fill 128 of the 132 SMs at
//   the serve shape (16 slices read slower on the card). kSplit is a
//   constant and a slice's bounds depend only on its own row's lo and
//   hi, so a row's result does not depend on the batch it came in (the
//   engine decodes at B = 8, generate() at B = 1, token for token alike).
// - A block streams its slice in tiles of kTile cache rows of k and v
//   through a kStages-deep ring of 16-byte cp.async copies into shared
//   memory (rows past the slice are zero-filled and never read, so the
//   ragged end of any capacity is safe): the first kStages - 1 tiles of
//   a slice are in flight at once. int8 tiles are widened to bf16 in
//   shared memory (exact: |v| <= 127), their scales copied beside them.
// - Both products run on tensor cores (mma.sync m16n8k16, bf16 in, f32
//   sums), the G query heads as the rows of A padded to 16 with zeros.
//   For S = q K^T the 4 warps split the tile's positions; the block takes
//   one max a tile (through shared memory) and one rescale; p, times the
//   int8 v scale and rounded to bf16 (the reference's order), goes to
//   shared memory as the A operand of O += P V, for which the warps
//   split the head dim. No warp reduction per cache row, and each warp
//   owns its O columns outright.
// - The slices meet through distributed shared memory: each block
//   publishes its (m, l, O) in f32, and block s of the cluster finishes
//   the s-th share of the row's G x hd outputs, reading the kSplit
//   partials in rank order. One launch, no workspace, no atomics: two
//   launches give the same bits. A slice with no live row (a row with
//   fewer live positions than kSplit, or cut by a window) publishes l = 0
//   and is masked out of the combine by that, not by its m.
// Rolling slots map to global position pos - ((pos - slot) mod capacity)
// with a non-negative modulo; every slot in [0, min(pos, capacity - 1)]
// is live, so the slices cut the slot range.
#include <cooperative_groups.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSplit = 8;      // slices of a row's live range: a cluster
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 8;   // query heads of one kv head: rows of A
constexpr int kStages = 3;     // tiles in the copy ring
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one instantiation, as byte offsets (each a multiple
// of 16).
template <int HD, typename KT>
struct Layout {
  static constexpr bool kInt8 = sizeof(KT) == 1;
  static constexpr int kTile = HD == 256 ? 32 : 64;  // cache rows a tile
  // bf16 row stride: 16 bytes of padding put the 8 rows of an ldmatrix
  // on 8 different bank groups.
  static constexpr int kRow = HD + 8;
  static constexpr int kPRow = kTile + 8;  // P row stride (bf16)
  static constexpr int kBf16Tile = kTile * kRow * 2;  // one k or v tile
  static constexpr int kRingTile = kInt8 ? kTile * HD : kBf16Tile;
  static constexpr int kRing = 0;
  static constexpr int kScales = kRing + kStages * 2 * kRingTile;
  static constexpr int kWide = kScales + (kInt8 ? kStages * 2 * kTile * 4 : 0);
  static constexpr int kP = kWide + (kInt8 ? 2 * kBf16Tile : 0);
  static constexpr int kRedM = kP + kMaxGroup * kPRow * 2;
  static constexpr int kRedL = kRedM + kWarps * kMaxGroup * 4;
  static constexpr int kM = kRedL + kWarps * kMaxGroup * 4;
  static constexpr int kL = kM + kMaxGroup * 4;
  static constexpr int kO = kL + kMaxGroup * 4;
  static constexpr int kBytes = kO + kMaxGroup * HD * 4;
};

// Grid (kSplit, B * Hkv), launched as clusters of kSplit blocks along x:
// block x of a cluster takes slice x of its (batch row, kv head)'s live
// range. `scale` is the softmax scale (hd^-0.5).
template <int HD, typename KT>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const bf16* __restrict__ q, const KT* __restrict__ kc,
                        const KT* __restrict__ vc,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ pos, bf16* __restrict__ out,
                        int H, int Hkv, int cap, int window, int rolling,
                        float scale) {
  using L = Layout<HD, KT>;
  constexpr int T = L::kTile;
  constexpr int kRow = L::kRow;
  constexpr int kQT = T / kWarps / 8;   // score n-tiles of a warp
  constexpr int kOT = HD / kWarps / 8;  // output n-tiles of a warp
  constexpr int kChunks = HD * (int)sizeof(KT) / 16;  // 16-byte copies a row
  constexpr int kCopies = 2 * T * kChunks;           // of a k and v tile
  static_assert(kCopies % kThreads == 0, "whole copies per thread");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t smem0 = smem_u32(smem);
  bf16* const p_s = reinterpret_cast<bf16*>(smem + L::kP);
  float* const red_m = reinterpret_cast<float*>(smem + L::kRedM);
  float* const red_l = reinterpret_cast<float*>(smem + L::kRedL);
  float* const m_s = reinterpret_cast<float*>(smem + L::kM);
  float* const l_s = reinterpret_cast<float*>(smem + L::kL);
  float* const o_s = reinterpret_cast<float*>(smem + L::kO);
  const float* const scales = reinterpret_cast<const float*>(smem + L::kScales);

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // this thread's query head (row of A and C)
  const int t = lane % 4;
  const int bk = blockIdx.y;  // b * Hkv + kv head
  const int b = bk / Hkv;
  const int kvh = bk % Hkv;
  const int G = H / Hkv;
  const int p = pos[b];
  const int hi = min(p, cap - 1);
  const int lo = !rolling && window > 0 ? max(p - window + 1, 0) : 0;
  // This block's slice [s_lo, s_hi] of the live range, from the row's own
  // bounds and constants only.
  const int chunk = (max(hi - lo + 1, 0) + kSplit - 1) / kSplit;
  const int s_lo = lo + split * chunk;
  const int s_hi = min(hi, s_lo + chunk - 1);
  const int ntiles = s_hi >= s_lo ? (s_hi - s_lo) / T + 1 : 0;
  const size_t base = (size_t)bk * cap;

  // Tile i of the slice into ring stage i % kStages (an empty group past
  // the last tile keeps the wait counts uniform).
  auto issue = [&](int i) {
    if (i < ntiles) {
      const int r0 = s_lo + i * T;
      const int st = i % kStages;
      constexpr int kRowBytes = L::kInt8 ? HD : kRow * 2;
#pragma unroll
      for (int j = 0; j < kCopies / kThreads; ++j) {
        const int idx = tid + j * kThreads;
        const int mat = idx / (T * kChunks);  // 0: k, 1: v
        const int r = (idx / kChunks) % T;
        const int c = idx % kChunks;
        const bool valid = r0 + r <= s_hi;
        const KT* src = (mat ? vc : kc) + (base + (valid ? r0 + r : 0)) * HD +
                        c * (16 / (int)sizeof(KT));
        cp_async16(smem0 + L::kRing + (st * 2 + mat) * L::kRingTile +
                       r * kRowBytes + c * 16,
                   src, valid);
      }
      if constexpr (L::kInt8) {
        for (int j = tid; j < 2 * T; j += kThreads) {
          const int mat = j / T;
          const int r = j % T;
          const bool valid = r0 + r <= s_hi;
          cp_async4(smem0 + L::kScales + ((st * 2 + mat) * T + r) * 4,
                    (mat ? vs : ks) + base + (valid ? r0 + r : 0), valid);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // A fragments of q (rows g < G; the rest, and rows 8-15, are zero).
  uint32_t qa[HD / 16][2];
  {
    const bf16* qrow =
        q + ((size_t)b * H + kvh * G + (g < G ? g : 0)) * HD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] =
          g < G ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk) : 0u;
      qa[kk][1] =
          g < G ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 8) : 0u;
    }
  }
  const float qk_scale = scale * kLog2e;  // scores in log2 units
  const int n_w = warp * (T / kWarps);    // this warp's positions of a tile
  const int d_w = warp * (HD / kWarps);   // and its output columns
  float m_run = KFT_NEG_INF;  // row g's running max (the whole block's)
  float l_run = 0.f;          // this thread's share of row g's sum
  float o[kOT][4];
#pragma unroll
  for (int j = 0; j < kOT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i has landed; tile i - 1 is consumed
    issue(i + kStages - 1);
    const int st = i % kStages;
    const int r0 = s_lo + i * T;
    uint32_t k_tile = smem0 + L::kRing + st * 2 * L::kRingTile;
    if constexpr (L::kInt8) {
      constexpr int kWiden = 2 * T * HD / 16;  // 16-byte int8 chunks
      static_assert(kWiden % kThreads == 0, "whole chunks per thread");
#pragma unroll
      for (int j = 0; j < kWiden / kThreads; ++j) {
        const int idx = tid + j * kThreads;
        const int mat = idx / (T * HD / 16);
        const int r = (idx / (HD / 16)) % T;
        const int c = idx % (HD / 16);
        const uint4 raw = *reinterpret_cast<const uint4*>(
            smem + L::kRing + (st * 2 + mat) * L::kRingTile + r * HD + c * 16);
        const int8_t* v8 = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          w[e] = pack_bf16((float)v8[2 * e], (float)v8[2 * e + 1]);
        uint4* dst = reinterpret_cast<uint4*>(
            smem + L::kWide + mat * L::kBf16Tile + (r * kRow + c * 16) * 2);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
      k_tile = smem0 + L::kWide;
    }
    const uint32_t v_tile = k_tile + (L::kInt8 ? L::kBf16Tile : L::kRingTile);
    const float* k_scale = scales + st * 2 * T;
    const float* v_scale = k_scale + T;

    // S = q K^T over this warp's positions n_w + [0, T / 4).
    float s[kQT][4];
#pragma unroll
    for (int j = 0; j < kQT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 32; ++kk) {
#pragma unroll
      for (int j = 0; j < kQT; ++j) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3,
                    k_tile + ((n_w + 8 * j + (lane & 7)) * kRow + 32 * kk +
                              8 * (lane >> 3)) * 2);
        mma_16816(s[j], qa[2 * kk][0], 0u, qa[2 * kk][1], 0u, b0, b1);
        mma_16816(s[j], qa[2 * kk + 1][0], 0u, qa[2 * kk + 1][1], 0u, b2, b3);
      }
    }
    // One max of the tile for the whole block.
    float mx = KFT_NEG_INF;
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pi = n_w + 8 * j + 2 * t + e;
        float v = s[j][e] * qk_scale;
        if constexpr (L::kInt8) v *= k_scale[pi];
        s[j][e] = v;
        if (r0 + pi <= s_hi) mx = fmaxf(mx, v);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (t == 0) red_m[warp * kMaxGroup + g] = mx;
    __syncthreads();
    float m_new = m_run;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      m_new = fmaxf(m_new, red_m[w * kMaxGroup + g]);
    const float alpha = exp2f(m_run - m_new);
    m_run = m_new;
    // p, masked explicitly past the slice; the PV operand is p times the
    // int8 v scale, rounded to bf16.
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      const int pi = n_w + 8 * j + 2 * t;
      float pr[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pr[e] = r0 + pi + e <= s_hi ? exp2f(s[j][e] - m_new) : 0.f;
        lsum += pr[e];
        if constexpr (L::kInt8) pr[e] *= v_scale[pi + e];
      }
      *reinterpret_cast<uint32_t*>(p_s + g * L::kPRow + pi) =
          pack_bf16(pr[0], pr[1]);
    }
    l_run = l_run * alpha + lsum;
#pragma unroll
    for (int j = 0; j < kOT; ++j) {
      o[j][0] *= alpha;
      o[j][1] *= alpha;
    }
    __syncthreads();  // P is whole

    // O[:, d_w + [0, HD / 4)] += P V over the whole tile.
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      const bf16* prow = p_s + g * L::kPRow + 16 * kk + 2 * t;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(prow);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(prow + 8);
#pragma unroll
      for (int j = 0; j < kOT; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1,
                          v_tile + ((16 * kk + (lane & 15)) * kRow + d_w +
                                    8 * j) * 2);
        mma_16816(o[j], a0, 0u, a2, 0u, b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // Publish this slice's partial: m, l (its warps' shares summed in
  // order) and O (each warp's own columns).
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  if (t == 0) {
    red_l[warp * kMaxGroup + g] = l_run;
    if (warp == 0) m_s[g] = m_run;
  }
#pragma unroll
  for (int j = 0; j < kOT; ++j)
    *reinterpret_cast<float2*>(o_s + g * HD + d_w + 8 * j + 2 * t) =
        make_float2(o[j][0], o[j][1]);
  __syncthreads();
  if (tid < kMaxGroup) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += red_l[w * kMaxGroup + tid];
    l_s[tid] = l;
  }

  // The cluster's combine: block `split` finishes outputs [split * share,
  // (split + 1) * share) of the row's G x HD, each from the kSplit
  // partials in rank order, all read at once.
  cluster.sync();
  const int share = G * HD / kSplit;  // G * HD is a multiple of 32
  for (int e = split * share + tid; e < (split + 1) * share; e += kThreads) {
    const int gi = e / HD;
    const int d = e % HD;
    float ms[kSplit], ls[kSplit], os[kSplit];
#pragma unroll
    for (int src = 0; src < kSplit; ++src) {
      ms[src] = cluster.map_shared_rank(m_s, src)[gi];
      ls[src] = cluster.map_shared_rank(l_s, src)[gi];
      os[src] = cluster.map_shared_rank(o_s, src)[gi * HD + d];
    }
    float mx = KFT_NEG_INF;
#pragma unroll
    for (int src = 0; src < kSplit; ++src)
      if (ls[src] > 0.f) mx = fmaxf(mx, ms[src]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int src = 0; src < kSplit; ++src) {
      const float f = ls[src] > 0.f ? exp2f(ms[src] - mx) : 0.f;
      num = fmaf(f, os[src], num);
      den = fmaf(f, ls[src], den);
    }
    out[((size_t)b * H + kvh * G + gi) * HD + d] =
        __float2bfloat16(den > 0.f ? num / den : 0.f);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <int HD, typename KT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pos, void* out, int B, int H, int Hkv,
           int cap, int window, int rolling, float scale,
           cudaStream_t stream) {
  constexpr int kBytes = Layout<HD, KT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<HD, KT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return (int)err;
  if (B * Hkv == 0) return 0;
  return launch_clusters(
      decode_attention_kernel<HD, KT>, kSplit, B * Hkv, kThreads, kBytes,
      stream, static_cast<const bf16*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<bf16*>(out), H, Hkv, cap, window, rolling, scale);
}

template <int HD>
int launch_dtype(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* pos, void* out, int B, int H,
                 int Hkv, int cap, int window, int rolling, float scale,
                 int kv_int8, cudaStream_t stream) {
  if (kv_int8)
    return launch<HD, int8_t>(q, k, v, ks, vs, pos, out, B, H, Hkv, cap,
                              window, rolling, scale, stream);
  return launch<HD, bf16>(q, k, v, ks, vs, pos, out, B, H, Hkv, cap, window,
                          rolling, scale, stream);
}

}  // namespace

// q/out (B, H, 1, hd) bf16; k/v (B, Hkv, cap, hd) bf16 or int8;
// ks/vs (B, Hkv, cap) f32 or null; pos (B,) int32. window <= 0 means
// none. hd in {32, 64, 128, 256}; H / Hkv <= 8. Returns -1 on a head
// dim the kernel was not built for.
KFT_EXPORT int kft_decode_attention(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, const void* pos,
                                    void* out, int B, int H, int Hkv,
                                    int cap, int hd, int window,
                                    int rolling, float scale, int kv_int8,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KFT_DECODE(DIM)                                                     \
  case DIM:                                                                 \
    return launch_dtype<DIM>(q, k, v, ks, vs, pos, out, B, H, Hkv, cap,     \
                             window, rolling, scale, kv_int8, s);
  switch (hd) {
    KFT_DECODE(32)
    KFT_DECODE(64)
    KFT_DECODE(128)
    KFT_DECODE(256)
    default:
      return -1;
  }
#undef KFT_DECODE
}
