// Flash-attention forward: tiled online-softmax attention with GQA.
//
// Replaces the Pallas kernel kubeflow_tpu/ops/attention.py `_flash_kernel`
// (driven by `_flash_forward` / `flash_attention`). q (B, H, Sq, D),
// k/v (B, Hkv, Sk, D) bf16; q head h reads kv head h / (H / Hkv) with no
// repetition. Causal with an optional window band, or non-causal; an
// optional segment-id document mask (ids non-decreasing along the
// sequence, self-attention). Scores, m, l and the accumulator are f32;
// p is rounded to bf16 before the PV product (the reference's
// `p.astype(v.dtype)`). A row no live tile touches emits 0, not NaN.
// With a non-null `lse` the kernel also writes each row's logsumexp
// m + log(l_safe), (B, H, Sq) f32, which the backward (flash_bwd.cu)
// recomputes p from; l_safe is l, or 1 for a row no live tile touched,
// whose lse is then -1e30. Inference passes null and stores nothing.
//
// Bound on the H100: operations. At the flagship's prefill (S=1024,
// D=128) a tile does ~D multiply-adds per byte it loads, far above the
// card's ridge, so the score and PV products bound it.
//
// Design, simple first: plain f32 FMA on the CUDA cores, no tensor
// cores yet (mma/wgmma are later work; PERF.md has the measured gap).
// A block of 256 threads owns 32 query rows of one (batch, head) and
// walks 64-key tiles of K and V staged in shared memory (about 58 KB at
// D=128, well under the 227 KB a block may use). Each query row belongs
// to 8 threads of one warp: they share the row's softmax state in
// registers, compute 8 of the tile's 64 scores each, and own D/8 of the
// row's accumulator columns, so the row max and sum need only three
// shuffles and no block barrier. Tiles wholly outside the causal band,
// or whose segment-id range is disjoint from the query tile's, are
// skipped, exactly as the reference skips dead blocks.
#include "common.cuh"

namespace {

constexpr int kBQ = 32;
constexpr int kBK = 64;
constexpr int kThreads = 256;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBQ * (kBK + 1)) +
         sizeof(bf16) * (kBK * (D + 2) + kBK * D);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 bf16* __restrict__ out, float* __restrict__ lse, int H,
                 int Hkv, int Sq, int Sk, int causal, int window,
                 float scale) {
  constexpr int QS = D + 1;    // f32 row stride (padded: no bank conflicts)
  constexpr int KS = D + 2;    // bf16 row stride (padded)
  constexpr int PS = kBK + 1;  // f32 row stride of the p tile
  constexpr int DJ = D / 8;    // accumulator columns per thread
  extern __shared__ float smem[];
  float* sq = smem;
  float* sp = sq + kBQ * QS;
  bf16* sk = reinterpret_cast<bf16*>(sp + kBQ * PS);
  bf16* sv = sk + kBK * KS;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)(b * Hkv + kvh) * Sk * D;
  const bf16* vb = v + (size_t)(b * Hkv + kvh) * Sk * D;
  const int* segb = seg != nullptr ? seg + (size_t)b * Sq : nullptr;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    sq[r * QS + d] = (q0 + r < Sq) ? to_f32(qb[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  const int tr = tid / 8;  // query row within the tile
  const int tc = tid % 8;  // this thread's slice of the row
  const int row = q0 + tr;
  float m = KFT_NEG_INF;
  float l = 0.f;
  float acc[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) acc[j] = 0.f;

  int k_begin = 0;
  int k_end = Sk;
  if (causal) {
    k_end = min(Sk, q0 + kBQ);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  k_begin = (k_begin / kBK) * kBK;
  int seg_qlo = 0, seg_qhi = 0;
  if (segb != nullptr) {
    seg_qlo = segb[q0];
    seg_qhi = segb[min(q0 + kBQ, Sq) - 1];
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    if (segb != nullptr) {
      const int klo = segb[k0];
      const int khi = segb[min(k0 + kBK, Sk) - 1];
      if (seg_qlo > khi || klo > seg_qhi) continue;  // uniform per block
    }
    __syncthreads();  // everyone is done reading the previous tile
    for (int i = tid; i < kBK * D / 2; i += kThreads) {
      const int c = (2 * i) / D;
      const int d = (2 * i) % D;
      __nv_bfloat162 kv2, vv2;
      if (k0 + c < Sk) {
        kv2 = *reinterpret_cast<const __nv_bfloat162*>(kb + (size_t)(k0 + c) * D + d);
        vv2 = *reinterpret_cast<const __nv_bfloat162*>(vb + (size_t)(k0 + c) * D + d);
      } else {
        kv2 = __floats2bfloat162_rn(0.f, 0.f);
        vv2 = kv2;
      }
      *reinterpret_cast<__nv_bfloat162*>(sk + c * KS + d) = kv2;
      *reinterpret_cast<__nv_bfloat162*>(sv + c * D + d) = vv2;
    }
    __syncthreads();

    float s[8];
    float mx = KFT_NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tc + 8 * j;
      const float* qrow = sq + tr * QS;
      const bf16* krow = sk + c * KS;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qrow[d], to_f32(krow[d]), dot);
      float sc = dot * scale;
      const int col = k0 + c;
      bool keep = col < Sk;
      if (causal) {
        keep = keep && row >= col;
        if (window > 0) keep = keep && col > row - window;
      }
      if (keep && segb != nullptr) keep = row < Sq && segb[row] == segb[col];
      if (!keep) sc = KFT_NEG_INF;
      s[j] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float pr = expf(s[j] - m_new);
      psum += pr;
      sp[tr * PS + tc + 8 * j] = round_bf16(pr);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 4);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();  // the row's p values come from this warp only

    const float* prow = sp + tr * PS;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tc + 8 * j;
      float a = acc[j] * alpha;
#pragma unroll 16
      for (int c = 0; c < kBK; ++c) a = fmaf(prow[c], to_f32(sv[c * D + d]), a);
      acc[j] = a;
    }
  }

  if (row < Sq) {
    const float l_safe = l == 0.f ? 1.f : l;
    bf16* orow = out + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tc + 8 * j] = __float2bfloat16(acc[j] / l_safe);
    if (lse != nullptr && tc == 0) lse[(size_t)bh * Sq + row] = m + logf(l_safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg,
           void* out, void* lse, int B, int H, int Hkv, int Sq, int Sk,
           int causal, int window, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(seg),
      static_cast<bf16*>(out), static_cast<float*>(lse), H, Hkv, Sq, Sk,
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
