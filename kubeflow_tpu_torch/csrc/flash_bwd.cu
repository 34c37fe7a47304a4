// Flash-attention backward: the dq pass and the dk/dv pass, with GQA.
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
// Bound on the H100: operations. At the training shape (S=2048, D=128)
// the dq pass does 6*D flops per live pair and the dk/dv pass 8*D, on
// tiles that are read a few times each: far above the card's ridge.
//
// Design, simple first (the forward's scheme, CUDA-core FMA, no tensor
// cores yet). The TPU kernels carry their accumulators across a
// sequential grid axis; here one block owns its output tile and a loop
// inside the block takes the place of that axis, so each output element
// is summed by one thread in one fixed order: no atomics, and two
// launches on the same inputs give the same bits.
//  * dq: a block owns 32 query rows of one (batch, head) and walks the
//    live 64-key tiles, K and V staged in shared memory. As in the
//    forward, 8 threads of one warp share a row: each computes 8 of the
//    tile's 64 (s, dp) pairs and owns D/8 of the row's dq columns.
//  * dk/dv: a block owns 32 keys of one (batch, kv head) and walks the
//    live 64-row query tiles of EVERY query head of its group, so the
//    group's sum stays in registers and (B, Hkv, Sk, D) is written
//    directly (no per-query-head transient). 8 threads share a key row:
//    each computes 8 of the tile's 64 pairs and owns D/8 columns of both
//    dk and dv. Shared memory (about 83 KB at D=128, 149 KB at D=256)
//    is past the 48 KB default, so the launch opts in first.
// Tiles wholly outside the causal band, or whose segment-id ranges are
// disjoint, are skipped with the reference's predicates; keys and rows
// past the sequence ends are never read and never written.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// dq: query rows per block, keys per tile.
constexpr int kQ_Q = 32;
constexpr int kQ_K = 64;
// dk/dv: keys per block, query rows per tile.
constexpr int kKV_K = 32;
constexpr int kKV_Q = 64;

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

// Copy `rows` rows of D bf16 values starting at row r0 of a (S, D)
// matrix into shared memory with row stride `stride` (bf16 elements),
// zero-filling rows at or past S.
template <int D>
__device__ __forceinline__ void stage_bf16(bf16* dst, int stride,
                                           const bf16* src, int r0, int rows,
                                           int S) {
  for (int i = threadIdx.x; i < rows * D / 2; i += kThreads) {
    const int r = (2 * i) / D;
    const int d = (2 * i) % D;
    __nv_bfloat162 x = __floats2bfloat162_rn(0.f, 0.f);
    if (r0 + r < S)
      x = *reinterpret_cast<const __nv_bfloat162*>(src + (size_t)(r0 + r) * D + d);
    *reinterpret_cast<__nv_bfloat162*>(dst + r * stride + d) = x;
  }
}

// The same, widened to f32 (row stride `stride` floats).
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, int stride,
                                          const bf16* src, int r0, int rows,
                                          int S) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    dst[r * stride + d] = (r0 + r < S) ? to_f32(src[(size_t)(r0 + r) * D + d]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * kQ_Q * (D + 1) + kQ_Q * (kQ_K + 1)) +
         sizeof(bf16) * (2 * kQ_K * (D + 2));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ seg, bf16* __restrict__ dq, int H,
                int Hkv, int Sq, int Sk, int causal, int window, float scale) {
  constexpr int QS = D + 1;     // f32 row stride (padded: no bank conflicts)
  constexpr int KS = D + 2;     // bf16 row stride (padded)
  constexpr int PS = kQ_K + 1;  // f32 row stride of the ds tile
  constexpr int DJ = D / 8;     // dq columns per thread
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kQ_Q * QS;
  float* sds = sdo + kQ_Q * QS;
  bf16* sk = reinterpret_cast<bf16*>(sds + kQ_Q * PS);
  bf16* sv = sk + kQ_K * KS;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / Hkv);
  const int q0 = blockIdx.x * kQ_Q;
  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* dob = dout + (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)(b * Hkv + kvh) * Sk * D;
  const bf16* vb = v + (size_t)(b * Hkv + kvh) * Sk * D;
  const int* segb = seg != nullptr ? seg + (size_t)b * Sq : nullptr;

  stage_f32<D>(sq, QS, qb, q0, kQ_Q, Sq);
  stage_f32<D>(sdo, QS, dob, q0, kQ_Q, Sq);

  const int tr = tid / 8;  // query row within the tile
  const int tc = tid % 8;  // this thread's slice of the row
  const int row = q0 + tr;
  const float row_lse = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
  const float row_delta = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
  float acc[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) acc[j] = 0.f;

  int k_begin = 0;
  int k_end = Sk;
  if (causal) {
    k_end = min(Sk, q0 + kQ_Q);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  k_begin = (k_begin / kQ_K) * kQ_K;
  int seg_qlo = 0, seg_qhi = 0;
  if (segb != nullptr) {
    seg_qlo = segb[q0];
    seg_qhi = segb[min(q0 + kQ_Q, Sq) - 1];
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kQ_K) {
    if (segb != nullptr) {
      const int klo = segb[k0];
      const int khi = segb[min(k0 + kQ_K, Sk) - 1];
      if (seg_qlo > khi || klo > seg_qhi) continue;  // uniform per block
    }
    __syncthreads();  // everyone is done with the previous tile
    stage_bf16<D>(sk, KS, kb, k0, kQ_K, Sk);
    stage_bf16<D>(sv, KS, vb, k0, kQ_K, Sk);
    __syncthreads();

    const float* qrow = sq + tr * QS;
    const float* dorow = sdo + tr * QS;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tc + 8 * j;
      const bf16* krow = sk + c * KS;
      const bf16* vrow = sv + c * KS;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(qrow[d], to_f32(krow[d]), s);
        dp = fmaf(dorow[d], to_f32(vrow[d]), dp);
      }
      float ds = 0.f;
      if (pair_live(row, k0 + c, Sq, Sk, causal, window, segb)) {
        const float p = expf(__fmul_rn(s, scale) - row_lse);
        ds = p * (dp - row_delta) * scale;
      }
      sds[tr * PS + c] = round_bf16(ds);
    }
    __syncwarp();  // the row's ds values come from this warp only

    const float* dsrow = sds + tr * PS;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tc + 8 * j;
      float a = acc[j];
#pragma unroll 16
      for (int c = 0; c < kQ_K; ++c) a = fmaf(dsrow[c], to_f32(sk[c * KS + d]), a);
      acc[j] = a;
    }
  }

  if (row < Sq) {
    bf16* out = dq + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[tc + 8 * j] = __float2bfloat16(acc[j]);
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * kKV_K * (D + 1) + 2 * kKV_K * (kKV_Q + 1) +
                          2 * kKV_Q) +
         sizeof(bf16) * (2 * kKV_Q * (D + 2));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, const int* __restrict__ seg,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv,
                 int Sq, int Sk, int causal, int window, float scale) {
  constexpr int FS = D + 1;      // f32 row stride of K, V
  constexpr int QS = D + 2;      // bf16 row stride of Q, dO
  constexpr int PS = kKV_Q + 1;  // f32 row stride of the p / ds tiles
  constexpr int DJ = D / 8;      // dk and dv columns per thread
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kKV_K * FS;
  float* sp = sv + kKV_K * FS;
  float* sds = sp + kKV_K * PS;
  float* slse = sds + kKV_K * PS;
  float* sdelta = slse + kKV_Q;
  bf16* sq = reinterpret_cast<bf16*>(sdelta + kKV_Q);
  bf16* sdo = sq + kKV_Q * QS;

  const int tid = threadIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv;
  const int kvh = bkv % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.x * kKV_K;
  const int* segb = seg != nullptr ? seg + (size_t)b * Sq : nullptr;

  stage_f32<D>(sk, FS, k + (size_t)bkv * Sk * D, k0, kKV_K, Sk);
  stage_f32<D>(sv, FS, v + (size_t)bkv * Sk * D, k0, kKV_K, Sk);

  const int tr = tid / 8;  // key row within the block
  const int tc = tid % 8;  // this thread's slice of the row
  const int col = k0 + tr;
  float acc_k[DJ], acc_v[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    acc_k[j] = 0.f;
    acc_v[j] = 0.f;
  }

  // Query rows that can see a key of [k0, k0 + kKV_K): row >= k0 when
  // causal, and row < (k0 + kKV_K - 1) + window under a window band.
  int q_begin = 0;
  int q_end = Sq;
  if (causal) {
    q_begin = k0;
    if (window > 0) q_end = min(Sq, k0 + kKV_K - 1 + window);
  }
  q_begin = (q_begin / kKV_Q) * kKV_Q;
  int seg_klo = 0, seg_khi = 0;
  if (segb != nullptr) {
    seg_klo = segb[k0];
    seg_khi = segb[min(k0 + kKV_K, Sk) - 1];
  }

  for (int g = 0; g < group; ++g) {
    const int bh = b * H + kvh * group + g;
    const bf16* qb = q + (size_t)bh * Sq * D;
    const bf16* dob = dout + (size_t)bh * Sq * D;
    for (int q0 = q_begin; q0 < q_end; q0 += kKV_Q) {
      if (segb != nullptr) {
        const int qlo = segb[q0];
        const int qhi = segb[min(q0 + kKV_Q, Sq) - 1];
        if (qlo > seg_khi || seg_klo > qhi) continue;  // uniform per block
      }
      __syncthreads();  // everyone is done with the previous tile
      stage_bf16<D>(sq, QS, qb, q0, kKV_Q, Sq);
      stage_bf16<D>(sdo, QS, dob, q0, kKV_Q, Sq);
      for (int i = tid; i < kKV_Q; i += kThreads) {
        const bool in = q0 + i < Sq;
        slse[i] = in ? lse[(size_t)bh * Sq + q0 + i] : 0.f;
        sdelta[i] = in ? delta[(size_t)bh * Sq + q0 + i] : 0.f;
      }
      __syncthreads();

      const float* krow = sk + tr * FS;
      const float* vrow = sv + tr * FS;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tc + 8 * j;
        const bf16* qrow = sq + r * QS;
        const bf16* dorow = sdo + r * QS;
        float s = 0.f;
        float dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s = fmaf(to_f32(qrow[d]), krow[d], s);
          dp = fmaf(to_f32(dorow[d]), vrow[d], dp);
        }
        float p = 0.f;
        float ds = 0.f;
        if (pair_live(q0 + r, col, Sq, Sk, causal, window, segb)) {
          p = expf(__fmul_rn(s, scale) - slse[r]);
          ds = p * (dp - sdelta[r]) * scale;
        }
        sp[tr * PS + r] = round_bf16(p);
        sds[tr * PS + r] = round_bf16(ds);
      }
      __syncwarp();  // the key row's p and ds come from this warp only

      const float* prow = sp + tr * PS;
      const float* dsrow = sds + tr * PS;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tc + 8 * j;
        float ak = acc_k[j];
        float av = acc_v[j];
#pragma unroll 16
        for (int r = 0; r < kKV_Q; ++r) {
          av = fmaf(prow[r], to_f32(sdo[r * QS + d]), av);
          ak = fmaf(dsrow[r], to_f32(sq[r * QS + d]), ak);
        }
        acc_k[j] = ak;
        acc_v[j] = av;
      }
    }
  }

  if (col < Sk) {
    const size_t off = ((size_t)bkv * Sk + col) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tc + 8 * j] = __float2bfloat16(acc_k[j]);
      dv[off + tc + 8 * j] = __float2bfloat16(acc_v[j]);
    }
  }
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
  dim3 grid((Sq + kQ_Q - 1) / kQ_Q, B * H);
  flash_dq_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<bf16*>(dq), H, Hkv, Sq, Sk,
      causal, window, scale);
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
  dim3 grid((Sk + kKV_K - 1) / kKV_K, B * Hkv);
  flash_dkv_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Hkv, Sq, Sk, causal, window, scale);
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
