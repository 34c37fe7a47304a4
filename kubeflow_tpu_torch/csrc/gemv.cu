// Thin-row weight-streaming GEMV: (R, K) @ (K, N) -> (R, N), R <= 8.
//
// Replaces the Pallas kernel kubeflow_tpu/ops/gemv.py `_kernel` (driven
// by `gemv`). Same contract: bf16 activations, bf16 or int8 weights,
// f32 accumulation; an int8 weight's per-output-channel scale multiplies
// AFTER the dot; the optional residual epilogue emits
// `residual + bf16(y)` in the residual's dtype, else the output is f32.
//
// Bound on the H100: bytes. At decode every weight element is read once
// and used R <= 8 times, so the kernel is a pure stream of the weight
// matrix (K * N * itemsize bytes) against ~3.35 TB/s; the activations,
// scales and outputs are a rounding error beside it. Streaming at that
// rate needs tens of KB of loads in flight on every one of the 132 SMs.
//
// Design against that bound:
// - Every lane loads 16 bytes of a weight row at a time (8 bf16 or 16
//   int8 columns), neighbouring lanes on neighbouring addresses, with all
//   of a step's loads issued before the first is used. The activations
//   are staged once per block in shared memory (f32 for the (K, N)
//   kernel's FMAs, bf16 for the (N, K) kernel's tensor cores), and each
//   output's scale and residual are read at the start, under the stream.
// - (K, N) layout: a block owns 32 output columns and one slice of the
//   K rows. The slices of one column tile form a thread-block cluster of
//   1 to 8 blocks, as many as it takes for the grid to hold about two
//   blocks per SM (down 4096 -> 1024: 32 tiles x 8 slices = 256 blocks of
//   128 threads; up 1024 -> 4096: 128 tiles x 2 slices, 256 threads).
//   Each block sums its slice in registers, then within each warp by a
//   reduce-scatter and across its warps in shared memory, in a fixed
//   order; the cluster's blocks then read each
//   other's partials through distributed shared memory and each finishes
//   an equal share of the tile's outputs, summing the slices in rank
//   order. One launch, no workspace, no atomics: two launches give the
//   same bits. The stream and the block's sum are kn_stream.cuh's,
//   shared with the fused QKV+RoPE (decode_qkv.cu).
// - (N, K) layout (`transpose_w`, the tied head reading the (vocab, dim)
//   embedding): each output column's dot product belongs to one warp,
//   which walks the column's contiguous K row. A warp owns 16 columns and
//   runs their products on tensor cores (mma.sync, bf16 in, f32 sums),
//   since at 8 rows x 8 columns per 16-byte load the CUDA cores' FMAs
//   would take as long as the stream; eight loads per row in flight, the
//   32768-column head is 512 blocks of 4 warps.
// After the full sum the reference's op order: f32 dot, then * scale,
// then residual + bf16(y).
#include "kn_stream.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// (N, K) layout.
constexpr int kChunkNK = 1024;  // activation columns staged at a time
constexpr int kUnrollNK = 8;    // 16-byte loads of a weight row in flight

// Columns in one 16-byte load.
template <typename WT>
constexpr int kVec = 16 / (int)sizeof(WT);

// One output's epilogue operands, read at the kernel's start so that
// their latency hides under the weight stream: the channel scale (1 when
// there is none: y * 1 is y) and the residual.
struct Epilogue {
  float scale;
  float residual;
  __device__ __forceinline__ static Epilogue load(bool owns, int r, int c,
                                                  int n, const float* sp,
                                                  const bf16* rp) {
    Epilogue e{1.f, 0.f};
    if (owns && sp != nullptr) e.scale = sp[c];
    if (owns && rp != nullptr) e.residual = to_f32(rp[(size_t)r * n + c]);
    return e;
  }
  // The reference op order: f32 dot -> * scale -> (residual + bf16(y)).
  __device__ __forceinline__ void store(float y, int r, int c, int n,
                                        bool has_residual, void* out) const {
    y *= scale;
    const size_t idx = (size_t)r * n + c;
    if (has_residual)
      static_cast<bf16*>(out)[idx] = __float2bfloat16(residual + round_bf16(y));
    else
      static_cast<float*>(out)[idx] = y;
  }
};

// Grid (slices, column tiles), launched as clusters of `slices` blocks
// along x; block x of a cluster sums weight rows [x * slice, (x + 1) *
// slice).
template <typename WT, int NT>
__global__ void __launch_bounds__(NT)
gemv_kn_kernel(const bf16* __restrict__ x, const WT* __restrict__ w,
               const float* __restrict__ scale,
               const bf16* __restrict__ residual, void* __restrict__ out,
               int rows, int k, int n, int slice) {
  constexpr int VC = kVec<WT>;
  constexpr int TPR = kTileN / VC;  // threads on one weight row
  __shared__ __align__(16) float xs[kMaxRows][kChunkK];
  __shared__ float part[NT / 32][kMaxRows][kTileN];
  __shared__ float total[kMaxRows * kTileN];  // this block's partial

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int nsplit = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * kTileN;
  const int col = c0 + (tid % TPR) * VC;  // this thread's VC columns
  const int k_lo = split * slice;
  const int k_hi = min(k, k_lo + slice);
  // Block `split` finishes outputs [split * share, (split + 1) * share)
  // of the tile: output split * share + o for o = tid + u * NT.
  constexpr int kOuts = kMaxRows * kTileN / NT;
  const int share = kMaxRows * kTileN / nsplit;
  Epilogue epi[kOuts];
#pragma unroll
  for (int u = 0; u < kOuts; ++u) {
    const int i = split * share + tid + u * NT;
    epi[u] = Epilogue::load(tid + u * NT < share && i / kTileN < rows &&
                                c0 + i % kTileN < n,
                            i / kTileN, c0 + i % kTileN, n, scale, residual);
  }

  kn_block_sum<WT, NT, VC>(x, w, rows, k, n, k_lo, k_hi, col < n ? col : -1,
                           xs, part, total);

  // The cluster's sum: each owned output adds the slices' partials in
  // rank order, all read at once (0 past the cluster's last block).
  cluster.sync();
#pragma unroll
  for (int u = 0; u < kOuts; ++u) {
    if (tid + u * NT >= share) break;
    const int i = split * share + tid + u * NT;
    float part_of[kMaxSplit];
#pragma unroll
    for (int src = 0; src < kMaxSplit; ++src)
      part_of[src] =
          src < nsplit ? cluster.map_shared_rank(&total[0], src)[i] : 0.f;
    float y = 0.f;
#pragma unroll
    for (int src = 0; src < kMaxSplit; ++src) y += part_of[src];
    const int r = i / kTileN;
    const int c = c0 + i % kTileN;
    if (r < rows && c < n)
      epi[u].store(y, r, c, n, residual != nullptr, out);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

__device__ __forceinline__ uint32_t pack_pair(int8_t lo, int8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Word i (two neighbouring k values, bf16x2) of a 16-byte load.
__device__ __forceinline__ uint32_t pair_of(const uint4& u, int i, bf16) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}
__device__ __forceinline__ uint32_t pair_of(const uint4& u, int i, int8_t) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
  return pack_pair(b[2 * i], b[2 * i + 1]);
}

// The (N, K) layout on tensor cores: a warp owns 16 output columns and
// computes their (16 x R) block as W (16 x K) times x^T (K x R). The sum
// over k does not care which k a lane holds, so lane t loads VC
// neighbouring k values of its two weight rows (one 16-byte load each)
// and the same k of x, and feeds them to the mma as if they were the
// fragment's k pairs: A and B agree on every k, so each product pairs the
// right elements with no shuffle. int8 weights become bf16 exactly
// (|w| <= 127) and their scale multiplies after the dot, as everywhere.
template <typename WT>
__global__ void __launch_bounds__(kThreads)
gemv_nk_kernel(const bf16* __restrict__ x, const WT* __restrict__ w,
               const float* __restrict__ scale,
               const bf16* __restrict__ residual, void* __restrict__ out,
               int rows, int k, int n) {
  constexpr int VC = kVec<WT>;       // k values in one 16-byte load
  constexpr int KS = 4 * VC;         // k a warp covers in one step
  constexpr int kBatch = kUnrollNK * KS;
  // bf16 x, each row padded by 64 bytes: the 16-byte reads of two rows
  // in one shared-memory phase fall on different banks.
  __shared__ __align__(16) bf16 xs[kMaxRows][kChunkNK + 32];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int n0 = (blockIdx.x * kWarps + warp) * 16;
  const int ca = n0 + g;      // A rows: output columns ca and cb
  const int cb = ca + 8;
  // This lane's outputs: rows 2t, 2t + 1 of columns ca, cb.
  const Epilogue e00 = Epilogue::load(2 * t < rows && ca < n, 2 * t, ca, n,
                                      scale, residual);
  const Epilogue e01 = Epilogue::load(2 * t + 1 < rows && ca < n, 2 * t + 1,
                                      ca, n, scale, residual);
  const Epilogue e10 = Epilogue::load(2 * t < rows && cb < n, 2 * t, cb, n,
                                      scale, residual);
  const Epilogue e11 = Epilogue::load(2 * t + 1 < rows && cb < n, 2 * t + 1,
                                      cb, n, scale, residual);
  float d[4] = {0.f, 0.f, 0.f, 0.f};

  uint4 wa[kUnrollNK], wb[kUnrollNK];
  auto load_batch = [&](int kc, int kb, int kn) {
#pragma unroll
    for (int u = 0; u < kUnrollNK; ++u) {
      const int kk = kb + u * KS + t * VC;
      wa[u] = load16(w + (size_t)ca * k + kc + kk, ca < n && kk < kn);
      wb[u] = load16(w + (size_t)cb * k + kc + kk, cb < n && kk < kn);
    }
  };
  for (int kc = 0; kc < k; kc += kChunkNK) {
    const int kn = min(kChunkNK, k - kc);
    load_batch(kc, 0, kn);  // in flight while x is staged
    __syncthreads();  // the previous chunk's activations are consumed
    constexpr int kXLoads = kMaxRows * kChunkNK / 8 / kThreads;
    uint4 xl[kXLoads];
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int i = tid + j * kThreads;
      const int kk = (i % (kChunkNK / 8)) * 8;
      xl[j] = load16(x + (size_t)(i / (kChunkNK / 8)) * k + kc + kk,
                     i / (kChunkNK / 8) < rows && kk < kn);
    }
#pragma unroll
    for (int j = 0; j < kXLoads; ++j) {
      const int i = tid + j * kThreads;
      *reinterpret_cast<uint4*>(
          &xs[i / (kChunkNK / 8)][(i % (kChunkNK / 8)) * 8]) = xl[j];
    }
    __syncthreads();
    for (int kb = 0; kb < kn; kb += kBatch) {
      if (kb > 0) load_batch(kc, kb, kn);
#pragma unroll
      for (int u = 0; u < kUnrollNK; ++u) {
        const int kk = kb + u * KS + t * VC;
#pragma unroll
        for (int h = 0; h < VC / 8; ++h) {
          const uint4 xv = *reinterpret_cast<const uint4*>(&xs[g][kk + 8 * h]);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int i = 4 * h + 2 * m;  // weight pairs i, i + 1
            mma_16816(d, pair_of(wa[u], i, WT()), pair_of(wb[u], i, WT()),
                      pair_of(wa[u], i + 1, WT()),
                      pair_of(wb[u], i + 1, WT()), pair_of(xv, 2 * m, bf16()),
                      pair_of(xv, 2 * m + 1, bf16()));
          }
        }
      }
    }
  }
  const bool has_residual = residual != nullptr;
  if (2 * t < rows && ca < n) e00.store(d[0], 2 * t, ca, n, has_residual, out);
  if (2 * t + 1 < rows && ca < n)
    e01.store(d[1], 2 * t + 1, ca, n, has_residual, out);
  if (2 * t < rows && cb < n) e10.store(d[2], 2 * t, cb, n, has_residual, out);
  if (2 * t + 1 < rows && cb < n)
    e11.store(d[3], 2 * t + 1, cb, n, has_residual, out);
}

// Splits K until the grid holds about two blocks per SM (at least two
// steps of weight rows a slice) and launches the clusters.
template <typename WT, int NT>
int launch_kn(const bf16* xp, const WT* wp, const float* sp, const bf16* rp,
              void* out, int rows, int k, int n, int tiles,
              cudaStream_t stream) {
  constexpr int kRowsPerStep = NT / (kTileN / kVec<WT>);
  const int nsplit = kn_splits(tiles, k, kRowsPerStep);
  return launch_clusters(gemv_kn_kernel<WT, NT>, nsplit, tiles, NT, 0,
                         stream, xp, wp, sp, rp, out, rows, k, n,
                         kn_slice(k, nsplit));
}

template <typename WT>
int launch(const void* x, const void* w, const void* scale,
           const void* residual, void* out, int rows, int k, int n,
           int transpose_w, cudaStream_t stream) {
  const bf16* xp = static_cast<const bf16*>(x);
  const WT* wp = static_cast<const WT*>(w);
  const float* sp = static_cast<const float*>(scale);
  const bf16* rp = static_cast<const bf16*>(residual);
  if (transpose_w) {
    const int per_block = kWarps * 16;
    gemv_nk_kernel<WT><<<(n + per_block - 1) / per_block, kThreads, 0,
                         stream>>>(xp, wp, sp, rp, out, rows, k, n);
    return (int)cudaGetLastError();
  }
  // A wide N (a few K slices suffice) takes 256-thread blocks, a narrow
  // one 128-thread blocks split eight ways: the measured best of both
  // shapes on the card (PERF.md).
  const int tiles = (n + kTileN - 1) / kTileN;
  if (2 * tiles >= kMinBlocks)
    return launch_kn<WT, 2 * kThreads>(xp, wp, sp, rp, out, rows, k, n,
                                       tiles, stream);
  return launch_kn<WT, kThreads>(xp, wp, sp, rp, out, rows, k, n, tiles,
                                 stream);
}

}  // namespace

// The CUDA runtime's message for a status an entry point returned.
KFT_EXPORT const char* kft_error_string(int err) {
  return err < 0 ? "shape not supported by this build"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (rows, k) bf16; w (k, n) or, with transpose_w, (n, k), bf16 or int8;
// scale (n,) f32 or null; residual (rows, n) bf16 or null; out (rows, n)
// f32, or bf16 when a residual is given. k and n multiples of 16.
KFT_EXPORT int kft_gemv(const void* x, const void* w, const void* scale,
                        const void* residual, void* out, int rows, int k,
                        int n, int w_int8, int transpose_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_int8)
    return launch<int8_t>(x, w, scale, residual, out, rows, k, n,
                          transpose_w, s);
  return launch<bf16>(x, w, scale, residual, out, rows, k, n, transpose_w, s);
}
