// Fused q|k|v projection + RoPE for the decode step.
//
// Replaces the Pallas kernel kubeflow_tpu/ops/decode_qkv.py `_qkv_kernel`
// (driven by `qkv_rope`). One thin-row product (R, K) @ (K, N) against
// the concatenated q|k|v weight, N = (heads + 2 * kv_heads) * head_dim,
// in the reference op order: f32 accumulate, optional int8 per-channel
// scale, round to bf16; then the first `rope_cols` columns (whole q and
// k heads) get the half-split rotary embedding in f32 at the row's own
// position, `freqs = base ** (-i / half)`, and round back to bf16. The
// v columns pass through.
//
// Bound on the H100: bytes, the K * N weight stream (3 MB at the
// flagship's 1024 x 1536 in bf16), the GEMV's (K, N) layout.
//
// Design: the GEMV's (K, N) stream (kn_stream.cuh): 16 bytes of a bf16
// weight row a load, all of a step's loads issued before the first is
// used, x staged once per chunk in shared memory as f32, K split across
// a thread-block cluster of 1 to 4 blocks by the GEMV's rule (a function
// of K and N, never of the row count, so a row's result does not depend
// on its batch), a warp reduce-scatter, and the slices summed through
// distributed shared memory in rank order: no atomics, two launches give
// the same bits. What differs is the tile and the epilogue. A block's 32
// columns are 16 rotary PAIRS: columns c..c+15 of the first half of a
// head and their partners c+half.. in its second half, so the thread
// that finishes a pair holds both of its sums and the rotation needs no
// exchange. Every pair belongs to exactly one tile, so every output
// column is written whatever N (the reference once left tail columns
// unwritten with a non-dividing block). A load takes 8 columns (16 bytes
// of bf16, 8 of int8); a head dim whose half is no multiple of 8 loads
// fewer columns at once, down to one, so that no load straddles a head.
#include "kn_stream.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTilePairs = kTileN / 2;  // rotary pairs of a block
// At most 4 K slices (a cluster of 4): the flagship's 48 tiles x 4 slices
// read 0.0131 ms on the card where 8 slices (the GEMV's cap) read 0.0196
// (testing/torch_kernel_variants.py, PERF.md).
constexpr int kMaxSlices = 4;

// Grid (slices, pair tiles), launched as clusters of `slices` blocks
// along x; block x of a cluster sums weight rows [x * slice, (x + 1) *
// slice). VC: weight columns of one load, a divisor of half.
template <typename WT, int VC>
__global__ void __launch_bounds__(kThreads)
qkv_rope_kernel(const bf16* __restrict__ x, const WT* __restrict__ w,
                const float* __restrict__ scale, const int* __restrict__ pos,
                bf16* __restrict__ out, int rows, int k, int n, int head_dim,
                int rope_cols, float base, int slice) {
  __shared__ __align__(16) float xs[kMaxRows][kChunkK];
  __shared__ float part[kThreads / 32][kMaxRows][kTileN];
  __shared__ float total[kMaxRows * kTileN];  // this block's partial

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int nsplit = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int half = head_dim / 2;
  const int npairs = n / 2;
  const int p0 = blockIdx.y * kTilePairs;
  // Tile column lc < 16 is the first column of pair p0 + lc, lc >= 16 the
  // second column of pair p0 + lc - 16. This thread streams tile columns
  // lc..lc + VC - 1, VC pairs of one head (VC divides half).
  const int lc = (tid % (kTileN / VC)) * VC;
  const int pc = p0 + lc % kTilePairs;
  const int col = pc < npairs ? (pc / half) * head_dim + pc % half +
                                    (lc / kTilePairs) * half
                              : -1;
  const int k_lo = split * slice;
  const int k_hi = min(k, k_lo + slice);

  // Block `split` finishes pairs [split * share, (split + 1) * share) of
  // the tile's kMaxRows x kTilePairs: pair i = split * share + tid of row
  // i / kTilePairs. Its scales and rotation angle are read under the
  // stream.
  const int share = kMaxRows * kTilePairs / nsplit;
  const int i = split * share + tid;
  const int r = i / kTilePairs;
  const int pp = p0 + i % kTilePairs;
  const bool owns = tid < share && r < rows && pp < npairs;
  const int j = pp % half;
  const int c1 = (pp / half) * head_dim + j;
  const int c2 = c1 + half;
  const bool rotate = c1 < rope_cols;
  float s1 = 1.f, s2 = 1.f, angle = 0.f;
  if (owns) {
    if (scale != nullptr) {
      s1 = scale[c1];
      s2 = scale[c2];
    }
    if (rotate) angle = (float)pos[r] * powf(base, -(float)j / (float)half);
  }

  kn_block_sum<WT, kThreads, VC>(x, w, rows, k, n, k_lo, k_hi, col, xs, part,
                                 total);

  // The cluster's sum in rank order (0 past the cluster's last block),
  // then the reference's epilogue on the pair.
  cluster.sync();
  if (owns) {
    const int t1 = r * kTileN + i % kTilePairs;
    const int t2 = t1 + kTilePairs;
    float a[kMaxSplit], bsum[kMaxSplit];
#pragma unroll
    for (int src = 0; src < kMaxSplit; ++src) {
      a[src] = src < nsplit ? cluster.map_shared_rank(&total[0], src)[t1]
                            : 0.f;
      bsum[src] = src < nsplit ? cluster.map_shared_rank(&total[0], src)[t2]
                               : 0.f;
    }
    float y1 = 0.f, y2 = 0.f;
#pragma unroll
    for (int src = 0; src < kMaxSplit; ++src) {
      y1 += a[src];
      y2 += bsum[src];
    }
    // Round to the compute dtype BEFORE the rotation (reference order).
    y1 = round_bf16(y1 * s1);
    y2 = round_bf16(y2 * s2);
    if (rotate) {
      const float cs = cosf(angle);
      const float sn = sinf(angle);
      const float r1 = y1 * cs - y2 * sn;
      const float r2 = y2 * cs + y1 * sn;
      y1 = r1;
      y2 = r2;
    }
    out[(size_t)r * n + c1] = __float2bfloat16(y1);
    out[(size_t)r * n + c2] = __float2bfloat16(y2);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <typename WT, int VC>
int launch(const void* x, const void* w, const void* scale, const void* pos,
           void* out, int rows, int k, int n, int head_dim, int rope_cols,
           float base, cudaStream_t stream) {
  const int tiles = (n / 2 + kTilePairs - 1) / kTilePairs;
  constexpr int kRowsPerStep = kThreads / (kTileN / VC);
  const int nsplit = kn_splits(tiles, k, kRowsPerStep, kMaxSlices);
  return launch_clusters(
      qkv_rope_kernel<WT, VC>, nsplit, tiles, kThreads, 0, stream,
      static_cast<const bf16*>(x), static_cast<const WT*>(w),
      static_cast<const float*>(scale), static_cast<const int*>(pos),
      static_cast<bf16*>(out), rows, k, n, head_dim, rope_cols, base,
      kn_slice(k, nsplit));
}

// The widest load whose columns divide half, at most 8 columns (16 bytes
// of bf16, 8 of int8: 8 rows x 8 sums a thread).
template <typename WT>
int launch_widest(const void* x, const void* w, const void* scale,
                  const void* pos, void* out, int rows, int k, int n,
                  int head_dim, int rope_cols, float base,
                  cudaStream_t stream) {
  const int half = head_dim / 2;
  int vc = 8;
  while (half % vc) vc /= 2;
#define KFT_QKV(VC)                                                        \
  case VC:                                                                 \
    return launch<WT, VC>(x, w, scale, pos, out, rows, k, n, head_dim,     \
                          rope_cols, base, stream);
  switch (vc) {
    KFT_QKV(8)
    KFT_QKV(4)
    KFT_QKV(2)
    KFT_QKV(1)
  }
#undef KFT_QKV
  return -1;
}

}  // namespace

// x (rows, k) bf16; w (k, n) bf16 or int8; scale (n,) f32 or null;
// pos (rows,) int32; out (rows, n) bf16. rows <= 8; head_dim even; n and
// rope_cols multiples of head_dim.
KFT_EXPORT int kft_qkv_rope(const void* x, const void* w, const void* scale,
                            const void* pos, void* out, int rows, int k,
                            int n, int head_dim, int rope_cols, float base,
                            int w_int8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_int8)
    return launch_widest<int8_t>(x, w, scale, pos, out, rows, k, n, head_dim,
                                 rope_cols, base, s);
  return launch_widest<bf16>(x, w, scale, pos, out, rows, k, n, head_dim,
                             rope_cols, base, s);
}
