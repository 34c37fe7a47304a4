// The thin-row (K, N) weight stream shared by the (K, N) GEMV (gemv.cu)
// and the fused QKV+RoPE projection (decode_qkv.cu): (R, K) @ (K, N) for
// R <= kMaxRows, bound by reading the K x N weight once.
//
// A block owns one tile of kTileN output columns and one slice of the K
// rows; the slices of a tile form a thread-block cluster of 1 to
// kMaxSplit blocks (kn_splits) that the kernel sums through distributed
// shared memory in rank order. Within a block (kn_block_sum) every lane
// loads up to 16 bytes of a weight row at a time (VC neighbouring
// columns), neighbouring lanes on neighbouring addresses, with all of a
// step's loads issued before the first is used; the activations are
// staged once per chunk in shared memory as f32; each lane sums its
// slice in registers, then within each warp by a reduce-scatter and
// across the warps in shared memory, in a fixed order.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kMaxRows = 8;
constexpr int kTileN = 32;       // output columns of a block
constexpr int kMaxSplit = 8;     // K slices of a column tile (a cluster)
constexpr int kMinBlocks = 256;  // about two blocks for each of 132 SMs
constexpr int kChunkK = 512;     // activation rows staged at a time

__device__ __forceinline__ uint4 load16(const void* p, bool valid) {
  return valid ? __ldg(reinterpret_cast<const uint4*>(p))
               : make_uint4(0u, 0u, 0u, 0u);
}

// LB bytes (16, 8, 4, 2 or 1) from p into the low bytes of a uint4 (zero
// when !valid: p is then not read).
template <int LB>
__device__ __forceinline__ uint4 load_vec(const void* p, bool valid) {
  static_assert(LB == 16 || LB == 8 || LB == 4 || LB == 2 || LB == 1,
                "a load of 1 to 16 bytes");
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (!valid) return u;
  if constexpr (LB == 16) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (LB == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    u.x = v.x;
    u.y = v.y;
  } else if constexpr (LB == 4) {
    u.x = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (LB == 2) {
    u.x = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    u.x = __ldg(reinterpret_cast<const unsigned char*>(p));
  }
  return u;
}

// The first VC elements of a load as f32.
template <typename WT, int VC>
__device__ __forceinline__ void unpack(const uint4& u, float (&o)[VC]) {
  if constexpr (sizeof(WT) == 1) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < VC; ++i) o[i] = (float)b[i];
  } else if constexpr (VC % 2 == 0) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < VC / 2; ++i) {
      o[2 * i] = __low2float(h[i]);
      o[2 * i + 1] = __high2float(h[i]);
    }
  } else {
    o[0] = __bfloat162float(*reinterpret_cast<const bf16*>(&u));
  }
}

// Stages activation columns [kc, kc + kn) of the (rows, k) bf16 x into
// xs[kMaxRows][C] as f32, zero past `rows` and `kn`. When k is a multiple
// of 8 (kc is then one too): 16-byte loads, every one issued before the
// first store; else one element a load.
template <int C, int NT>
__device__ __forceinline__ void stage_x(float (*xs)[C], const bf16* x,
                                        int rows, int k, int kc, int kn,
                                        int tid) {
  if (k % 8 != 0) {
    for (int idx = tid; idx < kMaxRows * C; idx += NT) {
      const int r = idx / C;
      const int kk = idx % C;
      xs[r][kk] = r < rows && kk < kn ? to_f32(x[(size_t)r * k + kc + kk])
                                      : 0.f;
    }
    return;
  }
  constexpr int kPerRow = C / 8;
  constexpr int kLoads = kMaxRows * kPerRow / NT;
  uint4 v[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / kPerRow;
    const int kk = (idx % kPerRow) * 8;
    v[i] = load16(x + (size_t)r * k + kc + kk, r < rows && kk < kn);
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = tid + i * NT;
    float f[8];
    unpack<bf16>(v[i], f);
    float4* dst =
        reinterpret_cast<float4*>(&xs[idx / kPerRow][(idx % kPerRow) * 8]);
    dst[0] = make_float4(f[0], f[1], f[2], f[3]);
    dst[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// One step of a warp's reduce-scatter over the lanes that differ in lane
// bit OFF: each keeps one half of its first 2 * HALF sums (the upper
// lane the upper half), adds its partner's copy of that half into acc's
// first HALF, and recurses down to lane bit STOP. Every index is a
// compile-time constant, so acc stays in registers.
template <int OFF, int HALF, int STOP, int VC>
__device__ __forceinline__ void reduce_scatter(float (&acc)[kMaxRows][VC],
                                               int lane, int& base) {
  if constexpr (OFF >= STOP) {
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      float& lo = acc[i / VC][i % VC];
      const float hi = acc[(i + HALF) / VC][(i + HALF) % VC];
      const float send = upper ? lo : hi;
      lo = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    if (upper) base += HALF;
    reduce_scatter<OFF / 2, HALF / 2, STOP>(acc, lane, base);
  }
}

// This block's partial of its column tile: weight rows [k_lo, k_hi)
// against x, for kMaxRows rows and the tile's kTileN columns, into
// total[r * kTileN + c] (shared memory). The thread streams the VC
// contiguous weight columns that begin at `col`, which hold tile columns
// (tid % (kTileN / VC)) * VC onward; col < 0 marks columns past the
// matrix (nothing is read, their sums are zero). Ends with a barrier.
template <typename WT, int NT, int VC>
__device__ __forceinline__ void kn_block_sum(
    const bf16* __restrict__ x, const WT* __restrict__ w, int rows, int k,
    int n, int k_lo, int k_hi, int col, float (*xs)[kChunkK],
    float (*part)[kMaxRows][kTileN], float* total) {
  constexpr int TPR = kTileN / VC;  // threads on one weight row
  constexpr int RPS = NT / TPR;     // weight rows a step covers
  constexpr int kSteps = kChunkK / RPS < 16 ? kChunkK / RPS : 16;
  constexpr int kBatch = kSteps * RPS;  // weight rows of one batch of loads
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = tid % TPR;  // this thread's VC columns of the tile
  const int phase = tid / TPR;  // and its first weight row of a step

  float acc[kMaxRows][VC];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r)
#pragma unroll
    for (int c = 0; c < VC; ++c) acc[r][c] = 0.f;

  uint4 wv[kSteps];
  auto load_batch = [&](int kc, int kb, int kn) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int kk = kb + phase + j * RPS;
      wv[j] = load_vec<VC * (int)sizeof(WT)>(w + (size_t)(kc + kk) * n + col,
                                             kk < kn && col >= 0);
    }
  };
  for (int kc = k_lo; kc < k_hi; kc += kChunkK) {
    const int kn = min(kChunkK, k_hi - kc);
    load_batch(kc, 0, kn);  // in flight while x is staged
    __syncthreads();  // the previous chunk's activations are consumed
    stage_x<kChunkK, NT>(xs, x, rows, k, kc, kn, tid);
    __syncthreads();
    for (int kb = 0; kb < kn; kb += kBatch) {
      if (kb > 0) load_batch(kc, kb, kn);
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int kk = kb + phase + j * RPS;
        float wf[VC];
        unpack<WT>(wv[j], wf);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          const float xr = xs[r][kk];
#pragma unroll
          for (int c = 0; c < VC; ++c) acc[r][c] = fmaf(xr, wf[c], acc[r][c]);
        }
      }
    }
  }

  // Within a warp, the lanes of one column group (lane bits TPR..16)
  // reduce-scatter their R x VC sums: at each step a lane keeps one half,
  // sends the other to its partner and adds what it receives, so it ends
  // with 8 whole sums (56 shuffles at VC = 8, 120 at VC = 16, where a
  // butterfly would take R x VC a step). Then the warps add in order
  // through shared memory.
  int base = 0;  // flat index in acc of this lane's first kept sum
  reduce_scatter<16, kMaxRows * VC / 2, TPR>(acc, lane, base);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int idx = base + j;
    part[warp][idx / VC][group * VC + idx % VC] = acc[j / VC][j % VC];
  }
  __syncthreads();
  for (int i = tid; i < kMaxRows * kTileN; i += NT) {
    float y = 0.f;
#pragma unroll
    for (int wi = 0; wi < NT / 32; ++wi) y += part[wi][i / kTileN][i % kTileN];
    total[i] = y;
  }
}

// K slices of a column tile: doubled up to max_split (at most kMaxSplit)
// while the grid holds fewer than about two blocks per SM and each slice
// keeps at least two steps of weight rows. A function of K and N
// (through `tiles`) only, never of the row count: a row's sums do not
// depend on its batch.
inline int kn_splits(int tiles, int k, int rows_per_step,
                     int max_split = kMaxSplit) {
  int nsplit = 1;
  while (nsplit < max_split && tiles * nsplit < kMinBlocks &&
         k >= 2 * nsplit * rows_per_step)
    nsplit *= 2;
  return nsplit;
}

// Weight rows of one slice: K over nsplit, rounded up to 16.
inline int kn_slice(int k, int nsplit) {
  return ((k + nsplit - 1) / nsplit + 15) / 16 * 16;
}
