// The exact split of an f32 tensor into three bf16 terms.
//
// Replaces no TPU kernel. The tied head's backward (models/transformer.py)
// multiplies its f32 logit gradient g by bf16 operands; on the card that
// product runs on bf16 tensor cores as the sum of three bf16 products,
// g = hi + mid + lo with hi = bf16(g), mid = bf16(g - hi) and
// lo = bf16(g - hi - mid). Both differences are exact in f32 and lo is
// exact in bf16, so the three terms hold every bit of g for |g| in
// [2^-100, 2^100]. The JAX package leaves the f32 product to XLA.
//
// Bound by bytes: one f32 read and three bf16 writes an element (10 bytes),
// 5.4 GB at the LM's (16384, 32768) gradient, ~1.6 ms at 3.35 TB/s. One
// pass: a thread loads 4 elements (16 bytes) and stores 8 bytes to each of
// the three column blocks of its row; a width that is no multiple of 4
// takes one element a thread.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

__device__ __forceinline__ void split_value(float g, bf16& hi, bf16& mid,
                                            bf16& lo) {
  hi = __float2bfloat16_rn(g);
  const float r = g - __bfloat162float(hi);  // exact
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));  // exact twice
}

__device__ __forceinline__ uint32_t pack2(bf16 a, bf16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

// g (rows, cols) f32 -> out (rows, 3 * cols) bf16: row r holds hi, mid and
// lo of g's row r one after another. VEC consecutive elements a thread.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    split3_kernel(const float* __restrict__ g, bf16* __restrict__ out,
                  long long rows, long long cols) {
  const long long per_row = cols / VEC;
  const long long total = rows * per_row;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       t < total; t += stride) {
    const long long r = t / per_row;
    const long long c = (t - r * per_row) * VEC;
    const float* src = g + r * cols + c;
    bf16* dst = out + r * 3 * cols + c;
    if constexpr (VEC == 4) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      bf16 hi[4], mid[4], lo[4];
      split_value(v.x, hi[0], mid[0], lo[0]);
      split_value(v.y, hi[1], mid[1], lo[1]);
      split_value(v.z, hi[2], mid[2], lo[2]);
      split_value(v.w, hi[3], mid[3], lo[3]);
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(pack2(hi[0], hi[1]), pack2(hi[2], hi[3]));
      *reinterpret_cast<uint2*>(dst + cols) =
          make_uint2(pack2(mid[0], mid[1]), pack2(mid[2], mid[3]));
      *reinterpret_cast<uint2*>(dst + 2 * cols) =
          make_uint2(pack2(lo[0], lo[1]), pack2(lo[2], lo[3]));
    } else {
      bf16 hi, mid, lo;
      split_value(*src, hi, mid, lo);
      dst[0] = hi;
      dst[cols] = mid;
      dst[2 * cols] = lo;
    }
  }
}

template <int VEC>
int launch(const void* g, void* out, long long rows, long long cols,
           cudaStream_t stream) {
  const long long total = rows * (cols / VEC);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  split3_kernel<VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<bf16*>(out), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g (rows, cols) f32, 16-byte aligned; out (rows, 3 * cols) bf16. rows and
// cols at least 1.
KFT_EXPORT int kft_split3(const void* g, void* out, long long rows,
                          long long cols, void* stream) {
  if (rows < 1 || cols < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols % 4 == 0) return launch<4>(g, out, rows, cols, s);
  return launch<1>(g, out, rows, cols, s);
}
