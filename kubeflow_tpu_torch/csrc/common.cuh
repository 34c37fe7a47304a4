// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point is a plain C function loaded with ctypes: it takes
// raw device pointers, sizes and the caller's stream, launches, and
// returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch (too many threads, too much shared memory) that would
// otherwise never run and never be reported.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define KFT_EXPORT extern "C" __attribute__((visibility("default")))

// Finite "minus infinity", the same constant the reference kernels use:
// exp(NEG_INF - m) underflows to 0 instead of producing NaN.
#define KFT_NEG_INF (-1e30f)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(float v) { return v; }

// Round an f32 value to bf16 and back: the "astype(compute dtype)" step
// of the reference op order, kept explicit where a kernel must match it.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// D(16 x 8) += A(16 x 16) B(16 x 8), bf16 in, f32 accumulate (mma.sync
// m16n8k16: thread g = lane / 4, t = lane % 4 holds A rows g and g + 8 and
// B column g, each at k pairs (2t, 2t+1) and (2t+8, 2t+9); D rows g, g + 8
// at columns 2t, 2t + 1).
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Launches grid (cluster, rows) as clusters of `cluster` blocks along x,
// with `smem` bytes of dynamic shared memory; returns the launch's status.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int cluster, int rows,
                    int threads, int smem, cudaStream_t stream,
                    Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, rows);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
