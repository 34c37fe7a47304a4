// Hopper building blocks for the port's tensor-core kernels: cp.async
// copies into 128-byte-swizzled shared-memory tiles, wgmma descriptors
// for those tiles, and the wgmma instructions the flash backward issues.
//
// Tile layout. A bf16 tile of 64 rows and 64*nb columns is stored as nb
// column blocks of 64 rows x 64 columns (128 bytes a row); within a
// block the 16-byte chunk c of row r sits at chunk c ^ (r % 8). That is
// the hardware's 128-byte swizzle, so wgmma reads the tile through a
// descriptor of layout type SWIZZLE_128B, rows K-major (the reduction
// runs along the row) or MN-major (the reduction runs down the rows,
// the "transpose" bit), with no transposed copy. Tiles start on a
// 1024-byte boundary (one swizzle period of 8 rows).
//
// Fragment layout of a 64 x N f32 accumulator in a warpgroup (thread t,
// warp w = t / 32, lane l = t % 32): for each 8-column chunk j,
// d[4j + e] holds row 16w + l/4 + 8*(e >> 1), column 8j + 2*(l % 4) +
// (e & 1). The A operand of a register-sourced wgmma uses the same
// layout per 16-column k step, so an accumulator becomes the next
// product's A by packing pairs to bf16 (a_fragment below), with no
// data movement between threads.
#pragma once

#include "common.cuh"

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Every tile of the kernels has 64 rows: a column block is 8 KB.
constexpr int kTileRows = 64;
constexpr uint32_t kBlockBytes = kTileRows * 128;

// Byte offset of 16-byte chunk `chunk` (counted across the column
// blocks) of row `row` in a swizzled tile.
__device__ __forceinline__ uint32_t sw128_offset(int row, int chunk) {
  return (chunk >> 3) * kBlockBytes + row * 128 +
         (((chunk & 7) ^ (row & 7)) << 4);
}

// 16-byte and 4-byte asynchronous copies, zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// ldmatrix: four (x4) or two (x2) 8 x 8 bf16 matrices from shared memory,
// lanes 8i..8i+7 giving the 16-byte row addresses of matrix i. Lane l
// receives of each matrix row l / 4 at columns 2(l % 4), 2(l % 4) + 1, or
// with .trans column l / 4 at rows 2(l % 4), 2(l % 4) + 1: the mma.sync
// m16n8k16 fragment layouts (common.cuh).
__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr)
      : "memory");
}
// Makes this thread's generic-proxy shared-memory writes (cp.async,
// plain stores) visible to wgmma's async-proxy reads; a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copies rows [r0, r0 + 64) of a row-major (S, D) bf16 matrix into the
// swizzled tile at shared address `dst`, zero-filling rows at or
// past S. Only a row's D / 8 chunks are written: the columns of a tile
// padded past D are never read into a stored result. NT threads share
// the copies, each a fixed count (the loop unrolls, and a thread's chunk
// column and swizzle phase stay put from one copy to the next).
template <int D, int NT>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          int r0, int S, int tid) {
  constexpr int kChunks = D / 8;
  static_assert(kTileRows * kChunks % NT == 0, "whole copies per thread");
#pragma unroll
  for (int j = 0; j < kTileRows * kChunks / NT; ++j) {
    const int i = tid + j * NT;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool valid = r0 + r < S;
    cp_async16(dst + sw128_offset(r, c),
               src + (size_t)(valid ? r0 + r : 0) * D + c * 8, valid);
  }
}

// A wgmma shared-memory descriptor for a SWIZZLE_128B tile: start
// address, leading and stride byte offsets. K-major (the reduction along
// the 128-byte row): stride 1024 bytes from one 8-row group to the next,
// the leading offset unused; a 16-element k step inside a column block
// moves the start 32 bytes. MN-major: leading offset = the distance
// between 64-column blocks, stride 1024 bytes between 8-row groups of
// the reduction; a 16-row k step moves the start 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand: k step `kstep` of a 64-row tile.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kstep) {
  return desc_sw128(tile + (kstep >> 2) * kBlockBytes + (kstep & 3) * 32, 16,
                    1024);
}
// MN-major operand N columns wide, starting at column block `col_block`,
// k step `kstep` (rows 16*kstep..). A 64-wide read gets a leading offset
// that points nowhere: the card reads past the tile by that offset
// otherwise.
template <int N>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int col_block,
                                                 int kstep) {
  return desc_sw128(tile + col_block * kBlockBytes + kstep * 2048,
                    N > 64 ? kBlockBytes : 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins the accumulator registers at this point of the program: the
// compiler may not move their reads or writes across an in-flight wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k step `kk` (columns 16kk..16kk+15) of a 64 x N
// accumulator, rounded to bf16.
template <int N>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4],
                                           const float (&d)[N], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// D(64x64) += A(64x16) * B(16x64), A and B from shared memory (both
// K-major).
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// D(64x64) += A(64x16) * B(16x64), A from registers (the accumulator
// fragment layout, packed bf16x2), B from shared memory MN-major
// (transposed: N contiguous).
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64x128) += A(64x16) * B(16x128), A from registers (the accumulator
// fragment layout, packed bf16x2), B from shared memory MN-major
// (transposed: N contiguous).
__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The first k step of a product, D = A * B: D is written, not read, so
// its registers need hold nothing before.
__device__ __forceinline__ void wgmma_ss_m64n64_first(float (&d)[32],
                                                      uint64_t a,
                                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
      "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
      "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
      "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b), "r"(0));
}
