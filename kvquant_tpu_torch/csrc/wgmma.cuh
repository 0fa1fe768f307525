// Warpgroup matrix products (wgmma, sm_90a) of the tensor-core chunk body
// fd_chunk (flash_decode.cu): the swizzled shared-memory tile layout its
// producers write and its consumers read, the operand descriptors, the two
// product shapes it runs and their fences.
//
// Tile layout (wgmma's 128-byte swizzle): a bf16 tile of nr rows and up to
// 128 columns is two 64-column blocks of nr rows of 128 B each; in row r
// the 16-byte chunk j (columns 8j .. 8j + 7 of the block) sits at chunk
// j ^ (r % 8). A block's 8-row groups are 1024-byte swizzle atoms, so a
// tile must start 1024-aligned in shared memory (the hardware swizzles
// address bits 4-6 by bits 7-9). Read row-major (rows = M or N, columns =
// K) it is the K-major operand; read with the transpose (rows = K, columns
// = N) the MN-major one, each 64-column block being one 64-wide group of N.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SW_ROW = 128;       // bytes of a tile row within a 64-column block
constexpr int SW_ATOM = 8 * SW_ROW;  // bytes of an 8-row swizzle atom

// byte offset of element (r, c) (bf16) of a tile of nr rows
__host__ __device__ inline int sw_off(int r, int c, int nr) {
  return (c >> 6) * nr * SW_ROW + r * SW_ROW + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// The 64-bit shared-memory matrix descriptor of a 128-byte swizzled operand
// at shared address `addr`: lbo / sbo in bytes (encoded >> 4), layout type
// 1 (128-byte swizzle) in bits 62-63, base offset 0 (atoms 1024-aligned).
// K-major (a row-major tile read as M x K or N x K): sbo = SW_ATOM between
// 8-row groups, lbo unused; the k-step of 16 columns advances addr by 32 B
// inside a 64-column block. MN-major (read transposed): lbo = the bytes
// between 64-column blocks (the next 64 of N), sbo = SW_ATOM between 8-row
// groups (the next 8 of K).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// makes the compiler treat the registers as read and written here: no use
// of an accumulator moves across an asynchronous product's issue or wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(x[i][j])::"memory");
}

// d (+)= A.B^T, m64n32k16, bf16 in, fp32 accumulate; A (64 x 16) and B
// (32 x 16) K-major from shared memory; acc = 0 overwrites d. d[j][e] is
// row 16 (warp % 4) + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) +
// e % 2 (mma.sync's C fragment, repeated over the n8 blocks).
__device__ __forceinline__ void wg_m64n32_ss(float (&d)[4][4], uint64_t da, uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %18, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(acc));
}

// d += A.B, m64n128k16, bf16 in, fp32 accumulate; A (64 x 16) in registers
// (mma.sync's A fragment of the warp's 16 rows), B (16 x 128) MN-major from
// shared memory (the transpose). d[n][e] as above over 16 n8 blocks.
__device__ __forceinline__ void wg_m64n128_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),
        "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),
        "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// named barrier `id` over n threads: wait for it (sync) or only count this
// thread in (arrive)
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(n) : "memory");
}

// generic-proxy writes of this thread to shared memory made visible to the
// async proxy (the wgmma operand reads) before the barrier that hands them
// over
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

}  // namespace
