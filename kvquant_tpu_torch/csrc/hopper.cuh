// Device helpers shared by the Hopper (sm_90a) kernels of flash_decode.cu
// (K1, K5) and attention.cu (K3, K4): bf16 rounding, mbarriers and TMA
// bulk copies for the decode bodies' tile rings, nuq code bytes by bit
// spreading, the transposing warp reduction, and the ldmatrix /
// mma.sync.m16n8k16 wrappers of the tensor-core bodies. Included by both
// sources; the build keys each library by the headers it includes.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float rnd(float x, bool bf) {
  return bf ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}
// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// TMA 1-D bulk copy global -> shared; completion counted on `bar` in
// bytes. The codes stream through L2 once: evict-first, so that they do
// not push out the (cos, sin) table every layer and step reads again.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 pol;\n\t"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n\t"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], pol;\n\t}"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// bf16 rounding of four dot operands where asked (two paired conversions)
__device__ __forceinline__ void rnd4(float (&x)[4], bool bf) {
  if (bf) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    x[0] = __low2float(lo);
    x[1] = __high2float(lo);
    x[2] = __low2float(hi);
    x[3] = __high2float(hi);
  }
}

// byte i of w, zero-extended
__device__ __forceinline__ uint32_t byte_of(uint32_t w, int i) {
  return __byte_perm(w, 0u, 0x4440u | (uint32_t)i);
}
// A chunk's nuq codes of word row w4 for the lane's four columns (c0,
// c0 + 1, c0 + D/2, c0 + D/2 + 1), from NB staged planes (4 word rows of D
// words each): token 4*j + w4 of the chunk sits at bit b0 + j of every
// plane's word; cw[col][j / 4] gets code * 4 (a LUT byte offset) in byte
// j % 4. Four bits of a plane spread to four bytes with one multiply.
template <int NB, int NWD>
__device__ __forceinline__ void nuq_bytes(const unsigned char* planes, int w4, int D,
                                          int c0, int half, int b0,
                                          uint32_t (&cw)[4][NWD]) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int wi = 0; wi < NWD; ++wi) cw[jj][wi] = 0u;
#pragma unroll
  for (int bb = 0; bb < NB; ++bb) {
    const uint32_t* pl = reinterpret_cast<const uint32_t*>(planes + bb * 16 * D) + w4 * D;
    const uint2 lo = *reinterpret_cast<const uint2*>(pl + c0);
    const uint2 hi = *reinterpret_cast<const uint2*>(pl + c0 + half);
    const uint32_t wv[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int wi = 0; wi < NWD; ++wi) {
        const uint32_t nib = (wv[jj] >> (b0 + 4 * wi)) & 0xFu;
        cw[jj][wi] |= (nib * (0x204081u << (2 + bb))) & (0x01010101u << (2 + bb));
      }
  }
}

// One step of transpose_reduce: lanes with bit H set keep the upper H of
// their 2H partial sums and send the lower H to lane ^ H, the others the
// reverse (constant indices: the vector stays in registers).
template <int H>
__device__ __forceinline__ void fold(float (&v)[32], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, H);
  }
}

// Sum of 32 per-lane vectors v[0..31] over the warp, transposed: returns
// to lane l the full sum of entry l (31 shuffles in all).
__device__ __forceinline__ float transpose_reduce(float (&v)[32], int lane) {
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  return v[0];
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c += a.b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 fp32
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats as a bf16 pair (lo in the low half), rounded to nearest even
__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
