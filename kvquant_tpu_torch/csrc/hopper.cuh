// Device helpers shared by the Hopper (sm_90a) kernels of flash_decode.cu
// (K1, K5) and attention.cu (K3, K4): bf16 rounding, mbarriers and TMA
// bulk copies for the decode bodies' tile rings, nuq code bytes by bit
// spreading, the transposing warp reduction, the ldmatrix /
// mma.sync.m16n8k16 wrappers of the tensor-core bodies, and the key
// fragments of the tensor-core decode bodies fd_gqa (K1, K5) and qk_gqa
// (K3). Included by both sources; the build keys each library by the
// headers it includes.

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

// The rotation of the pair (x0 at dim i, x1 at dim i + D/2) by (c, s), with
// fixed roundings: every body and the K slot fix-up compute the same bits.
__device__ __forceinline__ void rope2(float x0, float x1, float c, float s, float& r0,
                                      float& r1) {
  r0 = __fmaf_rn(x0, c, -__fmul_rn(x1, s));
  r1 = __fmaf_rn(x1, c, __fmul_rn(x0, s));
}

// ---------------------------------------------------------------------------
// The tensor-core decode bodies (fd_gqa, qk_gqa: 3-8 query rows per kv head,
// bf16 dots). Scores run on mma.sync.m16n8k16 with A = 16 tokens x 16 dims
// of keys, dequantized in registers, and B = the query rows, N = 8 (rows
// past R zero). A consumer warp's unit is GU = 32 tokens of a stage; its
// slot s (0..31) is a token of the tile (bit planes: 4s + r, word row r of
// the 128-token group; containers: 32 u + s). Lane (g, tq) = (lane / 4,
// lane % 4) holds, as A operands of the m16 tile hh (0, 1), the keys of
// slots 16 hh + g (rows g) and 16 hh + g + 8 (rows g + 8) at the first-half
// dims c .. c + 3, c = 16 j + 4 tq (k-block j < D/32: operand columns 2tq,
// 2tq + 1 take c, c + 1 and columns 2tq + 8, 2tq + 9 take c + 2, c + 3),
// and at their RoPE partners c + D/2 in k-block j + D/32: a pair never
// leaves its thread. The score C fragment then holds slots 16 hh + g + 8 f
// (f = 0, 1) for query rows 2tq, 2tq + 1: sc[hh][2f + e], row 2tq + e.
// ---------------------------------------------------------------------------

constexpr int GU = 32;    // tokens per unit of a consumer warp
constexpr int GNJ = 4;    // most first-half k-blocks (D <= 128)

// B fragments of the scores for k-block j (e = 0: dims 16j + 4tq + 0..3,
// e = 1: their partners), column g = query row g, from the head's
// bf16-valued queries transposed, qT [D][8] (rows past R zero); zero past
// D/32 blocks
__device__ __forceinline__ void gqa_query_frags(const float* qT, int D, int g, int tq,
                                                uint32_t (&qf)[GNJ][2][2]) {
#pragma unroll
  for (int j = 0; j < GNJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      qf[j][e][0] = qf[j][e][1] = 0u;
      if (j < D / 32) {
        const float* qc = qT + (16 * j + 4 * tq + e * (D / 2)) * 8 + g;
        qf[j][e][0] = bf2(qc[0], qc[8]);
        qf[j][e][1] = bf2(qc[16], qc[24]);
      }
    }
}

// A warp's exchange tile of per-(query row, unit slot) fp32 terms that the
// lane of a slot computes for every row (an outlier's score terms) and the
// lanes that hold the slot's scores add: [8][GXS] floats.
constexpr int GXS = GU + 1;
constexpr int GXB = 8 * GXS * 4;  // its bytes

// the eight query rows of dim d from qT [D][8]
__device__ __forceinline__ void gqa_q8(const float* qT, int d, float (&q)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(qT + d * 8);
  const float4 hi = *reinterpret_cast<const float4*>(qT + d * 8 + 4);
  q[0] = lo.x; q[1] = lo.y; q[2] = lo.z; q[3] = lo.w;
  q[4] = hi.x; q[5] = hi.y; q[6] = hi.z; q[7] = hi.w;
}

// Lane l has put its slot's terms e[r] of rows r in sX; the lanes add
// those of their scores (sc[hh][2f + e]: slot g + 8(2hh + f), row 2tq + e).
__device__ __forceinline__ void gqa_exchange(float* sX, int lane, const float (&e)[8], int g,
                                             int tq, float (&sc)[2][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) sX[r * GXS + lane] = e[r];
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    sc[q >> 1][2 * (q & 1)] += sX[2 * tq * GXS + g + 8 * q];
    sc[q >> 1][2 * (q & 1) + 1] += sX[(2 * tq + 1) * GXS + g + 8 * q];
  }
  __syncwarp();
}

// Bit b of a plane word of one column as bit `to` of each byte: the word
// rotated right by b - to, masked to bits to, to + 8, to + 16, to + 24 (it
// takes bits b, b + 8, b + 16, b + 24, modulo 32).
__device__ __forceinline__ uint32_t plane_bits(uint32_t w, int b, int to) {
  return __funnelshift_r(w, w, b - to) & (0x01010101u << to);
}

// Code bytes of a bit-plane unit: byte q of cw[i] is 4 x the code of slot
// g + 8q (m16 tile q / 2, upper half q % 2) at column c + i (i < 4) or
// c + D/2 + i - 4, from NB staged planes of word row `row`: the four
// slots' bits of a plane are bits g, g + 8, g + 16, g + 24 of its word, one
// rotate and one AND-OR a plane.
template <int NB>
__device__ __forceinline__ void gqa_code_bytes(const unsigned char* planes, int D, int row, int c,
                                               int g, uint32_t (&cw)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) cw[i] = 0u;
#pragma unroll
  for (int bb = 0; bb < NB; ++bb) {
    const uint32_t* pl = reinterpret_cast<const uint32_t*>(planes + bb * 16 * D) + row * D;
    const uint4 lo = *reinterpret_cast<const uint4*>(pl + c);
    const uint4 hi = *reinterpret_cast<const uint4*>(pl + c + D / 2);
    const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) cw[i] |= plane_bits(w[i], g, 2 + bb);
  }
}

// A token's (cos, sin) rows at dims c .. c + 3 (the table at (token, c)),
// loaded ahead of its keys
struct Rot4 {
  float4 c01, c23;
};
template <bool PRE>
__device__ __forceinline__ Rot4 gqa_rot4(const float2* cs) {
  Rot4 r;
  if (PRE) {
    r.c01 = __ldg(reinterpret_cast<const float4*>(cs));
    r.c23 = __ldg(reinterpret_cast<const float4*>(cs) + 1);
  }
  return r;
}

// One token's A fragments (tile hh, half f) from its eight dequantized
// keys x (dims c .. c + 3, then their partners), rotated by its (cos, sin)
// rows when PRE, rounded to bf16.
template <bool PRE>
__device__ __forceinline__ void gqa_key_frag(float (&x)[8], const Rot4& cs, int f,
                                             uint32_t (&af)[2][4]) {
  if (PRE) {
    const float4 c01 = cs.c01, c23 = cs.c23;
    const float cc[4] = {c01.x, c01.z, c23.x, c23.z}, ss[4] = {c01.y, c01.w, c23.y, c23.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float r0, r1;
      rope2(x[i], x[i + 4], cc[i], ss[i], r0, r1);
      x[i] = r0;
      x[i + 4] = r1;
    }
  }
  af[0][f] = bf2(x[0], x[1]);
  af[0][2 + f] = bf2(x[2], x[3]);
  af[1][f] = bf2(x[4], x[5]);
  af[1][2 + f] = bf2(x[6], x[7]);
}

// The raw scores of a bit-plane unit (word row `row` of the staged planes,
// keys lut[code] * step[d] + zero[d], rotated at the table rows `rope` of
// the tile's tokens when PRE): sc[hh][2f + e] of slot 16hh + g + 8f, row
// 2tq + e. step / zero: the head's [D] fp32 constants in shared memory.
template <int NB, bool PRE>
__device__ __forceinline__ void gqa_nuq_scores(const unsigned char* planes, int D, int row,
                                               const float* step, const float* zero,
                                               const float* lut, const float2* rope, int g,
                                               int tq, const uint32_t (&qf)[GNJ][2][2],
                                               float (&sc)[2][4]) {
  const int half = D / 2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int r = 0; r < 4; ++r) sc[hh][r] = 0.f;
#pragma unroll
  for (int j = 0; j < GNJ; ++j) {
    if (j < D / 32) {
      const int c = 16 * j + 4 * tq;
      Rot4 rot[4];  // the four slots' table rows, loaded ahead
#pragma unroll
      for (int q = 0; q < 4; ++q)
        rot[q] = gqa_rot4<PRE>(PRE ? rope + (size_t)(4 * (g + 8 * q) + row) * half + c : nullptr);
      uint32_t cw[8];
      gqa_code_bytes<NB>(planes, D, row, c, g, cw);
      const float4 s0 = *reinterpret_cast<const float4*>(step + c);
      const float4 s1 = *reinterpret_cast<const float4*>(step + c + half);
      const float4 z0 = *reinterpret_cast<const float4*>(zero + c);
      const float4 z1 = *reinterpret_cast<const float4*>(zero + c + half);
      const float ks[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float kz[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t af[2][4];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int q = 2 * hh + f;  // byte q of the code words: slot g + 8q
          float x[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            x[i] = fmaf(*reinterpret_cast<const float*>(reinterpret_cast<const char*>(lut) +
                                                        byte_of(cw[i], q)),
                        ks[i], kz[i]);
          gqa_key_frag<PRE>(x, rot[q], f, af);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) mma16816(sc[hh], af[e], qf[j][e][0], qf[j][e][1]);
      }
    }
  }
}

}  // namespace
