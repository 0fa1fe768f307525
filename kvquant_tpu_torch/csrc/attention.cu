// The two-pass attention of kernel="pallas" over the quantized KV cache, for
// NVIDIA Hopper (sm_90a): scores over every packed token (qk_fused, K3),
// then the probability-weighted values (pv_fused, K4). The caller scales,
// masks and softmaxes between the two and adds the sink tokens.
//
// K3 replaces kvquant_tpu/ops/pallas/attention.py:_qk_kernel (the TPU
// kernel behind qk_fused): for batch row b, kv head h and query rows r,
//   out[b,h,r,t] = q[b,h,r] . rnd(RoPE(lut[code]*k_range + k_offset)
//                                 + RoPE(K slot addend))  at position S + t,
// for every t < Tc, from nuq bit planes (2-4 bits, any codebook) with keys
// stored pre-RoPE and slot outliers in kv_out rows [0, n_kslots).
// K4 (+ pv_merge) replaces attention.py:_pv_kernel (behind pv_fused):
//   out[b,h,r] = sum_t rnd(p*v_scale[t])*rnd(lut[code]) + sum_t p*v_offset[t]
//                + rnd(p) * rnd(V slot addend),  V slots in rows [spk, ...).
// rnd is the bf16 rounding under dot_bf16 (else the identity). Both read the
// whole capacity Tc, as the TPU kernels do: dead positions carry p = 0 from
// the caller's mask, and the functions take no length.
//
// What bounds them. At a decode step (R = G <= 8 rows) device-memory bytes:
// per token and kv head bits*D/8 code bytes, the head group's slot words
// and, in K3, the scores written (LLaMA-2-7B, nuq3, hg 4, cap 2: ~1.7 KB per
// token and layer for either kernel). Then instruction issue: every code is
// dequantized (K3 also rotated and rounded) once per call. For a prefill
// block (R = G * Tq_all, ~261 rows) the (R, Tc) scores and probabilities:
// the contractions, 2*R*Tc*D flops per head in each kernel, fit the tensor
// cores' rate several times over.
//
// Three bodies per kernel (and the tensor-core decode bodies qk_gqa, pv_gqa), picked
// by the host plan (qk_plan / pv_plan in ops/kernels/attention.py), which
// this file checks, its shared-memory count included:
//  - decode (R <= 8, both dot modes; G = 1/2/4/8 rows per instance): one
//    block per (batch row, hc kv heads of whole head groups, token split).
//    A producer warp fills a ring of 128-token stages (one nuq packing
//    group) with TMA bulk copies (evict-first) of the heads' bit planes and
//    the groups' slot rows (K4: and the V scale / offset), completing on the
//    stage's mbarrier; eight consumer warps take (head, 32/G-token chunk)
//    units and release the stage through a second mbarrier. Nothing
//    dequantized goes to shared memory: lane l owns columns 2l, 2l+1 and
//    their RoPE partners; codes become LUT bytes by bit spreading (one
//    multiply per four tokens of a plane). K3 rotates with the cached
//    (cos, sin) table (flash_decode.rope_table, K1's), rounds, takes the
//    rows' partial dots and leaves each score on one lane with a transposing
//    butterfly (31 shuffles per 32 (row, token) scores), stores coalesced
//    along t. A K slot changes the rounded operand of its dim and its RoPE
//    partner: the lane of the score recomputes that key pair from the staged
//    codes, adds the rotated, slot-order-summed addend, and adds
//    q.(rnd(k + a) - rnd(k)) to the score (no shared-memory atomics). K4
//    folds rnd(p*v_scale) per token into register accumulators; sum p*v_offset
//    is a lane sum per row; per slot row, the lanes of a chunk's tokens post
//    (dim, rnd(M)), M the dim's slots summed in slot order, in shared
//    memory, and five ballots give each lane the tokens whose dim it owns,
//    which it adds as rnd(p) * rnd(M) in token order. The warps of a head
//    meet in shared memory, the splits in pv_merge, in a fixed order: sums
//    are the same from run to run;
//  - qk_gqa (K3 at R = 3..8 with bf16 dots: DBRX's G 6, MISTRAL_7B's 4):
//    the decode body's ring, heads and splits, each consumer warp a
//    128-token stage's word row at a time; the scores on mma.sync.m16n8k16
//    with A = 16 tokens x 16 dims of keys dequantized, rotated (a pair
//    never leaves its lane) and rounded in registers and B = the R rows
//    (hopper.cuh's fd_gqa layout), written straight from the C fragments;
//    the K slot fix-ups are qk_decode's, one lane per token for every row,
//    added through a per-warp exchange tile. Two blocks an SM (96
//    registers; one block at 168 runs slower, gqa_ablation.py);
//  - pv_gqa (K4 at R = 3..8 with bf16 dots): the same ring, which also
//    stages each tile's P rows (cp.async, in fragment order); P.V on
//    mma.sync.m16n8k16 with A = 16 dims x 16 tokens of rnd(lut[code]) from
//    the bit planes in registers and B = rnd(p * v_scale) of the R rows;
//    V slots through a per-warp bf16 V^T slot tile (its note below);
//  - mma (R > 8, bf16 dots), on the tensor cores with mma.sync.m16n8k16 and
//    ldmatrix, 8 warps a block. K3: a block owns a head, up to 272 query
//    rows (bf16 in shared memory) and a token split; each 128-token tile of
//    keys is dequantized, rotated, given its slots (a bitmask of the pairs
//    a slot touches; sums before the one rounding) and rounded to bf16
//    once, into shared memory; warp w holds the B fragments of tokens
//    32 (w % 4) .. + 31 in registers and multiplies every other row tile
//    against them; the fp32 score fragments go straight to device memory.
//    K4: a block owns a head, up to 144 rows and a token split; per 64-token
//    tile rnd(p*v_scale) (and rnd(p) where V slots exist) are staged as
//    bf16 A tiles, the values as a bf16 B tile (ldmatrix.trans), the V
//    slots as a sparse bf16 tile multiplied over the 16-token steps that
//    hold one; sum p*v_offset stays fp32 SIMT; warp w accumulates output
//    columns 16w..16w+15 of every row;
//  - simt (R > 8, fp32 dots, the reference mode that bf16 tensor cores do
//    not compute): 64-token tiles dequantized into fp32 shared memory and
//    64-row register tiles of FMA; the rotation reads the table.
//
// Numerics: with dot_bf16 the dot operands round to bf16 where the TPU
// kernels round them (above) and accumulate in fp32; otherwise all fp32.
// A K slot dim d in [D, 3D/2) adds, as the TPU kernel's one-hot rotation
// does, -v*sin at d - D/2 and nothing at d; V slot dims >= D add nothing.
// Built without fast-math: slot words are fp32 bit patterns whose
// zero-valued slots are denormals.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "hopper.cuh"

// Field order is mirrored by the ctypes Structures in
// kvquant_tpu_torch/ops/kernels/attention.py.
struct QkArgs {
  const float* q;         // (B, Hkv, R, D) roped queries
  const int32_t* kp;      // (B, Hkv, bits, Tc/32, D) bit planes
  const float* kv_out;    // (B, Hkv/hg, J, Tc) slot words, K rows first
  const float* k_range;   // (Hkv, D)
  const float* k_offset;  // (Hkv, D)
  const float* lut;       // (2**bits,)
  const float2* rope;     // (Tc, D/2) (cos, sin) of packed token t at S + t
  float* out;             // (B, Hkv, R, Tc) unscaled scores
  int B, Hkv, R, D, Tc, J;
  int n_kslots;           // K slot rows (0: no slots)
  int hg, bits, dot_bf16;
  int body;               // BODY_DECODE / BODY_MMA / BODY_SIMT
  int hc;                 // kv heads per block
  int n_split;            // token splits (grid.x)
  int n_stage;            // decode: ring stages
  int rows_blk, n_rt;     // mma / simt: query rows per block, row blocks
  int smem;               // dynamic shared bytes per block, as the plan counts them
};

struct PvArgs {
  const float* p;         // (B, Hkv, R, *) probabilities, rows p_ld apart
  const int32_t* vp;      // (B, Hkv, bits, Tc/32, D) bit planes
  const float* v_scale;   // (B, Tc)
  const float* v_offset;  // (B, Tc)
  const float* kv_out;    // (B, Hkv/hg, J, Tc) slot words, V rows from spk
  const float* lut;       // (2**bits,)
  float* part;            // (B, Hkv, n_split, R, D) split partials
  float* out;             // (B, Hkv, R, D)
  int B, Hkv, R, D, Tc, p_ld, J, spk;
  int n_vslots;           // V slot rows (0: no slots)
  int hg, bits, dot_bf16;
  int body, hc, n_split, n_stage, rows_blk, n_rt, smem;
};

namespace {

constexpr int BODY_DECODE = 0, BODY_MMA = 1, BODY_SIMT = 2, BODY_GQA = 3;
constexpr int MAXD = 128;
constexpr int MAX_SLOTS = 8;  // slot rows of one kind per head group

// A slot word's dim when it belongs to in-group head jh (head field ignored
// at head_group 1) and lies inside the head, else -1.
__device__ __forceinline__ int slot_dim(uint32_t u, int hg, int jh, int D) {
  const int dim = (int)(u & 0x7Fu);
  return ((hg == 1 || (int)((u >> 7) & 0x3u) == jh) && dim < D) ? dim : -1;
}

__device__ __forceinline__ float slot_value(uint32_t u) {
  return __uint_as_float(u & 0xFFFFFE00u);
}

// A K slot word's dim when it belongs to in-group head jh and its rotation
// reaches the head: d < D, or D <= d < 3D/2, whose own column lies outside
// the head but whose rotate-half term -v*sin the TPU kernel adds at
// d - D/2; else -1.
__device__ __forceinline__ int kslot_dim(uint32_t u, int hg, int jh, int D) {
  const int dim = (int)(u & 0x7Fu);
  return ((hg == 1 || (int)((u >> 7) & 0x3u) == jh) && dim < D + D / 2) ? dim : -1;
}
// the key pair (i, i + D/2) such a dim touches
__device__ __forceinline__ int kslot_pair(int d, int D) {
  return d < D ? d & (D / 2 - 1) : d - D;
}

// ---------------------------------------------------------------------------
// the simt bodies (R > 8, fp32 dots): 64-token tiles, 64-row passes
// ---------------------------------------------------------------------------

constexpr int TT = 64;   // tokens per tile
constexpr int NT = 128;  // threads per block
constexpr int PR = 64;   // query rows per pass

// The 4 x BITS words of column c of the 128-token group g: token 4*j + i
// of the group is bit j of word i of each plane.
template <int BITS>
__device__ __forceinline__ void load_group_words(uint32_t (&w)[BITS][4], const int32_t* planes,
                                                 int TW, int D, int g, int c) {
#pragma unroll
  for (int bb = 0; bb < BITS; ++bb)
#pragma unroll
    for (int i = 0; i < 4; ++i) w[bb][i] = (uint32_t)planes[((size_t)bb * TW + g * 4 + i) * D + c];
}

template <int BITS>
__device__ __forceinline__ int plane_code(const uint32_t (&w)[BITS][4], int bit, int i) {
  int e = 0;
#pragma unroll
  for (int bb = 0; bb < BITS; ++bb) e |= (int)((w[bb][i] >> bit) & 1u) << bb;
  return e;
}

// Token t's `n` slot words of one kind (rows Tc apart), loaded together.
__device__ __forceinline__ void load_slots(uint32_t (&sw)[MAX_SLOTS], const float* words,
                                           int n, int Tc) {
#pragma unroll
  for (int j = 0; j < MAX_SLOTS; ++j)
    sw[j] = j < n ? __float_as_uint(words[(size_t)j * Tc]) : 0u;
}

// floats of qk_simt's dynamic shared memory
__host__ __device__ constexpr int qk_simt_floats(int D) {
  return TT * D            // sCS  (cos, sin) of (token, pair)
         + TT * (D + 1)    // sK   rotated keys + slots
         + PR * (D + 1)    // sQ   query rows of a pass
         + 16;             // sLut
}

// One block: tile blockIdx.x of 64 packed tokens, kv head blockIdx.y, batch
// row blockIdx.z; passes of 64 query rows, 8x4 register tiles per thread.
template <int BITS>
__global__ void __launch_bounds__(NT) qk_simt(QkArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, DP = D + 1, half = D / 2;
  float2* sCS = reinterpret_cast<float2*>(smem);
  float* sK = smem + TT * D;
  float* sQ = sK + TT * DP;
  float* sLut = sQ + PR * DP;

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TT, h = blockIdx.y, b = blockIdx.z;
  const int Tc = a.Tc, R = a.R, TW = Tc / 32;
  const size_t bh = (size_t)b * a.Hkv + h;

  for (int i = tid; i < TT * half; i += NT) sCS[i] = a.rope[(size_t)t0 * half + i];
  if (tid < (1 << BITS)) sLut[tid] = a.lut[tid];
  // this head's K slot words of token tid, in flight during the dequant
  const int nks = a.n_kslots;
  uint32_t sw[MAX_SLOTS];
  if (nks > 0 && tid < TT)
    load_slots(sw, a.kv_out + (((size_t)b * (a.Hkv / a.hg) + h / a.hg) * a.J) * Tc + t0 + tid,
               nks, Tc);
  __syncthreads();

  // dequant mapping: thread -> column pair (c0, c0 + D/2), D/4 tokens
  const int c0 = tid % half, c1 = c0 + half;
  const int tpp = TT * half / NT;
  const int tb = (tid / half) * tpp;
  const int g = t0 / 128, bit0 = ((t0 % 128) + tb) >> 2;
  uint32_t w0[BITS][4], w1[BITS][4];
  const int32_t* planes = a.kp + bh * BITS * TW * D;
  load_group_words<BITS>(w0, planes, TW, D, g, c0);
  load_group_words<BITS>(w1, planes, TW, D, g, c1);
  const float kr0 = a.k_range[h * D + c0], ko0 = a.k_offset[h * D + c0];
  const float kr1 = a.k_range[h * D + c1], ko1 = a.k_offset[h * D + c1];
#pragma unroll 4
  for (int j4 = 0; j4 < tpp / 4; ++j4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tb + 4 * j4 + i;
      const float x0 = fmaf(sLut[plane_code<BITS>(w0, bit0 + j4, i)], kr0, ko0);
      const float x1 = fmaf(sLut[plane_code<BITS>(w1, bit0 + j4, i)], kr1, ko1);
      const float2 cs = sCS[t * half + c0];
      rope2(x0, x1, cs.x, cs.y, sK[t * DP + c0], sK[t * DP + c1]);
    }
  }
  __syncthreads();

  // K slots: thread t owns token row t and adds its slots in slot order,
  // rotated by linearity (v at dim d adds v*cos at d and +-v*sin at d +- D/2)
  if (nks > 0 && tid < TT) {
    float* row = sK + tid * DP;
    const float2* cst = sCS + tid * half;
#pragma unroll
    for (int j = 0; j < MAX_SLOTS; ++j) {
      const int dim = j < nks ? kslot_dim(sw[j], a.hg, h % a.hg, D) : -1;
      if (dim >= 0) {
        const float v = slot_value(sw[j]);
        const float2 cs = cst[kslot_pair(dim, D)];
        if (dim < D) row[dim] += v * cs.x;
        if (dim < half) row[dim + half] += v * cs.y;
        else row[dim - half] -= v * cs.y;
      }
    }
  }
  __syncthreads();

  const int qd = tid % D, qr = tid / D, qstep = NT / D;
  for (int r0 = 0; r0 < R; r0 += PR) {
    const int nrows = min(PR, R - r0);
    const float* qb = a.q + (bh * R + r0) * D;
    for (int r = qr; r < PR; r += qstep) sQ[r * DP + qd] = r < nrows ? qb[(size_t)r * D + qd] : 0.f;
    __syncthreads();
    float* ob = a.out + (bh * R + r0) * (size_t)Tc + t0;
    // thread (ty, tx) owns rows ty*8 + i and tokens tx + 16j
    const int ty = tid / 16, tx = tid % 16;
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = sQ[(ty * 8 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      if (r < nrows) {
#pragma unroll
        for (int j = 0; j < 4; ++j) ob[(size_t)r * Tc + tx + 16 * j] = sc[i][j];
      }
    }
    __syncthreads();  // sQ is rewritten next
  }
}

// floats of pv_simt's dynamic shared memory
__host__ __device__ constexpr int pv_simt_floats(int D) {
  return TT * D              // sV   lut values of the tile's codes
         + TT * D            // sM   V slot tile
         + 2 * PR * (TT + 1) // sP, sPs  p and p*scale of the tile
         + 2 * TT            // sSc, sOf  V scale / offset of the tile
         + 16;               // sLut
}

// One block: token split blockIdx.x, kv head and row tile blockIdx.y, batch
// row blockIdx.z: 64 rows, 8 x (D/16) register tiles per thread.
template <int BITS>
__global__ void __launch_bounds__(NT) pv_simt(PvArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, PP = TT + 1;
  float* sV = smem;
  float* sM = sV + TT * D;
  float* sP = sM + TT * D;
  float* sPs = sP + PR * PP;
  float* sSc = sPs + PR * PP;
  float* sOf = sSc + TT;
  float* sLut = sOf + TT;

  const int s = blockIdx.x, h = blockIdx.y / a.n_rt, rt = blockIdx.y % a.n_rt;
  const int b = blockIdx.z, tid = threadIdx.x;
  const int Tc = a.Tc, R = a.R, TW = Tc / 32;
  const int r0 = rt * PR, nrows = min(PR, R - r0);
  const int n_tiles = Tc / TT, tps = (n_tiles + a.n_split - 1) / a.n_split;
  const int t_begin = s * tps, t_end = min(n_tiles, t_begin + tps);
  const size_t bh = (size_t)b * a.Hkv + h;
  float* pout = a.part + ((bh * a.n_split + s) * R + r0) * D;
  if (t_begin >= t_end) {
    for (int i = tid; i < nrows * D; i += NT) pout[i] = 0.f;
    return;
  }

  if (tid < (1 << BITS)) sLut[tid] = a.lut[tid];
  for (int i = tid; i < TT * D; i += NT) sM[i] = 0.f;
  // dequant mapping: thread -> column c, D/2 tokens
  const int c = tid % D;
  const int tpp = TT * D / NT;
  const int tb = (tid / D) * tpp;
  const int32_t* vp = a.vp + bh * BITS * TW * D;
  const float* psrc = a.p + (bh * R + r0) * (size_t)a.p_ld;
  const float* vsc = a.v_scale + (size_t)b * Tc;
  const float* vof = a.v_offset + (size_t)b * Tc;
  const int nvs = a.n_vslots, jh = h % a.hg;
  const float* kvo = nvs > 0
      ? a.kv_out + (((size_t)b * (a.Hkv / a.hg) + h / a.hg) * a.J + a.spk) * Tc
      : nullptr;

  float o[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
  float offacc = 0.f;  // thread r < nrows: sum_t p[r][t] * v_offset[t]
  // plane words of column c: this tile's group, and the next tile's loaded
  // under this tile's contraction
  uint32_t w[BITS][4], wn[BITS][4];
  load_group_words<BITS>(w, vp, TW, D, t_begin * TT / 128, c);
  __syncthreads();

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int t0 = tile * TT;
    const float vso = tid < TT ? vsc[t0 + tid] : (tid < 2 * TT ? vof[t0 + tid - TT] : 0.f);
    int sdim[MAX_SLOTS];
    float sval[MAX_SLOTS];
    if (nvs > 0 && tid < TT) {
      uint32_t sw[MAX_SLOTS];
      load_slots(sw, kvo + t0 + tid, nvs, Tc);
#pragma unroll
      for (int j = 0; j < MAX_SLOTS; ++j) {
        sdim[j] = j < nvs ? slot_dim(sw[j], a.hg, jh, D) : -1;
        sval[j] = slot_value(sw[j]);
      }
    }
    {
      const int bit0 = ((t0 % 128) + tb) >> 2;
#pragma unroll 4
      for (int j4 = 0; j4 < tpp / 4; ++j4)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sV[(tb + 4 * j4 + i) * D + c] = sLut[plane_code<BITS>(w, bit0 + j4, i)];
    }
    const bool more = tile + 1 < t_end;
    if (more) load_group_words<BITS>(wn, vp, TW, D, (t0 + TT) / 128, c);
    if (tid < TT) sSc[tid] = vso;
    else if (tid < 2 * TT) sOf[tid - TT] = vso;
    if (nvs > 0 && tid < TT) {
      // thread t owns token row t: its slots summed in slot order
      float* row = sM + tid * D;
#pragma unroll
      for (int j = 0; j < MAX_SLOTS; ++j)
        if (sdim[j] >= 0) row[sdim[j]] += sval[j];
    }
    __syncthreads();
    for (int i = tid; i < PR * TT; i += NT) {
      const int r = i / TT, t = i % TT;
      const float p = r < nrows ? psrc[(size_t)r * a.p_ld + t0 + t] : 0.f;
      sP[r * PP + t] = p;
      sPs[r * PP + t] = p * sSc[t];
    }
    __syncthreads();
    if (tid < nrows)
      for (int t = 0; t < TT; ++t) offacc = fmaf(sP[tid * PP + t], sOf[t], offacc);
    const int ty = tid / 16, tx = tid % 16, dj = D / 16;
    for (int t = 0; t < TT; ++t) {
      float pv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = sPs[(ty * 8 + i) * PP + t];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) vv[jj] = jj < dj ? sV[t * D + tx + 16 * jj] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) o[i][jj] = fmaf(pv[i], vv[jj], o[i][jj]);
      if (nvs > 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) pv[i] = sP[(ty * 8 + i) * PP + t];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) vv[jj] = jj < dj ? sM[t * D + tx + 16 * jj] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) o[i][jj] = fmaf(pv[i], vv[jj], o[i][jj]);
      }
    }
    __syncthreads();
    // the owners clear their slot entries for the next tile
    if (nvs > 0 && tid < TT) {
#pragma unroll
      for (int j = 0; j < MAX_SLOTS; ++j)
        if (sdim[j] >= 0) sM[tid * D + sdim[j]] = 0.f;
    }
    if (more) {
#pragma unroll
      for (int bb = 0; bb < BITS; ++bb)
#pragma unroll
        for (int i = 0; i < 4; ++i) w[bb][i] = wn[bb][i];
    }
  }

  // ---- this split's partial: the dot sums plus the offset sums ----
  if (tid < nrows) sSc[tid] = offacc;
  __syncthreads();
  const int ty = tid / 16, tx = tid % 16, dj = D / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (r < nrows) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        if (jj < dj) pout[(size_t)r * D + tx + 16 * jj] = o[i][jj] + sSc[r];
    }
  }
}

// ---------------------------------------------------------------------------
// the decode bodies (R <= 8): a TMA ring, scores and P.V in registers
// ---------------------------------------------------------------------------

constexpr int DW = 8;               // consumer warps per block
constexpr int DNT = (DW + 1) * 32;  // + one producer warp
constexpr int DT = 128;             // tokens per ring stage (one nuq packing group)
constexpr int MAX_STAGES = 4;

// byte offsets within one ring stage: the hc heads' bit planes, the slot rows
// of the block's head groups, V scale, V offset (K4 only)
struct DRing {
  int rows, vs, vo, bytes;
};

__host__ __device__ inline DRing dring(int hc, int bits, int D, int n_rows, bool pv) {
  DRing r;
  r.rows = hc * bits * 16 * D;
  r.vs = r.rows + n_rows * DT * 4;
  r.vo = r.vs + (pv ? DT * 4 : 0);
  r.bytes = r.vo + (pv ? DT * 4 : 0);
  return r;
}

// slot rows a decode block stages: n per head group, for hc / hg groups
__host__ __device__ inline int staged_rows(int n, int hc, int hg) {
  return n > 0 ? n * (hc / hg) : 0;
}

// dynamic shared memory: 128 B of mbarriers, the ring (K4: or the merge
// scratch [DW][G][D + 1] that reuses it), K3's queries [hc][G][D] and
// the heads' k_range and k_offset [hc][2][D]
__host__ __device__ inline int qk_decode_smem(const QkArgs& a, int G) {
  const DRing r = dring(a.hc, a.bits, a.D, staged_rows(a.n_kslots, a.hc, a.hg), false);
  return 128 + a.n_stage * r.bytes + 4 * a.hc * (G + 2) * a.D;
}
// qk_gqa's: the ring, the queries transposed [hc][D][8], k_range and
// k_offset [hc][2][D], a slot-term exchange tile per consumer warp
__host__ __device__ inline int qk_gqa_smem(const QkArgs& a) {
  return qk_decode_smem(a, 8) + DW * GXB;
}
__host__ __device__ inline int pv_decode_smem(const PvArgs& a, int G) {
  const DRing r = dring(a.hc, a.bits, a.D, staged_rows(a.n_vslots, a.hc, a.hg), true);
  const int ring = a.n_stage * r.bytes, merge = DW * G * (a.D + 1) * 4;
  return 128 + (ring > merge ? ring : merge);
}

// the LUT entry of byte j % 4 of the code bytes (a byte offset into lut)
__device__ __forceinline__ float lut_at(const float* lut, uint32_t cw, int j) {
  return *reinterpret_cast<const float*>(reinterpret_cast<const char*>(lut) + byte_of(cw, j));
}
// the code of staged token tt (0..127) at column c from NB staged planes
template <int NB>
__device__ __forceinline__ int staged_code(const unsigned char* planes, int D, int tt, int c) {
  int e = 0;
#pragma unroll
  for (int bb = 0; bb < NB; ++bb) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(planes + bb * 16 * D)[(tt & 3) * D + c];
    e |= (int)((w >> (tt >> 2)) & 1u) << bb;
  }
  return e;
}

// 4-byte asynchronous copy global -> shared (no register staging), and
// the arrive-on of a thread's prior cp.async copies on an mbarrier whose
// expected count includes the thread (.noinc)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// the position of unit slot sl (token 4 sl + un of a bit-plane word row un)
// in a P^T k-step order that matches the V codes' A fragments (fd_gqa's
// and pv_gqa's): column 2tq + e + 8f of k-step hh is slot tq + 4hh + 8e +
// 16f
__device__ __forceinline__ int gqa_pos(int sl) {
  return 16 * ((sl >> 2) & 1) + 8 * ((sl >> 4) & 1) + 2 * (sl & 3) + ((sl >> 3) & 1);
}

constexpr int GPW = DT + 8;  // float stride of a staged P row (pv_gqa)

// The probability rows a K4 stage holds (pv_gqa): R rows of each of the hc
// heads, rows p_ld apart from `p` (batch row b, head h0), at byte `off` of a
// stage, each 128-token row in the consumers' fragment order: token tt at
// float 32 (tt % 4) + gqa_pos(tt / 4) of its GPW-float row.
struct PStage {
  const float* p;
  int p_ld, R, off;
};

// The producer of a decode block: one thread keeps the ring full. Per stage
// (tile `it`, `stride` bytes apart): NB planes of each of the hc heads (4
// word rows each), n slot rows of each head group from row `row0`, and,
// when `vs` is given, the V scale and offset: L.bytes by TMA bulk copies.
// With `ps` (pv_gqa) the whole producer warp runs it (`lane`): it also
// stages the probability rows with 4-byte cp.async copies (a row's start
// need not be 16-byte aligned), every lane's completion counted on the
// stage's full barrier, whose count is 1 + 32.
template <int NB>
__device__ void fill_ring(unsigned char* ring, uint64_t* full, uint64_t* empty, int NS,
                          const DRing& L, int stride, const int32_t* planes,
                          const float* kv_out, const float* vs, const float* vo, int b, int Hkv,
                          int h0, int hc, int hg, int J, int row0, int n, int D, int Tc,
                          int t_begin, int t_end, const PStage* ps = nullptr, int lane = 0) {
  const size_t TW = Tc / 32;
  const int ng = n > 0 ? hc / hg : 0;
  for (int it = t_begin; it < t_end; ++it) {
    const int u = it - t_begin, st = u % NS;
    if (u >= NS) mbar_wait(&empty[st], (u / NS - 1) & 1);
    unsigned char* dst = ring + st * stride;
    if (lane == 0) {
      mbar_expect_tx(&full[st], L.bytes);
      for (int k = 0; k < hc; ++k)
        for (int bb = 0; bb < NB; ++bb)
          bulk_g2s(dst + (k * NB + bb) * 16 * D,
                   planes + ((((size_t)b * Hkv + h0 + k) * NB + bb) * TW + it * 4) * D, 16 * D,
                   &full[st]);
      for (int gi = 0; gi < ng; ++gi)
        for (int j = 0; j < n; ++j)
          bulk_g2s(dst + L.rows + (gi * n + j) * DT * 4,
                   kv_out + (((size_t)b * (Hkv / hg) + h0 / hg + gi) * J + row0 + j) * Tc +
                       (size_t)it * DT,
                   DT * 4, &full[st]);
      if (vs != nullptr) {
        bulk_g2s(dst + L.vs, vs + (size_t)b * Tc + (size_t)it * DT, DT * 4, &full[st]);
        bulk_g2s(dst + L.vo, vo + (size_t)b * Tc + (size_t)it * DT, DT * 4, &full[st]);
      }
    }
    if (ps != nullptr) {
      const float* src = ps->p + ((size_t)b * Hkv + h0) * ps->R * ps->p_ld + (size_t)it * DT;
      float* rows = reinterpret_cast<float*>(dst + ps->off);
      for (int r = 0; r < hc * ps->R; ++r) {
#pragma unroll
        for (int j = 0; j < DT / 32; ++j) {
          const int tt = lane + 32 * j;
          cp_async4(rows + r * GPW + 32 * (tt & 3) + gqa_pos(tt >> 2),
                    src + (size_t)r * ps->p_ld + tt);
        }
      }
      cp_async_arrive(&full[st]);
    }
  }
}

// K3, one decode block: batch row b (blockIdx.z), kv heads [h0, h0 + hc)
// (blockIdx.y), token split blockIdx.x. Consumer warp w takes head
// w / WPH and the chunks (w % WPH) mod WPH of each tile; lane l ends a
// chunk holding the score of row l / C, token l % C.
template <int NB, int G>
__global__ void __launch_bounds__(DNT, G >= 4 ? 1 : 2) qk_decode(QkArgs a) {
  extern __shared__ __align__(128) unsigned char dsm[];
  constexpr int C = 32 / G;             // tokens per chunk
  constexpr int NWD = (C / 4 + 3) / 4;  // code words per (column, word row)
  __shared__ float sLut[16];
  const int D = a.D, half = D / 2, hc = a.hc, NS = a.n_stage, Tc = a.Tc, R = a.R;
  const int nks = a.n_kslots, hg = a.hg;
  const DRing L = dring(hc, NB, D, staged_rows(nks, hc, hg), false);
  uint64_t* full = reinterpret_cast<uint64_t*>(dsm);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* ring = dsm + 128;
  float* sQ = reinterpret_cast<float*>(ring + NS * L.bytes);
  float* sKr = sQ + hc * G * D;  // [hc][2][D]: k_range, k_offset

  const int s = blockIdx.x, h0 = blockIdx.y * hc, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = Tc / DT, tps = (n_tiles + a.n_split - 1) / a.n_split;
  const int t_begin = s * tps, t_end = min(n_tiles, t_begin + tps);
  if (t_begin >= t_end) return;
  const bool bf = a.dot_bf16 != 0;
  const int WPH = DW / hc, nact = WPH * hc;

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], nact);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < hc * G * D; i += DNT) {
    const int k = i / (G * D), r = (i / D) % G, d = i % D;
    sQ[i] = r < R ? rnd(a.q[(((size_t)b * a.Hkv + h0 + k) * R + r) * D + d], bf) : 0.f;
  }
  for (int i = tid; i < hc * 2 * D; i += DNT) {
    const int k = i / (2 * D), d = i % D;
    sKr[i] = ((i / D) & 1 ? a.k_offset : a.k_range)[(size_t)(h0 + k) * D + d];
  }
  if (tid < (1 << NB)) sLut[tid] = a.lut[tid];
  __syncthreads();

  if (warp == DW) {
    if (lane == 0)
      fill_ring<NB>(ring, full, empty, NS, L, L.bytes, a.kp, a.kv_out, nullptr, nullptr, b,
                    a.Hkv, h0, hc, hg, a.J, 0, nks, D, Tc, t_begin, t_end);
    return;
  }
  if (warp >= nact) return;

  const int k = warp / WPH, wk = warp % WPH, h = h0 + k, jh = h % hg;
  const bool act = 2 * lane < half;  // lanes past D/2 hold zero queries
  const int c0 = act ? 2 * lane : 0;
  const int cols[4] = {c0, c0 + 1, c0 + half, c0 + half + 1};
  const float* kr = sKr + k * 2 * D;
  const float* ko = kr + D;
  float ks[4], kz[4], q[G][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ks[j] = kr[cols[j]];
    kz[j] = ko[cols[j]];
  }
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) q[r][j] = act ? sQ[(k * G + r) * D + cols[j]] : 0.f;
  const int rlane = lane / C, tlane = lane % C;  // (row, token) of the lane's score
  const float* sQr = sQ + (k * G + rlane) * D;
  const int rstr = half / 2;  // float4 of the (cos, sin) table per token
  float* orow = a.out + (((size_t)b * a.Hkv + h) * R + rlane) * Tc;

  for (int it = t_begin; it < t_end; ++it) {
    const int u = it - t_begin, st = u % NS;
    mbar_wait(&full[st], (u / NS) & 1);
    const unsigned char* stg = ring + st * L.bytes;
    const unsigned char* sKc = stg + k * NB * 16 * D;
    const float* sRows = reinterpret_cast<const float*>(stg + L.rows) + (k / hg) * nks * DT;
    const int t0 = it * DT;
    for (int ch = wk; ch < DT / C; ch += WPH) {
      const int tc = ch * C;
      const float4* rope_c =
          reinterpret_cast<const float4*>(a.rope) + ((size_t)(t0 + tc) * half + c0) / 2;
      // ---- partial dots of (row, token), then the butterfly ----
      float part[32];
#pragma unroll
      for (int w4 = 0; w4 < 4; ++w4) {
        uint32_t cw[4][NWD];
        nuq_bytes<NB>(sKc, w4, D, c0, half, tc / 4, cw);
#pragma unroll
        for (int j = 0; j < C / 4; ++j) {
          const int t = 4 * j + w4;
          float x[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) x[jj] = fmaf(lut_at(sLut, cw[jj][j / 4], j % 4), ks[jj], kz[jj]);
          const float4 cs = __ldg(rope_c + t * rstr);
          float y[4];
          rope2(x[0], x[2], cs.x, cs.y, y[0], y[2]);
          rope2(x[1], x[3], cs.z, cs.w, y[1], y[3]);
          rnd4(y, bf);
#pragma unroll
          for (int r = 0; r < G; ++r) {
            float acc = q[r][0] * y[0];
#pragma unroll
            for (int jj = 1; jj < 4; ++jj) acc = fmaf(q[r][jj], y[jj], acc);
            part[r * C + t] = acc;
          }
        }
      }
      float sc = transpose_reduce(part, lane);

      // ---- K slots of the lane's token: each key pair a slot touches is
      // recomputed as above, given the pair's addend (its slots summed in
      // slot order, rotated), rounded once, and the difference of the two
      // rounded operands enters the score ----
      const int tt = tc + tlane;
      if (nks > 0) {
        const float* wt = sRows + tt;  // the token's slot words, DT apart
        // every slot in turn, a pair fixed by its first slot, without
        // branches (a rolled loop: unrolled, it spills)
#pragma unroll 1
        for (int j = 0; j < MAX_SLOTS; ++j) {
          if (j >= nks) break;
          const int dj = kslot_dim(__float_as_uint(wt[j * DT]), hg, jh, D);
          const int i = kslot_pair(dj, D);
          bool first = dj >= 0;
#pragma unroll
          for (int j2 = 0; j2 < j; ++j2) {
            const int d2 = kslot_dim(__float_as_uint(wt[j2 * DT]), hg, jh, D);
            first = first && !(d2 >= 0 && kslot_pair(d2, D) == i);
          }
          // the pair's addend at i, at i + D/2, and past the head
          float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
          for (int j2 = j; j2 < MAX_SLOTS; ++j2) {
            if (j2 >= nks) break;
            const uint32_t w2 = __float_as_uint(wt[j2 * DT]);
            const int d2 = kslot_dim(w2, hg, jh, D);
            const bool on = d2 >= 0 && kslot_pair(d2, D) == i;
            a0 += on && d2 < half ? slot_value(w2) : 0.f;
            a1 += on && d2 >= half && d2 < D ? slot_value(w2) : 0.f;
            a2 += on && d2 >= D ? slot_value(w2) : 0.f;
          }
          const float x0 = fmaf(sLut[staged_code<NB>(sKc, D, tt, i)], kr[i], ko[i]);
          const float x1 = fmaf(sLut[staged_code<NB>(sKc, D, tt, i + half)], kr[i + half],
                                ko[i + half]);
          const float2 cs = __ldg(a.rope + (size_t)(t0 + tt) * half + i);
          float k0, k1, e0, e1;
          rope2(x0, x1, cs.x, cs.y, k0, k1);
          rope2(a0, a1, cs.x, cs.y, e0, e1);
          e1 -= a2 * cs.y;
          const float f = sQr[i] * (rnd(k0 + e0, bf) - rnd(k0, bf)) +
                          sQr[i + half] * (rnd(k1 + e1, bf) - rnd(k1, bf));
          sc += first ? f : 0.f;
        }
      }
      if (rlane < R) orow[t0 + tt] = sc;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the stage may be refilled
  }
}

// K3, one tensor-core decode block (R = 3..8 rows, bf16 dots): batch row
// b, kv heads [h0, h0 + hc), token split blockIdx.x and the ring of
// qk_decode. Consumer warp w takes head w / WPH and the word rows
// (w % WPH) mod WPH of each 128-token stage, 32 tokens a unit: scores on
// mma.sync.m16n8k16 with A = 16 tokens x 16 dims of keys dequantized,
// rotated and rounded in registers and B = the R query rows (N = 8,
// hopper.cuh's layout); the K slot fix-ups are qk_decode's, one lane per
// token for every row, added to the scores through the warp's exchange
// tile.
template <int NB>
__global__ void __launch_bounds__(DNT, 2) qk_gqa(QkArgs a) {
  extern __shared__ __align__(128) unsigned char dsm[];
  constexpr int UPS = DT / GU;  // units per stage
  __shared__ float sLut[16];
  const int D = a.D, half = D / 2, hc = a.hc, NS = a.n_stage, Tc = a.Tc, R = a.R;
  const int nks = a.n_kslots, hg = a.hg;
  const DRing L = dring(hc, NB, D, staged_rows(nks, hc, hg), false);
  uint64_t* full = reinterpret_cast<uint64_t*>(dsm);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* ring = dsm + 128;
  float* sQT = reinterpret_cast<float*>(ring + NS * L.bytes);  // [hc][D][8]
  float* sKr = sQT + hc * 8 * D;  // [hc][2][D]: k_range, k_offset
  float* sXall = sKr + hc * 2 * D;  // [DW][8][GXS]

  const int s = blockIdx.x, h0 = blockIdx.y * hc, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = Tc / DT, tps = (n_tiles + a.n_split - 1) / a.n_split;
  const int t_begin = s * tps, t_end = min(n_tiles, t_begin + tps);
  if (t_begin >= t_end) return;
  const int WPH = DW / hc, nact = hc * min(WPH, UPS);

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], nact);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const float* qb = a.q + ((size_t)b * a.Hkv + h0) * R * D;
  for (int i = tid; i < hc * D * 8; i += DNT) {  // rows past R zero
    const int k = i / (8 * D), d = (i / 8) % D, r = i % 8;
    sQT[i] = r < R ? rnd(qb[((size_t)k * R + r) * D + d], true) : 0.f;
  }
  for (int i = tid; i < hc * 2 * D; i += DNT) {
    const int k = i / (2 * D), d = i % D;
    sKr[i] = ((i / D) & 1 ? a.k_offset : a.k_range)[(size_t)(h0 + k) * D + d];
  }
  if (tid < (1 << NB)) sLut[tid] = a.lut[tid];
  __syncthreads();

  if (warp == DW) {
    if (lane == 0)
      fill_ring<NB>(ring, full, empty, NS, L, L.bytes, a.kp, a.kv_out, nullptr, nullptr, b,
                    a.Hkv, h0, hc, hg, a.J, 0, nks, D, Tc, t_begin, t_end);
    return;
  }
  const int k = warp / WPH, wk = warp % WPH, h = h0 + k, jh = h % hg;
  if (wk >= UPS) return;  // warps past a stage's units idle (hc = 1)
  const int g = lane >> 2, tq = lane & 3;
  const float* kr = sKr + k * 2 * D;
  const float* ko = kr + D;
  const float* qT = sQT + k * D * 8;
  float* sX = sXall + warp * 8 * GXS;
  uint32_t qf[GNJ][2][2];
  gqa_query_frags(qT, D, g, tq, qf);
  const bool r0ok = 2 * tq < R, r1ok = 2 * tq + 1 < R;
  float* orow = a.out + (((size_t)b * a.Hkv + h) * R + 2 * tq) * Tc;

  for (int it = t_begin; it < t_end; ++it) {
    const int u = it - t_begin, st = u % NS;
    mbar_wait(&full[st], (u / NS) & 1);
    const unsigned char* stg = ring + st * L.bytes;
    const unsigned char* sKc = stg + k * NB * 16 * D;
    const float* sRows = reinterpret_cast<const float*>(stg + L.rows) + (k / hg) * nks * DT;
    const int t0 = it * DT;
    for (int un = wk; un < UPS; un += WPH) {
      float sc[2][4];
      gqa_nuq_scores<NB, true>(sKc, D, un, kr, ko, sLut, a.rope + (size_t)t0 * half, g, tq, qf,
                               sc);
      // ---- K slots: lane l takes unit slot l (tile token 4l + un); each
      // key pair a slot touches is recomputed as the keys were, given the
      // pair's addend (its slots summed in slot order, rotated), rounded
      // once, and the difference of the two rounded operands enters every
      // row's score, exchanged to the lanes that hold the scores ----
      if (nks > 0) {
        const int tt = 4 * lane + un;
        const float* wt = sRows + tt;  // the token's slot words, DT apart
        float e[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) e[r] = 0.f;
#pragma unroll 1
        for (int j = 0; j < MAX_SLOTS; ++j) {
          if (j >= nks) break;
          const int dj = kslot_dim(__float_as_uint(wt[j * DT]), hg, jh, D);
          const int i = kslot_pair(dj, D);
          bool first = dj >= 0;
#pragma unroll
          for (int j2 = 0; j2 < j; ++j2) {
            const int d2 = kslot_dim(__float_as_uint(wt[j2 * DT]), hg, jh, D);
            first = first && !(d2 >= 0 && kslot_pair(d2, D) == i);
          }
          if (!first) continue;
          float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
          for (int j2 = j; j2 < MAX_SLOTS; ++j2) {
            if (j2 >= nks) break;
            const uint32_t w2 = __float_as_uint(wt[j2 * DT]);
            const int d2 = kslot_dim(w2, hg, jh, D);
            const bool on = d2 >= 0 && kslot_pair(d2, D) == i;
            a0 += on && d2 < half ? slot_value(w2) : 0.f;
            a1 += on && d2 >= half && d2 < D ? slot_value(w2) : 0.f;
            a2 += on && d2 >= D ? slot_value(w2) : 0.f;
          }
          const float x0 = fmaf(sLut[staged_code<NB>(sKc, D, tt, i)], kr[i], ko[i]);
          const float x1 = fmaf(sLut[staged_code<NB>(sKc, D, tt, i + half)], kr[i + half],
                                ko[i + half]);
          const float2 cs = __ldg(a.rope + (size_t)(t0 + tt) * half + i);
          float k0, k1, e0, e1;
          rope2(x0, x1, cs.x, cs.y, k0, k1);
          rope2(a0, a1, cs.x, cs.y, e0, e1);
          e1 -= a2 * cs.y;
          const float d0 = rnd(k0 + e0, true) - rnd(k0, true);
          const float d1 = rnd(k1 + e1, true) - rnd(k1, true);
          float q0[8], q1[8];
          gqa_q8(qT, i, q0);
          gqa_q8(qT, i + half, q1);
#pragma unroll
          for (int r = 0; r < 8; ++r) e[r] += q0[r] * d0 + q1[r] * d1;
        }
        gqa_exchange(sX, lane, e, g, tq, sc);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int tt = 4 * (g + 8 * q) + un;
        if (r0ok) orow[t0 + tt] = sc[q >> 1][2 * (q & 1)];
        if (r1ok) orow[Tc + t0 + tt] = sc[q >> 1][2 * (q & 1) + 1];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the stage may be refilled
  }
}

// K4, one decode block: as qk_decode; lane l of a chunk loads p of row
// l / C, token l % C. Ends with this split's partial (B, Hkv, n_split, R, D).
template <int NB, int G>
__global__ void __launch_bounds__(DNT, G >= 4 ? 1 : 2) pv_decode(PvArgs a) {
  extern __shared__ __align__(128) unsigned char dsm[];
  constexpr int C = 32 / G;
  constexpr int NWD = (C / 4 + 3) / 4;
  __shared__ float sLut[16];  // rnd(lut)
  __shared__ float sX[DW][3][32];  // per warp: rnd(p) of each lane, a slot's rnd(M), dim
  const int D = a.D, half = D / 2, hc = a.hc, NS = a.n_stage, Tc = a.Tc, R = a.R;
  const int nvs = a.n_vslots, hg = a.hg, NSP = a.n_split;
  const DRing L = dring(hc, NB, D, staged_rows(nvs, hc, hg), true);
  uint64_t* full = reinterpret_cast<uint64_t*>(dsm);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* ring = dsm + 128;

  const int s = blockIdx.x, h0 = blockIdx.y * hc, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = Tc / DT, tps = (n_tiles + NSP - 1) / NSP;
  const int t_begin = s * tps, t_end = min(n_tiles, t_begin + tps);
  const size_t bh0 = (size_t)b * a.Hkv + h0;
  if (t_begin >= t_end) {  // a split with no tile adds zero
    for (int i = tid; i < hc * R * D; i += DNT)
      a.part[((bh0 + i / (R * D)) * NSP + s) * R * D + i % (R * D)] = 0.f;
    return;
  }
  const bool bf = a.dot_bf16 != 0;
  const int WPH = DW / hc, nact = WPH * hc;
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], nact);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < (1 << NB)) sLut[tid] = rnd(a.lut[tid], bf);
  __syncthreads();

  const int k = warp / WPH, wk = warp % WPH, h = h0 + k, jh = h % hg;
  const bool act = 2 * lane < half;
  const int c0 = act ? 2 * lane : 0;
  const int cols[4] = {c0, c0 + 1, c0 + half, c0 + half + 1};
  const int rlane = lane / C, tlane = lane % C;
  float o[G][4];
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[r][j] = 0.f;
  float offacc = 0.f;  // sum over the lane's tokens of p * v_offset

  if (warp == DW) {
    if (lane == 0)
      fill_ring<NB>(ring, full, empty, NS, L, L.bytes, a.vp, a.kv_out, a.v_scale, a.v_offset,
                    b, a.Hkv, h0, hc, hg, a.J, a.spk, nvs, D, Tc, t_begin, t_end);
  } else if (warp < nact) {
    const float* prow = a.p + (((size_t)b * a.Hkv + h) * R + min(rlane, R - 1)) * (size_t)a.p_ld;
    for (int it = t_begin; it < t_end; ++it) {
      const int u = it - t_begin, st = u % NS;
      mbar_wait(&full[st], (u / NS) & 1);
      const unsigned char* stg = ring + st * L.bytes;
      const unsigned char* sVc = stg + k * NB * 16 * D;
      const float* sRows = reinterpret_cast<const float*>(stg + L.rows) + (k / hg) * nvs * DT;
      const float* sVs = reinterpret_cast<const float*>(stg + L.vs);
      const float* sVo = reinterpret_cast<const float*>(stg + L.vo);
      const int t0 = it * DT;
      for (int ch = wk; ch < DT / C; ch += WPH) {
        const int tc = ch * C, tt = tc + tlane;
        const float p = rlane < R ? prow[t0 + tt] : 0.f;
        const float ps = rnd(p * sVs[tt], bf);  // the dot operand rnd(p * v_scale)
        offacc = fmaf(p, sVo[tt], offacc);
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          uint32_t cw[4][NWD];
          nuq_bytes<NB>(sVc, w4, D, c0, half, tc / 4, cw);
#pragma unroll
          for (int j = 0; j < C / 4; ++j) {
            const int t = 4 * j + w4;
            float y[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) y[jj] = lut_at(sLut, cw[jj][j / 4], j % 4);
#pragma unroll
            for (int r = 0; r < G; ++r) {
              const float pt = __shfl_sync(FULL, ps, r * C + t);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) o[r][jj] = fmaf(pt, y[jj], o[r][jj]);
            }
          }
        }
        // ---- V slots of the chunk: lane (row, token) holds its token's
        // words; per slot, the first slot of a (token, dim) carries M, the
        // dim's slots summed in slot order. The first row's lanes post
        // (dim, rnd(M)) in shared memory; five ballots give each lane the
        // set of tokens whose dim it owns, which it adds in token order ----
        if (nvs > 0) {
          float* xp = sX[warp][0];
          float* xv = sX[warp][1];
          int* xd = reinterpret_cast<int*>(sX[warp][2]);
          xp[lane] = rnd(p, bf);
          uint32_t sw[MAX_SLOTS];
          int sd[MAX_SLOTS];
#pragma unroll
          for (int j = 0; j < MAX_SLOTS; ++j) {
            sw[j] = j < nvs ? __float_as_uint(sRows[j * DT + tt]) : 0u;
            sd[j] = j < nvs ? slot_dim(sw[j], hg, jh, D) : -1;
          }
#pragma unroll
          for (int j = 0; j < MAX_SLOTS; ++j) {
            if (j >= nvs) break;
            int d = sd[j];
#pragma unroll
            for (int j2 = 0; j2 < j; ++j2) d = sd[j2] == d ? -1 : d;
            float M = 0.f;
#pragma unroll
            for (int j2 = j; j2 < MAX_SLOTS; ++j2) {
              if (j2 >= nvs) break;
              M += (d >= 0 && sd[j2] == d) ? slot_value(sw[j2]) : 0.f;
            }
            const bool post = d >= 0 && rlane == 0;
            const int owner = (d & (half - 1)) >> 1;
            if (post) {
              xv[lane] = rnd(M, bf);
              xd[lane] = d;
            }
            unsigned mine = __ballot_sync(FULL, post);
#pragma unroll
            for (int bit = 0; bit < 5; ++bit) {
              const unsigned on = __ballot_sync(FULL, post && ((owner >> bit) & 1));
              mine &= ((lane >> bit) & 1) ? on : ~on;
            }
            __syncwarp();
            while (mine) {
              const int src = __ffs(mine) - 1;
              mine &= mine - 1;
              const int ds = xd[src];
              const float m = xv[src];
#pragma unroll
              for (int r = 0; r < G; ++r) {
                const float pt = xp[r * C + src];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                  if (cols[jj] == ds) o[r][jj] = fmaf(pt, m, o[r][jj]);
              }
            }
            __syncwarp();
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    // the offset sum of each row over its C lanes
#pragma unroll
    for (int off = C / 2; off; off >>= 1) offacc += __shfl_xor_sync(FULL, offacc, off);
  }

  __syncthreads();  // every stage consumed: the ring becomes merge scratch
  float* red = reinterpret_cast<float*>(ring);  // [DW][G][D + 1], D: the offset sum
  if (warp < nact) {
    float* rw = red + (size_t)warp * G * (D + 1);
#pragma unroll
    for (int r = 0; r < G; ++r)
      if (act) {
#pragma unroll
        for (int j = 0; j < 4; ++j) rw[r * (D + 1) + cols[j]] = o[r][j];
      }
    if (tlane == 0) rw[rlane * (D + 1) + D] = offacc;
  }
  __syncthreads();
  // the warps of each head in order: this split's partial
  for (int i = tid; i < hc * R * D; i += DNT) {
    const int kk = i / (R * D), r = (i / D) % R, d = i % D;
    float acc = 0.f;
    for (int w = 0; w < WPH; ++w) {
      const float* rw = red + ((size_t)(kk * WPH + w) * G + r) * (D + 1);
      acc += rw[d] + rw[D];
    }
    a.part[((bh0 + kk) * NSP + s) * R * D + (size_t)r * D + d] = acc;
  }
}

// ---------------------------------------------------------------------------
// pv_gqa: K4's tensor-core decode body (R = 3..8 rows, bf16 dots)
// ---------------------------------------------------------------------------
//
// Replaces, with pv_merge, kvquant_tpu/ops/pallas/attention.py:_pv_kernel
// (pv_fused) at a GQA decode step: DBRX's 6 query rows per kv head,
// MISTRAL_7B's 4. What bounds it: device-memory bytes (the heads' V bit
// planes, the probabilities, V scale / offset and the groups' V slot rows:
// ~21 MB at one DBRX layer over 32K, 6.4 us at 3.35 TB/s), then issue.
// pv_decode's 8-row SIMT instance paid per token 8 shuffles and 32 FMAs a
// lane whatever R, and read P from device memory inside its token loop.
// Here the rows are the N of mma.sync.m16n8k16 (rows past R zero), so the
// tensor cores take every row at once: O^T += V^T P^T with A = 16 dims x
// 16 tokens of rnd(lut[code]) made in registers from the staged bit planes
// (the byte layout of fd_gqa's V operand) and B = rnd(p * v_scale), 16
// tokens x 8 rows; fp32 accumulators. The producer warp also stages each
// 128-token tile's P rows in the ring, in the fragment order the B
// operands read (cp.async, 4 bytes a copy: a row need not start 16-byte
// aligned); sum p * v_offset stays fp32 per row; a token's V slots (summed
// per dim in slot order, rounded once) go through a per-warp bf16 V^T slot
// tile, a second A operand against B = rnd(p), as in fd_gqa: no
// shared-memory atomics. The products are pv_decode's with bf16 dots; only
// the order of the sums differs. Block, ring, heads and splits are
// pv_decode's (whole head groups, 128-token stages); a consumer warp takes
// the word rows (32-token units) warp % WPH (mod WPH) of its head, and the
// warps of a head meet in shared memory at the end, the splits in pv_merge.

constexpr int GVT = GU + 8;  // bf16 stride of a dim's row of a warp's V^T slot tile

// pv_gqa's stage: pv_decode's (planes, V slot rows, V scale, V offset),
// then the P rows [hc][R][GPW] fp32 from byte `p`
struct PvGqaRing {
  DRing d;
  int p, bytes;
};
__host__ __device__ inline PvGqaRing pv_gqa_ring(const PvArgs& a) {
  PvGqaRing r;
  r.d = dring(a.hc, a.bits, a.D, staged_rows(a.n_vslots, a.hc, a.hg), true);
  r.p = r.d.bytes;
  r.bytes = r.p + a.hc * a.R * GPW * 4;
  return r;
}
// dynamic shared memory: 128 B of mbarriers, the ring (or the merge
// scratch [DW][R][D + 1] that reuses it) and, with V slots, a V^T slot
// tile [D][GVT] bf16 per consumer warp
__host__ __device__ inline int pv_gqa_smem(const PvArgs& a) {
  const int ring = a.n_stage * pv_gqa_ring(a).bytes, merge = DW * a.R * (a.D + 1) * 4;
  return 128 + (ring > merge ? ring : merge) + (a.n_vslots > 0 ? DW * a.D * GVT * 2 : 0);
}

template <int NB>
__global__ void __launch_bounds__(DNT, 1) pv_gqa(PvArgs a) {
  extern __shared__ __align__(128) unsigned char dsm[];
  constexpr int UPS = DT / GU;   // units per stage
  constexpr int NM = MAXD / 16;  // m-blocks (16 dims) at most
  __shared__ float sLut[16];     // rnd(lut)
  const int D = a.D, hc = a.hc, NS = a.n_stage, Tc = a.Tc, R = a.R;
  const int nvs = a.n_vslots, hg = a.hg, NSP = a.n_split;
  const PvGqaRing L = pv_gqa_ring(a);
  uint64_t* full = reinterpret_cast<uint64_t*>(dsm);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* ring = dsm + 128;
  const int ring_bytes = NS * L.bytes, merge_bytes = DW * R * (D + 1) * 4;
  __nv_bfloat16* sVtAll =
      reinterpret_cast<__nv_bfloat16*>(ring + (ring_bytes > merge_bytes ? ring_bytes : merge_bytes));

  const int s = blockIdx.x, h0 = blockIdx.y * hc, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = Tc / DT, tps = (n_tiles + NSP - 1) / NSP;
  const int t_begin = s * tps, t_end = min(n_tiles, t_begin + tps);
  const size_t bh0 = (size_t)b * a.Hkv + h0;
  if (t_begin >= t_end) {  // a split with no tile adds zero
    for (int i = tid; i < hc * R * D; i += DNT)
      a.part[((bh0 + i / (R * D)) * NSP + s) * R * D + i % (R * D)] = 0.f;
    return;
  }
  const int WPH = DW / hc, nw = min(WPH, UPS), nact = hc * nw;
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1 + 32);  // the TMA bytes' arrival, the P copies of 32 lanes
      mbar_init(&empty[i], nact);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < (1 << NB)) sLut[tid] = rnd(a.lut[tid], true);
  if (nvs > 0)  // the V slot tiles start zero; each unit clears what it wrote
    for (int i = tid; i < DW * D * GVT / 2; i += DNT) reinterpret_cast<uint32_t*>(sVtAll)[i] = 0u;
  __syncthreads();

  const int k = warp / WPH, wk = warp % WPH, jh = (h0 + k) % hg;
  const int g = lane >> 2, tq = lane & 3;
  float acc[NM][4];
#pragma unroll
  for (int mt = 0; mt < NM; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[mt][r] = 0.f;
  float off = 0.f;  // sum over the lane's tokens of p * v_offset, row g

  if (warp == DW) {
    const PStage ps{a.p, a.p_ld, R, L.p};
    fill_ring<NB>(ring, full, empty, NS, L.d, L.bytes, a.vp, a.kv_out, a.v_scale, a.v_offset, b,
                  a.Hkv, h0, hc, hg, a.J, a.spk, nvs, D, Tc, t_begin, t_end, &ps, lane);
  } else if (wk < UPS) {
    __nv_bfloat16* sVt = sVtAll + (size_t)warp * D * GVT;
    for (int it = t_begin; it < t_end; ++it) {
      const int u = it - t_begin, st = u % NS;
      mbar_wait(&full[st], (u / NS) & 1);
      const unsigned char* stg = ring + st * L.bytes;
      const uint32_t* sVc = reinterpret_cast<const uint32_t*>(stg + k * NB * 16 * D);
      const float* sRows = reinterpret_cast<const float*>(stg + L.d.rows) + (k / hg) * nvs * DT;
      const float* sVs = reinterpret_cast<const float*>(stg + L.d.vs);
      const float* sVo = reinterpret_cast<const float*>(stg + L.d.vo);
      const float* sP = reinterpret_cast<const float*>(stg + L.p) + k * R * GPW;
      for (int un = wk; un < UPS; un += WPH) {
        // ---- B fragments of row g: k-step hh, b[f] takes positions
        // 16hh + 8f + 2tq (+1) = slots tq + 4hh + 16f (+8), tokens
        // 4 slot + un; rnd(p * v_scale) for the codes, rnd(p) for the
        // V slot tile ----
        uint32_t pb[2][2], qb[2][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const float2 p2 = g < R ? *reinterpret_cast<const float2*>(
                                          sP + g * GPW + 32 * un + 16 * hh + 8 * f + 2 * tq)
                                    : make_float2(0.f, 0.f);
            const int t0 = 4 * (tq + 4 * hh + 16 * f) + un, t1 = t0 + 32;
            pb[hh][f] = bf2(p2.x * sVs[t0], p2.y * sVs[t1]);
            qb[hh][f] = bf2(p2.x, p2.y);
            off = fmaf(p2.x, sVo[t0], off);
            off = fmaf(p2.y, sVo[t1], off);
          }
        // ---- V slots: lane l takes unit slot l (tile token 4l + un); the
        // first slot of each of its dims writes rnd(M), M the dim's slots
        // summed in slot order, into column gqa_pos(l) of the warp's V^T
        // slot tile; vmask: the m-blocks the unit's slots touch ----
        unsigned vmask = 0u;
        const float* wt = sRows + 4 * lane + un;  // the token's slot words, DT apart
        if (nvs > 0) {
#pragma unroll 1
          for (int j = 0; j < nvs; ++j) {
            const int d = slot_dim(__float_as_uint(wt[j * DT]), hg, jh, D);
            bool first = d >= 0;
            for (int j2 = 0; j2 < j; ++j2)
              first = first && slot_dim(__float_as_uint(wt[j2 * DT]), hg, jh, D) != d;
            if (!first) continue;
            float M = 0.f;
            for (int j2 = j; j2 < nvs; ++j2) {
              const uint32_t w2 = __float_as_uint(wt[j2 * DT]);
              if (slot_dim(w2, hg, jh, D) == d) M += slot_value(w2);
            }
            sVt[d * GVT + gqa_pos(lane)] = __float2bfloat16_rn(M);
            vmask |= 1u << (d >> 4);
          }
          vmask = __reduce_or_sync(FULL, vmask);
          __syncwarp();
        }
        // ---- O^T += V^T P^T: m-block mt, A row g (+ 8) is dim 16mt + g
        // (+ 8); byte e + 2f of cw[hf][hh] is 4 x the code of slot
        // tq + 4hh + 8e + 16f at that dim ----
#pragma unroll
        for (int mt = 0; mt < NM; ++mt) {
          if (mt < D / 16) {
            uint32_t cw[2][2];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              cw[hf][0] = cw[hf][1] = 0u;
#pragma unroll
              for (int bb = 0; bb < NB; ++bb) {
                const uint32_t w = sVc[(bb * 4 + un) * D + 16 * mt + g + 8 * hf];
                cw[hf][0] |= plane_bits(w, tq, 2 + bb);
                cw[hf][1] |= plane_bits(w, tq + 4, 2 + bb);
              }
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float y[2][2][2];  // [dim g + 8hf][e][f]
#pragma unroll
              for (int hf = 0; hf < 2; ++hf)
#pragma unroll
                for (int e = 0; e < 2; ++e)
#pragma unroll
                  for (int f = 0; f < 2; ++f) y[hf][e][f] = lut_at(sLut, cw[hf][hh], e + 2 * f);
              const uint32_t fa[4] = {bf2(y[0][0][0], y[0][1][0]), bf2(y[1][0][0], y[1][1][0]),
                                      bf2(y[0][0][1], y[0][1][1]), bf2(y[1][0][1], y[1][1][1])};
              mma16816(acc[mt], fa, pb[hh][0], pb[hh][1]);
            }
            if ((vmask >> mt) & 1u) {  // the V slot tile's dims of this block
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                uint32_t fv[4];
                ldsm4(fv, smem_u32(sVt + (16 * mt + (lane & 15)) * GVT + 16 * hh + 8 * (lane >> 4)));
                mma16816(acc[mt], fv, qb[hh][0], qb[hh][1]);
              }
            }
          }
        }
        if (nvs > 0) {  // clear the slot tile's cells this lane wrote
          __syncwarp();
#pragma unroll 1
          for (int j = 0; j < nvs; ++j) {
            const int d = slot_dim(__float_as_uint(wt[j * DT]), hg, jh, D);
            if (d >= 0) sVt[d * GVT + gqa_pos(lane)] = __float2bfloat16_rn(0.f);
          }
          __syncwarp();
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // the stage may be refilled
    }
    // row g's offset sum over the four lanes of g
    off += __shfl_xor_sync(FULL, off, 1);
    off += __shfl_xor_sync(FULL, off, 2);
  }

  __syncthreads();  // every stage consumed: the ring becomes merge scratch
  float* red = reinterpret_cast<float*>(ring);  // [DW][R][D + 1], D: the offset sum
  if (warp < DW && wk < nw) {
    float* rw = red + (size_t)warp * R * (D + 1);
#pragma unroll
    for (int mt = 0; mt < NM; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 2 * tq + (r & 1);
        if (mt < D / 16 && row < R) rw[row * (D + 1) + 16 * mt + g + 8 * (r >> 1)] = acc[mt][r];
      }
    if (tq == 0 && g < R) rw[g * (D + 1) + D] = off;
  }
  __syncthreads();
  // the warps of each head in order: this split's partial
  for (int i = tid; i < hc * R * D; i += DNT) {
    const int kk = i / (R * D), r = (i / D) % R, d = i % D;
    float sum = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float* rw = red + ((size_t)(kk * WPH + w) * R + r) * (D + 1);
      sum += rw[d] + rw[D];
    }
    a.part[((bh0 + kk) * NSP + s) * R * D + (size_t)r * D + d] = sum;
  }
}

// ---------------------------------------------------------------------------
// the mma bodies (R > 8, bf16 dots): mma.sync.m16n8k16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int QS = MAXD + 8;      // bf16 row stride of K / V tiles and the queries
constexpr int QK_ROWS = 272;      // most query rows per K3 block (17 row tiles)
constexpr int PV_ROWS = 144;      // most rows per K4 block (9 row tiles a warp)
constexpr int PT = 64;            // tokens per K4 tile
constexpr int PS = PT + 8;        // bf16 row stride of K4's probability tiles
constexpr int CNT = 256;          // threads of an mma block (8 warps)

// dynamic shared memory of qk_mma: the block's bf16 queries [rows][QS], the
// bf16 key tile [128][QS], the slot pairs' token bitmask [64][4], the
// tile's slot words [MAX_SLOTS][128], the LUT
__host__ __device__ inline int qk_mma_smem(const QkArgs& a) {
  return a.rows_blk * QS * 2 + DT * QS * 2 + (MAXD / 2) * 4 * 4 + MAX_SLOTS * DT * 4 + 64;
}

// K3 at R > 8 with bf16 dots. One block: kv head h and query rows [r0, r0 +
// rows_blk) (blockIdx.y = h * n_rt + rt), batch row blockIdx.z, token split
// blockIdx.x; 8 warps. Per 128-token tile: thread t < 128 marks the key
// pairs its token's slots touch; thread (pair i, token range) dequantizes,
// rotates, adds a marked pair's addend and rounds to bf16 once; warp w
// loads the B fragments of tokens 32 (w % 4) .. + 31 and multiplies every
// other 16-row tile of queries (from w / 4) against them.
template <int NB>
__global__ void __launch_bounds__(CNT, 2) qk_mma(QkArgs a) {
  extern __shared__ __align__(128) unsigned char dsm[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(dsm);
  __nv_bfloat16* sK = sQ + a.rows_blk * QS;
  uint32_t* sMask = reinterpret_cast<uint32_t*>(sK + DT * QS);
  float* sW = reinterpret_cast<float*>(sMask + (MAXD / 2) * 4);
  float* sLut = sW + MAX_SLOTS * DT;

  const int D = a.D, half = D / 2, Tc = a.Tc, R = a.R, nks = a.n_kslots, hg = a.hg;
  const int s = blockIdx.x, h = blockIdx.y / a.n_rt, rt = blockIdx.y % a.n_rt, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = rt * a.rows_blk, nrows = min(a.rows_blk, R - r0);
  const int n_tiles = Tc / DT, tps = (n_tiles + a.n_split - 1) / a.n_split;
  const int t_begin = s * tps, t_end = min(n_tiles, t_begin + tps);
  if (t_begin >= t_end) return;
  const size_t bh = (size_t)b * a.Hkv + h, TW = Tc / 32;

  // the queries (rows past R and columns past D zero), the key tile's zero
  // columns past D, the mask, the LUT
  // (eight float4 loads in flight per thread)
  for (int i0 = tid; i0 < a.rows_blk * (MAXD / 4); i0 += 8 * CNT) {
    float4 x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * CNT, r = i / (MAXD / 4), c = 4 * (i % (MAXD / 4));
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nrows && c < D)
        x[u] = *reinterpret_cast<const float4*>(a.q + (bh * R + r0 + r) * D + c);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * CNT, r = i / (MAXD / 4), c = 4 * (i % (MAXD / 4));
      if (r < a.rows_blk)
        *reinterpret_cast<uint2*>(sQ + r * QS + c) =
            make_uint2(bf2(x[u].x, x[u].y), bf2(x[u].z, x[u].w));
    }
  }
  for (int i = tid; i < DT * (MAXD / 2); i += CNT)
    *reinterpret_cast<uint32_t*>(sK + (i / (MAXD / 2)) * QS + 2 * (i % (MAXD / 2))) = 0u;
  for (int i = tid; i < (MAXD / 2) * 4; i += CNT) sMask[i] = 0u;
  if (tid < 16) sLut[tid] = tid < (1 << NB) ? a.lut[tid] : 0.f;

  // dequant mapping: thread -> pair (i, i + D/2), tokens [tb, tb + 4 * nbt)
  const int pi = tid % half, tpp = CNT / half, nbt = 32 / tpp, tb = 4 * (tid / half) * nbt;
  const float kr0 = a.k_range[h * D + pi], ko0 = a.k_offset[h * D + pi];
  const float kr1 = a.k_range[h * D + pi + half], ko1 = a.k_offset[h * D + pi + half];
  const int32_t* planes = a.kp + bh * NB * TW * D;
  const float* words = nks > 0 ? a.kv_out + ((size_t)b * (a.Hkv / hg) + h / hg) * a.J * Tc
                               : nullptr;
  const int jh = h % hg;

  const int g = lane >> 2, tq4 = lane & 3;
  const uint32_t qoff =
      smem_u32(sQ) + (((lane & 7) + 8 * ((lane >> 3) & 1)) * QS + 8 * (lane >> 4)) * 2;
  const uint32_t koff = smem_u32(sK) +
      (((lane & 7) + 8 * (lane >> 4) + 32 * (warp & 3)) * QS + 8 * ((lane >> 3) & 1)) * 2;
  const int nmt = a.rows_blk / 16;
  __syncthreads();

  for (int it = t_begin; it < t_end; ++it) {
    const int t0 = it * DT;
    // ---- the tile's slot words; thread t marks the pairs token t touches ----
    if (nks > 0 && tid < DT) {
      for (int j = 0; j < nks; ++j) {
        const float wv = words[(size_t)j * Tc + t0 + tid];
        sW[j * DT + tid] = wv;
        const int d = kslot_dim(__float_as_uint(wv), hg, jh, D);
        if (d >= 0) atomicOr(&sMask[kslot_pair(d, D) * 4 + (tid >> 5)], 1u << (tid & 31));
      }
    }
    uint32_t w0[NB][4], w1[NB][4];
#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
#pragma unroll
      for (int wr = 0; wr < 4; ++wr) {
        const int32_t* pw = planes + ((size_t)bb * TW + it * 4 + wr) * D;
        w0[bb][wr] = (uint32_t)pw[pi];
        w1[bb][wr] = (uint32_t)pw[pi + half];
      }
    __syncthreads();

    // ---- keys: dequantize, rotate, add a marked pair's slots, round ----
#pragma unroll 4
    for (int jb = 0; jb < nbt; ++jb) {
      const int bit = tb / 4 + jb;
#pragma unroll
      for (int wr = 0; wr < 4; ++wr) {
        const int tt = 4 * bit + wr;
        int e0 = 0, e1 = 0;
#pragma unroll
        for (int bb = 0; bb < NB; ++bb) {
          e0 |= (int)((w0[bb][wr] >> bit) & 1u) << bb;
          e1 |= (int)((w1[bb][wr] >> bit) & 1u) << bb;
        }
        const float2 cs = __ldg(a.rope + (size_t)(t0 + tt) * half + pi);
        float k0, k1;
        rope2(fmaf(sLut[e0], kr0, ko0), fmaf(sLut[e1], kr1, ko1), cs.x, cs.y, k0, k1);
        if (nks > 0 && ((sMask[pi * 4 + (tt >> 5)] >> (tt & 31)) & 1u)) {
          float a0 = 0.f, a1 = 0.f, a2 = 0.f;
          for (int j = 0; j < nks; ++j) {
            const uint32_t u = __float_as_uint(sW[j * DT + tt]);
            const int d = kslot_dim(u, hg, jh, D);
            if (d == pi) a0 += slot_value(u);
            else if (d == pi + half) a1 += slot_value(u);
            else if (d == pi + D) a2 += slot_value(u);
          }
          float e0r, e1r;
          rope2(a0, a1, cs.x, cs.y, e0r, e1r);
          k0 += e0r;
          k1 += e1r - a2 * cs.y;
        }
        sK[tt * QS + pi] = __float2bfloat16_rn(k0);
        sK[tt * QS + pi + half] = __float2bfloat16_rn(k1);
      }
    }
    __syncthreads();

    // ---- S = Q.K^T: the warp's 32 tokens against every row tile ----
    uint32_t bk[MAXD / 16][4][2];
#pragma unroll
    for (int kk = 0; kk < MAXD / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        ldsm4(r, koff + (16 * jp * QS + 16 * kk) * 2);
        bk[kk][2 * jp][0] = r[0];
        bk[kk][2 * jp][1] = r[1];
        bk[kk][2 * jp + 1][0] = r[2];
        bk[kk][2 * jp + 1][1] = r[3];
      }
    float* ob = a.out + (bh * R + r0) * (size_t)Tc + t0 + 32 * (warp & 3) + 2 * tq4;
    for (int mt = warp >> 2; mt < nmt; mt += 2) {
      float c[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MAXD / 16; ++kk) {
        uint32_t qa[4];
        ldsm4(qa, qoff + (16 * mt * QS + 16 * kk) * 2);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma16816(c[n], qa, bk[kk][n][0], bk[kk][n][1]);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * mt + 8 * hf + g;
        if (r < nrows) {
#pragma unroll
          for (int n = 0; n < 4; ++n)
            *reinterpret_cast<float2*>(ob + (size_t)r * Tc + 8 * n) =
                make_float2(c[n][2 * hf], c[n][2 * hf + 1]);
        }
      }
    }
    // the marks go before the next tile sets its own
    if (nks > 0 && tid < DT)
      for (int j = 0; j < nks; ++j) {
        const int d = kslot_dim(__float_as_uint(sW[j * DT + tid]), hg, jh, D);
        if (d >= 0) sMask[kslot_pair(d, D) * 4 + (tid >> 5)] = 0u;
      }
    __syncthreads();
  }
}

// dynamic shared memory of pv_mma: the bf16 A tiles rnd(p*v_scale) and
// (with V slots) rnd(p) [rows][PS]; the bf16 value tile and (with V slots)
// the slot tile [64][QS]; V scale and offset of the tile; the rows' offset
// sums; the tile's slot words [MAX_SLOTS][64]; the slot tile's k-step mask;
// the LUT
__host__ __device__ inline int pv_mma_smem(const PvArgs& a) {
  const int nb = a.n_vslots > 0 ? 2 : 1;
  return nb * (a.rows_blk * PS * 2 + PT * QS * 2) + 2 * PT * 4 + a.rows_blk * 4 +
         MAX_SLOTS * PT * 4 + 32 + 64;
}

// K4 at R > 8 with bf16 dots. One block: kv head h, rows [r0, r0 + rows_blk)
// (blockIdx.y = h * n_rt + rt), batch row blockIdx.z, token split
// blockIdx.x; 8 warps, warp w accumulating output columns 16w..16w+15 of
// every row tile (up to 9) in registers. Per 64-token tile: the value tile
// and the slot tile (thread t < 64 owns token row t), then the A tiles and
// the offset sums (warp w owns rows w mod 8, lane l tokens l and l + 32),
// then the products.
template <int NB>
__global__ void __launch_bounds__(CNT, 2) pv_mma(PvArgs a) {
  constexpr int MTX = PV_ROWS / 16;
  extern __shared__ __align__(128) unsigned char dsm[];
  const int D = a.D, Tc = a.Tc, R = a.R, nvs = a.n_vslots, hg = a.hg, RB = a.rows_blk;
  const bool slots = nvs > 0;
  __nv_bfloat16* sPs = reinterpret_cast<__nv_bfloat16*>(dsm);
  __nv_bfloat16* sPr = sPs + RB * PS;
  __nv_bfloat16* sV = sPr + (slots ? RB * PS : 0);
  __nv_bfloat16* sM = sV + PT * QS;
  float* sVs = reinterpret_cast<float*>(sM + (slots ? PT * QS : 0));
  float* sVo = sVs + PT;
  float* sOff = sVo + PT;
  float* sW = sOff + RB;
  uint32_t* sKm = reinterpret_cast<uint32_t*>(sW + MAX_SLOTS * PT);
  float* sLut = reinterpret_cast<float*>(sKm + CNT / 32);

  const int s = blockIdx.x, h = blockIdx.y / a.n_rt, rt = blockIdx.y % a.n_rt, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = rt * RB, nrows = min(RB, R - r0);
  const int n_tiles = Tc / PT, tps = (n_tiles + a.n_split - 1) / a.n_split;
  const int t_begin = s * tps, t_end = min(n_tiles, t_begin + tps);
  const size_t bh = (size_t)b * a.Hkv + h, TW = Tc / 32;
  float* pout = a.part + ((bh * a.n_split + s) * R + r0) * D;
  if (t_begin >= t_end) {
    for (int i = tid; i < nrows * D; i += CNT) pout[i] = 0.f;
    return;
  }

  for (int i = tid; i < PT * QS / 2; i += CNT) {
    reinterpret_cast<uint32_t*>(sV)[i] = 0u;
    if (slots) reinterpret_cast<uint32_t*>(sM)[i] = 0u;
  }
  for (int i = tid; i < RB; i += CNT) sOff[i] = 0.f;
  if (tid < 16) sLut[tid] = tid < (1 << NB) ? rnd(a.lut[tid], true) : 0.f;
  if (tid < CNT / 32) sKm[tid] = 0u;

  // dequant mapping: thread -> column c, tokens [tb, tb + 4 * nbt) of a tile
  const int c = tid % D, tpc = CNT / D, nbt = 16 / tpc, tb = 4 * (tid / D) * nbt;
  const int32_t* vp = a.vp + bh * NB * TW * D;
  const float* words = slots
      ? a.kv_out + (((size_t)b * (a.Hkv / hg) + h / hg) * a.J + a.spk) * Tc
      : nullptr;
  const int jh = h % hg;
  const float* prow = a.p + (bh * R + r0) * (size_t)a.p_ld;

  const int g = lane >> 2, tq4 = lane & 3, nmt = RB / 16;
  const bool wact = 16 * warp < D;
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 8 * (lane >> 4);
  const uint32_t psoff = smem_u32(sPs) + (arow * PS + acol) * 2;
  const uint32_t proff = smem_u32(sPr) + (arow * PS + acol) * 2;
  const uint32_t voff = (arow * QS + acol + 16 * warp) * 2;
  float acc[MTX][2][4];
#pragma unroll
  for (int mt = 0; mt < MTX; ++mt)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  __syncthreads();

  for (int it = t_begin; it < t_end; ++it) {
    const int t0 = it * PT;
    // ---- the V range, the slot words, the value tile ----
    if (tid < PT) sVs[tid] = a.v_scale[(size_t)b * Tc + t0 + tid];
    else if (tid < 2 * PT) sVo[tid - PT] = a.v_offset[(size_t)b * Tc + t0 + tid - PT];
    if (slots && tid < PT)
      for (int j = 0; j < nvs; ++j) sW[j * PT + tid] = words[(size_t)j * Tc + t0 + tid];
    {
      uint32_t w[NB][4];
#pragma unroll
      for (int bb = 0; bb < NB; ++bb)
#pragma unroll
        for (int wr = 0; wr < 4; ++wr)
          w[bb][wr] = (uint32_t)vp[((size_t)bb * TW + (t0 / 128) * 4 + wr) * D + c];
      const int bit0 = (t0 % 128) / 4 + tb / 4;
      for (int jb = 0; jb < nbt; ++jb)
#pragma unroll
        for (int wr = 0; wr < 4; ++wr) {
          int e = 0;
#pragma unroll
          for (int bb = 0; bb < NB; ++bb) e |= (int)((w[bb][wr] >> (bit0 + jb)) & 1u) << bb;
          sV[(tb + 4 * jb + wr) * QS + c] = __float2bfloat16_rn(sLut[e]);
        }
    }
    __syncthreads();

    // ---- A tiles and offset sums (warp w: rows w mod 8, PU rows' loads
    // in flight at once) ----
    constexpr int PU = 9;
    const float vs0 = sVs[lane], vs1 = sVs[32 + lane], vo0 = sVo[lane], vo1 = sVo[32 + lane];
    for (int rb = warp; rb < RB; rb += PU * (CNT / 32)) {
      float p0[PU], p1[PU];
#pragma unroll
      for (int u = 0; u < PU; ++u) {
        const int r = rb + u * (CNT / 32);
        p0[u] = p1[u] = 0.f;
        if (r < nrows) {
          p0[u] = prow[(size_t)r * a.p_ld + t0 + lane];
          p1[u] = prow[(size_t)r * a.p_ld + t0 + 32 + lane];
        }
      }
#pragma unroll
      for (int u = 0; u < PU; ++u) {
        const int r = rb + u * (CNT / 32);
        if (r < RB) {
          sPs[r * PS + lane] = __float2bfloat16_rn(p0[u] * vs0);
          sPs[r * PS + 32 + lane] = __float2bfloat16_rn(p1[u] * vs1);
          if (slots) {
            sPr[r * PS + lane] = __float2bfloat16_rn(p0[u]);
            sPr[r * PS + 32 + lane] = __float2bfloat16_rn(p1[u]);
          }
          float off = fmaf(p0[u], vo0, p1[u] * vo1);
#pragma unroll
          for (int o = 16; o; o >>= 1) off += __shfl_xor_sync(FULL, off, o);
          if (lane == 0) sOff[r] += off;
        }
      }
    }
    // ---- the slot tile: thread (slot j, token t) writes the entry of the
    // first slot of each (token, dim), M summed in slot order; each warp
    // marks the 16-token k-steps of its 32 tokens that hold one ----
    if (slots) {
      const int t = tid % PT;
      bool any = false;
      for (int j = tid / PT; j < nvs; j += CNT / PT) {
        int d = slot_dim(__float_as_uint(sW[j * PT + t]), hg, jh, D);
        for (int j2 = 0; j2 < j && d >= 0; ++j2)
          if (slot_dim(__float_as_uint(sW[j2 * PT + t]), hg, jh, D) == d) d = -1;
        if (d < 0) continue;
        float M = 0.f;
        for (int j2 = j; j2 < nvs; ++j2) {
          const uint32_t u = __float_as_uint(sW[j2 * PT + t]);
          if (slot_dim(u, hg, jh, D) == d) M += slot_value(u);
        }
        sM[t * QS + d] = __float2bfloat16_rn(M);
        any = true;
      }
      const unsigned bal = __ballot_sync(FULL, any);
      const int kb = 2 * ((t >> 5) & 1);  // the k-steps of the warp's tokens
      if (lane == 0) sKm[warp] = (((bal & 0xFFFFu) ? 1u : 0u) | ((bal >> 16) ? 2u : 0u)) << kb;
    }
    __syncthreads();

    // ---- O += rnd(p*scale).V, then rnd(p).M over the k-steps with a slot ----
    if (wact) {
      uint32_t bv[PT / 16][4];
#pragma unroll
      for (int kk = 0; kk < PT / 16; ++kk) ldsm4_t(bv[kk], smem_u32(sV) + voff + 16 * kk * QS * 2);
      uint32_t km = 0u;
      if (slots)
        for (int w = 0; w < CNT / 32; ++w) km |= sKm[w];
#pragma unroll
      for (int mt = 0; mt < MTX; ++mt) {
        if (mt < nmt) {
#pragma unroll
          for (int kk = 0; kk < PT / 16; ++kk) {
            uint32_t pa[4];
            ldsm4(pa, psoff + (16 * mt * PS + 16 * kk) * 2);
            mma16816(acc[mt][0], pa, bv[kk][0], bv[kk][1]);
            mma16816(acc[mt][1], pa, bv[kk][2], bv[kk][3]);
          }
          for (uint32_t mk = km; mk; mk &= mk - 1) {
            const int kk = __ffs(mk) - 1;
            uint32_t pa[4];
            ldsm4(pa, proff + (16 * mt * PS + 16 * kk) * 2);
            uint32_t r[4];
            ldsm4_t(r, smem_u32(sM) + voff + 16 * kk * QS * 2);
            mma16816(acc[mt][0], pa, r[0], r[1]);
            mma16816(acc[mt][1], pa, r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();
    // the owners clear their slot entries for the next tile
    if (slots)
      for (int j = tid / PT; j < nvs; j += CNT / PT) {
        const int d = slot_dim(__float_as_uint(sW[j * PT + tid % PT]), hg, jh, D);
        if (d >= 0) sM[(tid % PT) * QS + d] = __float2bfloat16_rn(0.f);
      }
  }

  // ---- this split's partial: the products plus the offset sums ----
  if (wact) {
#pragma unroll
    for (int mt = 0; mt < MTX; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * mt + 8 * hf + g;
        if (mt < nmt && r < nrows) {
          const float off = sOff[r];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int col = 16 * warp + 8 * n + 2 * tq4;
            if (col < D)
              *reinterpret_cast<float2*>(pout + (size_t)r * D + col) =
                  make_float2(acc[mt][n][2 * hf] + off, acc[mt][n][2 * hf + 1] + off);
          }
        }
      }
  }
}

// One block per (query row, kv head, batch row): the splits' partials added
// in split order.
__global__ void __launch_bounds__(NT) pv_merge(PvArgs a) {
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  if (d >= a.D) return;
  const size_t bh = (size_t)b * a.Hkv + h;
  const float* part = a.part + (bh * a.n_split * a.R + r) * a.D + d;
  float acc = 0.f;
  for (int s = 0; s < a.n_split; ++s) acc += part[(size_t)s * a.R * a.D];
  a.out[(bh * a.R + r) * a.D + d] = acc;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr int SMEM_MAX = 227 * 1024;  // dynamic shared memory a block may use

// raises the kernel's dynamic shared memory limit once to what it is asked for
template <typename Kern>
cudaError_t allow_smem(Kern k, int bytes, int& configured) {
  if (bytes <= configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) configured = bytes;
  return e;
}

template <typename Kern, typename Args>
cudaError_t launch(Kern k, dim3 grid, int threads, int smem, const Args& a, cudaStream_t st,
                   int& configured) {
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(k, smem, configured);
  if (e != cudaSuccess) return e;
  k<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// rows of the decode instance for R <= 8 rows
inline int decode_rows(int R) { return R <= 1 ? 1 : R <= 2 ? 2 : R <= 4 ? 4 : 8; }

template <int NB, int G>
cudaError_t qk_decode_go(const QkArgs& a, cudaStream_t st) {
  static int configured = 0;
  return launch(qk_decode<NB, G>, dim3(a.n_split, a.Hkv / a.hc, a.B), DNT,
                a.smem, a, st, configured);
}
template <int NB, int G>
cudaError_t pv_decode_go(const PvArgs& a, cudaStream_t st) {
  static int configured = 0;
  return launch(pv_decode<NB, G>, dim3(a.n_split, a.Hkv / a.hc, a.B), DNT,
                a.smem, a, st, configured);
}

template <int NB>
cudaError_t qk_bits(const QkArgs& a, cudaStream_t st) {
  if (a.body == BODY_GQA) {
    static int configured = 0;
    return launch(qk_gqa<NB>, dim3(a.n_split, a.Hkv / a.hc, a.B), DNT, a.smem, a, st,
                  configured);
  }
  if (a.body == BODY_DECODE) {
    switch (decode_rows(a.R)) {
      case 1: return qk_decode_go<NB, 1>(a, st);
      case 2: return qk_decode_go<NB, 2>(a, st);
      case 4: return qk_decode_go<NB, 4>(a, st);
      default: return qk_decode_go<NB, 8>(a, st);
    }
  }
  if (a.body == BODY_MMA) {
    static int configured = 0;
    return launch(qk_mma<NB>, dim3(a.n_split, a.Hkv * a.n_rt, a.B), CNT, a.smem, a, st,
                  configured);
  }
  static int configured = 0;
  return launch(qk_simt<NB>, dim3(a.Tc / TT, a.Hkv, a.B), NT, a.smem, a, st, configured);
}

template <int NB>
cudaError_t pv_bits(const PvArgs& a, cudaStream_t st) {
  if (a.body == BODY_GQA) {
    static int configured = 0;
    return launch(pv_gqa<NB>, dim3(a.n_split, a.Hkv / a.hc, a.B), DNT, a.smem, a, st,
                  configured);
  }
  if (a.body == BODY_DECODE) {
    switch (decode_rows(a.R)) {
      case 1: return pv_decode_go<NB, 1>(a, st);
      case 2: return pv_decode_go<NB, 2>(a, st);
      case 4: return pv_decode_go<NB, 4>(a, st);
      default: return pv_decode_go<NB, 8>(a, st);
    }
  }
  if (a.body == BODY_MMA) {
    static int configured = 0;
    return launch(pv_mma<NB>, dim3(a.n_split, a.Hkv * a.n_rt, a.B), CNT, a.smem, a, st,
                  configured);
  }
  static int configured = 0;
  return launch(pv_simt<NB>, dim3(a.n_split, a.Hkv * a.n_rt, a.B), NT, a.smem, a, st,
                configured);
}

template <typename Args, cudaError_t (*F2)(const Args&, cudaStream_t),
          cudaError_t (*F3)(const Args&, cudaStream_t), cudaError_t (*F4)(const Args&, cudaStream_t)>
cudaError_t by_bits(const Args& a, cudaStream_t st) {
  switch (a.bits) {
    case 2: return F2(a, st);
    case 3: return F3(a, st);
    case 4: return F4(a, st);
  }
  return cudaErrorInvalidValue;
}

// The plan fields a body needs, as ops/kernels/attention.py's qk_plan /
// pv_plan set them: false when the call is not one the body takes.
template <typename Args>
bool plan_ok(const Args& a, int n_slots, int max_rows) {
  if (a.D > MAXD || a.D < 32 || (a.D & (a.D - 1)) || a.Tc % DT || a.Tc <= 0 || a.bits < 2 ||
      a.bits > 4 || a.R < 1 || n_slots > MAX_SLOTS || a.Hkv % a.hg ||
      (n_slots > 0 && a.hg > 4) || a.n_split < 1)
    return false;
  if (a.body == BODY_DECODE || a.body == BODY_GQA)
    return a.R <= 8 && a.hc >= 1 && a.hc <= DW && a.Hkv % a.hc == 0 &&
           (n_slots == 0 || a.hc % a.hg == 0) && a.n_stage >= 2 && a.n_stage <= MAX_STAGES &&
           (a.body == BODY_DECODE || (a.R >= 3 && a.dot_bf16));
  if (a.R <= 8) return false;
  if (a.body == BODY_MMA)
    return a.dot_bf16 && a.rows_blk % 16 == 0 && a.rows_blk >= 16 && a.rows_blk <= max_rows &&
           a.n_rt * a.rows_blk >= a.R && (a.n_rt - 1) * a.rows_blk < a.R;
  return a.body == BODY_SIMT && !a.dot_bf16 && a.rows_blk == PR &&
         a.n_rt == (a.R + PR - 1) / PR;
}

// The dynamic shared memory of the body a valid plan names. The host plan
// passes its own count in a.smem, and the launch is refused where the two
// differ, so that the plan and the bodies' layouts cannot drift apart.
inline int qk_smem(const QkArgs& a) {
  if (a.body == BODY_DECODE) return qk_decode_smem(a, decode_rows(a.R));
  if (a.body == BODY_GQA) return qk_gqa_smem(a);
  return a.body == BODY_MMA ? qk_mma_smem(a) : qk_simt_floats(a.D) * 4;
}
inline int pv_smem(const PvArgs& a) {
  if (a.body == BODY_DECODE) return pv_decode_smem(a, decode_rows(a.R));
  if (a.body == BODY_GQA) return pv_gqa_smem(a);
  return a.body == BODY_MMA ? pv_mma_smem(a) : pv_simt_floats(a.D) * 4;
}

}  // namespace

// Launches K3 on `stream`; returns the cudaError_t of the launch (0 on
// success). Nothing is synchronised.
extern "C" int qk_fused(const QkArgs* a, void* stream) {
  if (!plan_ok(*a, a->n_kslots, QK_ROWS) || a->smem != qk_smem(*a) ||
      (a->body == BODY_SIMT && a->n_split != a->Tc / TT))
    return (int)cudaErrorInvalidValue;
  return (int)by_bits<QkArgs, qk_bits<2>, qk_bits<3>, qk_bits<4>>(
      *a, static_cast<cudaStream_t>(stream));
}

// Launches K4's split kernel and its merge kernel on `stream`; returns the
// cudaError_t of the launches (0 on success). Nothing is synchronised.
extern "C" int pv_fused(const PvArgs* a, void* stream) {
  if (!plan_ok(*a, a->n_vslots, PV_ROWS) || a->smem != pv_smem(*a))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = by_bits<PvArgs, pv_bits<2>, pv_bits<3>, pv_bits<4>>(*a, st);
  if (e != cudaSuccess) return (int)e;
  pv_merge<<<dim3(a->R, a->Hkv, a->B), NT, 0, st>>>(*a);
  return (int)cudaGetLastError();
}
