// The two-pass attention of kernel="pallas" over the quantized KV cache, for
// NVIDIA Hopper (sm_90a): scores over every packed token (qk_fused, K3),
// then the probability-weighted values (pv_fused, K4). The caller scales,
// masks and softmaxes between the two and adds the sink tokens.
//
// qk_kernel replaces kvquant_tpu/ops/pallas/attention.py:_qk_kernel (the TPU
// kernel behind qk_fused): for batch row b, kv head h and query rows r,
//   out[b,h,r,t] = q[b,h,r] . (RoPE(lut[code]*k_range + k_offset)
//                              + RoPE(K slot addend))  at position S + t,
// for every t < Tc, from nuq bit planes (2-4 bits, any codebook) with keys
// stored pre-RoPE and slot outliers in kv_out rows [0, n_kslots).
// pv_kernel + pv_merge replace attention.py:_pv_kernel (behind pv_fused):
//   out[b,h,r] = sum_t (p*v_scale[t])*lut[code] + sum_t p*v_offset[t]
//                + p * (V slot addend),  V slots in kv_out rows [spk, ...).
// Both read the whole capacity Tc, as the TPU kernels do: dead positions
// carry p = 0 from the caller's mask.
//
// What bounds them. At a decode step (R = G rows) device-memory bytes: per
// token and kv head bits*D/8 code bytes, the head group's slot words and, in
// K3, the scores written (LLaMA-2-7B, nuq3, hg 4, cap 2: K3 ~1792 B, K4
// ~1800 B per token and layer). Decoding a code costs ~bits + 3 integer
// operations and K3's rotation one sincosf per (token, pair), so the decode
// work must be shared to stay near the byte time. For a 256-token prefill
// chunk (R = 261 at G = 1) the contractions dominate: 2*R*Tc*D flops per
// head in each kernel, far above the code bytes but close to the bytes of
// the (R, Tc) scores and probabilities; this version runs them on fp32 FMA
// (tensor cores are later work).
//
// What the design does about it:
//  - a nuq code is `bits` shift-and-masks over the 4*bits words that hold a
//    128-token group of one d column (neighbouring threads take
//    neighbouring d, so the word loads coalesce), then one indexed load of
//    the 2**bits-entry LUT in shared memory: the TPU kernels' mux tree
//    exists only because the TPU's vector unit has no indexed load;
//  - K3: a block owns one 64-token tile of one batch row and up to 8 kv
//    heads (decode) or one head (prefill). It writes the tile's (cos, sin)
//    once into shared memory with accurate sincosf of the plain version's
//    fp32 angle ((S + t) / scaling) * inv_freq[i] (angles reach ~1.3e5 rad
//    at 128K, where __sinf and fast-math are wrong) and every head of the
//    block reuses it. Per head, the rotated keys go to shared memory, each
//    token's K slots are added into its row by one owner thread (in slot
//    order, no atomics), rotated by linearity (v at dim d adds v*cos at d
//    and +-v*sin at d +- D/2: the TPU kernel's one-hot E-tiles work around
//    its lack of scatters), and the query rows are multiplied against the
//    tile with FMA, scores written coalesced along t;
//  - K4: every token is summed, and Hopper runs blocks in no order, so the
//    TPU kernel's revisit of one output block across its grid becomes a
//    grid of (token splits, kv heads x row tiles, batch rows); each block
//    sums its split's tiles into registers (dequantized values, p*scale,
//    the offset sum, the V slots as a dense tile built by owner threads)
//    and writes a partial; pv_merge adds the splits in a fixed order (no
//    atomics: sums are reproducible from run to run);
//  - both are latency-bound at a decode step (3 blocks per SM, limited by
//    shared memory and registers), so what a phase needs is loaded before
//    it: the next head's (K3) or next tile's (K4) plane words under the
//    current contraction, each token's slot words and the few-row
//    instances' queries / probabilities under the dequantization; the code
//    width and the row count are template parameters, so the inner loops
//    carry no runtime division and no empty plane.
//
// Numerics: with dot_bf16 the dot operands round to bf16 where the TPU
// kernels round them (K3: the queries and the rotated keys after the slot
// addend; K4: p*scale, lut[code], p and the slot tile) and accumulate in
// fp32; otherwise all fp32. Built without fast-math: slot words are fp32 bit
// patterns whose zero-valued slots are denormals.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

// Field order is mirrored by the ctypes Structures in
// kvquant_tpu_torch/ops/kernels/attention.py.
struct QkArgs {
  const float* q;         // (B, Hkv, R, D) roped queries
  const int32_t* kp;      // (B, Hkv, bits, Tc/32, D) bit planes
  const float* kv_out;    // (B, Hkv/hg, J, Tc) slot words, K rows first
  const float* k_range;   // (Hkv, D)
  const float* k_offset;  // (Hkv, D)
  const float* lut;       // (2**bits,)
  const float* inv_freq;  // (D/2,) RoPE inverse frequencies
  float* out;             // (B, Hkv, R, Tc) unscaled scores
  int B, Hkv, R, D, Tc, S, J;
  int n_kslots;           // K slot rows (0: no slots)
  int hg, bits, dot_bf16;
  int hc;                 // kv heads per block
  float scaling;          // linear RoPE position scaling
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
  int hg, bits, dot_bf16, n_split, n_rt;
};

namespace {

constexpr int TT = 64;      // tokens per tile
constexpr int NT = 128;     // threads per block
constexpr int MAXD = 128;
constexpr int PR = 64;      // query rows per pass, multi-row instances
constexpr int MAX_SLOTS = 8;  // slot rows of one kind per head group

__device__ __forceinline__ float rnd(float x, bool bf) {
  return bf ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

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

// Token t's `n` slot words of one kind (rows j*Tc apart), loaded together
// into registers so that their latencies overlap.
__device__ __forceinline__ void load_slots(uint32_t (&sw)[MAX_SLOTS], const float* words,
                                           int n, int Tc) {
#pragma unroll
  for (int j = 0; j < MAX_SLOTS; ++j)
    sw[j] = j < n ? __float_as_uint(words[(size_t)j * Tc]) : 0u;
}

// A slot word's dim when it belongs to in-group head jh (head field ignored
// at head_group 1) and lies inside the head, else -1.
__device__ __forceinline__ int slot_dim(uint32_t u, int hg, int jh, int D) {
  const int dim = (int)(u & 0x7Fu);
  return ((hg == 1 || (int)((u >> 7) & 0x3u) == jh) && dim < D) ? dim : -1;
}

__device__ __forceinline__ float slot_value(uint32_t u) {
  return __uint_as_float(u & 0xFFFFFE00u);
}

// ---------------------------------------------------------------------------
// K3: scores
// ---------------------------------------------------------------------------

// floats of qk_kernel's dynamic shared memory
__host__ __device__ constexpr int qk_smem_floats(int RT, int D) {
  return TT * D                         // sCS  (cos, sin) of (token, pair)
         + TT * (D + 1)                 // sK   rotated keys + slots
         + RT * (D + 1)                 // sQ   query rows of a pass
         + (RT <= 8 ? 2 * RT * TT : 0)  // sS   half-dot scores (few rows)
         + 16;                          // sLut
}

// One block: tile blockIdx.x of 64 packed tokens, kv heads
// [blockIdx.y * hc, +hc), batch row blockIdx.z. RT <= 8: all R rows in one
// pass (thread per token and half of d); RT == PR: passes of 64 rows, 8x4
// register tiles per thread.
template <int BITS, int RT>
__global__ void __launch_bounds__(NT) qk_kernel(QkArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, DP = D + 1, half = D / 2;
  float2* sCS = reinterpret_cast<float2*>(smem);
  float* sK = smem + TT * D;
  float* sQ = sK + TT * DP;
  float* sS = sQ + RT * DP;
  float* sLut = sS + (RT <= 8 ? 2 * RT * TT : 0);

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TT, h0 = blockIdx.y * a.hc, b = blockIdx.z;
  const int Tc = a.Tc, R = a.R, TW = Tc / 32;
  const bool bf = a.dot_bf16 != 0;

  // the tile's rotation, shared by every head of the block: thread ->
  // pair j, every (NT / half)-th token
  {
    const int j = tid % half;
    const float f = a.inv_freq[j];
    for (int t = tid / half; t < TT; t += NT / half) {
      float sn, cs;
      sincosf(((float)(a.S + t0 + t) / a.scaling) * f, &sn, &cs);
      sCS[t * half + j] = make_float2(cs, sn);
    }
  }
  if (tid < (1 << BITS)) sLut[tid] = a.lut[tid];
  __syncthreads();

  // dequant mapping: thread -> column pair (c0, c0 + D/2), D/4 tokens
  const int c0 = tid % half, c1 = c0 + half;
  const int tpp = TT * half / NT;
  const int tb = (tid / half) * tpp;
  const int g = t0 / 128, bit0 = ((t0 % 128) + tb) >> 2;

  // row-wise loops (queries, rounding): thread -> column qd, rows qr +
  // k * qstep
  const int qd = tid % D, qr = tid / D, qstep = NT / D;
  const int nks = a.n_kslots;
  // plane words of columns c0 / c1: this head's, and the next head's
  // loaded under this head's slot and contraction phases
  uint32_t w0[BITS][4], w1[BITS][4], n0[BITS][4], n1[BITS][4];
  auto planes_of = [&](int h) { return a.kp + ((size_t)b * a.Hkv + h) * BITS * TW * D; };
  load_group_words<BITS>(w0, planes_of(h0), TW, D, g, c0);
  load_group_words<BITS>(w1, planes_of(h0), TW, D, g, c1);
  for (int hh = 0; hh < a.hc; ++hh) {
    const int h = h0 + hh;
    const size_t bh = (size_t)b * a.Hkv + h;
    // this head's K slot words of token tid, in flight during the dequant
    uint32_t sw[MAX_SLOTS];
    if (nks > 0 && tid < TT)
      load_slots(sw, a.kv_out + (((size_t)b * (a.Hkv / a.hg) + h / a.hg) * a.J) * Tc + t0 + tid,
                 nks, Tc);
    // few-row instances: the head's query rows, in flight during the
    // dequant; thread -> column qd, rows qr + k * (NT / D)
    constexpr int QPT = RT <= 8 ? RT * MAXD / NT : 1;
    float qpre[QPT];
    if constexpr (RT <= 8) {
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        const int r = qr + k * qstep;
        qpre[k] = r < R ? a.q[(bh * R + r) * D + qd] : 0.f;
      }
    }
    const float kr0 = a.k_range[h * D + c0], ko0 = a.k_offset[h * D + c0];
    const float kr1 = a.k_range[h * D + c1], ko1 = a.k_offset[h * D + c1];
#pragma unroll 4
    for (int j4 = 0; j4 < tpp / 4; ++j4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tb + 4 * j4 + i;
        const float x0 = sLut[plane_code<BITS>(w0, bit0 + j4, i)] * kr0 + ko0;
        const float x1 = sLut[plane_code<BITS>(w1, bit0 + j4, i)] * kr1 + ko1;
        const float2 cs = sCS[t * half + c0];
        sK[t * DP + c0] = x0 * cs.x - x1 * cs.y;
        sK[t * DP + c1] = x1 * cs.x + x0 * cs.y;
      }
    }
    if (hh + 1 < a.hc) {
      load_group_words<BITS>(n0, planes_of(h + 1), TW, D, g, c0);
      load_group_words<BITS>(n1, planes_of(h + 1), TW, D, g, c1);
    }
    __syncthreads();

    // K slots: thread t owns token row t and adds its slots in slot order
    if (nks > 0 && tid < TT) {
      float* row = sK + tid * DP;
      const float2* cst = sCS + tid * half;
#pragma unroll
      for (int j = 0; j < MAX_SLOTS; ++j) {
        const int dim = j < nks ? slot_dim(sw[j], a.hg, h % a.hg, D) : -1;
        if (dim >= 0) {
          const float v = slot_value(sw[j]);
          const float2 cs = cst[dim % half];
          row[dim] += v * cs.x;
          if (dim < half) row[dim + half] += v * cs.y;
          else row[dim - half] -= v * cs.y;
        }
      }
    }
    __syncthreads();
    if (bf) {
      for (int t = qr; t < TT; t += qstep) sK[t * DP + qd] = rnd(sK[t * DP + qd], true);
      __syncthreads();
    }

    for (int r0 = 0; r0 < R; r0 += RT) {
      const int nrows = min(RT, R - r0);
      if constexpr (RT <= 8) {
#pragma unroll
        for (int k = 0; k < QPT; ++k) {
          const int r = qr + k * qstep;
          if (r < RT) sQ[r * DP + qd] = rnd(qpre[k], bf);
        }
      } else {
        const float* qb = a.q + (bh * R + r0) * D;
        for (int r = qr; r < RT; r += qstep)
          sQ[r * DP + qd] = r < nrows ? rnd(qb[(size_t)r * D + qd], bf) : 0.f;
      }
      __syncthreads();
      float* ob = a.out + (bh * R + r0) * (size_t)Tc + t0;
      if constexpr (RT <= 8) {
        // thread (token t, half hf of d); the halves meet in sS
        const int t = tid % TT, hf = tid / TT;
        const float* kr = sK + t * DP + hf * half;
        const float* qr = sQ + hf * half;
        float acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = 0.f;
        for (int d = 0; d < half; ++d) {
          const float kv = kr[d];
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] = fmaf(qr[r * DP + d], kv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) sS[(hf * RT + r) * TT + t] = acc[r];
        __syncthreads();
        for (int i = tid; i < nrows * TT; i += NT) {
          const int r = i / TT, tt = i % TT;
          ob[(size_t)r * Tc + tt] = sS[r * TT + tt] + sS[(RT + r) * TT + tt];
        }
      } else {
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
      }
      __syncthreads();  // sQ / sS / sK are rewritten next
    }
    if (hh + 1 < a.hc) {
#pragma unroll
      for (int bb = 0; bb < BITS; ++bb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w0[bb][i] = n0[bb][i];
          w1[bb][i] = n1[bb][i];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// K4: probability-weighted values
// ---------------------------------------------------------------------------

// floats of pv_kernel's dynamic shared memory
__host__ __device__ constexpr int pv_smem_floats(int RT, int D) {
  return TT * D              // sV   lut values of the tile's codes
         + TT * D            // sM   V slot tile
         + 2 * RT * (TT + 1) // sP, sPs  p and p*scale of the tile
         + 2 * TT            // sSc, sOf  V scale / offset of the tile
         + 16;               // sLut
}

// One block: token split blockIdx.x, kv head and row tile blockIdx.y, batch
// row blockIdx.z. RT <= 8: all rows, thread per (d, token subset); RT ==
// PR: 64 rows, 8 x (D/16) register tiles per thread.
template <int BITS, int RT>
__global__ void __launch_bounds__(NT) pv_kernel(PvArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, PP = TT + 1;
  float* sV = smem;
  float* sM = sV + TT * D;
  float* sP = sM + TT * D;
  float* sPs = sP + RT * PP;
  float* sSc = sPs + RT * PP;
  float* sOf = sSc + TT;
  float* sLut = sOf + TT;

  const int s = blockIdx.x, h = blockIdx.y / a.n_rt, rt = blockIdx.y % a.n_rt;
  const int b = blockIdx.z, tid = threadIdx.x;
  const int Tc = a.Tc, R = a.R, TW = Tc / 32;
  const bool bf = a.dot_bf16 != 0;
  const int r0 = rt * RT, nrows = min(RT, R - r0);
  const int n_tiles = Tc / TT, tps = (n_tiles + a.n_split - 1) / a.n_split;
  const int t_begin = s * tps, t_end = min(n_tiles, t_begin + tps);
  const size_t bh = (size_t)b * a.Hkv + h;
  float* pout = a.part + ((bh * a.n_split + s) * R + r0) * D;
  if (t_begin >= t_end) {
    for (int i = tid; i < nrows * D; i += NT) pout[i] = 0.f;
    return;
  }

  if (tid < (1 << BITS)) sLut[tid] = rnd(a.lut[tid], bf);
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

  constexpr int RM = RT <= 8 ? RT : 8;  // rows per thread
  float o[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
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
    // ---- the tile's values, ranges and slots ----
    // loads first, in flight during the dequantization: the V range (one
    // value per thread), the few-row instances' probabilities, token tid's
    // V slots (one load each, kept for the add and the clear)
    const float vso = tid < TT ? vsc[t0 + tid] : (tid < 2 * TT ? vof[t0 + tid - TT] : 0.f);
    constexpr int PPT = RT <= 8 ? (RT * TT + NT - 1) / NT : 1;
    float ppre[PPT];
    if constexpr (RT <= 8) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int i = tid + k * NT, r = i / TT;
        ppre[k] = r < nrows ? psrc[(size_t)r * a.p_ld + t0 + i % TT] : 0.f;
      }
    }
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
      // thread t owns token row t: its slots summed in slot order, then
      // rounded once (the TPU kernel's dense addend M, then bf16(M))
      float* row = sM + tid * D;
#pragma unroll
      for (int j = 0; j < MAX_SLOTS; ++j)
        if (sdim[j] >= 0) row[sdim[j]] += sval[j];
      if (bf) {
#pragma unroll
        for (int j = 0; j < MAX_SLOTS; ++j)
          if (sdim[j] >= 0) row[sdim[j]] = rnd(row[sdim[j]], true);
      }
    }
    __syncthreads();
    // ---- the tile's probabilities: p, and p * scale as a dot operand ----
    if constexpr (RT <= 8) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int i = tid + k * NT, r = i / TT, t = i % TT;
        if (r < RT) {
          sP[r * PP + t] = ppre[k];
          sPs[r * PP + t] = rnd(ppre[k] * sSc[t], bf);
        }
      }
    } else {
      for (int i = tid; i < RT * TT; i += NT) {
        const int r = i / TT, t = i % TT;
        const float p = r < nrows ? psrc[(size_t)r * a.p_ld + t0 + t] : 0.f;
        sP[r * PP + t] = p;
        sPs[r * PP + t] = rnd(p * sSc[t], bf);
      }
    }
    __syncthreads();
    if (tid < nrows)
      for (int t = 0; t < TT; ++t) offacc = fmaf(sP[tid * PP + t], sOf[t], offacc);
    if constexpr (RT <= 8) {
      const int d = tid % D, ts = tid / D, nts = NT / D;
      for (int t = ts; t < TT; t += nts) {
        const float v = sV[t * D + d];
#pragma unroll
        for (int r = 0; r < RT; ++r) o[r][0] = fmaf(sPs[r * PP + t], v, o[r][0]);
        if (nvs > 0) {
          const float m = sM[t * D + d];
#pragma unroll
          for (int r = 0; r < RT; ++r) o[r][0] = fmaf(rnd(sP[r * PP + t], bf), m, o[r][0]);
        }
      }
    } else {
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
          for (int i = 0; i < 8; ++i) pv[i] = rnd(sP[(ty * 8 + i) * PP + t], bf);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) vv[jj] = jj < dj ? sM[t * D + tx + 16 * jj] : 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) o[i][jj] = fmaf(pv[i], vv[jj], o[i][jj]);
        }
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
  if (tid < nrows) sSc[tid] = offacc;  // RT <= TT rows
  if constexpr (RT <= 8) {
    const int d = tid % D, ts = tid / D, nts = NT / D;
    float* red = sV;  // [nts][RT][D]
#pragma unroll
    for (int r = 0; r < RT; ++r) red[(ts * RT + r) * D + d] = o[r][0];
    __syncthreads();
    for (int r = ts; r < nrows; r += nts) {
      float v = 0.f;
      for (int u = 0; u < nts; ++u) v += red[(u * RT + r) * D + d];
      pout[(size_t)r * D + d] = v + sSc[r];
    }
  } else {
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

template <typename Kern>
cudaError_t allow_smem(Kern k, int floats, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)(floats * sizeof(float)));
  if (e == cudaSuccess) configured = true;
  return e;
}

template <int BITS, int RT>
cudaError_t launch_qk(const QkArgs& a, cudaStream_t st) {
  static bool configured = false;
  cudaError_t e = allow_smem(qk_kernel<BITS, RT>, qk_smem_floats(RT, MAXD), configured);
  if (e != cudaSuccess) return e;
  qk_kernel<BITS, RT><<<dim3(a.Tc / TT, a.Hkv / a.hc, a.B), NT,
                        qk_smem_floats(RT, a.D) * sizeof(float), st>>>(a);
  return cudaGetLastError();
}

template <int BITS, int RT>
cudaError_t launch_pv(const PvArgs& a, cudaStream_t st) {
  static bool configured = false;
  cudaError_t e = allow_smem(pv_kernel<BITS, RT>, pv_smem_floats(RT, MAXD), configured);
  if (e != cudaSuccess) return e;
  pv_kernel<BITS, RT><<<dim3(a.n_split, a.Hkv * a.n_rt, a.B), NT,
                        pv_smem_floats(RT, a.D) * sizeof(float), st>>>(a);
  return cudaGetLastError();
}

// the instance for R rows: 1, 2, 4 or 8 rows in one pass, else 64-row passes
template <int BITS, typename Args, template <int, int> class L>
cudaError_t by_rows(const Args& a, cudaStream_t st) {
  if (a.R <= 1) return L<BITS, 1>::go(a, st);
  if (a.R <= 2) return L<BITS, 2>::go(a, st);
  if (a.R <= 4) return L<BITS, 4>::go(a, st);
  if (a.R <= 8) return L<BITS, 8>::go(a, st);
  return L<BITS, PR>::go(a, st);
}

template <int BITS, int RT>
struct Qk {
  static cudaError_t go(const QkArgs& a, cudaStream_t st) { return launch_qk<BITS, RT>(a, st); }
};
template <int BITS, int RT>
struct Pv {
  static cudaError_t go(const PvArgs& a, cudaStream_t st) { return launch_pv<BITS, RT>(a, st); }
};

// the instance for the code width: 2, 3 or 4 bit planes
template <typename Args, template <int, int> class L>
cudaError_t by_bits(const Args& a, cudaStream_t st) {
  switch (a.bits) {
    case 2: return by_rows<2, Args, L>(a, st);
    case 3: return by_rows<3, Args, L>(a, st);
    case 4: return by_rows<4, Args, L>(a, st);
  }
  return cudaErrorInvalidValue;
}

bool bad_shape(int D, int Tc, int bits) {
  return D > MAXD || D < 32 || D % 32 || Tc % 128 || bits < 2 || bits > 4;
}

}  // namespace

// Launches K3 on `stream`; returns the cudaError_t of the launch (0 on
// success). Nothing is synchronised.
extern "C" int qk_fused(const QkArgs* a, void* stream) {
  if (bad_shape(a->D, a->Tc, a->bits) || a->hc < 1 || a->Hkv % a->hc ||
      a->Hkv % a->hg || a->n_kslots > MAX_SLOTS || (a->n_kslots > 0 && a->hg > 4))
    return (int)cudaErrorInvalidValue;
  return (int)by_bits<QkArgs, Qk>(*a, static_cast<cudaStream_t>(stream));
}

// Launches K4's split kernel and its merge kernel on `stream`; returns the
// cudaError_t of the launches (0 on success). Nothing is synchronised.
extern "C" int pv_fused(const PvArgs* a, void* stream) {
  const bool few = a->R <= 8;
  if (bad_shape(a->D, a->Tc, a->bits) || a->n_vslots > MAX_SLOTS || a->Hkv % a->hg ||
      (a->n_vslots > 0 && a->hg > 4) || a->n_split < 1 ||
      a->n_rt != (few ? 1 : (a->R + PR - 1) / PR))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = by_bits<PvArgs, Pv>(*a, st);
  if (e != cudaSuccess) return (int)e;
  pv_merge<<<dim3(a->R, a->Hkv, a->B), NT, 0, st>>>(*a);
  return (int)cudaGetLastError();
}
