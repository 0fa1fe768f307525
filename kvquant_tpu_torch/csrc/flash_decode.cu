// One-pass attention over the sink prefix and the quantized KV cache, for
// NVIDIA Hopper (sm_90a): decode steps (Tq = 1) and blocks of quantized
// chunked prefill (Tq > 1).
//
// Replaces kvquant_tpu/ops/pallas/flash_decode.py:_flash_kernel (the TPU
// kernel behind flash_attention / flash_decode): one layer `li` of the full
// (L, ...) cache arrays; codes as nuq bit planes (2-4 bits, any codebook),
// int4 / int8 containers (affine codebook) or the head-paired 2-bit int4x2
// container (affine codebook); keys stored pre-RoPE (rotated
// here at their absolute positions) or post-RoPE; K outliers as slot words
// or static-channel residuals, V outliers as slot words; an exact sink
// prefix; per-row causal and sliding-window masks; per-sample positions.
// Query rows r = 0..Q-1 are g-major over (G, Tq); row r of batch b sits at
// position pos[b] + r % Tq and sees the sink tokens k <= its position and
// the packed tokens t with S + t <= its position.
//
// What bounds it. At Tq = 1 device-memory bytes: each live token costs
// 2*Hkv*D*bits/8 code bytes, its head groups' outlier rows and 8 bytes of V
// scale/offset per layer (LLaMA-2-7B, nuq3, hg 4, cap 2: 3336 B), against
// ~2*Hkv*D*(bits + 6) integer and float operations to decode it and
// rotate it under pre-RoPE storage: the decode work is close to the byte
// time, so both must stay lean. At Tq = 256 the two contractions
// dominate (4*Q*live*D*Hkv flops per call), far above the bytes: fp32 FMA
// rate bounds this version (the tensor-core rate is a later change).
//
// What the design does about it:
//  - a block owns one kv head, one tile of up to 64 query rows and one
//    split of the live 64-token key tiles; it dequantizes each tile of K
//    and V ONCE into shared memory (fp32, rows padded against bank
//    conflicts) and every query row of the tile reuses it (GQA rows and the
//    Tq rows of a prefill block alike);
//  - the token axis is split across blocks (grid = splits x (Hkv * row
//    tiles) x B), each block deriving its share of the live range from
//    pos[b] on the device, so a batch of one fills the card and cost tracks
//    the filled prefix, not the capacity; a second small kernel merges the
//    splits' (m, l, acc) with the sink prefix by log-sum-exp;
//  - a nuq code is `bits` shift-and-masks over the 4*bits words that hold a
//    128-token group of one d column (neighbouring threads take
//    neighbouring d, so the word loads coalesce), then one indexed load of
//    the 2**bits-entry LUT in shared memory (the TPU kernel's 19-op mux
//    tree exists only because its vector unit has no indexed load);
//  - keys are rotated in registers while they are dequantized, one thread
//    per (d, d + D/2) pair, from a (cos, sin) table that a first small
//    kernel writes once per call for the live positions (one sincosf per
//    position and pair instead of one per position, pair and kv head);
//    the angles are ((S + t) / scaling) * inv_freq[d] in the plain
//    version's fp32 order, and sincosf, not __sinf/__cosf or fast-math,
//    which are wrong at the ~1e5-radian angles of long contexts;
//  - outlier slots (and static-channel residuals) are added into the
//    rotated tile at (head, dim) with shared-memory atomics, rotated by
//    linearity: v at dim d adds v*cos at d and +-v*sin at d +- D/2 (the
//    TPU kernel's one-hot E-tiles and score corrections work around its
//    lack of scatters);
//  - rows with no valid key in a split report m = -inf, l = 0, acc = 0 and
//    carry zero weight in the merge;
//  - int4x2 (two 2-bit codes per nibble, kv heads 2j and 2j + 1 sharing
//    container head j): the block of head h reads container head h >> 1
//    and takes its own two bits of each nibble, so a pair's container is
//    read by two blocks (the second read mostly from L2). The TPU kernel's
//    distributed even-head dot (c_even = x - 4 c_odd + 8) and its stacked
//    per-pair softmax balance its matrix and vector units; here each block
//    dequantizes its own head's code into the shared tile, as for int4.
//
// Numerics: with dot_bf16 the dot operands (queries, roped keys, the
// dequantized values, the rotated outlier terms, the probabilities, the
// sink rows) are rounded to bf16 and accumulated in fp32; otherwise all
// fp32. Built without fast-math:
// slot words are fp32 bit patterns whose zero-valued slots are denormals.
//
// The paged entry fd_paged_attention replaces kvquant_tpu/paged.py:
// paged_flash_decode (K5), which on the TPU reuses _flash_kernel unchanged
// and only remaps the token-block index through a scalar-prefetched
// (B, MP) page table. Here too the body is shared: fd_partial takes its
// addressing as a template policy. Contig (K1) reads the (L, B, ..., Tc)
// cache of batch row b; Paged (K5) reads a 64-token tile at logical packed
// position t0 from page table[b, min(t0 / P, last live page)] of the
// (L, NP, ..., P) pool, at row t0 % P. Sinks stay per slot, the RoPE table
// is indexed by logical position over MP * P tokens, and tiles past each
// slot's position are skipped as in K1, so dead pages cost nothing. K5 is a
// decode kernel (Tq = 1, G <= 8 query rows per kv head); its bound is K1's
// decode bound: the live tokens' bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>
#include <type_traits>

// Field order is mirrored by the ctypes Structure in
// kvquant_tpu_torch/ops/kernels/flash_decode.py.
struct FdArgs {
  const float* q;          // (B, Hkv, Q, D) roped queries
  const void* kp;          // nuq: (L, B, Hkv, bits, Tc/32, D) int32 planes;
  const void* vp;          //   int4: (L, B, Hkv, Tc, D/2) uint8; int8: (L, B, Hkv, Tc, D);
                           //   int4x2: (L, B, Hkv/2, Tc, D/2) uint8
  const float* kv_out;     // (L, B, NG, J, Tc) outlier rows
  const float* k_range;    // (L, Hkv, D)
  const float* k_offset;   // (L, Hkv, D)
  const float* v_scale;    // (L, B, Tc)
  const float* v_offset;   // (L, B, Tc)
                           // (paged: the pool's (L, NP, ..., P) in place of
                           //  (L, B, ..., Tc) for kp, vp, kv_out, v_scale,
                           //  v_offset; Tc = MP * P logical tokens)
  const float* k_sink;     // (L, B, Hkv, S, D) post-RoPE
  const float* v_sink;     // (L, B, Hkv, S, D)
  const float* k_lut;      // (L, 2**bits)
  const float* v_lut;      // (L, 2**bits)
  const float* inv_freq;   // (D/2,) RoPE inverse frequencies
  float2* rope;            // (Tc, D/2) scratch: (cos, sin) of packed token t
                           //   (pre-RoPE storage only; written by fd_rope)
  const int* pos;          // (B,) position of query row 0
  const int* k_chan;       // (NG, n_kc) group-space channels of layer li
  float* part_m;           // (B, Hkv, NS, Q)
  float* part_l;           // (B, Hkv, NS, Q)
  float* part_acc;         // (B, Hkv, NS, Q, D)
  float* out;              // (B, Hkv, Q, D)
  int L, B, Hkv, Q, Tq, D, Tc, S, J;
  int spk;                 // first V row of kv_out
  int n_kc;                // static K channels per group (0: none)
  int n_kslots, n_vslots;  // live K / V slot rows
  int hg, mode, bits, window, post_rope, dot_bf16, li, n_split, n_rt;
  float inv;               // 1 / sqrt(D)
  float scaling;           // linear RoPE position scaling
  const int* table;        // paged: (B, MP) page ids of each slot
  int MP, P, NP;           // paged: table width, tokens per page, pool pages
};

namespace {

constexpr int TT = 64;       // key tokens per tile
constexpr int NT = 128;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int MAXD = 128;
constexpr int MAX_KC = 64;
constexpr int MAX_SINK = 64;
constexpr int PR = 64;       // query rows per block, multi-row instance
constexpr int MODE_NUQ = 0, MODE_INT4 = 1, MODE_INT8 = 2, MODE_INT4X2 = 3;
constexpr int NEG_ROW = -(1 << 30);  // position of a padding row: sees nothing

__device__ __forceinline__ float rnd(float x, bool bf) {
  return bf ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float nibble(uint8_t x, int hi) {
  return (float)((int)(((x >> (4 * hi)) & 0xF) ^ 8) - 8);
}

// int4x2: the nibble holds c_even + 4 * c_odd - 8; head parity `odd` picks
// its 2-bit code
__device__ __forceinline__ float pair_code(uint8_t x, int hi, int odd) {
  const int v = (((x >> (4 * hi)) & 0xF) ^ 8) >> (2 * odd);
  return (float)(v & 3);
}

__device__ __forceinline__ bool key_ok(int t_abs, int rp, int S, int window) {
  return t_abs <= rp - S && (window <= 0 || t_abs + S > rp - window);
}

// floats / ints of the partial kernel's dynamic shared memory
__host__ __device__ constexpr int smem_floats(int RT, int D) {
  return TT * (D + 1)                 // sK  rotated, corrected keys
         + TT * D                     // sV  dequantized values
         + RT * (D + 1)               // sQ  queries
         + RT * (TT + 1)              // sP  probabilities of the tile
         + (RT <= 8 ? 2 * RT * TT : 0)  // sS  half-dot scores (few-row path)
         + 3 * RT                     // sM, sL, sA  (few-row path)
         + 32                         // sLutK, sLutV
         + 2 * TT;                    // sVs, sVo  V scale / offset of the tile
}
__host__ __device__ constexpr int smem_ints(int RT) { return RT + MAX_KC; }
size_t smem_bytes(int RT, int D) {
  return sizeof(float) * smem_floats(RT, D) + sizeof(int) * smem_ints(RT);
}

// Addressing policies of fd_partial: where the cache rows of the 64-token
// key tile at logical packed position t0 live. A slab is one entry of the
// cache arrays' second axis (a batch row, or a pool page) and holds
// tokens() rows; locate() returns (slab, row of t0 in it).
struct Contig {  // K1: the (L, B, ..., Tc) cache of batch row b
  __device__ static int slabs(const FdArgs& a) { return a.B; }
  __device__ static int tokens(const FdArgs& a) { return a.Tc; }
  __device__ static int last_page(const FdArgs&, int, int) { return 0; }
  __device__ static int2 locate(const FdArgs&, int b, int t0, int) {
    return make_int2(b, t0);
  }
};
struct Paged {  // K5: page table[b, t / P] of the (L, NP, ..., P) pool
  __device__ static int slabs(const FdArgs& a) { return a.NP; }
  __device__ static int tokens(const FdArgs& a) { return a.P; }
  // the slot's last live page (its last visible packed token's), kept
  // below MP: the table is never read at or past a slot's MP entries
  __device__ static int last_page(const FdArgs& a, int maxp, int S) {
    return min(max(maxp - S, 0) / a.P, a.MP - 1);
  }
  // page index clamped to the last live page before the lookup, as the TPU
  // kernel's index map does (paged.py:211-216)
  __device__ static int2 locate(const FdArgs& a, int b, int t0, int last) {
    return make_int2(a.table[(size_t)b * a.MP + min(t0 / a.P, last)], t0 % a.P);
  }
};

// One block: kv head h, query rows [r0, r0 + RT) of batch row b, split s of
// the live key tiles. RT <= 8: the rows of a decode step (thread per token
// for the scores, thread per d for P.V); RT == PR: 8x4 / 8x(D/16)
// register tiles per thread for a prefill block. AP: Contig or Paged.
template <int MODE, int RT, class AP>
__global__ void __launch_bounds__(NT) fd_partial(FdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, DP = D + 1, half = D / 2;
  float* sK = smem;
  float* sV = sK + TT * DP;
  float* sQ = sV + TT * D;
  float* sP = sQ + RT * DP;
  float* sS = sP + RT * (TT + 1);
  float* sM = sS + (RT <= 8 ? 2 * RT * TT : 0);
  float* sL = sM + RT;
  float* sA = sL + RT;
  float* sLutK = sA + RT;
  float* sLutV = sLutK + 16;
  float* sVs = sLutV + 16;
  float* sVo = sVs + TT;
  int* sRpos = reinterpret_cast<int*>(sVo + TT);
  int* sChDim = sRpos + RT;  // [n_kc] dim of channel row n in this head, or -1

  const int s = blockIdx.x, h = blockIdx.y / a.n_rt, rt = blockIdx.y % a.n_rt;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = a.li, Tc = a.Tc, S = a.S, Q = a.Q, win = a.window;
  const bool bf = a.dot_bf16 != 0;
  const int r0 = rt * RT, nrows = min(RT, Q - r0);
  const int pos = a.pos[b];

  // ---- this block's live key tiles ----
  int minp = 0x7fffffff, maxp = NEG_ROW;
  for (int r = 0; r < nrows; ++r) {
    const int rp = pos + (r0 + r) % a.Tq;
    minp = min(minp, rp);
    maxp = max(maxp, rp);
  }
  const int hi = min(maxp - S, Tc - 1);
  const int lo = win > 0 ? max(0, minp - win + 1 - S) : 0;
  const int n_tiles = hi < lo ? 0 : hi / TT - lo / TT + 1;
  const int tps = (n_tiles + a.n_split - 1) / a.n_split;
  const int t_begin = lo / TT + s * tps;
  const int t_end = min(lo / TT + n_tiles, t_begin + tps);

  const size_t bh = (size_t)b * a.Hkv + h;
  float* pm = a.part_m + (bh * a.n_split + s) * Q + r0;
  float* pl = a.part_l + (bh * a.n_split + s) * Q + r0;
  float* pacc = a.part_acc + ((bh * a.n_split + s) * Q + r0) * D;
  if (n_tiles == 0 || t_begin >= t_end) {
    for (int r = tid; r < nrows; r += NT) {
      pm[r] = -INFINITY;
      pl[r] = 0.f;
    }
    for (int i = tid; i < nrows * D; i += NT) pacc[i] = 0.f;
    return;
  }

  // ---- per-block constants ----
  const int hg = a.hg, jh = h % hg, grp = h / hg;
  const int K = 1 << a.bits;
  const float* kl = a.k_lut + (size_t)li * K;
  const float* vl = a.v_lut + (size_t)li * K;
  if (MODE == MODE_NUQ && tid < K) {
    sLutK[tid] = kl[tid];
    sLutV[tid] = vl[tid];
  }
  if (tid < RT) {
    sRpos[tid] = tid < nrows ? pos + (r0 + tid) % a.Tq : NEG_ROW;
    if (RT <= 8) {
      sM[tid] = -INFINITY;
      sL[tid] = 0.f;
    }
  }
  const float* qb = a.q + (bh * Q + r0) * D;
  for (int i = tid; i < RT * D; i += NT) {
    const int r = i / D, d = i % D;
    sQ[r * DP + d] = r < nrows ? rnd(qb[(size_t)r * D + d], bf) : 0.f;
  }
  for (int n = tid; n < a.n_kc; n += NT) {
    const int ch = a.k_chan[grp * a.n_kc + n];
    sChDim[n] = ch / D == jh ? ch % D : -1;
  }
  // the affine codebook of the integer containers, folded as in the plain
  // version (common.fold_affine): code c_s -> c_s * kstep + kzero, c_s the
  // signed code (int4 / int8) or the unsigned one (int4x2, bias 0)
  const float bias = MODE == MODE_INT4X2 ? 0.f : (float)(1 << (a.bits - 1));
  const float kb = (kl[K - 1] - kl[0]) / (float)(K - 1);
  const float ka = kl[0] + bias * kb;
  const float vb = (vl[K - 1] - vl[0]) / (float)(K - 1);
  const float va = vl[0] + bias * vb;

  // dequant mapping: thread -> column pair (c0, c1 = c0 + D/2), token part
  const int c0 = tid % half, c1 = c0 + half;
  const int tpp = TT * half / NT;  // tokens per part: D/4
  const int tb = (tid / half) * tpp;
  const size_t cidx = ((size_t)li * a.Hkv + h) * D;
  const float kr0 = a.k_range[cidx + c0], ko0 = a.k_offset[cidx + c0];
  const float kr1 = a.k_range[cidx + c1], ko1 = a.k_offset[cidx + c1];
  const float ks0 = kb * kr0, kz0 = ka * kr0 + ko0;
  const float ks1 = kb * kr1, kz1 = ka * kr1 + ko1;
  // the tile's slab and row through the addressing policy
  const int TS = AP::tokens(a);
  const size_t lay = (size_t)li * AP::slabs(a);
  const int last = AP::last_page(a, maxp, S);
  auto at = [&](int t0) { return AP::locate(a, b, t0, last); };
  // the code arrays' head: int4x2 keeps head h in container head h >> 1
  const bool paired = MODE == MODE_INT4X2;
  const int Hc = paired ? a.Hkv / 2 : a.Hkv, hc = paired ? h >> 1 : h;
  const int odd = h & 1;
  auto head_slab = [&](int2 sr) { return (lay + sr.x) * Hc + hc; };
  auto kvo_of = [&](int2 sr) {
    return a.kv_out + ((lay + sr.x) * (a.Hkv / hg) + grp) * a.J * (size_t)TS + sr.y;
  };
  const bool pre = !a.post_rope;
  // the tile's per-token V scale / offset, one load per thread
  auto load_vso = [&](int2 sr) {
    const size_t o = (lay + sr.x) * TS + sr.y;
    return tid < TT ? a.v_scale[o + tid] : (tid < 2 * TT ? a.v_offset[o + tid - TT] : 0.f);
  };
  auto store_vso = [&](float x) {
    if (tid < TT) sVs[tid] = x;
    else if (tid < 2 * TT) sVo[tid - TT] = x;
  };
  int2 cur = at(t_begin * TT);
  store_vso(load_vso(cur));
  __syncthreads();

  // one token's K pair (rotated at position S + t under pre-RoPE storage)
  // or V pair into the tile, as bf16-rounded dot operands where asked
  auto put_k = [&](int t0, int t, float x0, float x1) {
    if (pre) {
      const float2 cs = a.rope[(size_t)(t0 + t) * half + c0];
      const float r0 = x0 * cs.x - x1 * cs.y;
      x1 = x1 * cs.x + x0 * cs.y;
      x0 = r0;
    }
    sK[t * DP + c0] = rnd(x0, bf);
    sK[t * DP + c1] = rnd(x1, bf);
  };
  auto put_v = [&](int t0, int t, float y0, float y1) {
    const bool live = t0 + t <= hi;
    sV[t * D + c0] = live ? rnd(y0, bf) : 0.f;
    sV[t * D + c1] = live ? rnd(y1, bf) : 0.f;
  };
  // an outlier value at (t, dim) of the rotated K tile: RoPE is linear, so
  // value v at dim d adds v*cos at d and +-v*sin at its partner d +- D/2
  auto add_k = [&](int t0, int t, int dim, float v) {
    if (pre) {
      const int i = dim % half;
      const float2 cs = a.rope[(size_t)(t0 + t) * half + i];
      atomicAdd(&sK[t * DP + dim], rnd(v * cs.x, bf));
      atomicAdd(&sK[t * DP + (dim < half ? dim + half : i)],
                rnd(dim < half ? v * cs.y : -v * cs.y, bf));
    } else {
      atomicAdd(&sK[t * DP + dim], rnd(v, bf));
    }
  };

  // The tile's outlier rows (J x TT words: K slots or channel residuals,
  // then V slots), the first OPF words per thread loaded at the top of the
  // tile so that they arrive during the dequantization.
  constexpr int OPF = 4;
  const int n_ow = (a.n_kslots > 0 || a.n_kc > 0 || a.n_vslots > 0) ? a.J * TT : 0;
  float ow[OPF];
  auto load_ow = [&](const float* kvo, int i) {
    return kvo[(size_t)(i / TT) * TS + i % TT];
  };
  auto use_ow = [&](int t0, int i, float w) {
    const int r = i / TT, t = i % TT;
    const uint32_t u = __float_as_uint(w);
    const int dim = u & 0x7Fu;
    const bool mine = (int)((u >> 7) & 0x3u) == jh && dim < D;
    const float val = __uint_as_float(u & 0xFFFFFE00u);
    if (r < a.spk) {  // K rows
      if (a.n_kc > 0) {
        if (sChDim[r] >= 0) add_k(t0, t, sChDim[r], w);
      } else if (r < a.n_kslots && mine) {
        add_k(t0, t, dim, val);
      }
    } else if (r - a.spk < a.n_vslots && mine && t0 + t <= hi) {
      atomicAdd(&sV[t * D + dim], rnd(val, bf));
    }
  };

  // Bit-plane words of columns c0 / c1 for K and V, [plane][word row]. In
  // the decode instances the next tile's words load right after this
  // tile's dequantization, under its outlier and contraction phases.
  constexpr bool PF = RT <= 8;
  uint32_t wk0[4][4], wk1[4][4], wv0[4][4], wv1[4][4];
  auto load_words = [&](int2 sr) {
    const int bits = a.bits, TW = TS / 32, g = sr.y / 128;
    const size_t slab = head_slab(sr) * bits * TW * D;
    const int32_t* kpl = reinterpret_cast<const int32_t*>(a.kp) + slab;
    const int32_t* vpl = reinterpret_cast<const int32_t*>(a.vp) + slab;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const size_t row = ((size_t)bb * TW + g * 4 + w) * D;
        const bool on = bb < bits;
        wk0[bb][w] = on ? (uint32_t)kpl[row + c0] : 0u;
        wk1[bb][w] = on ? (uint32_t)kpl[row + c1] : 0u;
        wv0[bb][w] = on ? (uint32_t)vpl[row + c0] : 0u;
        wv1[bb][w] = on ? (uint32_t)vpl[row + c1] : 0u;
      }
  };
  if (MODE == MODE_NUQ && PF) load_words(cur);

  // running state: few-row path in shared memory (sM, sL, sA) and o[];
  // multi-row path in registers
  constexpr int RM = RT <= 8 ? RT : 8;  // rows per thread
  float o[RM][8];
  float m_r[RM], l_r[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int t0 = tile * TT;
    const float* kvo = kvo_of(cur);
#pragma unroll
    for (int k = 0; k < OPF; ++k)
      ow[k] = tid + k * NT < n_ow ? load_ow(kvo, tid + k * NT) : 0.f;
    // ---- dequantize (and rotate) K and V of the tile into shared memory ----
    if (MODE == MODE_NUQ) {
      if (!PF) load_words(cur);
      const int bit0 = ((t0 % 128) + tb) >> 2;
#pragma unroll
      for (int kind = 0; kind < 2; ++kind) {
        // unrolled: the next tokens' loads issue under this one's work
#pragma unroll 4
        for (int j4 = 0; j4 < tpp / 4; ++j4) {
          const int bit = bit0 + j4;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            int e0 = 0, e1 = 0;
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) {
              const uint32_t x0 = kind == 0 ? wk0[bb][w] : wv0[bb][w];
              const uint32_t x1 = kind == 0 ? wk1[bb][w] : wv1[bb][w];
              e0 |= (int)((x0 >> bit) & 1u) << bb;
              e1 |= (int)((x1 >> bit) & 1u) << bb;
            }
            const int t = tb + 4 * j4 + w;
            if (kind == 0) {
              put_k(t0, t, sLutK[e0] * kr0 + ko0, sLutK[e1] * kr1 + ko1);
            } else {
              const float sc_t = sVs[t], of_t = sVo[t];
              put_v(t0, t, sLutV[e0] * sc_t + of_t, sLutV[e1] * sc_t + of_t);
            }
          }
        }
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < tpp; ++j) {
        const int t = tb + j;
        const size_t row = head_slab(cur) * TS + cur.y + t;
        float x0, x1, y0, y1;
        if (MODE == MODE_INT8) {
          const int8_t* kr = reinterpret_cast<const int8_t*>(a.kp) + row * D;
          const int8_t* vr = reinterpret_cast<const int8_t*>(a.vp) + row * D;
          x0 = kr[c0]; x1 = kr[c1]; y0 = vr[c0]; y1 = vr[c1];
        } else if (MODE == MODE_INT4X2) {
          const uint8_t* kr = reinterpret_cast<const uint8_t*>(a.kp) + row * (D / 2);
          const uint8_t* vr = reinterpret_cast<const uint8_t*>(a.vp) + row * (D / 2);
          x0 = pair_code(kr[c0 >> 1], c0 & 1, odd); x1 = pair_code(kr[c1 >> 1], c1 & 1, odd);
          y0 = pair_code(vr[c0 >> 1], c0 & 1, odd); y1 = pair_code(vr[c1 >> 1], c1 & 1, odd);
        } else {
          const uint8_t* kr = reinterpret_cast<const uint8_t*>(a.kp) + row * (D / 2);
          const uint8_t* vr = reinterpret_cast<const uint8_t*>(a.vp) + row * (D / 2);
          x0 = nibble(kr[c0 >> 1], c0 & 1); x1 = nibble(kr[c1 >> 1], c1 & 1);
          y0 = nibble(vr[c0 >> 1], c0 & 1); y1 = nibble(vr[c1 >> 1], c1 & 1);
        }
        const float sc_t = sVs[t];
        const float vs_t = sc_t * vb, vo_t = sc_t * va + sVo[t];
        put_k(t0, t, x0 * ks0 + kz0, x1 * ks1 + kz1);
        put_v(t0, t, y0 * vs_t + vo_t, y1 * vs_t + vo_t);
      }
    }
    __syncthreads();
    const bool more = tile + 1 < t_end;
    // the next tile's slab and row: under paging its table lookup comes
    // before the prefetch that reads through it
    const int2 nxt = more ? at(t0 + TT) : cur;
    const float vso_next = more ? load_vso(nxt) : 0.f;
    if (MODE == MODE_NUQ && PF && more) load_words(nxt);

    // ---- outliers, added to the rotated tile ----
    if (n_ow > 0) {
#pragma unroll
      for (int k = 0; k < OPF; ++k)
        if (tid + k * NT < n_ow) use_ow(t0, tid + k * NT, ow[k]);
      for (int i = tid + OPF * NT; i < n_ow; i += NT) use_ow(t0, i, load_ow(kvo, i));
      __syncthreads();
    }

    if constexpr (RT <= 8) {
      // ---- scores: thread (token t, half hh of d) ----
      {
        const int t = tid % TT, hh = tid / TT;
        const float* kr = sK + t * DP + hh * half;
        const float* qr = sQ + hh * half;
        float acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = 0.f;
        for (int d = 0; d < half; ++d) {
          const float kv = kr[d];
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] = fmaf(qr[r * DP + d], kv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) sS[(hh * RT + r) * TT + t] = acc[r];
      }
      __syncthreads();
      // ---- online softmax: warp w takes rows w, w + 4 ----
      for (int r = warp; r < RT; r += NW) {
        const int rp = sRpos[r];
        float sc[2];
        float tmax = -INFINITY;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = lane + 32 * i;
          const float v = (sS[r * TT + t] + sS[(RT + r) * TT + t]) * a.inv;
          sc[i] = key_ok(t0 + t, rp, S, win) ? v : -INFINITY;
          tmax = fmaxf(tmax, sc[i]);
        }
        for (int off = 16; off; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_old = sM[r], m_new = fmaxf(m_old, tmax);
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p = sc[i] == -INFINITY ? 0.f : expf(sc[i] - m_new);
          sum += p;
          sP[r * (TT + 1) + lane + 32 * i] = rnd(p, bf);
        }
        for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        __syncwarp();
        if (lane == 0) {
          sM[r] = m_new;
          sL[r] = sL[r] * alpha + sum;
          sA[r] = alpha;
        }
      }
      __syncthreads();
      // ---- P.V: thread (d, token subset ts) ----
      {
        const int d = tid % D, ts = tid / D, nts = NT / D;
#pragma unroll
        for (int r = 0; r < RT; ++r) o[r][0] *= sA[r];
        for (int t = ts; t < TT; t += nts) {
          const float v = sV[t * D + d];
#pragma unroll
          for (int r = 0; r < RT; ++r) o[r][0] = fmaf(sP[r * (TT + 1) + t], v, o[r][0]);
        }
      }
    } else {
      // ---- scores: thread (ty, tx) owns rows ty*8+i, tokens tx + 16j ----
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
      // ---- online softmax over the 16 threads that share a row ----
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty * 8 + i, rp = sRpos[r];
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = tx + 16 * j;
          sc[i][j] = key_ok(t0 + t, rp, S, win) ? sc[i][j] * a.inv : -INFINITY;
          tmax = fmaxf(tmax, sc[i][j]);
        }
        for (int off = 8; off; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_new = fmaxf(m_r[i], tmax);
        const float alpha = m_r[i] == -INFINITY ? 0.f : expf(m_r[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = sc[i][j] == -INFINITY ? 0.f : expf(sc[i][j] - m_new);
          sum += p;
          sP[r * (TT + 1) + tx + 16 * j] = rnd(p, bf);
        }
        for (int off = 8; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        m_r[i] = m_new;
        l_r[i] = l_r[i] * alpha + sum;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) o[i][jj] *= alpha;
      }
      __syncthreads();
      // ---- P.V: thread (ty, tx) owns rows ty*8+i, dims tx + 16jj ----
      const int dj = D / 16;
      for (int t = 0; t < TT; ++t) {
        float pv[8], vv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) pv[i] = sP[(ty * 8 + i) * (TT + 1) + t];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) vv[jj] = jj < dj ? sV[t * D + tx + 16 * jj] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) o[i][jj] = fmaf(pv[i], vv[jj], o[i][jj]);
      }
    }
    if (more) store_vso(vso_next);
    cur = nxt;
    __syncthreads();  // the next tile overwrites sK, sV, sP, sVs, sVo
  }

  // ---- this split's partials ----
  if constexpr (RT <= 8) {
    const int d = tid % D, ts = tid / D, nts = NT / D;
    float* red = sK;  // [nts][RT][D]
#pragma unroll
    for (int r = 0; r < RT; ++r) red[(ts * RT + r) * D + d] = o[r][0];
    __syncthreads();
    for (int i = tid; i < nrows * D; i += NT) {
      const int r = i / D, dd = i % D;
      float v = 0.f;
      for (int u = 0; u < nts; ++u) v += red[(u * RT + r) * D + dd];
      pacc[i] = v;
    }
    for (int r = tid; r < nrows; r += NT) {
      pm[r] = sM[r];
      pl[r] = sL[r];
    }
  } else {
    const int ty = tid / 16, tx = tid % 16, dj = D / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      if (r < nrows) {
        if (tx == 0) {
          pm[r] = m_r[i];
          pl[r] = l_r[i];
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          if (jj < dj) pacc[(size_t)r * D + tx + 16 * jj] = o[i][jj];
      }
    }
  }
}

// The (cos, sin) table of the packed tokens' RoPE angles, once per call:
// sincosf(((S + t) / scaling) * inv_freq[i]), the plain version's fp32 order
// (sincosf, not __sinf / __cosf: angles reach ~1e5 radians at long
// context). Rows past the last position any query row can see are skipped.
__global__ void __launch_bounds__(256) fd_rope(FdArgs a) {
  const int half = a.D / 2;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int t = (int)(idx / half), i = (int)(idx % half);
  int last = 0;
  for (int b = 0; b < a.B; ++b) last = max(last, a.pos[b] + a.Tq - 1 - a.S);
  if (t >= a.Tc || t > last) return;
  float sn, cs;
  sincosf(((float)(a.S + t) / a.scaling) * a.inv_freq[i], &sn, &cs);
  a.rope[idx] = make_float2(cs, sn);
}

// One block per (query row, kv head, batch row): the sink prefix and every
// split's partial merged by log-sum-exp, then 1/l.
__global__ void __launch_bounds__(NT) fd_merge(FdArgs a) {
  extern __shared__ float s_w[];  // [n_split] split weights
  __shared__ float red[NW];
  __shared__ float s_sc[MAX_SINK];
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int lane = d & 31, warp = d >> 5;
  const int D = a.D, S = a.S, NS = a.n_split, Q = a.Q;
  const bool bf = a.dot_bf16 != 0;
  const int rp = a.pos[b] + r % a.Tq;
  const size_t bh = (size_t)b * a.Hkv + h;
  const float* qg = a.q + (bh * Q + r) * D;
  const float* ks = a.k_sink + ((((size_t)a.li * a.B + b) * a.Hkv + h) * S) * D;
  const float* vs = a.v_sink + ((((size_t)a.li * a.B + b) * a.Hkv + h) * S) * D;

  // sink scores: warp w takes sink rows w, w + NW, ...
  for (int k = warp; k < S; k += NW) {
    float v = 0.f;
    for (int e = lane; e < D; e += 32) v += rnd(qg[e], bf) * rnd(ks[k * D + e], bf);
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) s_sc[k] = v * a.inv;
  }
  // split maxima (one split per thread), then the block maximum
  float mloc = -INFINITY;
  for (int sp = d; sp < NS; sp += NT) mloc = fmaxf(mloc, a.part_m[(bh * NS + sp) * Q + r]);
  for (int o = 16; o; o >>= 1) mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o));
  if (lane == 0) red[warp] = mloc;
  __syncthreads();
  float m0 = -INFINITY;  // sink maximum
  for (int k = 0; k < S; ++k)
    if (k <= rp && (a.window <= 0 || k > rp - a.window)) m0 = fmaxf(m0, s_sc[k]);
  float M = m0;
  for (int w = 0; w < NW; ++w) M = fmaxf(M, red[w]);
  __syncthreads();  // red is reused below
  // split weights and their share of l
  float lloc = 0.f;
  for (int sp = d; sp < NS; sp += NT) {
    const size_t pi = (bh * NS + sp) * Q + r;
    const float ms = a.part_m[pi];
    const float w = ms == -INFINITY ? 0.f : expf(ms - M);
    s_w[sp] = w;
    lloc += w * a.part_l[pi];
  }
  for (int o = 16; o; o >>= 1) lloc += __shfl_xor_sync(0xffffffffu, lloc, o);
  if (lane == 0) red[warp] = lloc;
  __syncthreads();
  float l = 0.f, acc = 0.f;
  for (int w = 0; w < NW; ++w) l += red[w];
  const float ck = m0 == -INFINITY ? 0.f : expf(m0 - M);
  for (int k = 0; k < S; ++k) {
    const bool ok = k <= rp && (a.window <= 0 || k > rp - a.window);
    const float pk = ok ? expf(s_sc[k] - m0) : 0.f;
    l += pk * ck;
    if (d < D) acc = fmaf(rnd(pk, bf) * ck, rnd(vs[k * D + d], bf), acc);
  }
  if (d < D) {
    const float* pacc = a.part_acc + (bh * NS * Q + r) * D + d;
    for (int sp = 0; sp < NS; ++sp) acc = fmaf(pacc[(size_t)sp * Q * D], s_w[sp], acc);
    a.out[(bh * Q + r) * D + d] = acc / l;
  }
}

template <int MODE, int RT, class AP>
cudaError_t launch_partial(const FdArgs& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(fd_partial<MODE, RT, AP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(RT, MAXD));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  fd_partial<MODE, RT, AP><<<dim3(a.n_split, a.Hkv * a.n_rt, a.B), NT, smem_bytes(RT, a.D),
                             stream>>>(a);
  return cudaGetLastError();
}

// The decode instances (all Q <= 8 rows of a kv head in one block) for
// both policies; the multi-row prefill instance for the contiguous cache
// only (paged attention is a decode step).
template <int MODE, class AP>
cudaError_t dispatch_rows(const FdArgs& a, cudaStream_t st) {
  if (a.n_rt == 1) {
    switch (a.Q) {
      case 1: return launch_partial<MODE, 1, AP>(a, st);
      case 2: return launch_partial<MODE, 2, AP>(a, st);
      case 4: return launch_partial<MODE, 4, AP>(a, st);
      case 8: return launch_partial<MODE, 8, AP>(a, st);
    }
  }
  if constexpr (std::is_same<AP, Contig>::value) return launch_partial<MODE, PR, AP>(a, st);
  return cudaErrorInvalidValue;
}

// The RoPE table, the split kernel and the merge kernel on `stream`.
template <class AP>
int run(const FdArgs* a, void* stream) {
  if (a->S > MAX_SINK || a->n_kc > MAX_KC || a->D > MAXD || a->D % 32 ||
      a->Tc % 128 || (a->mode == MODE_NUQ && (a->bits < 1 || a->bits > 4)) ||
      (a->mode == MODE_INT4X2 && (a->bits != 2 || a->Hkv % 2 || a->hg % 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!a->post_rope) {
    const size_t n = (size_t)a->Tc * (a->D / 2);
    fd_rope<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(*a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  cudaError_t e = cudaErrorInvalidValue;
  switch (a->mode) {
    case MODE_NUQ: e = dispatch_rows<MODE_NUQ, AP>(*a, st); break;
    case MODE_INT4: e = dispatch_rows<MODE_INT4, AP>(*a, st); break;
    case MODE_INT8: e = dispatch_rows<MODE_INT8, AP>(*a, st); break;
    case MODE_INT4X2: e = dispatch_rows<MODE_INT4X2, AP>(*a, st); break;
  }
  if (e != cudaSuccess) return (int)e;
  fd_merge<<<dim3(a->Q, a->Hkv, a->B), NT, a->n_split * sizeof(float), st>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

// K1 over the contiguous (L, B, ...) cache. Returns the cudaError_t of the
// launches (0 on success); nothing is synchronised.
extern "C" int fd_attention(const FdArgs* a, void* stream) {
  return run<Contig>(a, stream);
}

// K5: decode attention (Tq = 1, Q <= 8 rows per kv head) over the
// (L, NP, ...) page pool through the (B, MP) page table, Tc = MP * P.
extern "C" int fd_paged_attention(const FdArgs* a, void* stream) {
  if (!a->table || a->P <= 0 || a->P % 128 || a->MP <= 0 || a->NP <= 0 ||
      a->Tc != a->MP * a->P || a->Tq != 1 || a->n_rt != 1 || a->Q > 8)
    return (int)cudaErrorInvalidValue;
  return run<Paged>(a, stream);
}
