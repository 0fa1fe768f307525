// Decode-step attention over the quantized KV cache for NVIDIA Hopper (sm_90a).
//
// Replaces kvquant_tpu/ops/pallas/flash_serial.py:_serial_kernel (the TPU
// kernel behind flash_serial_decode): one layer `li` of the full (L, ...)
// cache arrays, Tq = 1, post-RoPE keys, int4 / int8 / int4x2 code
// containers, K outliers as static channels or slot words, V slot words, an
// exact sink prefix, optional sliding window, per-row positions pos[b].
//
// What bounds it: device-memory bytes. Per live token and layer it must
// read 2*Hkv*D code bytes (int8) or half that (int4 / int4x2), the head
// groups' outlier rows and 8 bytes of V scale/offset. For LLaMA-2-7B's
// speed config (int4, n_kc 16, cap 0, hg 16) that is 4232 B/token/layer.
// At that rate a code must cost the SM about one instruction or the
// instruction issue, not the bytes, becomes the limit.
//
// Two bodies, picked by the host plan (ops/kernels/flash_serial.fs_plan),
// both writing split partials that fs_merge folds with the sink prefix:
//
//  fs_mma (bf16 dots, int4 / int4x2): one wave of blocks, each a
//    contiguous run of 32-token tiles of the live range [lo, pos-S]
//    derived from pos[b] on the device. Each of the 4 warps owns every
//    4th tile of the run and streams it through its own 2-stage ring of
//    TMA bulk copies (K and V codes, V scale / offset, the head's outlier
//    rows), completion counted on one mbarrier per stage; the token loop
//    has no block barrier: each warp keeps its own online softmax (max and
//    sums by shuffles) and the warps meet once, at the end. Codes become
//    bf16 in registers with no conversion: one LOP3 puts two fields of a
//    word into the mantissa of bf16 128.0 (128 + code, exact) and the
//    codes' bias comes off in fp32, once per row. Scores run on
//    mma.sync.m16n8k16 with A = 16 tokens x 16 dims of K codes and B = the
//    folded query rnd(q*k_step), whose dims are staged in the order one
//    LOP3 yields them (i, i+4); P.V with A = V^T (a PRMT pairs two tokens
//    at one dim) and B = P^T, rnd(p * v_scale * vb). Zero term, static
//    channels, slot words and the V offset stay fp32 SIMT at the plain
//    version's rounding points. Four blocks an SM (16 warps) hide the
//    tiles' latency better than deeper rings with fewer warps. The query
//    rows are mma's N: one instance runs 2-8 rows as they are (DBRX's 6,
//    MISTRAL_7B's 4), and fs_merge gives each row a block of its own. At
//    few kv heads the call is bound by latency, not bytes (DBRX, 8 heads
//    over 32K: the rows padded to 8 and one merge block walking them took
//    0.10 ms against a 0.011 ms byte bound, more than half of it in that
//    merge; serial_ablation.py), so the host plan also gives each warp
//    more tiles there (fs_plan's WARP_TILES).
//  fs_partial (fp32 dots, or int8 containers, which do not fit bf16's
//    mantissa): grid = splits x Hkv x B, 128-token tiles double-buffered
//    with cp.async, one token per thread when scoring; codes become floats
//    with one OR into the mantissa of 2^23 and one subtract; the affine
//    codebook and per-channel K scale are folded into the query once per
//    block; all G query rows of a kv head share each decoded element.
//
// Numerics: with dot_bf16 the dot operands (q*k_step, the probabilities
// times the V scale, the outlier values, the sink rows) are rounded to bf16
// and accumulated in fp32, as the TPU kernel's MXU dots do; otherwise all
// fp32. Built without fast-math: slot words are fp32 bit patterns whose
// zero-valued slots are denormals.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "hopper.cuh"

// Field order is mirrored by the ctypes Structure in
// kvquant_tpu_torch/ops/kernels/flash_serial.py.
struct FsArgs {
  const float* q;          // (B, Hkv, G, D) roped queries
  const uint8_t* kp;       // (L, B, Hc, Tc, RB) K code containers
  const uint8_t* vp;       // (L, B, Hc, Tc, RB) V code containers
  const float* kv_out;     // (L, B, NG, J, Tc) outlier rows
  const float* k_range;    // (L, Hkv, D)
  const float* k_offset;   // (L, Hkv, D)
  const float* v_scale;    // (L, B, Tc)
  const float* v_offset;   // (L, B, Tc)
  const float* k_sink;     // (L, B, Hkv, S, D)
  const float* v_sink;     // (L, B, Hkv, S, D)
  const float* k_lut;      // (L, 2**bits)
  const float* v_lut;      // (L, 2**bits)
  const int* pos;          // (B,)
  const int* k_chan;       // (NG, n_kc) group-space channels of layer li
  float* part_m;           // (B, Hkv, NS, G)
  float* part_l;           // (B, Hkv, NS, G)
  float* part_acc;         // (B, Hkv, NS, G, D)
  float* out;              // (B, Hkv, G, D)
  int L, B, Hkv, G, D, Tc, S, J;
  int spk;                 // first V row of kv_out
  int n_kc;                // static K channels per group (0: none)
  int n_kslots, n_vslots;  // live K / V slot rows
  int hg, codes, bits, window, dot_bf16, li, n_split;
  int body;                // BODY_PARTIAL / BODY_MMA (the host plan's route)
  int smem;                // the plan's dynamic shared bytes per block
  float inv;               // 1 / sqrt(D)
};

namespace {

constexpr int TT = 128;      // tokens per tile
constexpr int NT = 128;      // threads per block (one token each when scoring)
constexpr int NW = NT / 32;  // warps per block
constexpr int MAX_KC = 64;   // static K channels per head group
constexpr int MAX_SINK = 64;
constexpr int CODES_INT4 = 0, CODES_INT8 = 1, CODES_INT4X2 = 2;
constexpr int BODY_PARTIAL = 0, BODY_MMA = 1;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Code decoding from a 32-bit word of a container row. The word is first
// XORed with FLIP, which turns each two's-complement field s into s + bias
// (unsigned); OR-ing that into the mantissa of 2^23 and subtracting gives
// the code as an exact float.
template <int CODES>
struct Dec;
template <>
struct Dec<CODES_INT4> {  // signed nibble s = code - 2**(bits-1)
  static constexpr int DPW = 8;
  static constexpr uint32_t FLIP = 0x88888888u;
  __device__ static float get(uint32_t x, int i, int) {
    return __uint_as_float(0x4B000000u | ((x >> (4 * i)) & 0xFu)) - 8388616.0f;
  }
};
template <>
struct Dec<CODES_INT8> {  // signed byte
  static constexpr int DPW = 4;
  static constexpr uint32_t FLIP = 0x80808080u;
  __device__ static float get(uint32_t x, int i, int) {
    return __uint_as_float(0x4B000000u | ((x >> (8 * i)) & 0xFFu)) - 8388736.0f;
  }
};
template <>
struct Dec<CODES_INT4X2> {  // nibble s + 8 = c_even + 4 * c_odd
  static constexpr int DPW = 8;
  static constexpr uint32_t FLIP = 0x88888888u;
  __device__ static float get(uint32_t x, int i, int odd) {
    return __uint_as_float(0x4B000000u | ((x >> (4 * i + 2 * odd)) & 0x3u)) -
           8388608.0f;
  }
};

template <int CODES, int D>
struct Layout {
  static constexpr int RB = (CODES == CODES_INT8) ? D : D / 2;  // row bytes
  static constexpr int CPR = RB / 16;                              // 16B chunks per row
  static constexpr int STRIDE = (CPR % 2 == 0) ? RB + 16 : RB;   // padded smem row
  static constexpr int DPW = Dec<CODES>::DPW;
  static constexpr int WPR = D / DPW;   // 32-bit words per row
  static constexpr int NTS = NT / WPR;  // token subsets in the PV phase
  static constexpr int TILE = TT * STRIDE;
  static_assert(RB % 16 == 0, "container rows must be a multiple of 16 bytes");
  static_assert(NT % WPR == 0, "threads must cover whole rows");
};

template <int CODES, int D, int G>
size_t partial_smem_bytes() {
  using Ly = Layout<CODES, D>;
  return 4 * (size_t)Ly::TILE                 // K, V tiles x 2 stages
         + sizeof(float) * (3 * G * D         // qs, q, vadd
                            + G * TT          // ps
                            + G * NW          // reduction scratch
                            + G)              // zq
         + sizeof(int) * 2 * MAX_KC;          // channel rows / dims
}

// One block: kv head h of batch row b, split s of the live token tiles.
template <int CODES, int D, int G>
__global__ void __launch_bounds__(NT) fs_partial(FsArgs a) {
  using Ly = Layout<CODES, D>;
  using Dc = Dec<CODES>;
  constexpr int DPW = Ly::DPW, WPR = Ly::WPR, NTS = Ly::NTS, CPR = Ly::CPR;
  constexpr int STRIDE = Ly::STRIDE, RB = Ly::RB;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sK = smem;                   // [2][TILE]
  unsigned char* sV = smem + 2 * Ly::TILE;    // [2][TILE]
  float* s_qs = reinterpret_cast<float*>(smem + 4 * Ly::TILE);  // [G][D]
  float* s_q = s_qs + G * D;                  // [G][D]
  float* s_vadd = s_q + G * D;                // [G][D]
  float* s_ps = s_vadd + G * D;               // [G][TT]
  float* s_red = s_ps + G * TT;               // [G][NW]
  float* s_zq = s_red + G * NW;               // [G]
  int* s_chrow = reinterpret_cast<int*>(s_zq + G);  // [MAX_KC]
  int* s_chdim = s_chrow + MAX_KC;                  // [MAX_KC]

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = a.li, Tc = a.Tc, S = a.S;
  const bool bf = a.dot_bf16 != 0;
  const int pos = a.pos[b];

  const size_t bh = (size_t)b * a.Hkv + h;
  float* pm = a.part_m + (bh * a.n_split + s) * G;
  float* pl = a.part_l + (bh * a.n_split + s) * G;
  float* pacc = a.part_acc + (bh * a.n_split + s) * G * D;

  // live packed range [lo, hi] and this split's tiles
  const int hi = pos - S;
  const int lo = a.window > 0 ? max(0, pos - a.window + 1 - S) : 0;
  const int n_tiles = hi < lo ? 0 : hi / TT - lo / TT + 1;
  const int tps = (n_tiles + a.n_split - 1) / a.n_split;
  const int t_begin = lo / TT + s * tps;
  const int t_end = min(lo / TT + n_tiles, t_begin + tps);
  if (n_tiles == 0 || t_begin >= t_end) {
    if (tid < G) {
      pm[tid] = -INFINITY;
      pl[tid] = 0.f;
    }
    for (int i = tid; i < G * D; i += NT) pacc[i] = 0.f;
    return;
  }
  const int ntile = t_end - t_begin;

  const int hg = a.hg, jh = h % hg, grp = h / hg;
  const int paired = CODES == CODES_INT4X2;
  const int hc = paired ? h >> 1 : h, odd = paired ? (h & 1) : 0;
  const int Hc = paired ? a.Hkv / 2 : a.Hkv;
  const unsigned char* gk =
      a.kp + ((((size_t)li * a.B + b) * Hc + hc) * Tc) * RB;
  const unsigned char* gv =
      a.vp + ((((size_t)li * a.B + b) * Hc + hc) * Tc) * RB;
  const float* kvo = a.kv_out + ((((size_t)li * a.B + b) * (a.Hkv / hg) + grp) * a.J) * Tc;
  const float* vsc = a.v_scale + ((size_t)li * a.B + b) * Tc;
  const float* vof = a.v_offset + ((size_t)li * a.B + b) * Tc;

  auto load_tile = [&](int tile, int st) {
    const unsigned char* k0 = gk + (size_t)tile * TT * RB;
    const unsigned char* v0 = gv + (size_t)tile * TT * RB;
    unsigned char* dk = sK + st * Ly::TILE;
    unsigned char* dv = sV + st * Ly::TILE;
    for (int c = tid; c < TT * CPR; c += NT) {
      const int off = (c / CPR) * STRIDE + (c % CPR) * 16;
      cp_async16(dk + off, k0 + (size_t)c * 16);
      cp_async16(dv + off, v0 + (size_t)c * 16);
    }
    cp_async_commit();
  };
  load_tile(t_begin, 0);

  // ---- per-block constants: the affine codebook folded into the query ----
  const int K = 1 << a.bits;
  const float bias = paired ? 0.f : (float)(1 << (a.bits - 1));
  const float* kl = a.k_lut + (size_t)li * K;
  const float* vl = a.v_lut + (size_t)li * K;
  const float kb = (kl[K - 1] - kl[0]) / (float)(K - 1);
  const float ka = kl[0] + bias * kb;
  const float vb = (vl[K - 1] - vl[0]) / (float)(K - 1);
  const float va = vl[0] + bias * vb;

  float zq[G];
#pragma unroll
  for (int g = 0; g < G; ++g) zq[g] = 0.f;
  for (int d = tid; d < D; d += NT) {
    const size_t cidx = ((size_t)li * a.Hkv + h) * D + d;
    const float kr = a.k_range[cidx];
    const float kstep = kb * kr;
    const float kzero = ka * kr + a.k_offset[cidx];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float qv = a.q[(bh * G + g) * D + d];
      s_qs[g * D + d] = rnd(qv * kstep, bf);
      s_q[g * D + d] = rnd(qv, bf);
      s_vadd[g * D + d] = 0.f;
      zq[g] += qv * kzero;
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float v = zq[g];
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) s_red[g * NW + warp] = v;
  }
  __shared__ int s_nch;
  if (tid == 0) {
    int cnt = 0;
    for (int n = 0; n < a.n_kc; ++n) {
      const int ch = a.k_chan[grp * a.n_kc + n];
      if (ch / D == jh) {
        s_chrow[cnt] = n;
        s_chdim[cnt] = ch % D;
        ++cnt;
      }
    }
    s_nch = cnt;
  }
  __syncthreads();
  if (tid < G) {
    float v = 0.f;
    for (int w = 0; w < NW; ++w) v += s_red[tid * NW + w];
    s_zq[tid] = v;
  }
  __syncthreads();
  const int nch = s_nch;

  float m_run[G], l_part[G], o_part[G], acc[G][DPW];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = -INFINITY;
    l_part[g] = 0.f;
    o_part[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPW; ++i) acc[g][i] = 0.f;
  }
  const int dw = tid % WPR, ts = tid / WPR;

  for (int it = 0; it < ntile; ++it) {
    const int st = it & 1;
    if (it + 1 < ntile) {
      load_tile(t_begin + it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- scores: thread tid owns token idx ----
    const int idx = (t_begin + it) * TT + tid;
    const bool valid = idx >= lo && idx <= hi;
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.f;
    const unsigned char* krow = sK + st * Ly::TILE + tid * STRIDE;
#pragma unroll
    for (int c = 0; c < CPR; ++c) {
      const uint4 v4 = *reinterpret_cast<const uint4*>(krow + 16 * c);
      const uint32_t w4[4] = {v4.x ^ Dc::FLIP, v4.y ^ Dc::FLIP, v4.z ^ Dc::FLIP,
                              v4.w ^ Dc::FLIP};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int i = 0; i < DPW; ++i) {
          const float cf = Dc::get(w4[k], i, odd);
          const int d = (c * 4 + k) * DPW + i;
#pragma unroll
          for (int g = 0; g < G; ++g) sc[g] = fmaf(s_qs[g * D + d], cf, sc[g]);
        }
      }
    }
    const float* kvt = kvo + idx;
    for (int n = 0; n < nch; ++n) {  // static K channels of this head
      const float r = rnd(kvt[(size_t)s_chrow[n] * Tc], bf);
      const int dim = s_chdim[n];
#pragma unroll
      for (int g = 0; g < G; ++g) sc[g] = fmaf(s_q[g * D + dim], r, sc[g]);
    }
    for (int k = 0; k < a.n_kslots; ++k) {  // K slot words of this head
      const uint32_t u = __float_as_uint(kvt[(size_t)k * Tc]);
      const int dim = u & 0x7Fu;
      if ((int)((u >> 7) & 0x3u) == jh && dim < D) {
        const float val = rnd(__uint_as_float(u & 0xFFFFFE00u), bf);
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g] = fmaf(s_q[g * D + dim], val, sc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sc[g] = (sc[g] + s_zq[g]) * a.inv;
      float v = valid ? sc[g] : -INFINITY;
      for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == 0) s_red[g * NW + warp] = v;
    }
    __syncthreads();

    // ---- online softmax update (m is uniform over the block) ----
    float alpha[G], p[G];
    const float vs_t = valid ? vsc[idx] : 0.f;
    const float vsc_eff = vs_t * vb;
    const float voff_eff = valid ? vs_t * va + vof[idx] : 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float tmax = s_red[g * NW];
      for (int w = 1; w < NW; ++w) tmax = fmaxf(tmax, s_red[g * NW + w]);
      const float m_new = fmaxf(m_run[g], tmax);
      alpha[g] = m_run[g] == -INFINITY ? 0.f : expf(m_run[g] - m_new);
      m_run[g] = m_new;
      p[g] = valid ? expf(sc[g] - m_new) : 0.f;
      l_part[g] = l_part[g] * alpha[g] + p[g];
      o_part[g] = o_part[g] * alpha[g] + p[g] * voff_eff;
      s_ps[g * TT + tid] = rnd(p[g] * vsc_eff, bf);
    }
    if (valid) {
      for (int k = 0; k < a.n_vslots; ++k) {  // V slot words of this head
        const uint32_t u = __float_as_uint(kvt[(size_t)(a.spk + k) * Tc]);
        const int dim = u & 0x7Fu;
        if ((int)((u >> 7) & 0x3u) == jh && dim < D) {
          const float val = rnd(__uint_as_float(u & 0xFFFFFE00u), bf);
#pragma unroll
          for (int g = 0; g < G; ++g) atomicAdd(&s_vadd[g * D + dim], rnd(p[g], bf) * val);
        }
      }
    }
    __syncthreads();

    // ---- P.V: thread (dw, ts) owns DPW dims of word dw, tokens ts::NTS ----
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < DPW; ++i) acc[g][i] *= alpha[g];
    const unsigned char* vbase = sV + st * Ly::TILE + dw * 4;
#pragma unroll 4
    for (int t = ts; t < TT; t += NTS) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(vbase + t * STRIDE) ^ Dc::FLIP;
      float ps[G];
#pragma unroll
      for (int g = 0; g < G; ++g) ps[g] = s_ps[g * TT + t];
#pragma unroll
      for (int i = 0; i < DPW; ++i) {
        const float cf = Dc::get(w, i, odd);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g][i] = fmaf(ps[g], cf, acc[g][i]);
      }
    }
    if (a.n_vslots > 0 && ts == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < DPW; ++i) {
          float* va_ = &s_vadd[g * D + dw * DPW + i];
          acc[g][i] += *va_;
          *va_ = 0.f;
        }
    }
    __syncthreads();
  }

  // ---- block totals: l and the V offset term over threads, acc over ts ----
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float lv = l_part[g], ov = o_part[g];
    for (int o = 16; o; o >>= 1) {
      lv += __shfl_xor_sync(0xffffffffu, lv, o);
      ov += __shfl_xor_sync(0xffffffffu, ov, o);
    }
    if (lane == 0) {
      s_red[g * NW + warp] = lv;
      s_ps[g * NW + warp] = ov;
    }
  }
  float* s_acc = s_qs;  // the query rows are no longer needed
  for (int r = 0; r < NTS; ++r) {
    if (ts == r) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < DPW; ++i) {
          float* dst = &s_acc[g * D + dw * DPW + i];
          *dst = (r == 0 ? 0.f : *dst) + acc[g][i];
        }
    }
    __syncthreads();
  }
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    float ov = 0.f;
    for (int w = 0; w < NW; ++w) ov += s_ps[g * NW + w];
    pacc[i] = s_acc[i] + ov;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (tid == g) {
      float lv = 0.f;
      for (int w = 0; w < NW; ++w) lv += s_red[g * NW + w];
      pm[g] = m_run[g];
      pl[g] = lv;
    }
  }
}

// One block per (kv head, batch row, query row g = blockIdx.z): the sink
// prefix and every split's partial merged by log-sum-exp, then 1/l. The
// splits' maxima and weights are formed in parallel (one split per thread)
// so the loads of the partial accumulators are independent and overlap.
// The rows of a head run on blocks of their own: at few kv heads and many
// splits (DBRX: 8 heads, G 6, 66 splits) one block walking every row took
// most of the call.
__global__ void __launch_bounds__(NT) fs_merge(FsArgs a) {
  extern __shared__ float s_w[];  // [n_split] split weights
  __shared__ float red[NW];
  __shared__ float s_sc[MAX_SINK];
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int lane = d & 31, warp = d >> 5;
  const int G = a.G, D = a.D, S = a.S, NS = a.n_split;
  const bool bf = a.dot_bf16 != 0;
  const int pos = a.pos[b];
  const size_t bh = (size_t)b * a.Hkv + h;
  const float* ks = a.k_sink + ((((size_t)a.li * a.B + b) * a.Hkv + h) * S) * D;
  const float* vs = a.v_sink + ((((size_t)a.li * a.B + b) * a.Hkv + h) * S) * D;

  const int g = blockIdx.z;  // the query row
  const float* qg = a.q + (bh * G + g) * D;
  // sink scores: warp w takes sink rows w, w + NW, ...
  for (int k = warp; k < S; k += NW) {
    float v = 0.f;
    for (int e = lane; e < D; e += 32) v += rnd(qg[e], bf) * rnd(ks[k * D + e], bf);
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) s_sc[k] = v * a.inv;
  }
  // split maxima (one split per thread), then the block maximum
  float mloc = -INFINITY;
  for (int sp = d; sp < NS; sp += NT) mloc = fmaxf(mloc, a.part_m[(bh * NS + sp) * G + g]);
  for (int o = 16; o; o >>= 1) mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o));
  if (lane == 0) red[warp] = mloc;
  __syncthreads();
  float m0 = -INFINITY;  // sink maximum
  for (int k = 0; k < S; ++k)
    if (k <= pos && (a.window <= 0 || k > pos - a.window)) m0 = fmaxf(m0, s_sc[k]);
  float M = m0;
  for (int w = 0; w < NW; ++w) M = fmaxf(M, red[w]);
  __syncthreads();  // red is reused below
  // split weights and their share of l
  float lloc = 0.f;
  for (int sp = d; sp < NS; sp += NT) {
    const size_t pi = (bh * NS + sp) * G + g;
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
  for (int k = 0; k < S; ++k) {
    const bool ok = k <= pos && (a.window <= 0 || k > pos - a.window);
    const float pk = ok ? expf(s_sc[k] - m0) : 0.f;
    const float ck = m0 == -INFINITY ? 0.f : expf(m0 - M);
    l += pk * ck;
    if (d < D) acc = fmaf(rnd(pk, bf) * ck, rnd(vs[k * D + d], bf), acc);
  }
  if (d < D) {
    const float* pacc = a.part_acc + (bh * NS * G + g) * D + d;
    // 16 loads in flight: at 66 splits their chain set the time
#pragma unroll 16
    for (int sp = 0; sp < NS; ++sp) acc = fmaf(pacc[(size_t)sp * G * D], s_w[sp], acc);
    a.out[(bh * G + g) * D + d] = acc / l;
  }
}

// ---------------------------------------------------------------------------
// fs_mma: the tensor-core body (bf16 dots, int4 / int4x2)
// ---------------------------------------------------------------------------

constexpr int MT = 32;            // tokens per tile (one warp step)
constexpr int MSTAGES = 2;        // ring stages per warp
constexpr int MW = 4;             // warps per block
constexpr int MNT = MW * 32;      // threads per block
constexpr int MMA_MIN_BLOCKS = 4; // __launch_bounds__: <= 128 registers
constexpr int KC_STAGED = 4;      // static K channel rows staged per tile
constexpr int PS = MT + 8;        // bf16 stride of a row of a warp's P tile
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }
// K rows a tile stages: the head's first KC_STAGED static channels (the
// rest are read from device memory where scored) or the K slot rows.
__host__ __device__ inline int mma_k_rows(const FsArgs& a) {
  return a.n_kc > 0 ? (a.n_kc < KC_STAGED ? a.n_kc : KC_STAGED) : a.n_kslots;
}
__host__ __device__ inline int mma_stage_bytes(const FsArgs& a) {
  // K codes, V codes, V scale and offset, staged outlier rows
  return 2 * MT * (a.D / 2) + 8 * MT + 4 * MT * (mma_k_rows(a) + a.n_vslots);
}
__host__ __device__ inline int mma_ring_bytes(const FsArgs& a) {
  // the ring, which also holds the warp's partial (acc, m, l, o) at the end
  const int ring = MSTAGES * mma_stage_bytes(a);
  const int part = 4 * (a.G * a.D + 3 * a.G);
  return round16(ring > part ? ring : part);
}
__host__ __device__ inline int mma_warp_bytes(const FsArgs& a) {
  return mma_ring_bytes(a)
         + round16(8 * PS * 2)                          // P tile (bf16)
         + 32                                           // stage mbarriers
         + (a.n_vslots ? 4 * a.G * a.D : 0)             // V slot sums
         + round16(4 * a.n_kc * (2 + a.G));             // channel list
}
inline int mma_smem_bytes(const FsArgs& a) { return MW * mma_warp_bytes(a); }

// Codes as bf16 with their bias left in: one LOP3 takes two fields of a
// word, (x & MASK) ^ XV, into the mantissa of bf16 128.0 and flips the
// container's sign bit where it lies in the field (XV = 0x4300 | flip, per
// half), which gives the exact pair (128 + u_j, 128 + u_{j+4}) with u = s +
// BIAS. The products with bf16 operands are exact; the bias is taken off
// in fp32 once per row: BIAS * sum(B) from the scores (the zero term) and
// BIAS * sum(P) from the P.V sums.
template <int CODES>
struct Bf;
template <>
struct Bf<CODES_INT4> {  // nibble s (two's complement): u = s + 8
  static constexpr uint32_t MASK = 0x000F000Fu;
  static constexpr float BIAS = 136.f;  // 128 + 8
  __device__ static uint32_t xv(int) { return 0x43084308u; }
  __device__ static uint32_t word(uint32_t w, int) { return w; }
};
template <>
struct Bf<CODES_INT4X2> {  // nibble s + 8 = c_even + 4 c_odd: u = c
  static constexpr uint32_t MASK = 0x00030003u;
  static constexpr float BIAS = 128.f;
  __device__ static uint32_t xv(int odd) { return odd ? 0x43024302u : 0x43004300u; }
  __device__ static uint32_t word(uint32_t w, int odd) { return w >> (2 * odd); }
};

// the bf16 pair (field j, field j + 4) of a word prepared by Bf::word
template <int CODES>
__device__ __forceinline__ uint32_t bpair(uint32_t x, int j, uint32_t xv) {
  uint32_t v;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;"
      : "=r"(v) : "r"(x >> (4 * j)), "r"(Bf<CODES>::MASK), "r"(xv));
  return v;
}
template <int N>
__device__ __forceinline__ void ld_words(const unsigned char* p, uint32_t (&w)[N]) {
  if constexpr (N == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (N == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}
// a thread's D/16 bytes of a V row (its D/8 dims), as words
template <int D>
__device__ __forceinline__ void ld_vbytes(const unsigned char* p,
                                          uint32_t (&w)[D >= 64 ? D / 64 : 1]) {
  if constexpr (D == 128) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (D == 64) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
}

// One block: kv head h of batch row b, split s of the live 32-token tiles.
// Thread (gr = lane / 4, tq = lane % 4) of a warp holds, in the mma
// fragments, scores of tokens gr and gr + 8 of each 16-token row tile for
// query rows g = 2tq, 2tq + 1, and the output dims DPT*gr + e*NMT + mt
// (e 0/1, mt < NMT) of the same two query rows. Scores and maxima are kept
// in log2 units (the 1/sqrt(D) scale times log2 e), so exponentials are
// exp2f; the partial's maximum is written back in natural units.
// Instances: GI = 1 (one query row, the count known at compile time) and
// GI = 8, which runs a.G = 2..8 rows as they are: the rows are mma's N,
// so rows past G cost the tensor cores nothing and are masked (g0, g1,
// the zero B columns), and no caller pads them.
template <int CODES, int D, int GI>
__global__ void __launch_bounds__(MNT, MMA_MIN_BLOCKS) fs_mma(FsArgs a) {
  const int G = GI == 1 ? 1 : a.G;  // query rows per kv head
  constexpr int RB = D / 2;            // container row bytes
  constexpr int WPT = D / 32;          // K words per thread per token
  constexpr int NMT = D / 16;          // k-steps of a score, dim tiles of P.V
  constexpr int DPT = D / 8;           // output dims per thread
  constexpr int NCH = D / 32;          // 2-byte V chunks per thread per token
  constexpr int NVW = D >= 64 ? D / 64 : 1;
  constexpr int RT = MT / 16;          // row tiles per tile

  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int li = a.li, Tc = a.Tc, S = a.S;
  const int pos = a.pos[b];

  const size_t bh = (size_t)b * a.Hkv + h;
  float* pm = a.part_m + (bh * a.n_split + s) * G;
  float* pl = a.part_l + (bh * a.n_split + s) * G;
  float* pacc = a.part_acc + (bh * a.n_split + s) * G * D;

  // live packed range [lo, hi]; split s takes tiles [t_begin, t_end), an
  // even share: every split holds a tile when there are n_split of them
  const int hi = pos - S;
  const int lo = a.window > 0 ? max(0, pos - a.window + 1 - S) : 0;
  const int n_t = hi < lo ? 0 : hi / MT - lo / MT + 1;
  const int t_begin = lo / MT + (int)(((long long)s * n_t) / a.n_split);
  const int t_end = lo / MT + (int)(((long long)(s + 1) * n_t) / a.n_split);
  if (t_begin >= t_end) {
    if (threadIdx.x < G) {
      pm[threadIdx.x] = -INFINITY;
      pl[threadIdx.x] = 0.f;
    }
    for (int i = threadIdx.x; i < G * D; i += MNT) pacc[i] = 0.f;
    return;
  }

  // ---- this warp's shared memory ----
  const int stage = mma_stage_bytes(a);
  const int ring_bytes = mma_ring_bytes(a);
  const int nrk = mma_k_rows(a);
  unsigned char* ring = smem + warp * mma_warp_bytes(a);
  uint16_t* sP = reinterpret_cast<uint16_t*>(ring + ring_bytes);  // [8][PS]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + ring_bytes + round16(8 * PS * 2));
  float* s_vadd = reinterpret_cast<float*>(bars + 4);               // [G][D]
  int* s_chrow = reinterpret_cast<int*>(s_vadd + (a.n_vslots ? G * D : 0));
  int* s_chdim = s_chrow + a.n_kc;
  float* s_cq = reinterpret_cast<float*>(s_chdim + a.n_kc);  // [n_kc][G]

  const int hg = a.hg, jh = h % hg, grp = h / hg;
  const int paired = CODES == CODES_INT4X2;
  const int hc = paired ? h >> 1 : h, odd = paired ? (h & 1) : 0;
  const int Hc = paired ? a.Hkv / 2 : a.Hkv;
  const unsigned char* gk = a.kp + ((((size_t)li * a.B + b) * Hc + hc) * Tc) * RB;
  const unsigned char* gv = a.vp + ((((size_t)li * a.B + b) * Hc + hc) * Tc) * RB;
  const float* kvo = a.kv_out + ((((size_t)li * a.B + b) * (a.Hkv / hg) + grp) * a.J) * Tc;
  const float* vsc = a.v_scale + ((size_t)li * a.B + b) * Tc;
  const float* vof = a.v_offset + ((size_t)li * a.B + b) * Tc;
  const float* qh = a.q + bh * G * D;

  // ---- per-warp setup: the head's static channels (ballot-compacted) ----
  int nch = 0;
  for (int base = 0; base < a.n_kc; base += 32) {
    const int n = base + lane;
    const int ch = n < a.n_kc ? a.k_chan[grp * a.n_kc + n] : -1;
    const bool mine = n < a.n_kc && ch / D == jh;
    const unsigned vote = __ballot_sync(FULL, mine);
    if (mine) {
      const int at = nch + __popc(vote & ((1u << lane) - 1u));
      s_chrow[at] = n;
      s_chdim[at] = ch % D;
    }
    nch += __popc(vote);
  }
  for (int i = lane; i < 8 * PS / 2; i += 32) reinterpret_cast<uint32_t*>(sP)[i] = 0u;
  if (a.n_vslots)
    for (int i = lane; i < G * D; i += 32) s_vadd[i] = 0.f;
  const int nst = a.n_kc > 0 ? min(nch, nrk) : 0;        // staged channel rows
  const int nrk_load = a.n_kc > 0 ? nst : nrk;            // staged K rows
  const int nload = nrk_load + a.n_vslots;
  const uint32_t tile_bytes = 2 * MT * RB + 4 * MT * (2 + nload);
  if (lane == 0) {
    for (int i = 0; i < MSTAGES; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();  // the channel list and the barriers are read by every lane

  // tile copies (lane 0): the warp's k-th tile is t_begin + warp + k * MW,
  // one TMA bulk copy per array, completion counted on the stage barrier
  const int my_n = (t_end - t_begin - warp + MW - 1) / MW;
  auto issue = [&](int k) {
    if (k < my_n) {
      const int t0 = (t_begin + warp + k * MW) * MT;
      unsigned char* st = ring + (k % MSTAGES) * stage;
      uint64_t* bar = &bars[k % MSTAGES];
      mbar_expect_tx(bar, tile_bytes);
      bulk_g2s(st, gk + (size_t)t0 * RB, MT * RB, bar);
      bulk_g2s(st + MT * RB, gv + (size_t)t0 * RB, MT * RB, bar);
      float* fv = reinterpret_cast<float*>(st + 2 * MT * RB);
      bulk_g2s(fv, vsc + t0, MT * 4, bar);
      bulk_g2s(fv + MT, vof + t0, MT * 4, bar);
#pragma unroll 1
      for (int r = 0; r < nload; ++r) {
        const int slot = r < nrk_load ? r : nrk + (r - nrk_load);
        const int row = r < nrk_load ? (a.n_kc > 0 ? s_chrow[r] : r)
                                     : a.spk + (r - nrk_load);
        bulk_g2s(fv + (2 + slot) * MT, kvo + (size_t)row * Tc + t0, MT * 4, bar);
      }
    }
  };
  if (lane == 0)
    for (int k = 0; k < MSTAGES - 1; ++k) issue(k);
  // the channels' rounded query entries, while the first tiles arrive
  for (int i = lane; i < nch * G; i += 32)
    s_cq[i] = rnd(qh[(i % G) * D + s_chdim[i / G]], true);
  __syncwarp();

  // ---- the affine codebook folded into the query (overlaps the copies) ----
  const int K = 1 << a.bits;
  const float bias = paired ? 0.f : (float)(1 << (a.bits - 1));
  const float* kl = a.k_lut + (size_t)li * K;
  const float* vl = a.v_lut + (size_t)li * K;
  const float kb = (kl[K - 1] - kl[0]) / (float)(K - 1);
  const float ka = kl[0] + bias * kb;
  const float vb = (vl[K - 1] - vl[0]) / (float)(K - 1);
  const float va = vl[0] + bias * vb;
  const float* krg = a.k_range + ((size_t)li * a.Hkv + h) * D;
  const float* kof = a.k_offset + ((size_t)li * a.Hkv + h) * D;
  const float scale = a.inv * LOG2E;

  // B fragments of the scores: k-step 2j + e takes dims d, d + 4 (b0) and
  // d + 1, d + 5 (b1), d = 8 (WPT tq + j) + 2e, the pairs bpair yields
  uint32_t qb[NMT][2];
#pragma unroll
  for (int kk = 0; kk < NMT; ++kk) {
    const int d = 8 * (WPT * tq + kk / 2) + 2 * (kk % 2);
    if (gr < G) {
      const float* qg = qh + gr * D;
      qb[kk][0] = bf2(qg[d] * (kb * krg[d]), qg[d + 4] * (kb * krg[d + 4]));
      qb[kk][1] = bf2(qg[d + 1] * (kb * krg[d + 1]), qg[d + 5] * (kb * krg[d + 5]));
    } else {
      qb[kk][0] = qb[kk][1] = 0u;
    }
  }
  // the zero term sum_d q k_zero (fp32) of the thread's two query rows,
  // less the codes' bias times the sum of the folded query's bf16 entries
  const uint32_t xv = Bf<CODES>::xv(odd);
  float z0 = 0.f, z1 = 0.f;
#pragma unroll
  for (int g = 0; g < GI; ++g) {  // unrolled to the instance's rows: the
    if (g < G) {                  // rows' loads overlap
      float v = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float qd = qh[g * D + d];
        v += qd * (ka * krg[d] + kof[d]);
        v -= Bf<CODES>::BIAS * __bfloat162float(__float2bfloat16_rn(qd * (kb * krg[d])));
      }
      for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
      if (g == 2 * tq) z0 = v;
      if (g == 2 * tq + 1) z1 = v;
    }
  }
  const bool g0 = 2 * tq < G, g1 = 2 * tq + 1 < G;

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, o0 = 0.f, o1 = 0.f;
  float ps0 = 0.f, ps1 = 0.f;  // sums of the bf16 P entries (the V bias)
  float acc[NMT][4];
#pragma unroll
  for (int mt = 0; mt < NMT; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[mt][r] = 0.f;

  for (int k = 0; k < my_n; ++k) {
    // the stage of tile k - 1 was released by the __syncwarp ending it
    if (lane == 0) issue(k + MSTAGES - 1);
    mbar_wait(&bars[k % MSTAGES], (k / MSTAGES) & 1);
    const unsigned char* st = ring + (k % MSTAGES) * stage;
    const unsigned char* sK = st;
    const unsigned char* sV = st + MT * RB;
    const float* svs = reinterpret_cast<const float*>(st + 2 * MT * RB);
    const float* svo = svs + MT;
    const float* srow = svo + MT;
    const int t0 = (t_begin + warp + k * MW) * MT;

    // ---- scores: A = 16 tokens x 16 dims of K codes, B = folded query ----
    float sc[RT][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[rt][r] = 0.f;
      uint32_t w0[WPT], w8[WPT];
      ld_words<WPT>(sK + (16 * rt + gr) * RB + 4 * WPT * tq, w0);
      ld_words<WPT>(sK + (16 * rt + gr + 8) * RB + 4 * WPT * tq, w8);
#pragma unroll
      for (int j = 0; j < WPT; ++j) {
        const uint32_t x0 = Bf<CODES>::word(w0[j], odd), x8 = Bf<CODES>::word(w8[j], odd);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t fa[4] = {bpair<CODES>(x0, 2 * e, xv), bpair<CODES>(x8, 2 * e, xv),
                                  bpair<CODES>(x0, 2 * e + 1, xv), bpair<CODES>(x8, 2 * e + 1, xv)};
          mma16816(sc[rt], fa, qb[2 * j + e][0], qb[2 * j + e][1]);
        }
      }
    }

    // ---- fp32 terms at the plain version's rounding points ----
    // the thread's tokens: tl = 16 rt + gr + 8 half, fragment entries
    // sc[rt][2 half] (row 2tq) and sc[rt][2 half + 1] (row 2tq + 1)
    if (g0) {
      auto add_row = [&](const float* row, float c0, float c1) {
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float r = rnd(row[16 * rt + gr + 8 * half], true);
            sc[rt][2 * half] = fmaf(c0, r, sc[rt][2 * half]);
            sc[rt][2 * half + 1] = fmaf(c1, r, sc[rt][2 * half + 1]);
          }
      };
      // static K channels: staged rows, then any beyond KC_STAGED in place
#pragma unroll 1
      for (int n = 0; n < nch; ++n)
        add_row(n < nst ? srow + n * MT : kvo + (size_t)s_chrow[n] * Tc + t0,
                s_cq[n * G + 2 * tq], g1 ? s_cq[n * G + 2 * tq + 1] : 0.f);
#pragma unroll 1
      for (int kq = 0; kq < a.n_kslots; ++kq) {  // K slot words
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t u = __float_as_uint(srow[kq * MT + 16 * rt + gr + 8 * half]);
            const int dim = u & 0x7Fu;
            if ((int)((u >> 7) & 0x3u) == jh && dim < D) {
              const float val = rnd(__uint_as_float(u & 0xFFFFFE00u), true);
              sc[rt][2 * half] = fmaf(rnd(qh[2 * tq * D + dim], true), val, sc[rt][2 * half]);
              if (g1)
                sc[rt][2 * half + 1] =
                    fmaf(rnd(qh[(2 * tq + 1) * D + dim], true), val, sc[rt][2 * half + 1]);
            }
          }
      }
    }

    // ---- scale, mask; the warp's running maximum (log2 units) ----
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int idx = t0 + 16 * rt + gr + 8 * half;
        const bool valid = idx >= lo && idx <= hi;
        const float s0 = valid ? (sc[rt][2 * half] + z0) * scale : -INFINITY;
        const float s1 = valid ? (sc[rt][2 * half + 1] + z1) * scale : -INFINITY;
        sc[rt][2 * half] = s0;
        sc[rt][2 * half + 1] = s1;
        mx0 = fmaxf(mx0, s0);
        mx1 = fmaxf(mx1, s1);
      }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = m0 == -INFINITY ? 0.f : exp2f(m0 - mn0);
    const float al1 = m1 == -INFINITY ? 0.f : exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0; l1 *= al1; o0 *= al0; o1 *= al1; ps0 *= al0; ps1 *= al1;

    // ---- probabilities: l, the V offset term, P^T as bf16 ----
    float p[RT][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int tl = 16 * rt + gr + 8 * half;
        const bool valid = t0 + tl >= lo && t0 + tl <= hi;
        const float p0 = valid ? exp2f(sc[rt][2 * half] - mn0) : 0.f;
        const float p1 = valid ? exp2f(sc[rt][2 * half + 1] - mn1) : 0.f;
        p[rt][2 * half] = p0;
        p[rt][2 * half + 1] = p1;
        const float vs_t = valid ? svs[tl] : 0.f;
        const float voff = valid ? vs_t * va + svo[tl] : 0.f;
        l0 += p0; l1 += p1;
        o0 = fmaf(p0, voff, o0);
        o1 = fmaf(p1, voff, o1);
        const float ve = vs_t * vb;
        const __nv_bfloat16 b0 = __float2bfloat16_rn(p0 * ve), b1 = __float2bfloat16_rn(p1 * ve);
        ps0 += __bfloat162float(b0);
        ps1 += __bfloat162float(b1);
        if (g0) sP[2 * tq * PS + tl] = __bfloat16_as_ushort(b0);
        if (g1) sP[(2 * tq + 1) * PS + tl] = __bfloat16_as_ushort(b1);
      }
    if (a.n_vslots && g0) {  // V slot words: rnd(p) rnd(value) at their dim
#pragma unroll 1
      for (int v = 0; v < a.n_vslots; ++v) {
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t u = __float_as_uint(srow[(nrk + v) * MT + 16 * rt + gr + 8 * half]);
            const int dim = u & 0x7Fu;
            if ((int)((u >> 7) & 0x3u) == jh && dim < D) {
              const float val = rnd(__uint_as_float(u & 0xFFFFFE00u), true);
              atomicAdd(&s_vadd[2 * tq * D + dim], rnd(p[rt][2 * half], true) * val);
              if (g1)
                atomicAdd(&s_vadd[(2 * tq + 1) * D + dim], rnd(p[rt][2 * half + 1], true) * val);
            }
          }
      }
    }
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) {
      acc[mt][0] *= al0; acc[mt][1] *= al1;
      acc[mt][2] *= al0; acc[mt][3] *= al1;
    }
    __syncwarp();

    // ---- P.V: A = V^T (16 dims x 16 tokens), B = P^T (16 tokens x 8) ----
#pragma unroll
    for (int kk = 0; kk < RT; ++kk) {
      const int tb = 16 * kk + 2 * tq;
      const uint32_t pb0 = *reinterpret_cast<const uint32_t*>(sP + gr * PS + tb);
      const uint32_t pb1 = *reinterpret_cast<const uint32_t*>(sP + gr * PS + tb + 8);
      uint32_t v0[NVW], v1[NVW], v8[NVW], v9[NVW];
      ld_vbytes<D>(sV + (tb + 0) * RB + (D / 16) * gr, v0);
      ld_vbytes<D>(sV + (tb + 1) * RB + (D / 16) * gr, v1);
      ld_vbytes<D>(sV + (tb + 8) * RB + (D / 16) * gr, v8);
      ld_vbytes<D>(sV + (tb + 9) * RB + (D / 16) * gr, v9);
      uint32_t fa[NMT][4];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const uint32_t sel = (c & 1) ? 0x7632u : 0x5410u;
        const uint32_t xl = Bf<CODES>::word(__byte_perm(v0[c >> 1], v1[c >> 1], sel), odd);
        const uint32_t xh = Bf<CODES>::word(__byte_perm(v8[c >> 1], v9[c >> 1], sel), odd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kd = 4 * c + j, mt = kd % NMT, e = kd / NMT;
          fa[mt][e] = bpair<CODES>(xl, j, xv);
          fa[mt][2 + e] = bpair<CODES>(xh, j, xv);
        }
      }
#pragma unroll
      for (int mt = 0; mt < NMT; ++mt) mma16816(acc[mt], fa[mt], pb0, pb1);
    }
    if (a.n_vslots) {  // fold this tile's V slot sums into the fragments
      __syncwarp();
#pragma unroll
      for (int mt = 0; mt < NMT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int g = 2 * tq + (r & 1), dim = DPT * gr + (r >> 1) * NMT + mt;
          if (g < G) {
            acc[mt][r] += s_vadd[g * D + dim];
            s_vadd[g * D + dim] = 0.f;
          }
        }
    }
    __syncwarp();  // the stage and the P tile are free for the next tile
  }

  // ---- the warp's partial into its ring, then one merge over the warps ----
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, o);
    l1 += __shfl_xor_sync(FULL, l1, o);
    o0 += __shfl_xor_sync(FULL, o0, o);
    o1 += __shfl_xor_sync(FULL, o1, o);
    ps0 += __shfl_xor_sync(FULL, ps0, o);
    ps1 += __shfl_xor_sync(FULL, ps1, o);
  }
  float* W = reinterpret_cast<float*>(ring);  // [G][D] acc, m[G], l[G], o[G]
#pragma unroll
  for (int mt = 0; mt < NMT; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int g = 2 * tq + (r & 1);
      if (g < G)
        W[g * D + DPT * gr + (r >> 1) * NMT + mt] =
            acc[mt][r] - Bf<CODES>::BIAS * ((r & 1) ? ps1 : ps0);
    }
  if (gr == 0) {
    if (g0) {
      W[G * D + 2 * tq] = m0;
      W[G * D + G + 2 * tq] = l0;
      W[G * D + 2 * G + 2 * tq] = o0;
    }
    if (g1) {
      W[G * D + 2 * tq + 1] = m1;
      W[G * D + G + 2 * tq + 1] = l1;
      W[G * D + 2 * G + 2 * tq + 1] = o1;
    }
  }
  __syncthreads();
  const int wstride = mma_warp_bytes(a) / 4;
  const float* W0 = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < G * D + G; i += MNT) {
    const int g = i < G * D ? i / D : i - G * D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < MW; ++w) M = fmaxf(M, W0[w * wstride + G * D + g]);
    float v = 0.f, lv = 0.f;
#pragma unroll
    for (int w = 0; w < MW; ++w) {
      const float* Ww = W0 + w * wstride;
      const float mw = Ww[G * D + g];
      const float sw = mw == -INFINITY ? 0.f : exp2f(mw - M);
      if (i < G * D) v = fmaf(sw, Ww[i] + Ww[G * D + 2 * G + g], v);
      else lv = fmaf(sw, Ww[G * D + G + g], lv);
    }
    if (i < G * D) {
      pacc[i] = v;
    } else {
      pm[g] = M / LOG2E;  // natural units, as fs_merge and fs_partial
      pl[g] = lv;
    }
  }
}

template <int CODES, int D, int G>
cudaError_t launch_partial(const FsArgs& a, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = partial_smem_bytes<CODES, D, G>();
  if ((size_t)a.smem != smem) return cudaErrorInvalidValue;  // plan and layout differ
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(fs_partial<CODES, D, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  fs_partial<CODES, D, G><<<dim3(a.n_split, a.Hkv, a.B), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int CODES, int D, int GI>
cudaError_t launch_mma(const FsArgs& a, cudaStream_t stream) {
  static int configured = 0;
  const int smem = mma_smem_bytes(a);
  if (a.smem != smem || !a.dot_bf16) return cudaErrorInvalidValue;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(fs_mma<CODES, D, GI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  fs_mma<CODES, D, GI><<<dim3(a.n_split, a.Hkv, a.B), MNT, smem, stream>>>(a);
  return cudaGetLastError();
}

// fs_mma: its one-row instance, or the instance of 2-8 rows at run time;
// fs_partial: its instances of 1 / 2 / 4 / 8 rows (the host pads to them)
template <int CODES, int D>
cudaError_t dispatch_g(const FsArgs& a, cudaStream_t st) {
  if (a.body == BODY_MMA) {
    if constexpr (CODES != CODES_INT8) {
      if (a.G == 1) return launch_mma<CODES, D, 1>(a, st);
      if (a.G >= 2 && a.G <= 8) return launch_mma<CODES, D, 8>(a, st);
    }
    return cudaErrorInvalidValue;
  }
  if (a.body != BODY_PARTIAL) return cudaErrorInvalidValue;
  switch (a.G) {
    case 1: return launch_partial<CODES, D, 1>(a, st);
    case 2: return launch_partial<CODES, D, 2>(a, st);
    case 4: return launch_partial<CODES, D, 4>(a, st);
    case 8: return launch_partial<CODES, D, 8>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <int CODES>
cudaError_t dispatch_d(const FsArgs& a, cudaStream_t st) {
  switch (a.D) {
    case 32: return dispatch_g<CODES, 32>(a, st);
    case 64: return dispatch_g<CODES, 64>(a, st);
    case 128: return dispatch_g<CODES, 128>(a, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches the plan's body (a.body) and the merge kernel on `stream`.
// Returns the cudaError_t of the launches (0 on success; a plan whose
// shared-memory count a.smem differs from the body's layout is refused
// with cudaErrorInvalidValue before anything runs); nothing is
// synchronised.
extern "C" int fs_decode(const FsArgs* a, void* stream) {
  if (a->S > MAX_SINK || a->n_kc > MAX_KC) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (a->codes) {
    case CODES_INT4: e = dispatch_d<CODES_INT4>(*a, st); break;
    case CODES_INT8: e = dispatch_d<CODES_INT8>(*a, st); break;
    case CODES_INT4X2: e = dispatch_d<CODES_INT4X2>(*a, st); break;
  }
  if (e != cudaSuccess) return (int)e;
  fs_merge<<<dim3(a->Hkv, a->B, a->G), NT, a->n_split * sizeof(float), st>>>(*a);
  return (int)cudaGetLastError();
}
