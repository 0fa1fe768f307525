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
// groups' outlier rows and 8 bytes of V scale/offset, and it does ~4
// flops per code it reads, far below the ~20 flops/byte the card can
// sustain in fp32. For LLaMA-2-7B's speed config (int4, n_kc 16, cap 0,
// hg 16) that is 4232 B/token/layer.
//
// What the design does about it:
//  - the token axis is split across blocks (grid = splits x Hkv x B); each
//    block derives its share of the LIVE range [lo, pos-S] from pos[b] on
//    the device, so cost tracks the filled prefix, not the capacity, and a
//    batch of one still fills the 132 SMs; a second small kernel merges the
//    (m, l, acc) partials with the sink prefix (log-sum-exp merge);
//  - 128-token tiles of K and V codes are copied into shared memory with
//    cp.async, double-buffered, so the next tile's loads run under the
//    current tile's arithmetic; rows are padded to an odd number of 16-byte
//    units so the per-token row reads are free of bank conflicts;
//  - codes become floats with one OR into the mantissa of 2^23 and one
//    subtract (no int-to-float conversions); the affine codebook and the
//    per-channel K scale are folded into the query once per block, so a K
//    code costs one fma per query row;
//  - all G query rows of a kv head share each decoded K/V element (GQA).
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
  float inv;               // 1 / sqrt(D)
};

namespace {

constexpr int TT = 128;      // tokens per tile
constexpr int NT = 128;      // threads per block (one token each when scoring)
constexpr int NW = NT / 32;  // warps per block
constexpr int MAX_KC = 64;   // static K channels per head group
constexpr int MAX_SINK = 64;
constexpr int CODES_INT4 = 0, CODES_INT8 = 1, CODES_INT4X2 = 2;

__device__ __forceinline__ float rnd(float x, bool bf) {
  return bf ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

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

// One block per (kv head, batch row): the sink prefix and every split's
// partial merged by log-sum-exp, then 1/l. The splits' maxima and weights
// are formed in parallel (one split per thread) so the loads of the
// partial accumulators are independent and overlap.
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

  for (int g = 0; g < G; ++g) {
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
#pragma unroll 4
      for (int sp = 0; sp < NS; ++sp) acc = fmaf(pacc[(size_t)sp * G * D], s_w[sp], acc);
      a.out[(bh * G + g) * D + d] = acc / l;
    }
    __syncthreads();  // s_sc, s_w and red are rewritten for the next row
  }
}

template <int CODES, int D, int G>
cudaError_t launch_partial(const FsArgs& a, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = partial_smem_bytes<CODES, D, G>();
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

template <int CODES, int D>
cudaError_t dispatch_g(const FsArgs& a, cudaStream_t st) {
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

// Launches the split kernel and the merge kernel on `stream`. Returns the
// cudaError_t of the launches (0 on success); nothing is synchronised.
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
  fs_merge<<<dim3(a->Hkv, a->B), NT, a->n_split * sizeof(float), st>>>(*a);
  return (int)cudaGetLastError();
}
