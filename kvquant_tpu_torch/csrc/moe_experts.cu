// The expert products of the MoE family's capacity dispatch at decode
// sizes (kvquant_tpu_torch/models/moe.py: moe_ffn_sparse, through
// ops/kernels/moe_experts.py), for sm_90a.
//
// It replaces no TPU kernel. The JAX package computes its dispatch with
// one-hot einsums over (N, E, C) (kvquant_tpu/models/moe.py:113-152) and
// leaves the products to XLA; at decode C = min(N, ...) = 1, so every one
// of the E experts computes one row and every expert's weights are read.
// Here the rows of each expert's capacity slots come in gathered, with
// count (E,) int32, the live slots of each expert: only the routed
// experts' weights are read, and no count goes to the host, so a CUDA
// graph captures the call.
//
// Two kernels, run one after the other, over the capacity rows c < C <= 8:
//   moe_glu:  a[e, c, :] = silu(x[e, c, :] . W_gate[e]) * (x[e, c, :] . W_up[e])
//   moe_down: y[e, c, :] = a[e, c, :] . W_down[e] for c < count[e], else 0
// moe_down writes y's zeros for a dead expert, so y is defined everywhere;
// moe_glu leaves a dead expert's a unwritten (moe_down does not read it).
//
// Bound: bytes. The work is a product of C <= 8 rows with each live
// expert's (K, N) weight matrices, about 2 C operations per weight byte at
// bf16, far below the ~295 operations a byte at which the H100's tensor
// cores, and not its 3.35 TB/s, become the limit. DBRX's decode step at 16
// rows (C 8, nearly all 16 experts live) reads 3 x 6144 x 10752 x 2 B an
// expert and layer: 15.1 ms a step of 8 layers at 3.35 TB/s.
//
// Two bodies, picked by the host (ops/kernels/moe_experts.py: body):
//
//  mma (bf16 at C 2-8): moe_glu_mma, moe_down_mma. Persistent blocks, two
//    an SM, walk equal shares of the flattened work (live expert, 256-column
//    tile, 32-row stage), stream-K style, so the last wave is never half
//    empty whatever the number of live experts. Two producer warps stream
//    each stage's weight rows (runs of 512 contiguous bytes) and the C input
//    rows into a 96 KB shared-memory ring (2 stages of moe_glu_mma, 5 of
//    moe_down_mma) with TMA bulk copies, the weights evict-first in L2,
//    completion counted on the stage's full mbarrier; four consumer warps
//    run mma.sync.m16n8k16 with A = 16 output columns x 16 inputs of the
//    weight tile (ldmatrix.trans; rows padded by 16 B so that the eight
//    rows of an 8x8 matrix hit distinct banks) and B = the rows as N (rows
//    C..7 zero), fp32 sums in registers: no SIMT FMA, few registers. The
//    rows come in as they are, (E, C, K), B's column-major layout: no
//    transpose. A tile that two or more blocks share is summed in a fixed
//    order: each writes its fp32 partial, takes a ticket, and the last to
//    arrive adds the partials in block order (k order) and writes the
//    tile, then sets the ticket back to 0, so the ticket array, zero at the
//    first call, stays zero between calls. Every run of one input gives
//    the same bits, and so does a graph replay.
//    What set the shape (moe_ablation.py, H100): the bytes each block has
//    in flight per stage hand-off, not the tensor cores. One block an SM
//    with a 192 KB ring of 256-column stages reached 69% of the byte
//    bound; two blocks an SM, or 512-column tiles, 85-89%; a second
//    producer warp +2-20 points, a fourth or eight consumer warps nothing;
//    16-row stages and 128-column tiles less. At C 8 with 16 experts live
//    2.14 ms against the SIMT body's 2.88 (bound 1.89).
//  simt (fp32, and C 1): moe_glu, moe_down. A grid of (64-column tile,
//    expert) blocks over the capacity rows padded to CR = 1, 2, 4 or 8
//    (the compiled instance) and laid out by input element, (E, K, CR), so
//    that a thread reads all CR rows' values of one input element in one
//    load; each thread owns 16 / sizeof(T) adjacent output columns, loads
//    them as one 16-byte vector per weight row with 2 row steps in flight
//    and keeps fp32 sums for its CR rows; lanes and warps are summed in a
//    fixed order. A block whose expert has no live slot returns before it
//    reads a weight. At C 1 (4 experts live) it ties the mma body within
//    1% (85% of the bound); fp32 stays here, since tensor cores would take
//    fp32 operands as TF32.

// Rounding, where the plain version (moe_experts_plain, torch.bmm in T)
// rounds: gate and up to T, silu(gate) to T, silu * up to T, the down
// product to T. T is bf16 or fp32 (no rounding).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TILE = 64;   // output columns a block computes
constexpr int U = 2;       // weight row steps a thread has in flight
constexpr int MAX_ROWS = 8;  // capacity rows an expert may hold
enum { DT_F32 = 0, DT_BF16 = 1 };  // ops/kernels/moe_experts.py DTYPES
enum { BODY_SIMT = 0, BODY_MMA = 1 };  // ops/kernels/moe_experts.py BODIES

template <typename T> struct Ty;

template <> struct Ty<float> {
  static constexpr int PER_WORD = 1;
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ void unpack(uint32_t w, float* o) {
    o[0] = __uint_as_float(w);
  }
};

template <> struct Ty<__nv_bfloat16> {
  static constexpr int PER_WORD = 2;
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
  // two bf16 values; the one at the lower address is the low half
  static __device__ __forceinline__ void unpack(uint32_t w, float* o) {
    o[0] = __uint_as_float(w << 16);
    o[1] = __uint_as_float(w & 0xffff0000u);
  }
};

// the 16 / sizeof(T) values of T in a 16-byte vector, as fp32
template <typename T>
__device__ __forceinline__ void unpack_vec(const uint4& u, float* o) {
  constexpr int W = Ty<T>::PER_WORD;
  Ty<T>::unpack(u.x, o);
  Ty<T>::unpack(u.y, o + W);
  Ty<T>::unpack(u.z, o + 2 * W);
  Ty<T>::unpack(u.w, o + 3 * W);
}

// the n values of T at p (n * sizeof(T) bytes, aligned to that size) as
// fp32, in the fewest loads: 16-byte vectors, or one 8-, 4- or 2-byte load
template <typename T, int n>
__device__ __forceinline__ void load_vals(const T* p, float* o) {
  constexpr int BYTES = n * (int)sizeof(T);
  constexpr int W = Ty<T>::PER_WORD;
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      unpack_vec<T>(__ldg(reinterpret_cast<const uint4*>(p) + i),
                    o + i * 4 * W);
  } else if constexpr (BYTES == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    Ty<T>::unpack(u.x, o);
    Ty<T>::unpack(u.y, o + W);
  } else if constexpr (BYTES == 4) {
    Ty<T>::unpack(__ldg(reinterpret_cast<const unsigned int*>(p)), o);
  } else {  // one bf16
    const uint32_t b = __ldg(reinterpret_cast<const unsigned short*>(p));
    o[0] = __uint_as_float(b << 16);
  }
}

// warps a block of the CR-row instance
__host__ __device__ constexpr int block_warps(int CR) {
  return CR >= 8 ? 4 : 8;
}

// From x (E, K, CR) and w0 [, w1] (E, K, N): GLU, the gated product into
// out (E, N, CR), every row of CR; else the product into out (E, C, N),
// rows c < C (0 past the expert's count).
template <typename T, int CR, bool GLU>
__device__ __forceinline__ void expert_gemv(
    const T* __restrict__ x, const int* __restrict__ count,
    const T* __restrict__ w0, const T* __restrict__ w1, T* __restrict__ out,
    int C, int K, int N) {
  constexpr int WARPS = block_warps(CR);
  constexpr int NT = 32 * WARPS;
  constexpr int V = 16 / sizeof(T);  // columns a thread owns
  constexpr int LPR = TILE / V;      // lanes on one row
  constexpr int RPW = 32 / LPR;      // rows a warp reads at a time
  constexpr int RPB = RPW * WARPS;   // rows the block reads at a time
  constexpr int M = GLU ? 2 : 1;     // weight matrices
  __shared__ float red[WARPS][M][CR][TILE];

  const int e = blockIdx.y;
  const int n0 = blockIdx.x * TILE;
  const int live = min(count[e], C);
  if (live <= 0) {
    if (!GLU) {
      for (int i = threadIdx.x; i < C * TILE; i += NT) {
        const int n = n0 + i % TILE;
        if (n < N)
          out[((size_t)e * C + i / TILE) * N + n] = Ty<T>::store(0.f);
      }
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = n0 + (lane % LPR) * V;
  const bool in = col < N;  // N % V == 0: a vector is all in or all out
  const T* xe = x + (size_t)e * K * CR;
  const size_t wofs = (size_t)e * K * N + (in ? col : 0);
  const T* wa = w0 + wofs;
  const T* wb = GLU ? w1 + wofs : w0;

  float acc[M][CR][V];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < CR; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[m][c][v] = 0.f;

  for (int r = warp * RPW + lane / LPR; r < K; r += RPB * U) {
    uint4 va[U], vb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * RPB;
      const bool ok = in && rr < K;
      va[u] = ok ? __ldg(reinterpret_cast<const uint4*>(wa + (size_t)rr * N))
                 : make_uint4(0, 0, 0, 0);
      if (GLU)
        vb[u] = ok ? __ldg(reinterpret_cast<const uint4*>(wb + (size_t)rr * N))
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * RPB;
      if (rr < K) {
        float fa[V], fb[V], xv[CR];
        unpack_vec<T>(va[u], fa);
        if (GLU) unpack_vec<T>(vb[u], fb);
        load_vals<T, CR>(xe + (size_t)rr * CR, xv);
#pragma unroll
        for (int c = 0; c < CR; ++c)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[0][c][v] = fmaf(xv[c], fa[v], acc[0][c][v]);
            if (GLU) acc[M - 1][c][v] = fmaf(xv[c], fb[v], acc[M - 1][c][v]);
          }
      }
    }
  }

  // the lanes on the same columns, then the warps, in a fixed order
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < CR; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float s = acc[m][c][v];
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1) s += __shfl_xor_sync(FULL, s, o);
        acc[m][c][v] = s;
      }
  if (lane < LPR) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int c = 0; c < CR; ++c)
#pragma unroll
        for (int v = 0; v < V; ++v) red[warp][m][c][lane * V + v] = acc[m][c][v];
  }
  __syncthreads();
  // GLU: column-major over (column, row), out's layout; else row-major
  for (int i = threadIdx.x; i < (GLU ? CR : C) * TILE; i += NT) {
    const int c = GLU ? i % CR : i / TILE, j = GLU ? i / CR : i % TILE;
    const int n = n0 + j;
    if (n >= N) continue;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      s0 += red[w][0][c][j];
      if (GLU) s1 += red[w][M - 1][c][j];
    }
    if (GLU) {
      const float g = Ty<T>::round(s0), up = Ty<T>::round(s1);
      out[((size_t)e * N + n) * CR + c] =
          Ty<T>::store(Ty<T>::round(g / (1.f + expf(-g))) * up);
    } else {
      out[((size_t)e * C + c) * N + n] = Ty<T>::store(c < live ? s0 : 0.f);
    }
  }
}

template <typename T, int CR>
__global__ void __launch_bounds__(32 * block_warps(CR)) moe_glu(
    const T* __restrict__ x, const int* __restrict__ count,
    const T* __restrict__ w_gate, const T* __restrict__ w_up,
    T* __restrict__ a, int C, int D, int F) {
  expert_gemv<T, CR, true>(x, count, w_gate, w_up, a, C, D, F);
}

template <typename T, int CR>
__global__ void __launch_bounds__(32 * block_warps(CR)) moe_down(
    const T* __restrict__ a, const int* __restrict__ count,
    const T* __restrict__ w_down, T* __restrict__ y, int C, int F, int D) {
  expert_gemv<T, CR, false>(a, count, w_down, w_down, y, C, F, D);
}


// ---------------------------------------------------------------------------
// The tensor-core body (bf16)
// ---------------------------------------------------------------------------

constexpr int MT_TN = 256;          // output columns a tile
constexpr int MT_BK = 32;           // weight rows a stage
constexpr int MT_RING = 96 * 1024;  // ring bytes a block
constexpr int MT_CW = 4;            // consumer warps
constexpr int MT_PW = 2;            // producer warps
constexpr int MT_NT = 32 * (MT_CW + MT_PW);
constexpr int MT_MTW = MT_TN / 16 / MT_CW;  // m16 tiles of a matrix a consumer warp owns
constexpr int MT_RS = MT_TN * 2 + 16;  // bytes a staged weight row (16 B of pad)
constexpr int MT_XS = MT_BK * 2 + 16;  // bytes a staged input row
constexpr int MT_OS = MT_TN + 8;    // bf16 a row of the output tile
constexpr int MT_BAR = 256;         // bytes of mbarriers (16 stages at most)
constexpr int MT_MAX_E = 256;       // experts the live list holds
static_assert(MT_TN % (16 * MT_CW) == 0 && MT_BK % 16 == 0, "tile shape");

template <bool GLU>
struct MmaShape {
  static constexpr int M = GLU ? 2 : 1;  // weight matrices
  static constexpr int XOFF = M * MT_BK * MT_RS;  // the input rows in a stage
  static constexpr int STAGE = (XOFF + 8 * MT_XS + 127) / 128 * 128;
  static constexpr int NS = MT_RING / STAGE < 16 ? MT_RING / STAGE : 16;
  static constexpr int REGS = M * MT_MTW * 4;  // fp32 sums a consumer thread
  static constexpr int SLOT = REGS * 32 * MT_CW;  // fp32 of a tile's partial
  static constexpr int SMEM = MT_BAR + NS * STAGE + 8 * MT_OS * 2;
  // copies a producer lane issues a stage at most (M BK weight rows, <= 8 rows)
  static constexpr int RQ = (M * MT_BK + 8 + 32 * MT_PW - 1) / (32 * MT_PW);
  static_assert(NS >= 2 && SMEM <= 227 * 1024, "ring");
};

struct MmaArgs {
  const __nv_bfloat16* x;  // (E, C, K) the rows
  const int* count;        // (E,)
  const __nv_bfloat16* w0;  // (E, K, N): W_gate, or W_down
  const __nv_bfloat16* w1;  // (E, K, N): W_up (moe_glu)
  __nv_bfloat16* out;      // (E, C, N): a, or y
  float* part;             // 2 x gridDim.x tile partials
  int* ticks;              // a ticket a (live expert, tile): 0 between calls
  int E, C, K, N;
};

// TMA 1-D bulk copy global -> shared under the L2 policy `pol`
__device__ __forceinline__ void bulk_g2s_pol(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(pol) : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(32 * MT_CW) : "memory");
}

// The flattened work: unit u = (j T + t) KS + s is stage s of tile t of
// live expert j; block b of G walks [W b / G, W (b + 1) / G).
struct Work {
  long long W;
  int G, T, KS;
  __device__ long long lo(int b) const { return W * b / G; }
  // the block whose share holds unit u
  __device__ int block_of(long long u) const { return (int)(((u + 1) * G - 1) / W); }
  // block b's partial slot for tile tl: 0 for its first tile, else 1
  __device__ size_t slot(int b, long long tl) const { return 2 * b + (tl == lo(b) / KS ? 0 : 1); }
};

// A consumer thread's sums of one tile, fp32 in mma's C layout: sums
// [m MT_MTW + mt][r] hold output column 16 (MT_MTW warp + mt) + g + 8 (r / 2) of
// row 2 tq + r % 2; written to the tile's rows of `out` with the plain
// version's roundings through the output tile `so`.
template <bool GLU>
__device__ __forceinline__ void mma_epilogue(const MmaArgs& a,
                                             const float (&sums)[MmaShape<GLU>::REGS / 4][4],
                                             __nv_bfloat16* so, int e, int n0, int tid) {
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT_MTW; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int col = (warp * MT_MTW + mt) * 16 + g + 8 * (r >> 1), c = 2 * tq + (r & 1);
      float v = sums[mt][r];
      if (GLU) {
        const float gt = rnd(v, true), up = rnd(sums[MT_MTW + mt][r], true);
        v = rnd(gt / (1.f + expf(-gt)), true) * up;
      }
      so[c * MT_OS + col] = __float2bfloat16_rn(v);
    }
  consumers_sync();
  const int C = a.C, cols = min(MT_TN, a.N - n0), vr = cols / 8;
  const int live = GLU ? C : min(__ldg(a.count + e), C);
  for (int i = tid; i < C * vr; i += 32 * MT_CW) {
    const int c = i / vr, q = i % vr;
    const uint4 v = c < live ? *reinterpret_cast<const uint4*>(so + c * MT_OS + 8 * q)
                             : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(a.out + ((size_t)e * C + c) * a.N + n0 + 8 * q) = v;
  }
  consumers_sync();
}

// The end of a consumer thread's segment of tile tl (units [u0, u1]): the
// whole tile gives the output at once; a share of it is written to the
// block's partial slot, and the last of the tile's blocks to take a ticket
// adds every share in block order and gives the output.
template <bool GLU>
__device__ __forceinline__ void mma_tile_end(const MmaArgs& a, const Work& w, long long tl,
                                             long long u0, long long u1,
                                             float (&sums)[MmaShape<GLU>::REGS / 4][4],
                                             __nv_bfloat16* so, const int* lx, int* s_last,
                                             int tid) {
  using S = MmaShape<GLU>;
  const int e = lx[tl / w.T], n0 = (int)(tl % w.T) * MT_TN;
  const long long t0 = tl * w.KS, t1 = t0 + w.KS - 1;
  if (u0 != t0 || u1 != t1) {
    float* p = a.part + w.slot(blockIdx.x, tl) * S::SLOT + tid;
#pragma unroll
    for (int q = 0; q < S::REGS; ++q) p[q * 32 * MT_CW] = sums[q / 4][q % 4];
    __threadfence();
    consumers_sync();
    const int bf = w.block_of(t0), bl = w.block_of(t1);
    if (tid == 0) {
      const bool last = atomicAdd(a.ticks + tl, 1) == bl - bf;
      if (last) a.ticks[tl] = 0;
      *s_last = last;
    }
    consumers_sync();
    if (!*s_last) return;
    __threadfence();
#pragma unroll
    for (int q = 0; q < S::REGS; ++q) sums[q / 4][q % 4] = 0.f;
    for (int bb = bf; bb <= bl; ++bb) {
      const float* pb = a.part + w.slot(bb, tl) * S::SLOT + tid;
#pragma unroll
      for (int q = 0; q < S::REGS; ++q) sums[q / 4][q % 4] += __ldcg(pb + q * 32 * MT_CW);
    }
  }
  mma_epilogue<GLU>(a, sums, so, e, n0, tid);
}

template <bool GLU>
__device__ __forceinline__ void expert_mma(const MmaArgs& a) {
  using S = MmaShape<GLU>;
  constexpr int M = S::M, NS = S::NS;
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ int lx[MT_MAX_E];  // the live experts, ascending
  __shared__ int s_nlive, s_last;
  uint64_t* full = reinterpret_cast<uint64_t*>(dsm);
  uint64_t* empty = full + NS;
  unsigned char* ring = dsm + MT_BAR;
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(ring + NS * S::STAGE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = a.E, C = a.C, K = a.K, N = a.N;
  if (tid == 0) {
    int n = 0;
    for (int e = 0; e < E; ++e)
      if (a.count[e] > 0) lx[n++] = e;
    s_nlive = n;
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], MT_PW);
      mbar_init(&empty[i], MT_CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the staged input rows C..7 are never copied: B's zero columns
  constexpr int XV = MT_XS / 16;
  for (int i = tid; i < NS * (8 - C) * XV; i += MT_NT) {
    const int st = i / ((8 - C) * XV), r = i % ((8 - C) * XV);
    *reinterpret_cast<uint4*>(ring + st * S::STAGE + S::XOFF + (C + r / XV) * MT_XS +
                              16 * (r % XV)) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  Work w;
  w.T = (N + MT_TN - 1) / MT_TN;
  w.KS = K / MT_BK;
  w.W = (long long)s_nlive * w.T * w.KS;
  w.G = w.W < gridDim.x ? (int)w.W : (int)gridDim.x;  // every working block has a unit
  const int b = blockIdx.x;
  const bool works = b < w.G;
  const long long lo = works ? w.lo(b) : 0, hi = works ? w.lo(b + 1) : 0;

  if (warp >= MT_CW) {
    // A producer: lane row r = 32 (pw + MT_PW q) + lane of every stage, a
    // weight row (r < M BK: matrix r / BK, row r % BK) or an input row (r -
    // M BK < C), copied from a source that moves BK rows a stage. The
    // weights stream through L2 once (evict-first); every tile of an
    // expert reads its input rows again (evict-last).
    uint64_t pol_w, pol_x;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol_w));
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol_x));
    constexpr int RQ = S::RQ;
    const int r0 = 32 * (warp - MT_CW) + lane;
    const char* src[RQ];
    uint32_t len[RQ], bytes = 0;
    // the unit's live expert j, its tile t, its stage s
    int j = (int)(lo / w.KS / w.T), t = (int)(lo / w.KS % w.T), s = (int)(lo % w.KS);
    for (int i = 0; i < (int)(hi - lo); ++i) {
      const int st = i % NS;
      if (i == 0 || s == 0) {  // a tile starts: the sources at stage s, the warp's bytes
        const int e = lx[j], n0 = t * MT_TN, cols = min(MT_TN, N - n0);
        uint32_t mine = 0;
#pragma unroll
        for (int q = 0; q < RQ; ++q) {
          const int r = r0 + 32 * MT_PW * q;
          len[q] = r < M * MT_BK ? cols * 2 : r < M * MT_BK + C ? MT_BK * 2 : 0;
          src[q] = reinterpret_cast<const char*>(
              r < M * MT_BK
                  ? (r < MT_BK ? a.w0 : a.w1) + ((size_t)e * K + s * MT_BK + r % MT_BK) * N + n0
                  : a.x + ((size_t)e * C + (len[q] ? r - M * MT_BK : 0)) * K + s * MT_BK);
          mine += len[q];
        }
        bytes = __reduce_add_sync(FULL, mine);
      }
      if (i >= NS) mbar_wait(&empty[st], (i / NS - 1) & 1);
      unsigned char* dst = ring + st * S::STAGE;
      if (lane == 0) mbar_expect_tx(&full[st], bytes);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const int r = r0 + 32 * MT_PW * q;
        if (len[q]) {
          const bool wt = r < M * MT_BK;
          bulk_g2s_pol(dst + (wt ? r * MT_RS : S::XOFF + (r - M * MT_BK) * MT_XS), src[q],
                       len[q], &full[st], wt ? pol_w : pol_x);
          src[q] += wt ? (size_t)MT_BK * N * 2 : MT_BK * 2;
        }
      }
      if (++s == w.KS) {
        s = 0;
        if (++t == w.T) {
          t = 0;
          ++j;
        }
      }
    }
    return;
  }

  if (!GLU) {  // y's rows of the dead experts are 0, a share of them a block
    const int vr = N / 8;
    for (long long i = (long long)b * 32 * MT_CW + tid; i < (long long)E * C * vr;
         i += (long long)gridDim.x * 32 * MT_CW)
      if (__ldg(a.count + i / ((long long)C * vr)) <= 0)
        *reinterpret_cast<uint4*>(a.out + 8 * i) = make_uint4(0, 0, 0, 0);
  }

  const int g = lane >> 2, tq = lane & 3;
  // this lane's ldmatrix row of a 16 x 16 A tile: input 8 (lane / 16) +
  // lane % 8, output columns 8 ((lane / 8) % 2) of the warp's m16 tiles
  const uint32_t a_lane = (uint32_t)(((lane & 7) + 8 * (lane >> 4)) * MT_RS +
                                     (warp * MT_MTW * 16 + 8 * ((lane >> 3) & 1)) * 2);
  float sums[S::REGS / 4][4] = {};
  long long tl = lo / w.KS, u0 = lo;  // the unit's tile, its stage s
  int s = (int)(lo % w.KS);
  for (int i = 0; i < (int)(hi - lo); ++i) {
    const int st = i % NS;
    mbar_wait(&full[st], (i / NS) & 1);
    const unsigned char* stg = ring + st * S::STAGE;
    const uint32_t sa = smem_u32(stg) + a_lane;
#pragma unroll
    for (int ks = 0; ks < MT_BK / 16; ++ks) {
      const unsigned char* xr = stg + S::XOFF + g * MT_XS + (ks * 16 + 2 * tq) * 2;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int mt = 0; mt < MT_MTW; ++mt) {
          uint32_t af[4];
          ldsm4_t(af, sa + (m * MT_BK + ks * 16) * MT_RS + mt * 32);
          mma16816(sums[m * MT_MTW + mt], af, b0, b1);
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the stage may be refilled
    const long long u = lo + i;
    if (s == w.KS - 1 || u == hi - 1) {
      mma_tile_end<GLU>(a, w, tl, u0, u, sums, so, lx, &s_last, tid);
#pragma unroll
      for (int q = 0; q < S::REGS; ++q) sums[q / 4][q % 4] = 0.f;
      u0 = u + 1;
    }
    if (++s == w.KS) {
      s = 0;
      ++tl;
    }
  }
}

__global__ void __launch_bounds__(MT_NT, 1) moe_glu_mma(MmaArgs a) { expert_mma<true>(a); }
__global__ void __launch_bounds__(MT_NT, 1) moe_down_mma(MmaArgs a) { expert_mma<false>(a); }

constexpr int MT_MAX_DEV = 64;

// The persistent grid of a tensor-core kernel on the current device: its
// resident blocks, SMs x blocks an SM (its shared memory raised once).
template <bool GLU>
cudaError_t mma_grid(int& G) {
  static int grid[MT_MAX_DEV] = {};
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MT_MAX_DEV) return cudaErrorInvalidValue;
  if (!grid[dev]) {
    auto k = GLU ? moe_glu_mma : moe_down_mma;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MmaShape<GLU>::SMEM);
    int sms = 0, per = 0;
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k, MT_NT, MmaShape<GLU>::SMEM);
    if (e != cudaSuccess) return e;
    if (per < 1) return cudaErrorInvalidConfiguration;
    grid[dev] = sms * per;
  }
  G = grid[dev];
  return cudaSuccess;
}

cudaError_t mma_launch(const MmaArgs& glu, const MmaArgs& down, cudaStream_t st) {
  int gg, gd;
  cudaError_t e = mma_grid<true>(gg);
  if (e == cudaSuccess) e = mma_grid<false>(gd);
  if (e != cudaSuccess) return e;
  moe_glu_mma<<<gg, MT_NT, MmaShape<true>::SMEM, st>>>(glu);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  moe_down_mma<<<gd, MT_NT, MmaShape<false>::SMEM, st>>>(down);
  return cudaGetLastError();
}

int compiled_rows(int C) {
  return C <= 1 ? 1 : C <= 2 ? 2 : C <= 4 ? 4 : 8;
}

template <typename T, int CR>
cudaError_t launch(const T* x, const int* count, const T* w_gate,
                   const T* w_up, const T* w_down, T* a, T* y, int E, int C,
                   int D, int F, cudaStream_t st) {
  constexpr int NT = 32 * block_warps(CR);
  moe_glu<T, CR><<<dim3((F + TILE - 1) / TILE, E), NT, 0, st>>>(
      x, count, w_gate, w_up, a, C, D, F);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_down<T, CR><<<dim3((D + TILE - 1) / TILE, E), NT, 0, st>>>(
      a, count, w_down, y, C, F, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const int* count, const void* w_gate,
                const void* w_up, const void* w_down, void* a, void* y, int E,
                int C, int D, int F, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (D % V || F % V) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* g = static_cast<const T*>(w_gate);
  const T* u = static_cast<const T*>(w_up);
  const T* d = static_cast<const T*>(w_down);
  T* at = static_cast<T*>(a);
  T* yt = static_cast<T*>(y);
  switch (compiled_rows(C)) {
    case 1: return launch<T, 1>(xt, count, g, u, d, at, yt, E, C, D, F, st);
    case 2: return launch<T, 2>(xt, count, g, u, d, at, yt, E, C, D, F, st);
    case 4: return launch<T, 4>(xt, count, g, u, d, at, yt, E, C, D, F, st);
    default: return launch<T, 8>(xt, count, g, u, d, at, yt, E, C, D, F, st);
  }
}

}  // namespace

// The tensor-core body's scratch for E experts of widths D, F on the
// current device: out[0] the fp32 partials, out[1] the int32 tickets (which
// the caller zeroes once and passes to every call; the kernels leave them
// zero), out[2] / out[3] the grids of moe_glu_mma / moe_down_mma. Returns
// the cudaError_t (0 on success).
extern "C" int moe_experts_scratch(int E, int D, int F, long long* out) {
  if (E < 1 || D < 1 || F < 1) return (int)cudaErrorInvalidValue;
  int gg, gd;
  cudaError_t e = mma_grid<true>(gg);
  if (e == cudaSuccess) e = mma_grid<false>(gd);
  if (e != cudaSuccess) return (int)e;
  const long long pg = (long long)gg * MmaShape<true>::SLOT;
  const long long pd = (long long)gd * MmaShape<false>::SLOT;
  out[0] = 2 * (pg > pd ? pg : pd);
  out[1] = (long long)E * (((F > D ? F : D) + MT_TN - 1) / MT_TN);
  out[2] = gg;
  out[3] = gd;
  return 0;
}

// y (E, C, D) = the SwiGLU experts on the capacity rows of E experts,
// C <= 8 an expert, count (E,) the live ones, W_gate / W_up (E, D, F),
// W_down (E, F, D). body BODY_MMA (bf16; D and F multiples of MT_BK, E <=
// MT_MAX_E): x the rows (E, C, D), CR == C, a the scratch (E, C, F), part
// and ticks as moe_experts_scratch gives them. body BODY_SIMT: x the rows
// by element (E, D, CR), CR = compiled_rows(C) (rows C..CR-1 zero), a the
// scratch (E, F, CR), part and ticks unused. Every pointer is 16-byte
// aligned and D, F are multiples of 16 / sizeof(T) (the wrapper checks).
// Returns the launch's cudaError_t (0 on success); an unsupported shape,
// type or body is cudaErrorInvalidValue and launches nothing.
extern "C" int moe_experts(const void* x, const int* count,
                           const void* w_gate, const void* w_up,
                           const void* w_down, void* a, void* y, float* part,
                           int* ticks, int E, int C, int CR, int D, int F,
                           int dtype, int body, void* stream) {
  if (E < 1 || C < 1 || C > MAX_ROWS || D < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == BODY_MMA) {
    if (dtype != DT_BF16 || CR != C || D % MT_BK || F % MT_BK || E > MT_MAX_E ||
        part == nullptr || ticks == nullptr)
      return (int)cudaErrorInvalidValue;
    using B = __nv_bfloat16;
    const B* xb = static_cast<const B*>(x);
    B* ab = static_cast<B*>(a);
    const MmaArgs glu{xb, count, static_cast<const B*>(w_gate), static_cast<const B*>(w_up),
                      ab, part, ticks, E, C, D, F};
    const MmaArgs down{ab, count, static_cast<const B*>(w_down), nullptr,
                       static_cast<B*>(y), part, ticks, E, C, F, D};
    return (int)mma_launch(glu, down, st);
  }
  if (body != BODY_SIMT || CR != compiled_rows(C))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case DT_BF16:
      return (int)run<__nv_bfloat16>(x, count, w_gate, w_up, w_down, a, y, E,
                                     C, D, F, st);
    case DT_F32:
      return (int)run<float>(x, count, w_gate, w_up, w_down, a, y, E, C, D,
                             F, st);
  }
  return (int)cudaErrorInvalidValue;
}
