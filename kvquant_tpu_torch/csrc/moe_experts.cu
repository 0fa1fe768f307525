// The expert products of the MoE family's capacity dispatch at decode
// sizes (kvquant_tpu_torch/models/moe.py: moe_ffn_sparse, through
// ops/kernels/moe_experts.py), for sm_90a.
//
// It replaces no TPU kernel. The JAX package computes its dispatch with
// one-hot einsums over (N, E, C) (kvquant_tpu/models/moe.py:113-152) and
// leaves the products to XLA; at decode C = min(N, ...) = 1, so every one
// of the E experts computes one row and every expert's weights are read.
// Here the rows of each expert's capacity slots come in gathered, with
// count (E,) int32, the live slots of each expert, and a block whose
// expert has no live slot returns before it reads a weight: only the
// routed experts' weights are read, and no count goes to the host, so a
// CUDA graph captures the call.
//
// Two kernels, each a grid of (column tile, expert) blocks, over the
// capacity rows padded to CR = 1, 2, 4 or 8 (the compiled instance) and
// laid out row-major by input element, (E, K, CR), so that a thread reads
// all CR rows' values of one input element in one load:
//   moe_glu:  a[e, :, c] = silu(x[e, :, c] . W_gate[e]) * (x[e, :, c] . W_up[e])
//   moe_down: y[e, c, :] = a[e, :, c] . W_down[e] for c < count[e], else 0
// moe_down writes its tile's zeros for a dead expert before it returns, so
// y is defined everywhere; moe_glu leaves a dead expert's a unwritten
// (moe_down does not read it).
//
// Bound: bytes. A block's work is a product of C <= 8 rows with a (K, N)
// weight matrix, about 2 C operations per weight byte at bf16, far below
// the ~295 operations a byte at which the H100's tensor cores, and not its
// 3.35 TB/s, become the limit. So the design is a SIMT batched GEMV that
// streams the weights once: each thread owns VEC = 16 / sizeof(T) adjacent
// output columns and loads them as one 16-byte vector per weight row; LPR
// lanes cover the block's TILE = 64 columns of one row (128 contiguous
// bytes at bf16), a warp RPW rows at a time, the block's 8 warps (4 at CR
// 8) RPB rows; U = 2 row steps are loaded before they are used. Those
// counts were timed against 4 and 8 steps in flight, 32-column tiles and
// 4 or 8 warps at every CR on an H100: more steps in flight cost
// registers, and so blocks an SM, for no more bytes in flight.
// Each thread keeps fp32 sums for its CR rows and VEC columns; the lanes
// on the same columns are summed by shuffles and the warps in shared
// memory in warp order, a fixed order, so every run gives the same bits.
// wgmma and TMA are later work.
//
// Rounding, where the plain version (moe_experts_plain, torch.bmm in T)
// rounds: gate and up to T, silu(gate) to T, silu * up to T, the down
// product to T. T is bf16 or fp32 (no rounding).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;   // output columns a block computes
constexpr int U = 2;       // weight row steps a thread has in flight
constexpr int MAX_ROWS = 8;  // capacity rows an expert may hold
constexpr unsigned FULL = 0xffffffffu;
enum { DT_F32 = 0, DT_BF16 = 1 };  // ops/kernels/moe_experts.py DTYPES

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

// y (E, C, D) = the SwiGLU experts on the rows x (E, D, CR), CR =
// compiled_rows(C) (rows C..CR-1 zero): moe_glu into the scratch
// a (E, F, CR), then moe_down. Every pointer is 16-byte aligned and D, F
// are multiples of 16 / sizeof(T) (the wrapper checks). Returns the
// launch's cudaError_t (0 on success); an unsupported shape or type, or a
// CR that is not compiled_rows(C), is cudaErrorInvalidValue and launches
// nothing.
extern "C" int moe_experts(const void* x, const int* count,
                           const void* w_gate, const void* w_up,
                           const void* w_down, void* a, void* y, int E, int C,
                           int CR, int D, int F, int dtype, void* stream) {
  if (E < 1 || C < 1 || C > MAX_ROWS || CR != compiled_rows(C) || D < 1 ||
      F < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
