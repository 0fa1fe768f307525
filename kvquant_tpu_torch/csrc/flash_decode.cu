// One-pass attention over the sink prefix and the quantized KV cache, for
// NVIDIA Hopper (sm_90a): decode steps (Tq = 1) and blocks of quantized
// chunked prefill (Tq > 1).
//
// Replaces kvquant_tpu/ops/pallas/flash_decode.py:_flash_kernel (the TPU
// kernel behind flash_attention / flash_decode, K1) and, through a page
// table, kvquant_tpu/paged.py:paged_flash_decode (K5), which on the TPU
// reuses _flash_kernel and only remaps the token-block index. One layer
// `li` of the full (L, ...) cache arrays; codes as nuq bit planes (2-4
// bits, any codebook), int4 / int8 containers (affine codebook) or the
// head-paired 2-bit int4x2 container (affine codebook); keys stored
// pre-RoPE (rotated here at their absolute positions) or post-RoPE; K
// outliers as slot words or static-channel residuals, V outliers as slot
// words; an exact sink prefix; causal and sliding-window masks; per-sample
// positions. Query rows r = 0..Q-1 are g-major over (G, Tq); row r of
// batch b sits at position pos[b] + r % Tq and sees the sink tokens
// k <= its position and the packed tokens t with S + t <= its position.
// Addressing: Contig (K1) reads the (L, B, ..., Tc) cache of batch row b;
// Paged (K5) reads the tile at logical packed position t0 from page
// table[b, min(t0 / P, last live page)] of the (L, NP, ..., P) pool, at
// row t0 % P. In fd_decode only the producer thread addresses memory, so
// the policy is chosen at run time there (K5 passes a table, K1 none).
//
// Six kernels:
//  - fd_decode, the SIMT decode body of K1 and K5 (Tq = 1, G = 1/2 rows
//    per kv head, and 4/8 with fp32 dots; other G padded to an instance);
//  - fd_gqa, the tensor-core decode body of K1 and K5 (Tq = 1, 3-8 rows
//    per kv head, bf16 dots; the host's body() / GQA_ROWS route it);
//  - fd_chunk, the multi-row body of K1 with bf16 dots over bit planes
//    (prefill chunks, every call that is not a decode step): wgmma on the
//    tensor cores;
//  - fd_chunk_sync, the same over the containers (int4, int8, int4x2):
//    mma.sync on the tensor cores;
//  - fd_partial, the multi-row body of K1 with fp32 dots (64 rows, SIMT);
//  - fd_merge, which merges the token splits of any of them with the sink
//    prefix by log-sum-exp (a split of zero weight is not read).
//
// fd_decode. What bounds it: device-memory bytes. Each live token costs
// 2*Hkv*D*bits/8 code bytes, its head groups' outlier rows and 8 bytes of
// V scale / offset per layer (LLaMA-2-7B: 3336 B nuq3 with slots cap 2,
// hg 4; 2184 B int4x2 with 4 static K channels), read once: 0.0327 ms
// (nuq3) and 0.0214 ms (int4x2) at 32K tokens on an H100 (3.35 TB/s).
// Second, instruction issue: every one of the 2*D codes of a (token, kv
// head) is dequantized (bit planes: integer bit gathering, a LUT load and
// an fma), rotated under pre-RoPE storage, rounded to bf16 and used in a
// dot, so at G = 1 the issue rate, not the bytes, sets the time (PERF.md
// gives the measured times). Third, the (cos, sin) table: 512 B per token
// for every kv head block that reads it.
// What the design does about it:
//  - one block per (batch row, hb kv heads of one head group, token
//    split): the hb heads' codes, the group's outlier rows, the tile's V
//    scale / offset and, under int4x2, the pair containers are read once
//    per block (hb = hg, or a slice of it when the stage would not fit);
//  - a ring of 2-4 tile stages in shared memory, filled by one producer
//    thread with TMA bulk copies (cp.async.bulk ... complete_tx, L2
//    evict-first so the streamed codes leave the table in L2), one
//    contiguous piece of >= 256 B per (head, plane) or row; eight consumer
//    warps wait on each stage's mbarrier and release it through a second
//    one, so the loads of the next tiles are in flight while a tile is
//    consumed. A tile is 128 tokens for bit planes (one packing group: 4
//    word rows per plane) and 64 for the containers;
//  - no dequantized tile in shared memory: a consumer warp takes one head
//    and 32/G-token chunks of the tile; lane l owns columns 2l, 2l+1 and
//    their RoPE partners 2l+D/2, 2l+D/2+1 (lanes past D/2 idle at D < 128)
//    and keeps its G rows' query values in registers. Per word row of a
//    chunk it spreads each plane's bits to bytes (one multiply per four
//    tokens), so a nuq code is a byte permute and a LUT load; container
//    codes become floats through the mantissa of 2**23 (conversion
//    instructions issue at a sixteenth of the fma rate). Per token it
//    rotates its pairs with one 16-byte load of the (cos, sin) table and
//    takes G partial dots; a transposing butterfly over the 32 (row,
//    token) partials of the chunk (31 shuffles) leaves lane l with the
//    score of row l / C, token l % C. Online softmax and P.V run in the same
//    registers; the warps of a head merge their (m, l, acc) through shared
//    memory once, at the end;
//  - outliers enter by linearity: a K slot or channel at (t, dim) adds
//    q[dim]*rnd(v*cos) + q[partner]*rnd(+-v*sin) to the score of t; a V
//    slot adds p*rnd(v) to the lane that owns dim, through a ballot over the
//    chunk's slot words (no shared-memory atomics);
//  - the (cos, sin) table (Tc, D/2) is built once per (capacity, sink,
//    RoPE parameters, device) by the wrapper and reused by every layer and
//    step; pre- and post-RoPE storage are separate instances, so the
//    token loop carries no branch;
//  - splits: grid.x fills the card's resident blocks once; each block
//    derives its tiles from pos[b] on the device, with at least MIN_TPS
//    tiles per split, so short live lengths use fewer splits and the
//    launch reads no host value of pos.
// Budget (chip_smoke.py --verbose-build: nvcc -Xptxas -v, sm_90a, 288
// threads): G = 1 and 2 instances at 96 registers (two blocks per SM;
// 0-32 B of spills at G = 1, up to 116 B at G = 2 with pre-RoPE keys),
// G = 4 at 138-160 and G = 8 at 168 (one block per SM). Shared memory: the
// ring (2-4 stages, <= 96 KB: 87 KB for LLaMA-2-7B nuq3, 70 KB for its
// int4x2) plus hb * G * D query floats.
//
// fd_gqa (decode steps of 3-8 rows per kv head, bf16 dots: DBRX's 48 / 8
// heads, MISTRAL_7B's 32 / 8). What bounds it: the bytes, as fd_decode
// (DBRX nuq3 at 32K: 27.6 MB a layer, 0.0082 ms at 3.35 TB/s). fd_decode's
// SIMT consumers take G partial dots per code and a butterfly per chunk, so
// their cost grows with the rows, not the bytes; the G rows of a kv head
// are what mma.sync's N = 8 holds, so on the tensor cores a code costs the
// same at any G <= 8. What the design does:
//  - the ring, producer thread, splits, sink prefix (fd_merge) and both
//    addressings of fd_decode (produce_tiles); a consumer warp takes one
//    head and 32-token units of a stage (a nuq word row: tokens 4s + r at
//    bit s; containers: 32 consecutive tokens);
//  - scores S^T = K Q^T on mma.sync.m16n8k16: A = 16 tokens x 16 dims of
//    keys dequantized in registers (a nuq plane's four slot bits of a lane
//    sit at bits g, g + 8, g + 16, g + 24 of one word: one rotate and one
//    AND-OR a plane give four codes, then the LUT), straight into the A
//    fragments; a lane's k-block j holds dims 16j + 4tq .. + 3 and k-block
//    j + D/32 their RoPE partners, so pre-RoPE keys rotate in registers
//    with the (cos, sin) rows loaded ahead; B = the G query rows (bf16,
//    zero past G; hopper.cuh's layout);
//  - K outliers by linearity in fp32, one lane per token for every row
//    (the slot's rotated terms times the transposed queries), added to the
//    score fragments through a per-warp exchange tile;
//  - an online softmax in log2 units per row (a column of C), P^T through
//    a per-warp bf16 tile (rows past G zero), then O^T += V^T P^T with V^T
//    dequantized in registers (m-block mt row g is dim 16mt + g; the
//    bit-plane tokens of a k-step are the slot order the P^T tile is
//    written in);
//  - V slots as a second A operand: one lane per token writes rnd(v_add)
//    (its slots summed per dim) into column p of a per-warp bf16 V^T slot
//    tile, multiplied by the same P^T over the m-blocks that hold one, and
//    cleared after; no shared-memory atomics;
//  - one block an SM (288 threads at <= 168 registers, no spills; two
//    blocks an SM at 96 registers spill and run slower, gqa_ablation.py),
//    three ring stages.
// Budget (chip_smoke.py --verbose-build): 0-16 B of spills across the 12
// instances; 190 KB of shared memory for DBRX's nuq3 (3 stages, V slots).
//
// fd_chunk (prefill chunks over bit planes, bf16 dots). What bounds it: at
// Tq = 256 rows the two contractions, 4*Q*live*D*Hkv flops per call (0.139
// ms at 32K tokens of a LLaMA-2-7B layer at 989 TFLOP/s), which only wgmma
// runs at the card's tensor-core rate; beside them the producers' dequantization
// and outlier tiles, whose instruction count does not shrink with the rows
// and which wait on shared-memory and L2 latency (two producer warps a
// scheduler). With outliers the products are four passes (Q.K^T,
// Q.K_add^T, P.V, P.V_add). PERF.md gives chunk_ablation.py's split: the
// producers set the pace. What the design does:
//  - one block per (batch row, kv head, up to 256 query rows, token split):
//    every K / V tile is dequantized once for all rows of a 256-row chunk;
//  - warp specialisation: two producer warpgroups (setmaxnreg.dec to 56
//    registers) keep the ring full and dequantize while two consumer
//    warpgroups (setmaxnreg.inc to 200) multiply; 3 piece buffers with
//    full / empty mbarriers hand the pieces over, so the dequantization of
//    the next pieces overlaps the products of this one;
//  - raw planes, outlier rows and V scale / offset of a 128-token tile (one
//    nuq packing group) arrive through a ring of 2-3 stages; producer warp
//    0 refills a stage with TMA bulk copies (one per lane, completing on the
//    stage's mbarrier) once every producer has dequantized it (a named
//    barrier of the producers);
//  - the producers dequantize each 32-token piece into bf16 K and V tiles
//    with fd_decode's code tricks (bit spreading by one multiply + byte
//    permute + LUT, paired bf16 conversion), a unit being 4 tokens x a column quad (c0,
//    c0 + 1 and their RoPE partners); pre-RoPE keys are rotated with the
//    cached (cos, sin) table before rounding, its four rows of a bit-plane
//    unit loaded before the codes are decoded. Every tile (and the block's
//    bf16 queries) is written in wgmma's 128-byte swizzled layout
//    (wgmma.cuh: rows of 64 columns, 16-byte chunks XORed by the row), and
//    each producer fences its writes to the async proxy before it arrives
//    on the buffer's full barrier;
//  - a consumer warpgroup owns two m64 row tiles (wg and wg + 2, so a
//    128-row block keeps both warpgroups busy) and multiplies with
//    asynchronous wgmma: S = Q.K^T as m64n32k16 with both operands read from
//    shared memory (the queries as A, the K tile as B, K-major, read once
//    per warpgroup and not once per warp), then the K outlier tile into the
//    same accumulator over the 16-dim k-steps it touches; after
//    wgmma.wait_group the online softmax runs in base 2 on the fp32
//    accumulators, P is repacked as the bf16 A operand in registers (the
//    accumulator's layout is the A fragment's: no round trip through shared
//    memory) and O is rescaled only when a row maximum moved; O += P.V as
//    m64n128k16 with A in registers and the V tile read transposed
//    (MN-major), then P.V_add where the piece holds a V slot. The two
//    warpgroups take turns to issue their score products (two named
//    barriers), so one's softmax runs beside the other's products. A
//    consumer releases a buffer after the wait that ends its products.
//    ptxas serializes every wgmma of a kernel that needs a register fence
//    on a divergent path (its C7520), so a batch branches only on
//    warp-uniform values: a tile's sight of the piece, the outlier tile's
//    k-step mask and the V slot flag pass through a vote (__any_sync /
//    __reduce_or_sync) first. Columns D .. 127 stay zero, so the value
//    product is N = 128 at every D; a tile whose rows all see all of a
//    piece drops the per-element mask;
//  - outliers at the plain version's rounding points, as sparse bf16 tiles
//    multiplied by the same operands: the K tile holds rnd(rope(kd)) and a
//    second K tile rnd(rope(k_add)) (slots or static channels of one dim
//    add before the rotation, a dim and its RoPE partner mix before the
//    rounding); V slots as a tile rnd(v_add) multiplied by the same bf16 P.
//    A few lanes build a token's row (zero, then one entry a lane), no
//    shared-memory atomics; with both tiles the first half of the producer
//    warps builds the K rows and the second half the V rows, two latency
//    chains side by side;
//  - splits (chunk_plan / chunk_splits in ops/kernels/flash_decode.py):
//    grid = n_split x Hkv * n_rt x B fills the SMs once (one block per SM:
//    384-512 threads, up to 225 KB of shared memory); blocks derive their
//    live tiles from pos on the device, as fd_decode.
// Budget: 65,536 registers an SM, one block: 256 x 56 (producers) + 256 x
// 200 (consumers) (chunk_ablation.py measured the neighbours: more for the
// producers or for the consumers is slower); a consumer holds O (2 tiles x
// 64 fp32), S (2 x 16), P (2 x 8) and the softmax state. ptxas (-Xptxas
// -v, sm_90a) reports 208-212 B of spill stores for both roles together,
// and no serialized wgmma. Shared memory at LLaMA-2-7B width, 256 rows, 3
// buffers and 3 stages: 213 KB nuq3 with slots (the swizzled tiles need no
// padding columns; 1 KB aligns the base). Why not more rows or longer
// pieces: a third m64 tile's, or a 64-token piece's, accumulators do not
// fit beside O.
//
// fd_chunk_sync (prefill chunks over the containers, bf16 dots) is the
// mma.sync body fd_chunk had before its wgmma consumers: on the containers
// the wgmma body ran slower (int4x2 at LLaMA-2-7B width, 256 rows: 1.04
// against 0.96 ms at 32K; its producers alone 0.75 against 0.61, for no
// reason the ablations found: not the register split, the proxy fence or
// the swizzled stores; PERF.md). The same block, ring, pieces and outlier
// tiles as fd_chunk, with one producer warpgroup (56 registers) and eight
// consumer warps (224), each owning 32 rows as two 16-row mma tiles: it
// loads its Q, K and V fragments from shared memory with ldmatrix (tiles
// in rows of 128 + 8 bf16, conflict-free) and multiplies with
// mma.sync.m16n8k16 (Q.K^T, Q.K_add^T over the k-steps the K outlier tile
// touches, P.V, P.V_add where the piece holds a V slot). Rows per block in
// tiles of 16. Shared memory at LLaMA-2-7B width, 256 rows, 3 buffers and
// 3 stages: 202 KB int4x2 with 4 channels.
//
// fd_partial (fp32 dots) stays the SIMT body: the fp32 reference
// mode of the parity checks, which bf16 tensor cores cannot compute. The
// dispatch picks the body by dot mode; a CUDA call launches one or raises.
// A block owns one kv head, 64 query rows and one split; it dequantizes
// each 64-token tile of K and V once into fp32 shared memory (keys rotated,
// outliers added with shared-memory atomics) and every row reuses it
// through 8x4 / 8x(D/16) register tiles.
//
// Numerics: with dot_bf16 the dot operands (queries, roped keys, the
// dequantized values, the rotated outlier terms, the probabilities, the
// sink rows) are rounded to bf16 and accumulated in fp32; otherwise all
// fp32. The rotated key and its rotated outlier term are rounded
// separately, as are the value and its slot term. Built without fast-math:
// slot words are fp32 bit patterns whose zero-valued slots are denormals,
// and the angles reach ~1e5 radians.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "hopper.cuh"
#include "wgmma.cuh"

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
  const float2* rope;      // (Tc, D/2) (cos, sin) of packed token t at
                           //   position S + t (pre-RoPE storage only)
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
  const int* table;        // paged: (B, MP) page ids of each slot
  int MP, P, NP;           // paged: table width, tokens per page, pool pages
  int hb;                  // decode: kv heads per block (divides hg)
  int n_stage;             // decode and tensor-core chunk: ring stages (2..MAX_STAGES)
  int rows_blk;            // tensor-core chunk: query rows per block (64..256, of 64)
  int n_buf;               // tensor-core chunk: dequantized piece buffers (1..MAX_BUF)
  int body;                // BODY_DECODE / BODY_GQA / BODY_CHUNK / BODY_PARTIAL (the host's route)
};

namespace {

constexpr int TT = 64;       // key tokens per tile, prefill body
constexpr int NT = 128;      // threads per block, prefill body and merge
constexpr int NW = NT / 32;  // warps per block
constexpr int MAXD = 128;
constexpr int MAX_KC = 64;
constexpr int MAX_SINK = 64;
constexpr int PR = 64;       // query rows per block, prefill body
constexpr int MODE_NUQ = 0, MODE_INT4 = 1, MODE_INT8 = 2, MODE_INT4X2 = 3;
constexpr int BODY_DECODE = 0, BODY_GQA = 1, BODY_CHUNK = 2, BODY_PARTIAL = 3;
constexpr int NEG_ROW = -(1 << 30);  // position of a padding row: sees nothing
constexpr float LOG2E = 1.4426950408889634f;

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

// Addressing policies: where the cache rows of the key tile at logical
// packed position t0 live. A slab is one entry of the cache arrays' second
// axis (a batch row, or a pool page) and holds tokens() rows; locate()
// returns (slab, row of t0 in it).
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

// ===========================================================================
// fd_decode: Tq = 1, G rows per kv head
// ===========================================================================

constexpr int DW = 8;                // consumer warps per block
constexpr int DNT = (DW + 1) * 32;   // + one producer warp
constexpr int MAX_STAGES = 4;
constexpr int MIN_TPS = 2;           // least tiles per live split
constexpr int DECODE_SMEM_MAX = 200 * 1024;

__host__ __device__ constexpr int tile_tokens(int mode) {
  return mode == MODE_NUQ ? 128 : 64;
}

// bytes of one kind (K or V) of one tile for one head (int4x2: one pair)
__host__ __device__ inline int code_bytes(int mode, int bits, int D) {
  return mode == MODE_NUQ ? bits * 16 * D : mode == MODE_INT8 ? 64 * D : 32 * D;
}

__host__ __device__ inline int rows_copied(const FdArgs& a) {
  return (a.n_kslots > 0 || a.n_kc > 0 || a.n_vslots > 0) ? a.J : 0;
}

// byte offsets within one ring stage: K codes of the block's heads (or
// pairs), V codes, outlier rows, V scale, V offset
struct Ring {
  int k, v, rows, vs, vo, bytes;
};

__host__ __device__ inline Ring ring_layout(const FdArgs& a) {
  const int units = a.mode == MODE_INT4X2 ? a.hb / 2 : a.hb;
  const int cb = code_bytes(a.mode, a.bits, a.D), tt = tile_tokens(a.mode);
  Ring r;
  r.k = 0;
  r.v = units * cb;
  r.rows = 2 * units * cb;
  r.vs = r.rows + rows_copied(a) * tt * 4;
  r.vo = r.vs + tt * 4;
  r.bytes = r.vo + tt * 4;
  return r;
}

// the ring, or the end-of-block merge scratch [DW][G][D + 2] that reuses it
__host__ __device__ inline int ring_span(const FdArgs& a) {
  const int ring = a.n_stage * ring_layout(a).bytes;
  const int merge = DW * a.Q * (a.D + 2) * 4;
  return ring > merge ? ring : merge;
}

// dynamic shared memory: 128 B of mbarriers, the ring, the block's queries
// (hb * G * D), the static-channel dims (hb * n_kc)
__host__ __device__ inline int decode_smem(const FdArgs& a) {
  return 128 + ring_span(a) + 4 * (a.hb * a.Q * a.D + a.hb * a.n_kc);
}

// Small integers to fp32 without a conversion instruction (those issue at
// a sixteenth of the FMA rate): u < 2**23 in the mantissa of 2**23.
__device__ __forceinline__ float small_uint(uint32_t u) {
  return __uint_as_float(0x4B000000u | u) - 8388608.0f;
}
// the signed code of an int4 nibble n (two's complement), of an int8 byte b
__device__ __forceinline__ float int4_code(uint32_t n) {
  return __uint_as_float(0x4B000000u | (n ^ 8u)) - 8388616.0f;
}
__device__ __forceinline__ float int8_code(uint32_t b) {
  return __uint_as_float(0x4B000000u | (b ^ 0x80u)) - 8388736.0f;
}

// The lane's four codes (columns c0, c0 + 1, c0 + D/2, c0 + D/2 + 1) of
// staged container row tt, as the folded dequant multiplies them: signed
// (int4 / int8) or unsigned (int4x2, head parity `odd`) small integers.
template <int MODE>
__device__ __forceinline__ void container_codes(const unsigned char* codes, int tt, int D,
                                                int c0, int half, int odd, float (&x)[4]) {
  if (MODE == MODE_INT8) {
    const unsigned char* row = codes + tt * D;
    const uint32_t w0 = *reinterpret_cast<const uint16_t*>(row + c0);
    const uint32_t w1 = *reinterpret_cast<const uint16_t*>(row + c0 + half);
    x[0] = int8_code(w0 & 0xFFu);
    x[1] = int8_code(w0 >> 8);
    x[2] = int8_code(w1 & 0xFFu);
    x[3] = int8_code(w1 >> 8);
  } else {
    const unsigned char* row = codes + tt * half;
    const uint32_t b0 = row[c0 >> 1], b1 = row[(c0 + half) >> 1];
    if (MODE == MODE_INT4X2) {
      const int sh = 2 * odd;
      x[0] = small_uint(((b0 ^ 8u) >> sh) & 3u);
      x[1] = small_uint((((b0 >> 4) ^ 8u) >> sh) & 3u);
      x[2] = small_uint(((b1 ^ 8u) >> sh) & 3u);
      x[3] = small_uint((((b1 >> 4) ^ 8u) >> sh) & 3u);
    } else {
      x[0] = int4_code(b0 & 0xFu);
      x[1] = int4_code(b0 >> 4);
      x[2] = int4_code(b1 & 0xFu);
      x[3] = int4_code(b1 >> 4);
    }
  }
}

// The producer thread of a decode block (fd_decode, fd_gqa): keeps the
// ring full with the tiles [t_begin, t_end) of the block's hb heads from
// h0 (int4x2: their pair containers), the head group's outlier rows and the
// V scale / offset, one TMA bulk copy per piece, through the page table
// when K5 passes one.
template <int MODE>
__device__ __forceinline__ void produce_tiles(const FdArgs& a, unsigned char* ring, uint64_t* full,
                                              uint64_t* empty, const Ring& R, int b, int h0,
                                              int grp, int pos, int t_begin, int t_end) {
  constexpr int TILE = tile_tokens(MODE);
  const int li = a.li, S = a.S, D = a.D, hb = a.hb, NS = a.n_stage;
  // the addressing policy: K5 passes a page table, K1 none
  const bool paged = a.table != nullptr;
  const size_t lay = (size_t)li * (paged ? Paged::slabs(a) : Contig::slabs(a));
  const int TS = paged ? Paged::tokens(a) : Contig::tokens(a);
  const int last = paged ? Paged::last_page(a, pos, S) : 0;
  const bool paired = MODE == MODE_INT4X2;
  const int Hc = paired ? a.Hkv / 2 : a.Hkv, hc0 = paired ? h0 / 2 : h0;
  const int units = paired ? hb / 2 : hb;
  const int cb = code_bytes(MODE, a.bits, D), NG = a.Hkv / a.hg;
  const int nrows = rows_copied(a);
  for (int i = t_begin; i < t_end; ++i) {
    const int u = i - t_begin, st = u % NS;
    if (u >= NS) mbar_wait(&empty[st], (u / NS - 1) & 1);
    // under paging the page lookup comes before the copy through it
    const int2 sr = paged ? Paged::locate(a, b, i * TILE, last)
                          : Contig::locate(a, b, i * TILE, last);
    const size_t slab = lay + sr.x;
    unsigned char* dst = ring + st * R.bytes;
    mbar_expect_tx(&full[st], R.bytes);
    for (int c = 0; c < units; ++c) {
      const size_t hs = slab * Hc + hc0 + c;
      if (MODE == MODE_NUQ) {
        // plane bb: word rows 4g .. 4g + 3 of the tile's 128-token group
        const size_t TW = TS / 32;
        for (int bb = 0; bb < a.bits; ++bb) {
          const size_t w = (hs * a.bits + bb) * TW * D + (size_t)(sr.y / 32) * D;
          bulk_g2s(dst + R.k + c * cb + bb * 16 * D,
                   reinterpret_cast<const int32_t*>(a.kp) + w, 16 * D, &full[st]);
          bulk_g2s(dst + R.v + c * cb + bb * 16 * D,
                   reinterpret_cast<const int32_t*>(a.vp) + w, 16 * D, &full[st]);
        }
      } else {
        const size_t rb = MODE == MODE_INT8 ? D : D / 2;
        const size_t o = (hs * TS + sr.y) * rb;
        bulk_g2s(dst + R.k + c * cb, reinterpret_cast<const uint8_t*>(a.kp) + o,
                 cb, &full[st]);
        bulk_g2s(dst + R.v + c * cb, reinterpret_cast<const uint8_t*>(a.vp) + o,
                 cb, &full[st]);
      }
    }
    for (int r = 0; r < nrows; ++r)
      bulk_g2s(dst + R.rows + r * TILE * 4,
               a.kv_out + ((slab * NG + grp) * a.J + r) * TS + sr.y,
               TILE * 4, &full[st]);
    bulk_g2s(dst + R.vs, a.v_scale + slab * TS + sr.y, TILE * 4, &full[st]);
    bulk_g2s(dst + R.vo, a.v_offset + slab * TS + sr.y, TILE * 4, &full[st]);
  }
}

// The end of a decode block (fd_decode, fd_gqa): the DW consumer warps'
// (acc [G][D], m, l) in the merge scratch `red` ([DW][G][D + 2], the
// warps of head k at k * DW / hb ..) merged by log-sum-exp into split s's
// partials of the block's hb heads.
__device__ __forceinline__ void merge_warps(const FdArgs& a, const float* red, int G,
                                            size_t bh0, int s, int tid) {
  const int D = a.D, hb = a.hb, WPH = DW / hb, NSP = a.n_split;
  for (int i = tid; i < hb * G * D; i += DNT) {
    const int k = i / (G * D), r = (i / D) % G, d = i % D;
    const float* rw = red + ((size_t)k * WPH * G + r) * (D + 2);
    const size_t wstride = (size_t)G * (D + 2);
    float M = -INFINITY;
    for (int w = 0; w < WPH; ++w) M = fmaxf(M, rw[w * wstride + D]);
    float acc = 0.f, L = 0.f;
    for (int w = 0; w < WPH; ++w) {
      const float mw = rw[w * wstride + D];
      const float e = mw == -INFINITY ? 0.f : expf(mw - M);
      acc = fmaf(e, rw[w * wstride + d], acc);
      L = fmaf(e, rw[w * wstride + D + 1], L);
    }
    const size_t pi = ((bh0 + k) * NSP + s) * G + r;
    a.part_acc[pi * D + d] = acc;
    if (d == 0) {
      a.part_m[pi] = M;
      a.part_l[pi] = L;
    }
  }
}

// One block: batch row b (blockIdx.z), kv heads [h0, h0 + hb) of one head
// group (blockIdx.y), split s of the live key tiles (blockIdx.x). Warp DW
// is the producer; consumer warp `warp` takes head slot warp / WPH and the
// chunks c = warp % WPH (mod WPH) of each tile. MODE, NB (nuq planes; 0
// for the containers), G rows per head, AP the addressing policy.
template <int MODE, int NB, int G, bool PRE>
__global__ void __launch_bounds__(DNT, G >= 4 ? 1 : 2) fd_decode(FdArgs a) {
  extern __shared__ __align__(128) unsigned char dsm[];
  constexpr int C = 32 / G;              // tokens per chunk
  constexpr int NWD = (C / 4 + 3) / 4;   // code words per (column, word row)
  constexpr int TILE = tile_tokens(MODE);
  __shared__ float sLut[2][16];          // nuq K / V codebooks of layer li
  const int D = a.D, half = D / 2, hb = a.hb, NS = a.n_stage;
  const Ring R = ring_layout(a);
  uint64_t* full = reinterpret_cast<uint64_t*>(dsm);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* ring = dsm + 128;
  float* sQ = reinterpret_cast<float*>(ring + ring_span(a));
  int* sCh = reinterpret_cast<int*>(sQ + hb * G * D);

  const int s = blockIdx.x, h0 = blockIdx.y * hb, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = a.li, S = a.S, win = a.window, NSP = a.n_split;
  const bool bf = a.dot_bf16 != 0;
  const int pos = a.pos[b];

  // ---- this block's live key tiles: packed tokens [lo, hi] ----
  const int hi = min(pos - S, a.Tc - 1);
  const int lo = win > 0 ? max(0, pos - win + 1 - S) : 0;
  const int n_tiles = hi < lo ? 0 : hi / TILE - lo / TILE + 1;
  const int tps = max(MIN_TPS, (n_tiles + NSP - 1) / NSP);
  const int t_begin = lo / TILE + s * tps;
  const int t_end = min(lo / TILE + n_tiles, t_begin + tps);
  const size_t bh0 = (size_t)b * a.Hkv + h0;
  if (t_begin >= t_end) {  // a split with no tile: zero weight in the merge
    for (int i = tid; i < hb * G; i += DNT) {
      const size_t pi = ((bh0 + i / G) * NSP + s) * G + i % G;
      a.part_m[pi] = -INFINITY;
      a.part_l[pi] = 0.f;
    }
    return;
  }

  // ---- per-block constants ----
  const int grp = h0 / a.hg, jh0 = h0 % a.hg;
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], DW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const float* qb = a.q + bh0 * G * D;
  for (int i = tid; i < hb * G * D; i += DNT) sQ[i] = rnd(qb[i], bf);
  const int K = 1 << a.bits;
  if (MODE == MODE_NUQ && tid < K) {
    sLut[0][tid] = a.k_lut[(size_t)li * K + tid];
    sLut[1][tid] = a.v_lut[(size_t)li * K + tid];
  }
  for (int i = tid; i < hb * a.n_kc; i += DNT) {
    const int k = i / a.n_kc;
    const int ch = a.k_chan[grp * a.n_kc + i % a.n_kc];
    sCh[i] = ch / D == jh0 + k ? ch % D : -1;
  }
  __syncthreads();

  // consumer lane l owns columns 2l, 2l + 1 and their RoPE partners (lanes
  // past D/2 hold zero queries and store nothing); its running state
  const bool act = 2 * lane < half;
  const int c0 = act ? 2 * lane : 0;
  const int cols[4] = {c0, c0 + 1, c0 + half, c0 + half + 1};
  float m[G], l[G], o[G][4];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[r][j] = 0.f;
  }

  if (warp == DW) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) produce_tiles<MODE>(a, ring, full, empty, R, b, h0, grp, pos, t_begin, t_end);
  } else {
    // ---- consumers ----
    const int WPH = DW / hb, k = warp / WPH, wk = warp % WPH;
    const int h = h0 + k, jh = jh0 + k;
    const int lgD = 31 - __clz(D);  // D is 32, 64 or 128
    // per-column dequant constants: nuq (range, offset); the containers'
    // affine codebook folded as in the plain version (common.fold_affine):
    // code c_s -> c_s * step + zero, c_s signed (int4 / int8) or unsigned
    // (int4x2, bias 0)
    const float* kl = a.k_lut + (size_t)li * K;
    const float* vl = a.v_lut + (size_t)li * K;
    const float bias = MODE == MODE_INT4X2 ? 0.f : (float)(1 << (a.bits - 1));
    const float kb = (kl[K - 1] - kl[0]) / (float)(K - 1);
    const float ka = kl[0] + bias * kb;
    const float vb = (vl[K - 1] - vl[0]) / (float)(K - 1);
    const float va = vl[0] + bias * vb;
    const size_t cidx = ((size_t)li * a.Hkv + h) * D;
    float ks[4], kz[4], q[G][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float kr = a.k_range[cidx + cols[j]], ko = a.k_offset[cidx + cols[j]];
      ks[j] = MODE == MODE_NUQ ? kr : kb * kr;
      kz[j] = MODE == MODE_NUQ ? ko : ka * kr + ko;
    }
#pragma unroll
    for (int r = 0; r < G; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) q[r][j] = act ? sQ[(k * G + r) * D + cols[j]] : 0.f;
    const float* sQh = sQ + k * G * D;
    const int odd = h & 1, cu = MODE == MODE_INT4X2 ? k / 2 : k;
    const int cb = code_bytes(MODE, a.bits, D);
    const int rlane = lane / C, tlane = lane % C;  // (row, token) of lane's score
    const int rstr = half / 2;  // float4 of the (cos, sin) table per token

    // an outlier value v at (token t_abs, dim) of this head's key, as a
    // score term of the lane's row: RoPE is linear, so v at dim d adds
    // v*cos at d and +-v*sin at its partner d +- D/2
    auto kterm = [&](int t_abs, int dim, float v) {
      const float* qr = sQh + rlane * D;
      if (!PRE) return qr[dim] * rnd(v, bf);
      const int i = dim & (half - 1);
      const float2 cs = __ldg(a.rope + (size_t)t_abs * half + i);
      const float t0v = rnd(v * cs.x, bf);
      const float t1v = rnd(dim < half ? v * cs.y : -v * cs.y, bf);
      return qr[dim] * t0v + qr[dim < half ? dim + half : i] * t1v;
    };

    for (int it = t_begin; it < t_end; ++it) {
      const int u = it - t_begin, st = u % NS;
      mbar_wait(&full[st], (u / NS) & 1);
      const unsigned char* stg = ring + st * R.bytes;
      const unsigned char* sKc = stg + R.k + cu * cb;
      const unsigned char* sVc = stg + R.v + cu * cb;
      const float* sRows = reinterpret_cast<const float*>(stg + R.rows);
      const float* sVs = reinterpret_cast<const float*>(stg + R.vs);
      const float* sVo = reinterpret_cast<const float*>(stg + R.vo);
      const int t0 = it * TILE;
      for (int ch = wk; ch < TILE / C; ch += WPH) {
        const int tc = ch * C;  // chunk's first token in the tile
        // the chunk's (cos, sin) rows, one 16-byte load per token and lane
        const float4* rope_c = reinterpret_cast<const float4*>(a.rope) +
                               ((size_t)(t0 + tc) * half + c0) / 2;

        // ---- scores: partial dots of (row, token), then the butterfly ----
        float part[32];
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          uint32_t cw[4][NWD];
          if (MODE == MODE_NUQ) nuq_bytes<NB>(sKc, w4, D, c0, half, tc / 4, cw);
#pragma unroll
          for (int j = 0; j < C / 4; ++j) {
            const int t = 4 * j + w4, tt = tc + t;
            float x[4];
            if (MODE == MODE_NUQ) {
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                x[jj] = *reinterpret_cast<const float*>(
                    reinterpret_cast<const char*>(sLut[0]) + byte_of(cw[jj][j / 4], j % 4));
            } else {
              container_codes<MODE>(sKc, tt, D, c0, half, odd, x);
            }
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) x[jj] = fmaf(x[jj], ks[jj], kz[jj]);
            if (PRE) {  // rotate the pairs (c0, c0 + D/2), (c0 + 1, c0 + 1 + D/2)
              const float4 cs = __ldg(rope_c + t * rstr);
              const float r0 = x[0] * cs.x - x[2] * cs.y;
              const float r2 = x[2] * cs.x + x[0] * cs.y;
              const float r1 = x[1] * cs.z - x[3] * cs.w;
              const float r3 = x[3] * cs.z + x[1] * cs.w;
              x[0] = r0; x[1] = r1; x[2] = r2; x[3] = r3;
            }
            rnd4(x, bf);
#pragma unroll
            for (int r = 0; r < G; ++r) {
              float acc = q[r][0] * x[0];
#pragma unroll
              for (int jj = 1; jj < 4; ++jj) acc = fmaf(q[r][jj], x[jj], acc);
              part[r * C + t] = acc;
            }
          }
        }
        float sc = transpose_reduce(part, lane);

        // ---- K outliers of the lane's (row, token) ----
        const int tt_l = tc + tlane, ta_l = t0 + tt_l;
        if (a.n_kc > 0) {
          for (int n = 0; n < a.n_kc; ++n) {
            const int dim = sCh[k * a.n_kc + n];
            if (dim >= 0) sc += kterm(ta_l, dim, sRows[n * TILE + tt_l]);
          }
        } else {
          for (int sl = 0; sl < a.n_kslots; ++sl) {
            const uint32_t w = __float_as_uint(sRows[sl * TILE + tt_l]);
            const int gidx = (int)((w >> 7) & 0x3u) * D + (int)(w & 0x7Fu);
            if ((gidx >> lgD) == jh)
              sc += kterm(ta_l, gidx & (D - 1), __uint_as_float(w & 0xFFFFFE00u));
          }
        }
        sc = key_ok(ta_l, pos, S, win) ? sc * a.inv : -INFINITY;

        // ---- online softmax over the chunk: C lanes per row ----
        float mx = sc;
#pragma unroll
        for (int off = C / 2; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        float m_mine = -INFINITY;
        float alpha[G];
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const float m_new = fmaxf(m[r], __shfl_sync(FULL, mx, r * C));
          alpha[r] = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
          m[r] = m_new;
          if (r == rlane) m_mine = m_new;
        }
        const float p = sc == -INFINITY ? 0.f : expf(sc - m_mine);
        float sum = p;
#pragma unroll
        for (int off = C / 2; off; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
#pragma unroll
        for (int r = 0; r < G; ++r) {
          l[r] = l[r] * alpha[r] + __shfl_sync(FULL, sum, r * C);
#pragma unroll
          for (int j = 0; j < 4; ++j) o[r][j] *= alpha[r];
        }
        const float pr = rnd(p, bf);

        // ---- P.V over the chunk; a token past the live range gets a zero
        // V scale and offset, so its value is 0 whatever its codes ----
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          uint32_t cw[4][NWD];
          if (MODE == MODE_NUQ) nuq_bytes<NB>(sVc, w4, D, c0, half, tc / 4, cw);
#pragma unroll
          for (int j = 0; j < C / 4; ++j) {
            const int t = 4 * j + w4, tt = tc + t;
            const bool live = t0 + tt <= hi;
            const float sc_t = live ? sVs[tt] : 0.f, of_t = live ? sVo[tt] : 0.f;
            const float vs_t = MODE == MODE_NUQ ? sc_t : sc_t * vb;
            const float vo_t = MODE == MODE_NUQ ? of_t : sc_t * va + of_t;
            float y[4];
            if (MODE == MODE_NUQ) {
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                y[jj] = *reinterpret_cast<const float*>(
                    reinterpret_cast<const char*>(sLut[1]) + byte_of(cw[jj][j / 4], j % 4));
            } else {
              container_codes<MODE>(sVc, tt, D, c0, half, odd, y);
            }
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) y[jj] = fmaf(y[jj], vs_t, vo_t);
            rnd4(y, bf);
#pragma unroll
            for (int r = 0; r < G; ++r) {
              const float pt = __shfl_sync(FULL, pr, r * C + t);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) o[r][jj] = fmaf(pt, y[jj], o[r][jj]);
            }
          }
        }

        // ---- V slots of the chunk, this head's words by ballot: entry
        // e = slot * C + token, one per lane and round ----
        if (a.n_vslots > 0) {
          const int ne = C * a.n_vslots;
          for (int e0 = 0; e0 < ne; e0 += 32) {
            const int e = e0 + lane, tt = tc + (e & (C - 1));
            uint32_t w = 0u;
            bool mine = false;
            if (e < ne) {
              w = __float_as_uint(sRows[(a.spk + e / C) * TILE + tt]);
              const int gidx = (int)((w >> 7) & 0x3u) * D + (int)(w & 0x7Fu);
              mine = (gidx >> lgD) == jh && t0 + tt <= hi;
            }
            unsigned msk = __ballot_sync(FULL, mine);
            while (msk) {
              const int src = __ffs(msk) - 1;
              msk &= msk - 1;
              const uint32_t ws = __shfl_sync(FULL, w, src);
              const int d = ((int)((ws >> 7) & 0x3u) * D + (int)(ws & 0x7Fu)) & (D - 1);
              const float v = rnd(__uint_as_float(ws & 0xFFFFFE00u), bf);
              const int t = src & (C - 1);  // e0 is a multiple of C
#pragma unroll
              for (int r = 0; r < G; ++r) {
                const float pt = __shfl_sync(FULL, pr, r * C + t);
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                  if (act && cols[jj] == d) o[r][jj] = fmaf(pt, v, o[r][jj]);
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // the stage may be refilled
    }
  }

  __syncthreads();  // every tile consumed: the ring becomes merge scratch
  if (warp < DW) {
    float* red = reinterpret_cast<float*>(ring) + (size_t)warp * G * (D + 2);
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (act) {
#pragma unroll
        for (int j = 0; j < 4; ++j) red[r * (D + 2) + cols[j]] = o[r][j];
      }
      if (lane == 0) {
        red[r * (D + 2) + D] = m[r];
        red[r * (D + 2) + D + 1] = l[r];
      }
    }
  }
  __syncthreads();

  // ---- merge the warps of each head: this split's partials ----
  merge_warps(a, reinterpret_cast<const float*>(ring), G, bh0, s, tid);
}

// ===========================================================================
// fd_gqa: Tq = 1, 3..8 rows per kv head, bf16 dots, on the tensor cores
// ===========================================================================

constexpr int GPS = GU + 8;  // bf16 stride of a row of a warp's P^T tile
constexpr int GVS = GU + 8;  // bf16 stride of a row (a dim) of a warp's V slot tile

// dynamic shared memory of fd_gqa: 128 B of mbarriers, the ring (or the
// merge scratch), the block's queries transposed [hb][D][8] fp32, the
// static-channel dims [hb][n_kc], the heads' K step and zero [hb][2][D],
// per consumer warp an exchange tile [8][GXS] fp32 that is also its P^T
// tile [8][GPS] bf16 and, with V slots, its V^T slot tile [D][GVS] bf16
struct GqaSmem {
  int q, ch, kc, p, vt, bytes;
};
__host__ __device__ inline GqaSmem gqa_layout(const FdArgs& a) {
  GqaSmem L;
  L.q = 128 + ring_span(a);
  L.ch = L.q + 4 * a.hb * 8 * a.D;
  L.kc = (L.ch + 4 * a.hb * a.n_kc + 15) & ~15;
  L.p = L.kc + 4 * a.hb * 2 * a.D;
  L.vt = L.p + DW * GXB;
  L.bytes = L.vt + (a.n_vslots > 0 ? 2 * DW * a.D * GVS : 0);
  return L;
}

// The container codes of staged row tt at dims c .. c + 3 (x[0..3]) and
// their partners c + D/2 .. (x[4..7]), as the folded dequant multiplies
// them (container_codes' arithmetic)
template <int MODE>
__device__ __forceinline__ void gqa_container_codes(const unsigned char* codes, int tt, int D,
                                                    int c, int odd, float (&x)[8]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int cc = c + p * (D / 2);
    if (MODE == MODE_INT8) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(codes + tt * D + cc);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[4 * p + i] = int8_code((w >> (8 * i)) & 0xFFu);
    } else {
      const uint32_t w = *reinterpret_cast<const uint16_t*>(codes + tt * (D / 2) + cc / 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t n = (w >> (4 * i)) & 0xFu;
        x[4 * p + i] = MODE == MODE_INT4X2 ? small_uint(((n ^ 8u) >> (2 * odd)) & 3u)
                                           : int4_code(n);
      }
    }
  }
}

// the container code of staged row tt at dim d
template <int MODE>
__device__ __forceinline__ float gqa_container_code(const unsigned char* codes, int tt, int D,
                                                    int d, int odd) {
  if (MODE == MODE_INT8) return int8_code(codes[tt * D + d]);
  const uint32_t n = (codes[tt * (D / 2) + (d >> 1)] >> (4 * (d & 1))) & 0xFu;
  return MODE == MODE_INT4X2 ? small_uint(((n ^ 8u) >> (2 * odd)) & 3u) : int4_code(n);
}

// One block: as fd_decode (batch row b, kv heads [h0, h0 + hb), split s),
// G = a.Q rows per head. Consumer warp `warp` takes head warp / WPH and the
// units (32-token slices of a stage) warp % WPH (mod WPH); warps past a
// stage's units idle (hb = 1 bit planes, hb <= 2 containers). Per unit:
// scores S^T = K Q^T as 2 m16 tiles x D/16 k-blocks (hopper.cuh's layout),
// the outliers' fp32 terms, an online softmax in log2 units per row (a
// column of C), P^T through the warp's bf16 tile, then O^T += V^T P^T with
// V^T in registers: m-block mt, row g (+ 8) is dim 16 mt + g (+ 8); k-step
// hh, column 2tq + e + 8f is unit slot tq + 4hh + 8e + 16f (bit planes) or
// 16hh + 2tq + e + 8f (containers), at P^T position 16hh + 2tq + e + 8f.
template <int MODE, int NB, bool PRE>
__global__ void __launch_bounds__(DNT, 1) fd_gqa(FdArgs a) {
  extern __shared__ __align__(128) unsigned char dsm[];
  constexpr int TILE = tile_tokens(MODE);
  constexpr int UPS = TILE / GU;       // units per stage
  constexpr int NM = MAXD / 16;        // m-blocks of P.V at most
  __shared__ float sLut[2][16];        // nuq K / V codebooks of layer li
  const int D = a.D, half = D / 2, hb = a.hb, NS = a.n_stage, G = a.Q;
  const Ring R = ring_layout(a);
  const GqaSmem SL = gqa_layout(a);
  uint64_t* full = reinterpret_cast<uint64_t*>(dsm);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* ring = dsm + 128;
  float* sQT = reinterpret_cast<float*>(dsm + SL.q);
  int* sCh = reinterpret_cast<int*>(dsm + SL.ch);
  float* sKc = reinterpret_cast<float*>(dsm + SL.kc);

  const int s = blockIdx.x, h0 = blockIdx.y * hb, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = a.li, S = a.S, win = a.window, NSP = a.n_split;
  const int pos = a.pos[b];

  // ---- this block's live key tiles: packed tokens [lo, hi] ----
  const int hi = min(pos - S, a.Tc - 1);
  const int lo = win > 0 ? max(0, pos - win + 1 - S) : 0;
  const int n_tiles = hi < lo ? 0 : hi / TILE - lo / TILE + 1;
  const int tps = max(MIN_TPS, (n_tiles + NSP - 1) / NSP);
  const int t_begin = lo / TILE + s * tps;
  const int t_end = min(lo / TILE + n_tiles, t_begin + tps);
  const size_t bh0 = (size_t)b * a.Hkv + h0;
  if (t_begin >= t_end) {  // a split with no tile: zero weight in the merge
    for (int i = tid; i < hb * G; i += DNT) {
      const size_t pi = ((bh0 + i / G) * NSP + s) * G + i % G;
      a.part_m[pi] = -INFINITY;
      a.part_l[pi] = 0.f;
    }
    return;
  }

  // ---- per-block constants ----
  const int grp = h0 / a.hg, jh0 = h0 % a.hg;
  const int WPH = DW / hb, nact = hb * min(WPH, UPS);
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], nact);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const float* qb = a.q + bh0 * G * D;
  for (int i = tid; i < hb * D * 8; i += DNT) {  // [k][d][r], rows past G zero
    const int k = i / (8 * D), d = (i / 8) % D, r = i % 8;
    sQT[i] = r < G ? rnd(qb[((size_t)k * G + r) * D + d], true) : 0.f;
  }
  const int K = 1 << a.bits;
  if (MODE == MODE_NUQ && tid < K) {
    sLut[0][tid] = a.k_lut[(size_t)li * K + tid];
    sLut[1][tid] = a.v_lut[(size_t)li * K + tid];
  }
  for (int i = tid; i < hb * a.n_kc; i += DNT) {
    const int k = i / a.n_kc;
    const int ch = a.k_chan[grp * a.n_kc + i % a.n_kc];
    sCh[i] = ch / D == jh0 + k ? ch % D : -1;
  }
  // per-column dequant constants: nuq (range, offset); the containers'
  // affine codebook folded as in the plain version (common.fold_affine)
  const float* kl = a.k_lut + (size_t)li * K;
  const float* vl = a.v_lut + (size_t)li * K;
  const float bias = MODE == MODE_INT4X2 ? 0.f : (float)(1 << (a.bits - 1));
  const float kb = (kl[K - 1] - kl[0]) / (float)(K - 1);
  const float ka = kl[0] + bias * kb;
  const float vb = (vl[K - 1] - vl[0]) / (float)(K - 1);
  const float va = vl[0] + bias * vb;
  for (int i = tid; i < hb * D; i += DNT) {
    const int k = i / D, d = i % D;
    const size_t ci = ((size_t)li * a.Hkv + h0 + k) * D + d;
    const float kr = a.k_range[ci], ko = a.k_offset[ci];
    sKc[2 * k * D + d] = MODE == MODE_NUQ ? kr : kb * kr;
    sKc[(2 * k + 1) * D + d] = MODE == MODE_NUQ ? ko : ka * kr + ko;
  }
  if (a.n_vslots > 0)  // the V slot tiles start zero; each unit clears what it wrote
    for (int i = tid; i < DW * D * GVS / 2; i += DNT) reinterpret_cast<uint32_t*>(dsm + SL.vt)[i] = 0u;
  __syncthreads();

  // the consumer's lane roles and running state (an idle warp keeps the
  // initial state, which the merge weighs zero)
  const int g = lane >> 2, tq = lane & 3;
  const bool r0ok = 2 * tq < G, r1ok = 2 * tq + 1 < G;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NM][4];
#pragma unroll
  for (int mt = 0; mt < NM; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[mt][r] = 0.f;

  if (warp == DW) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) produce_tiles<MODE>(a, ring, full, empty, R, b, h0, grp, pos, t_begin, t_end);
  } else if (warp % WPH < UPS) {
    // ---- consumers ----
    const int k = warp / WPH, wk = warp % WPH;
    const int h = h0 + k, jh = jh0 + k, lgD = 31 - __clz(D);
    const int odd = h & 1, cu = MODE == MODE_INT4X2 ? k / 2 : k;
    const int cb = code_bytes(MODE, a.bits, D);
    const float* qT = sQT + k * D * 8;
    const float* kst = sKc + 2 * k * D;
    const float* kze = kst + D;
    float* sX = reinterpret_cast<float*>(dsm + SL.p + warp * GXB);
    uint16_t* sP = reinterpret_cast<uint16_t*>(sX);
    __nv_bfloat16* sVt = reinterpret_cast<__nv_bfloat16*>(dsm + SL.vt) + (size_t)warp * D * GVS;
    // a V slot word's dim in this head, or -1
    auto vdim = [&](uint32_t w) {
      const int gidx = (int)((w >> 7) & 0x3u) * D + (int)(w & 0x7Fu);
      return (gidx >> lgD) == jh ? gidx & (D - 1) : -1;
    };
    const float scl = a.inv * LOG2E;
    uint32_t qf[GNJ][2][2];
    gqa_query_frags(qT, D, g, tq, qf);

    // an outlier value v at (token t_abs, dim) of this head's key, as the
    // score terms e of every query row: RoPE is linear, so v at dim d adds
    // v*cos at d and +-v*sin at its partner d +- D/2
    auto kterm = [&](int t_abs, int dim, float v, float (&e)[8]) {
      float qd[8];
      gqa_q8(qT, dim, qd);
      if (!PRE) {
        const float rv = rnd(v, true);
#pragma unroll
        for (int r = 0; r < 8; ++r) e[r] = fmaf(qd[r], rv, e[r]);
        return;
      }
      const int i = dim & (half - 1);
      const float2 cs = __ldg(a.rope + (size_t)t_abs * half + i);
      const float t0v = rnd(v * cs.x, true);
      const float t1v = rnd(dim < half ? v * cs.y : -v * cs.y, true);
      float qp[8];
      gqa_q8(qT, dim < half ? dim + half : i, qp);
#pragma unroll
      for (int r = 0; r < 8; ++r) e[r] += qd[r] * t0v + qp[r] * t1v;
    };
    // the P^T position of unit slot sl (bit planes: the V operand's column
    // order, hopper.cuh)
    auto ppos = [](int sl) {
      return MODE == MODE_NUQ
                 ? 16 * ((sl >> 2) & 1) + 8 * ((sl >> 4) & 1) + 2 * (sl & 3) + ((sl >> 3) & 1)
                 : sl;
    };

    for (int it = t_begin; it < t_end; ++it) {
      const int u = it - t_begin, st = u % NS;
      mbar_wait(&full[st], (u / NS) & 1);
      const unsigned char* stg = ring + st * R.bytes;
      const unsigned char* sKq = stg + R.k + cu * cb;
      const unsigned char* sVq = stg + R.v + cu * cb;
      const float* sRows = reinterpret_cast<const float*>(stg + R.rows);
      const float* sVs = reinterpret_cast<const float*>(stg + R.vs);
      const float* sVo = reinterpret_cast<const float*>(stg + R.vo);
      const int t0 = it * TILE;
      for (int un = wk; un < UPS; un += WPH) {
        // the tile token of unit slot sl
        auto tok = [&](int sl) { return MODE == MODE_NUQ ? 4 * sl + un : GU * un + sl; };

        // ---- scores: A = keys in registers, B = the query rows ----
        float sc[2][4];
        if (MODE == MODE_NUQ) {
          gqa_nuq_scores<NB, PRE>(sKq, D, un, kst, kze, sLut[0],
                                  PRE ? a.rope + (size_t)t0 * half : nullptr, g, tq, qf, sc);
        } else {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int r = 0; r < 4; ++r) sc[hh][r] = 0.f;
#pragma unroll
          for (int j = 0; j < GNJ; ++j) {
            if (j < D / 32) {
              const int c = 16 * j + 4 * tq;
              const float4 s0 = *reinterpret_cast<const float4*>(kst + c);
              const float4 s1 = *reinterpret_cast<const float4*>(kst + c + half);
              const float4 z0 = *reinterpret_cast<const float4*>(kze + c);
              const float4 z1 = *reinterpret_cast<const float4*>(kze + c + half);
              const float ks[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
              const float kz[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                uint32_t af[2][4];
#pragma unroll
                for (int f = 0; f < 2; ++f) {
                  const int tt = tok(g + 8 * (2 * hh + f));
                  const Rot4 rot =
                      gqa_rot4<PRE>(PRE ? a.rope + (size_t)(t0 + tt) * half + c : nullptr);
                  float x[8];
                  gqa_container_codes<MODE>(sKq, tt, D, c, odd, x);
#pragma unroll
                  for (int i = 0; i < 8; ++i) x[i] = fmaf(x[i], ks[i], kz[i]);
                  gqa_key_frag<PRE>(x, rot, f, af);
                }
#pragma unroll
                for (int e = 0; e < 2; ++e) mma16816(sc[hh], af[e], qf[j][e][0], qf[j][e][1]);
              }
            }
          }
        }

        // ---- K outliers (fp32, by linearity): lane l takes unit slot l,
        // its rows' terms for every query row, exchanged to the lanes that
        // hold its scores ----
        if (a.n_kc > 0 || a.n_kslots > 0) {
          const int tl = tok(lane), tal = t0 + tl;
          float e[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) e[r] = 0.f;
          if (a.n_kc > 0) {
            for (int n = 0; n < a.n_kc; ++n) {
              const int dim = sCh[k * a.n_kc + n];
              if (dim >= 0) kterm(tal, dim, sRows[n * TILE + tl], e);
            }
          } else {
            for (int sl = 0; sl < a.n_kslots; ++sl) {
              const uint32_t w = __float_as_uint(sRows[sl * TILE + tl]);
              const int gidx = (int)((w >> 7) & 0x3u) * D + (int)(w & 0x7Fu);
              if ((gidx >> lgD) == jh)
                kterm(tal, gidx & (D - 1), __uint_as_float(w & 0xFFFFFE00u), e);
            }
          }
          gqa_exchange(sX, lane, e, g, tq, sc);
        }

        // ---- mask, scale to log2 units ----
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int hh = q >> 1, f = q & 1, ta = t0 + tok(g + 8 * q);
          const bool ok = key_ok(ta, pos, S, win);
          const float s0 = ok ? sc[hh][2 * f] * scl : -INFINITY;
          const float s1 = ok ? sc[hh][2 * f + 1] * scl : -INFINITY;
          sc[hh][2 * f] = s0;
          sc[hh][2 * f + 1] = s1;
          mx0 = fmaxf(mx0, s0);
          mx1 = fmaxf(mx1, s1);
        }
        // the unit's row maxima: the lanes of one tq hold a row's 32 slots
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
        l0 *= al0;
        l1 *= al1;
#pragma unroll
        for (int mt = 0; mt < NM; ++mt) {
          acc[mt][0] *= al0;
          acc[mt][1] *= al1;
          acc[mt][2] *= al0;
          acc[mt][3] *= al1;
        }

        // ---- probabilities: l, P^T as bf16 (rows past G zero) ----
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int hh = q >> 1, f = q & 1, pp = ppos(g + 8 * q);
          const float p0 = sc[hh][2 * f] == -INFINITY || !r0ok ? 0.f : exp2f(sc[hh][2 * f] - mn0);
          const float p1 =
              sc[hh][2 * f + 1] == -INFINITY || !r1ok ? 0.f : exp2f(sc[hh][2 * f + 1] - mn1);
          l0 += p0;
          l1 += p1;
          sP[2 * tq * GPS + pp] = __bfloat16_as_ushort(__float2bfloat16_rn(p0));
          sP[(2 * tq + 1) * GPS + pp] = __bfloat16_as_ushort(__float2bfloat16_rn(p1));
        }
        __syncwarp();
        // ---- V slots: lane l writes its slot's V slot values (summed per
        // dim in slot order, rounded once: rnd(v_add)) into column ppos(l)
        // of the warp's V^T slot tile, a second A operand of P.V: rnd(p)
        // rnd(v_add), the plain version's rounding; vmask: the m-blocks
        // the unit's slots touch ----
        unsigned vmask = 0u;
        const bool vlive = a.n_vslots > 0 && t0 + tok(lane) <= hi;
        const float* vrow = sRows + a.spk * TILE + tok(lane);  // the slot's V words, TILE apart
        if (vlive) {
          for (int j = 0; j < a.n_vslots; ++j) {
            const int dj = vdim(__float_as_uint(vrow[j * TILE]));
            bool first = dj >= 0;
            for (int j2 = 0; j2 < j; ++j2) first = first && vdim(__float_as_uint(vrow[j2 * TILE])) != dj;
            if (!first) continue;
            float sum = 0.f;
            for (int j2 = j; j2 < a.n_vslots; ++j2) {
              const uint32_t w2 = __float_as_uint(vrow[j2 * TILE]);
              if (vdim(w2) == dj) sum += __uint_as_float(w2 & 0xFFFFFE00u);
            }
            sVt[dj * GVS + ppos(lane)] = __float2bfloat16_rn(sum);
            vmask |= 1u << (dj >> 4);
          }
        }
        if (a.n_vslots > 0) {
          vmask = __reduce_or_sync(FULL, vmask);
          __syncwarp();
        }

        // ---- P.V: A = V^T (16 dims x 16 tokens), B = P^T (16 tokens x 8) ----
        uint32_t pb[2][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          pb[hh][0] = *reinterpret_cast<const uint32_t*>(sP + g * GPS + 16 * hh + 2 * tq);
          pb[hh][1] = *reinterpret_cast<const uint32_t*>(sP + g * GPS + 16 * hh + 2 * tq + 8);
        }
        // the V scale / offset of the thread's eight tokens [hh][e][f]; a
        // token past the live range gets zero, so its value is 0 whatever
        // its codes
        float vsc[2][2][2], vof[2][2][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              const int tt = MODE == MODE_NUQ ? tok(tq + 4 * hh + 8 * e + 16 * f)
                                              : tok(16 * hh + 2 * tq + e + 8 * f);
              const bool live = t0 + tt <= hi;
              const float sc_t = live ? sVs[tt] : 0.f, of_t = live ? sVo[tt] : 0.f;
              vsc[hh][e][f] = MODE == MODE_NUQ ? sc_t : sc_t * vb;
              vof[hh][e][f] = MODE == MODE_NUQ ? of_t : sc_t * va + of_t;
            }
#pragma unroll
        for (int mt = 0; mt < NM; ++mt) {
          if (mt < D / 16) {
            // the codes of the thread's two dims: bit planes as LUT byte
            // offsets (byte e + 2f of cw[hf][hh]: slot tq + 4hh + 8e + 16f)
            uint32_t cw[2][2];
            if (MODE == MODE_NUQ) {
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                cw[hf][0] = cw[hf][1] = 0u;
#pragma unroll
                for (int bb = 0; bb < NB; ++bb) {
                  const uint32_t w = reinterpret_cast<const uint32_t*>(
                      sVq + bb * 16 * D)[un * D + 16 * mt + g + 8 * hf];
                  cw[hf][0] |= plane_bits(w, tq, 2 + bb);
                  cw[hf][1] |= plane_bits(w, tq + 4, 2 + bb);
                }
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
                  for (int f = 0; f < 2; ++f) {
                    const float c = MODE == MODE_NUQ
                        ? *reinterpret_cast<const float*>(reinterpret_cast<const char*>(sLut[1]) +
                                                          byte_of(cw[hf][hh], e + 2 * f))
                        : gqa_container_code<MODE>(sVq, tok(16 * hh + 2 * tq + e + 8 * f), D,
                                                   16 * mt + g + 8 * hf, odd);
                    y[hf][e][f] = fmaf(c, vsc[hh][e][f], vof[hh][e][f]);
                  }
              const uint32_t fa[4] = {bf2(y[0][0][0], y[0][1][0]), bf2(y[1][0][0], y[1][1][0]),
                                      bf2(y[0][0][1], y[0][1][1]), bf2(y[1][0][1], y[1][1][1])};
              mma16816(acc[mt], fa, pb[hh][0], pb[hh][1]);
            }
            if ((vmask >> mt) & 1u) {  // the V slot tile's dims of this block
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                uint32_t fv[4];
                ldsm4(fv, smem_u32(sVt + (16 * mt + (lane & 15)) * GVS + 16 * hh + 8 * (lane >> 4)));
                mma16816(acc[mt], fv, pb[hh][0], pb[hh][1]);
              }
            }
          }
        }
        __syncwarp();  // the P^T tile and the V slot tile are read
        if (vlive)  // clear the slot tile's cells this lane wrote
          for (int j = 0; j < a.n_vslots; ++j) {
            const int dj = vdim(__float_as_uint(vrow[j * TILE]));
            if (dj >= 0) sVt[dj * GVS + ppos(lane)] = __float2bfloat16_rn(0.f);
          }
      }
      if (lane == 0) mbar_arrive(&empty[st]);  // the stage may be refilled
    }
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, o);
    l1 += __shfl_xor_sync(FULL, l1, o);
  }

  __syncthreads();  // every tile consumed: the ring becomes merge scratch
  if (warp < DW) {
    float* red = reinterpret_cast<float*>(ring) + (size_t)warp * G * (D + 2);
#pragma unroll
    for (int mt = 0; mt < NM; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 2 * tq + (r & 1);
        if (mt < D / 16 && row < G) red[row * (D + 2) + 16 * mt + g + 8 * (r >> 1)] = acc[mt][r];
      }
    if (g == 0) {  // the maxima in natural units, as fd_merge reads them
      if (r0ok) {
        red[2 * tq * (D + 2) + D] = m0 == -INFINITY ? -INFINITY : m0 / LOG2E;
        red[2 * tq * (D + 2) + D + 1] = l0;
      }
      if (r1ok) {
        red[(2 * tq + 1) * (D + 2) + D] = m1 == -INFINITY ? -INFINITY : m1 / LOG2E;
        red[(2 * tq + 1) * (D + 2) + D + 1] = l1;
      }
    }
  }
  __syncthreads();

  // ---- merge the warps of each head: this split's partials ----
  merge_warps(a, reinterpret_cast<const float*>(ring), G, bh0, s, tid);
}

// ===========================================================================
// fd_partial: prefill chunks, PR query rows per block
// ===========================================================================

// floats / ints of the partial kernel's dynamic shared memory
__host__ __device__ constexpr int smem_floats(int RT, int D) {
  return TT * (D + 1)                 // sK  rotated, corrected keys
         + TT * D                     // sV  dequantized values
         + RT * (D + 1)               // sQ  queries
         + RT * (TT + 1)              // sP  probabilities of the tile
         + 32                         // sLutK, sLutV
         + 2 * TT;                    // sVs, sVo  V scale / offset of the tile
}
__host__ __device__ constexpr int smem_ints(int RT) { return RT + MAX_KC; }
size_t smem_bytes(int RT, int D) {
  return sizeof(float) * smem_floats(RT, D) + sizeof(int) * smem_ints(RT);
}

// One block: kv head h, query rows [r0, r0 + RT) of batch row b, split s of
// the live key tiles; thread (ty, tx) owns 8x4 scores and 8x(D/16) outputs.
template <int MODE, int RT, class AP>
__global__ void __launch_bounds__(NT) fd_partial(FdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, DP = D + 1, half = D / 2;
  float* sK = smem;
  float* sV = sK + TT * DP;
  float* sQ = sV + TT * D;
  float* sP = sQ + RT * DP;
  float* sLutK = sP + RT * (TT + 1);
  float* sLutV = sLutK + 16;
  float* sVs = sLutV + 16;
  float* sVo = sVs + TT;
  int* sRpos = reinterpret_cast<int*>(sVo + TT);
  int* sChDim = sRpos + RT;  // [n_kc] dim of channel row n in this head, or -1

  const int s = blockIdx.x, h = blockIdx.y / a.n_rt, rt = blockIdx.y % a.n_rt;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
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
  if (tid < RT) sRpos[tid] = tid < nrows ? pos + (r0 + tid) % a.Tq : NEG_ROW;
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

  // Bit-plane words of columns c0 / c1 for K and V, [plane][word row]
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

  // running state in registers: thread (ty, tx) owns rows ty*8 + i
  float o[8][8];
  float m_r[8], l_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
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
      load_words(cur);
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
    // the next tile's slab and row
    const int2 nxt = more ? at(t0 + TT) : cur;
    const float vso_next = more ? load_vso(nxt) : 0.f;

    // ---- outliers, added to the rotated tile ----
    if (n_ow > 0) {
#pragma unroll
      for (int k = 0; k < OPF; ++k)
        if (tid + k * NT < n_ow) use_ow(t0, tid + k * NT, ow[k]);
      for (int i = tid + OPF * NT; i < n_ow; i += NT) use_ow(t0, i, load_ow(kvo, i));
      __syncthreads();
    }

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
      for (int off = 8; off; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, off));
      const float m_new = fmaxf(m_r[i], tmax);
      const float alpha = m_r[i] == -INFINITY ? 0.f : expf(m_r[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = sc[i][j] == -INFINITY ? 0.f : expf(sc[i][j] - m_new);
        sum += p;
        sP[r * (TT + 1) + tx + 16 * j] = rnd(p, bf);
      }
      for (int off = 8; off; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
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
    if (more) store_vso(vso_next);
    cur = nxt;
    __syncthreads();  // the next tile overwrites sK, sV, sP, sVs, sVo
  }

  // ---- this split's partials ----
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

// ===========================================================================
// fd_chunk / fd_chunk_sync: prefill chunks with bf16 dots, on the tensor cores
// ===========================================================================

constexpr int CW = 8;                 // consumer warps (two warpgroups): the products
constexpr int CWG = CW / 4;           // consumer warpgroups
constexpr int MT = 2;                 // m64 row tiles per consumer warpgroup
constexpr int CHUNK_ROWS = CWG * MT * 64;  // most query rows per block
constexpr int CT = 128;               // key tokens per ring stage (one nuq packing group)
constexpr int PT = 32;                // key tokens per dequantized piece
constexpr int MAX_BUF = 4;            // piece buffers
constexpr int PTILE = PT * 2 * MAXD;  // bytes of one swizzled bf16 piece tile [PT][MAXD]
// mbarriers (128 B), then the producer warps' outlier masks [MAX_BUF][2][8]
constexpr int CHUNK_HEAD = 128 + MAX_BUF * 2 * 8 * 4;
constexpr int CHUNK_BAR = 2;          // named barriers 2, 3: the consumer warpgroups' turns

// Each body's roles: producer warps (whole warpgroups) beside the CW
// consumer warps, and the registers a producer / consumer thread holds
// after setmaxnreg. fd_chunk (bit planes, whose dequantization costs the
// most): two producer warpgroups; fd_chunk_sync (the containers): one.
constexpr int CHUNK_PW = 8, CHUNK_P_REGS = 56, CHUNK_C_REGS = 200;
constexpr int SYNC_PW = 4, SYNC_P_REGS = 56, SYNC_C_REGS = 224;
static_assert(CHUNK_PW * 32 * CHUNK_P_REGS + CW * 32 * CHUNK_C_REGS <= 65536, "registers");
static_assert(SYNC_PW * 32 * SYNC_P_REGS + CW * 32 * SYNC_C_REGS <= 65536, "registers");
constexpr int CHUNK_SMEM_MAX = 225 * 1024;
constexpr float LN2 = 0.6931471805599453f;

// bytes of one kind (K or V) of one 128-token stage for one head (int4x2:
// its pair container)
__host__ __device__ inline int chunk_code_bytes(int mode, int bits, int D) {
  return mode == MODE_NUQ ? bits * 16 * D : mode == MODE_INT8 ? CT * D : CT * D / 2;
}

// Dynamic shared memory of fd_chunk (mirrored by chunk_layout in
// ops/kernels/flash_decode.py), from the first 1024-aligned byte of the
// block's dynamic shared memory (the launch asks for SW_ATOM bytes more):
// the mbarriers (the ring's, then the piece buffers' full and empty ones)
// and the producer warps' masks of the outlier tiles' nonzero 16-dim
// groups; the ring of raw 128-token stages; then, 1024-aligned, the
// block's queries as a swizzled bf16 tile [rows_blk][MAXD] and n_buf piece
// buffers of swizzled bf16 tiles [PT][MAXD] (wgmma.cuh): K, V, the K
// outlier tile (K slots or channels) and the V slot tile (V slots).
// Columns D .. 127 stay zero.
struct ChunkLayout {
  int cb, rows, vs, vo, stage;  // a stage: K codes, V codes at cb, outlier rows, V scale, V offset
  int ring, q, buf0, buf;       // offsets from the aligned base; bytes of a buffer
  int k, v, kc, vsl;            // offsets in a buffer
  int end, bytes;               // the layout's end; the bytes a launch asks for
};

__host__ __device__ inline ChunkLayout chunk_layout(const FdArgs& a) {
  ChunkLayout c;
  c.cb = chunk_code_bytes(a.mode, a.bits, a.D);
  c.rows = 2 * c.cb;
  c.vs = c.rows + rows_copied(a) * CT * 4;
  c.vo = c.vs + CT * 4;
  c.stage = c.vo + CT * 4;
  c.ring = CHUNK_HEAD;
  c.q = (c.ring + a.n_stage * c.stage + SW_ATOM - 1) / SW_ATOM * SW_ATOM;
  c.buf0 = c.q + a.rows_blk * 2 * MAXD;
  c.k = 0;
  c.v = PTILE;
  c.kc = 2 * PTILE;
  c.vsl = c.kc + (a.n_kc > 0 || a.n_kslots > 0 ? PTILE : 0);
  c.buf = c.vsl + (a.n_vslots > 0 ? PTILE : 0);
  c.end = c.buf0 + a.n_buf * c.buf;
  c.bytes = c.end + SW_ATOM;
  return c;
}

// positions of n query rows from r0 (row r sits at pos + r % Tq)
__device__ __forceinline__ void row_span(int r0, int n, int Tq, int pos, int& pmin, int& pmax) {
  const int last = r0 + n - 1;
  if (last / Tq != r0 / Tq) {
    pmin = pos;
    pmax = pos + Tq - 1;
  } else {
    pmin = pos + r0 % Tq;
    pmax = pos + last % Tq;
  }
}
// (in-group dim index, value) of an outlier slot word, as the plain version
// decodes it: group index head * D + dim, value with the index bits cleared
__device__ __forceinline__ int slot_gidx(uint32_t w, int D) {
  return (int)((w >> 7) & 0x3u) * D + (int)(w & 0x7Fu);
}
__device__ __forceinline__ float slot_value(uint32_t w) {
  return __uint_as_float(w & 0xFFFFFE00u);
}

// One block: kv head h and query rows [r0, r0 + rows_blk) of batch row b
// (blockIdx.y = h * n_rt + rt, blockIdx.z = b), split s of the live key
// tiles (blockIdx.x). Producer warps 0 .. PW - 1 keep the ring full (warp 0
// refills a stage once they have all dequantized it) and turn each 32-token
// piece into swizzled bf16 tiles in a piece buffer; consumer warpgroup wg
// (warps PW + 4 wg ..) owns the block's m64 row tiles wg and wg + CWG and
// multiplies them with wgmma (warp wi of it: rows 16 wi .. 16 wi + 15 of
// each tile; lane: rows g = lane / 4 and g + 8 of those, columns
// 2 * (lane % 4) + {0, 1} of every 8-wide block). A buffer's full / empty
// mbarriers hand it over.
template <int NB>
__global__ void __launch_bounds__((CHUNK_PW + CW) * 32, 1) fd_chunk(FdArgs a) {
  constexpr int PW = CHUNK_PW, CNT = (PW + CW) * 32;
  constexpr int P_REGS = CHUNK_P_REGS, C_REGS = CHUNK_C_REGS;
  constexpr int TPW = PT / PW;   // tokens per producer warp in the outlier tiles' build
  constexpr int LPT = 32 / TPW;  // lanes per token there
  extern __shared__ __align__(128) unsigned char csm_raw[];
  __shared__ float sLut[2][16];  // K / V codebooks of layer li
  __shared__ float sKs[MAXD];    // K dequant scale and offset per dim
  __shared__ float sKz[MAXD];
  __shared__ int sCh[MAX_KC];    // static channel n's dim in this head, or -1
  const ChunkLayout Lc = chunk_layout(a);
  // the layout's base: the first byte of a 1024-byte swizzle atom
  unsigned char* csm =
      csm_raw + ((SW_ATOM - (smem_u32(csm_raw) & (SW_ATOM - 1))) & (SW_ATOM - 1));
  const int D = a.D, half = D / 2, NS = a.n_stage, NSP = a.n_split;
  const int S = a.S, win = a.window, li = a.li, Q = a.Q, Tq = a.Tq;
  uint64_t* full = reinterpret_cast<uint64_t*>(csm);  // ring stages
  uint64_t* pfull = full + MAX_STAGES;                 // piece buffers: dequantized
  uint64_t* pempty = pfull + MAX_BUF;                  //   multiplied
  uint32_t* masks = reinterpret_cast<uint32_t*>(csm + 128);  // [buffer][K, V][warp]
  unsigned char* ring = csm + Lc.ring;
  unsigned char* sQ = csm + Lc.q;

  const int s = blockIdx.x, h = blockIdx.y / a.n_rt, rt = blockIdx.y % a.n_rt;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int RB = a.rows_blk, r0 = rt * RB, nrows = min(RB, Q - r0);
  const int pos = a.pos[b];

  // ---- this block's live key tiles: packed tokens [lo, hi] ----
  int pmin, pmax;
  row_span(r0, nrows, Tq, pos, pmin, pmax);
  const int hi = min(pmax - S, a.Tc - 1);
  const int lo = win > 0 ? max(0, pmin - win + 1 - S) : 0;
  const int n_tiles = hi < lo ? 0 : hi / CT - lo / CT + 1;
  const int tps = (n_tiles + NSP - 1) / NSP;
  const int t_begin = lo / CT + s * tps;
  const int t_end = min(lo / CT + n_tiles, t_begin + tps);
  const size_t bh = (size_t)b * a.Hkv + h;
  float* pm = a.part_m + (bh * NSP + s) * Q + r0;
  float* pl = a.part_l + (bh * NSP + s) * Q + r0;
  float* pacc = a.part_acc + ((bh * NSP + s) * Q + r0) * D;
  if (n_tiles == 0 || t_begin >= t_end) {  // zero weight in the merge
    for (int r = tid; r < nrows; r += CNT) {
      pm[r] = -INFINITY;
      pl[r] = 0.f;
    }
    return;
  }

  // ---- per-block constants ----
  const int hg = a.hg, jh = h % hg, grp = h / hg;
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(&full[i], 1);
    for (int i = 0; i < a.n_buf; ++i) {
      mbar_init(&pfull[i], PW * 32);
      mbar_init(&pempty[i], CW * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the queries and every tile start at zero: columns D .. 127 stay so
  for (int i = tid; i < (Lc.end - Lc.q) / 16; i += CNT)
    reinterpret_cast<uint4*>(csm + Lc.q)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const float* qb = a.q + (bh * Q + r0) * D;
  for (int i = tid; i < nrows * half; i += CNT) {
    const int r = i / half, d = 2 * (i % half);
    const float2 v = *reinterpret_cast<const float2*>(qb + (size_t)r * D + d);
    *reinterpret_cast<uint32_t*>(sQ + sw_off(r, d, RB)) = bf2(v.x, v.y);
  }
  const int K = 1 << a.bits;
  const float* kl = a.k_lut + (size_t)li * K;
  const float* vl = a.v_lut + (size_t)li * K;
  if (tid < K) {
    sLut[0][tid] = kl[tid];
    sLut[1][tid] = vl[tid];
  }
  if (tid < D) {
    const size_t ci = ((size_t)li * a.Hkv + h) * D + tid;
    sKs[tid] = a.k_range[ci];
    sKz[tid] = a.k_offset[ci];
  }
  for (int i = tid; i < a.n_kc; i += CNT) {
    const int ch = a.k_chan[grp * a.n_kc + i];
    sCh[i] = ch / D == jh ? ch % D : -1;
  }
  fence_async_smem();  // the zeroed tiles and the queries, for wgmma
  __syncthreads();

  // ---- the ring: tile i of the split into stage (i - t_begin) % NS, by
  // warp 0, one TMA bulk copy per lane (K and V planes, outlier rows, V
  // scale, V offset), completing on the stage's mbarrier, which lane 0 arms
  // with the stage's bytes ----
  const int nrw = rows_copied(a);
  auto fill = [&](int i, int st) {
    const size_t slab = (size_t)li * a.B + b, hs = slab * a.Hkv + h;
    const int t0 = i * CT, cb = Lc.cb;
    unsigned char* dst = ring + st * Lc.stage;
    if (lane == 0) mbar_expect_tx(&full[st], Lc.stage);
    for (int c = lane; c < 2 * NB + nrw + 2; c += 32) {
      if (c < 2 * NB) {
        // kind c / NB (0: K, 1: V), plane bb: word rows t0 / 32 .. t0 / 32
        // + 3 (the 128-token group)
        const int kv = c / NB, bb = c % NB;
        const size_t w = ((hs * NB + bb) * (a.Tc / 32) + t0 / 32) * D;
        bulk_g2s(dst + kv * cb + bb * 16 * D,
                 reinterpret_cast<const int32_t*>(kv ? a.vp : a.kp) + w, 16 * D, &full[st]);
      } else if (c < 2 * NB + nrw) {
        const int r = c - 2 * NB;
        bulk_g2s(dst + Lc.rows + r * CT * 4,
                 a.kv_out + ((slab * (a.Hkv / hg) + grp) * a.J + r) * a.Tc + t0, CT * 4,
                 &full[st]);
      } else {
        const bool scale = c == 2 * NB + nrw;
        const float* src = (scale ? a.v_scale : a.v_offset) + slab * a.Tc + t0;
        bulk_g2s(dst + (scale ? Lc.vs : Lc.vo), src, CT * 4, &full[st]);
      }
    }
  };

  // ---- the thread's dequantization units: kind (K or V), its column
  // quad (c0, c0 + 1, c0 + D/2, c0 + D/2 + 1) and 4 tokens of a piece ----
  const int lgD = 31 - __clz(D), lgq = lgD - 2;  // D and D/4 quads are powers of 2
  const int upk = 8 << lgq;                      // units of one kind per piece
  const bool pre = !a.post_rope;
  const bool kfix = a.n_kc > 0 || a.n_kslots > 0, vfix = a.n_vslots > 0;
  const float4* rope4 = reinterpret_cast<const float4*>(a.rope);
  const float2* rope2 = reinterpret_cast<const float2*>(a.rope);

  if (warp < PW) {
    // ---- producers: the ring's tiles into bf16 pieces, in order ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(P_REGS));
    if (warp == 0)
      for (int i = t_begin; i < min(t_end, t_begin + NS); ++i) fill(i, i - t_begin);
    int ub = 0, urnd = 0;  // the piece buffer and the fills it had before
    int st = 0, phase = 0;  // the ring stage and its parity
    for (int it = t_begin; it < t_end; ++it) {
      const int t0 = it * CT;
      mbar_wait(&full[st], phase);
      const unsigned char* stg = ring + st * Lc.stage;
      const float* sRows = reinterpret_cast<const float*>(stg + Lc.rows);
      const float* sVs = reinterpret_cast<const float*>(stg + Lc.vs);
      const float* sVo = reinterpret_cast<const float*>(stg + Lc.vo);
      const int last_pc = min(CT / PT - 1, (hi - t0) / PT);  // the stage's last live piece
      for (int pc = 0; pc <= last_pc; ++pc) {
        const int tb0 = t0 + PT * pc;  // the piece's first packed token
        if (tb0 + PT - 1 < lo) continue;  // before the window: uniform over the block
        if (urnd > 0) mbar_wait(&pempty[ub], (urnd - 1) & 1);  // its last piece multiplied
        unsigned char* buf = csm + Lc.buf0 + ub * Lc.buf;
        unsigned char* tK = buf + Lc.k;
        unsigned char* tV = buf + Lc.v;
        unsigned char* tKc = buf + Lc.kc;
        unsigned char* tVs = buf + Lc.vsl;
        uint32_t* bMask = masks + ub * 16;

        // ---- dequantize the piece once for every row of the block: a unit
        // is 4 tokens x 4 columns of K (rotated) or V, rounded to bf16 ----
        for (int uu = tid; uu < 2 * upk; uu += PW * 32) {
          const int kind = uu >= upk, un = uu - kind * upk;
          const int c0 = 2 * (un & ((1 << lgq) - 1)), tu = un >> lgq;
          const unsigned char* codes = stg + kind * Lc.cb;
          float x[4][4];  // [token of the unit][column]
          int tls[4];
          // token 16 nib + 4 jb + w4 of the piece sits at bit 8 pc + 4 nib +
          // jb of word row w4 (the packing group's interleave)
          const int w4 = tu & 3, nib = tu >> 2;
#pragma unroll
          for (int jb = 0; jb < 4; ++jb) tls[jb] = 16 * nib + 4 * jb + w4;
          // pre-RoPE keys: the tokens' (cos, sin) rows, loaded before the
          // codes so that their latency overlaps the decoding
          float4 csv[4];
          if (pre && kind == 0)
#pragma unroll
            for (int jb = 0; jb < 4; ++jb)
              csv[jb] = __ldg(rope4 + ((size_t)(tb0 + tls[jb]) * half + c0) / 2);
          uint32_t cw[4][1];
          nuq_bytes<NB, 1>(codes, w4, D, c0, half, 8 * pc + 4 * nib, cw);
#pragma unroll
          for (int jb = 0; jb < 4; ++jb) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              x[jb][jj] = *reinterpret_cast<const float*>(
                  reinterpret_cast<const char*>(sLut[kind]) + byte_of(cw[jj][0], jb));
          }
          if (kind == 0) {
            const float2 s01 = *reinterpret_cast<const float2*>(sKs + c0);
            const float2 s23 = *reinterpret_cast<const float2*>(sKs + c0 + half);
            const float2 z01 = *reinterpret_cast<const float2*>(sKz + c0);
            const float2 z23 = *reinterpret_cast<const float2*>(sKz + c0 + half);
#pragma unroll
            for (int jb = 0; jb < 4; ++jb) {
              const int tl = tls[jb];
              float x0 = fmaf(x[jb][0], s01.x, z01.x), x1 = fmaf(x[jb][1], s01.y, z01.y);
              float x2 = fmaf(x[jb][2], s23.x, z23.x), x3 = fmaf(x[jb][3], s23.y, z23.y);
              if (pre) {  // rotate the pairs (c0, c0 + D/2), (c0 + 1, c0 + 1 + D/2)
                const float4 cs = csv[jb];
                const float q0 = x0 * cs.x - x2 * cs.y;
                const float q2 = x2 * cs.x + x0 * cs.y;
                const float q1 = x1 * cs.z - x3 * cs.w;
                const float q3 = x3 * cs.z + x1 * cs.w;
                x0 = q0; x1 = q1; x2 = q2; x3 = q3;
              }
              *reinterpret_cast<uint32_t*>(tK + sw_off(tl, c0, PT)) = bf2(x0, x1);
              *reinterpret_cast<uint32_t*>(tK + sw_off(tl, c0 + half, PT)) = bf2(x2, x3);
            }
          } else {
#pragma unroll
            for (int jb = 0; jb < 4; ++jb) {
              const int tl = tls[jb], tt = PT * pc + tl;
              // a token past the live range gets a zero V scale and offset,
              // so its value is 0 whatever its codes
              const bool live = tb0 + tl <= hi;
              const float vs_t = live ? sVs[tt] : 0.f, vo_t = live ? sVo[tt] : 0.f;
              *reinterpret_cast<uint32_t*>(tV + sw_off(tl, c0, PT)) =
                  bf2(fmaf(x[jb][0], vs_t, vo_t), fmaf(x[jb][1], vs_t, vo_t));
              *reinterpret_cast<uint32_t*>(tV + sw_off(tl, c0 + half, PT)) =
                  bf2(fmaf(x[jb][2], vs_t, vo_t), fmaf(x[jb][3], vs_t, vo_t));
            }
          }
        }

        // ---- the piece's outliers as sparse bf16 tiles, at the plain
        // version's rounding points: K as rnd(rope(k_add)) (slots of one dim
        // add before the rotation, a dim and its RoPE partner mix before the
        // rounding), V as rnd(v_add). Warp w builds the rows of its TPW
        // tokens, LPT lanes each (zero the row, then one entry per lane), and
        // the masks of the 16-dim column groups its rows touch ----
        if (kfix || vfix) {
          // with both tiles, the first half of the warps builds the K
          // outlier rows and the second the V slot rows, of twice the tokens
          // each: two chains side by side in place of one after the other
          const bool split = kfix && vfix;
          const bool dok = kfix && (!split || warp < PW / 2);
          const bool dov = vfix && (!split || warp >= PW / 2);
          const int lpt = split ? LPT / 2 : LPT;
          const int tl = split ? 2 * TPW * (warp % (PW / 2)) + lane / (LPT / 2)
                               : TPW * warp + lane / LPT;
          const int le = lane % lpt;
          const int tt = PT * pc + tl, ta = tb0 + tl;
          for (int i = le; i < MAXD / 8; i += lpt) {
            if (dok) *reinterpret_cast<uint4*>(tKc + sw_off(tl, 8 * i, PT)) = make_uint4(0u, 0u, 0u, 0u);
            if (dov) *reinterpret_cast<uint4*>(tVs + sw_off(tl, 8 * i, PT)) = make_uint4(0u, 0u, 0u, 0u);
          }
          __syncwarp();
          uint32_t km = 0u, vm = 0u;
          if (dok && ta <= hi) {
            const bool chan = a.n_kc > 0;
            const int ne = chan ? a.n_kc : a.n_kslots;
            // entry e's dim in this head (or -1) and value
            auto dim_of = [&](int e) {
              if (chan) return sCh[e];
              const int gi = slot_gidx(__float_as_uint(sRows[e * CT + tt]), D);
              return (gi >> lgD) == jh ? gi & (D - 1) : -1;
            };
            auto val_of = [&](int e) {
              const float w = sRows[e * CT + tt];
              return chan ? w : slot_value(__float_as_uint(w));
            };
            for (int e = le; e < ne; e += lpt) {
              const int d = dim_of(e);
              if (d < 0) continue;
              // the dims whose addend this entry's positions read: d, and
              // pre-RoPE its partner; the first entry among them writes
              const int i = pre ? d & (half - 1) : d;
              float s_lo = 0.f, s_hi = 0.f;
              bool first = true;
              for (int e2 = 0; e2 < ne && first; ++e2) {
                const int d2 = dim_of(e2);
                if (d2 < 0 || (pre ? d2 & (half - 1) : d2) != i) continue;
                if (e2 < e) {
                  first = false;
                } else if (!pre || d2 < half) {
                  s_lo += val_of(e2);
                } else {
                  s_hi += val_of(e2);
                }
              }
              if (!first) continue;
              if (pre) {
                const float2 cs = __ldg(rope2 + (size_t)ta * half + i);
                *reinterpret_cast<__nv_bfloat16*>(tKc + sw_off(tl, i, PT)) = __float2bfloat16_rn(
                    __fsub_rn(__fmul_rn(s_lo, cs.x), __fmul_rn(s_hi, cs.y)));
                *reinterpret_cast<__nv_bfloat16*>(tKc + sw_off(tl, i + half, PT)) =
                    __float2bfloat16_rn(__fadd_rn(__fmul_rn(s_hi, cs.x), __fmul_rn(s_lo, cs.y)));
                km |= (1u << (i >> 4)) | (1u << ((i + half) >> 4));
              } else {
                *reinterpret_cast<__nv_bfloat16*>(tKc + sw_off(tl, d, PT)) =
                    __float2bfloat16_rn(s_lo);
                km |= 1u << (d >> 4);
              }
            }
          }
          if (dov && ta <= hi) {
            const float* vw = sRows + a.spk * CT + tt;
            for (int e = le; e < a.n_vslots; e += lpt) {
              const int gi = slot_gidx(__float_as_uint(vw[e * CT]), D);
              if ((gi >> lgD) != jh) continue;
              // slots of one (token, dim) add before rounding: the first
              // writes
              float v = 0.f;
              bool first = true;
              for (int e2 = 0; e2 < a.n_vslots && first; ++e2) {
                if (slot_gidx(__float_as_uint(vw[e2 * CT]), D) != gi) continue;
                if (e2 < e) first = false;
                else v += slot_value(__float_as_uint(vw[e2 * CT]));
              }
              if (!first) continue;
              *reinterpret_cast<__nv_bfloat16*>(tVs + sw_off(tl, gi & (D - 1), PT)) =
                  __float2bfloat16_rn(v);
              vm |= 1u << ((gi & (D - 1)) >> 4);
            }
          }
          km = __reduce_or_sync(FULL, km);
          vm = __reduce_or_sync(FULL, vm);
          if (lane == 0) {
            bMask[warp] = km;
            bMask[8 + warp] = vm;
          }
        }
        fence_async_smem();  // the tiles, for the consumers' wgmma
        mbar_arrive(&pfull[ub]);  // the piece's tiles are complete
        if (++ub == a.n_buf) {
          ub = 0;
          ++urnd;
        }
        if (pc == last_pc) {  // every producer has read the stage: it takes tile it + NS
          asm volatile("bar.sync 1, %0;" :: "n"(PW * 32) : "memory");
          if (warp == 0 && it + NS < t_end) fill(it + NS, st);
        }
      }
      if (++st == NS) {
        st = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers: the products over each piece, in order ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(C_REGS));
  // ---- the warpgroup's m64 tiles and the warp's rows in them: positions,
  // spans; the operands' descriptors ----
  const int wg = (warp - PW) >> 2, wi = (warp - PW) & 3;
  const int g = lane >> 2, tq4 = lane & 3;
  int rp[MT][2], tmin[MT], tmax[MT];
  bool tlive[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int tr0 = 64 * (wg + CWG * mt);
    tlive[mt] = tr0 < nrows;
    tmin[mt] = 0;
    tmax[mt] = NEG_ROW;
    if (tlive[mt]) row_span(r0 + tr0, min(64, nrows - tr0), Tq, pos, tmin[mt], tmax[mt]);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = tr0 + 16 * wi + 8 * hf + g;
      rp[mt][hf] = r < nrows ? pos + (r0 + r) % Tq : NEG_ROW;
    }
  }
  // Q (A, K-major) of tile mt at k-step kk; a piece tile of keys (B,
  // K-major) at kk; of values (B, MN-major: 64-column blocks PT rows apart)
  // at token step kt. A descriptor's low bits are the address / 16, so a
  // step adds its offset / 16 to a base descriptor.
  const uint64_t qd0 = wg_desc(smem_u32(sQ) + 64 * wg * SW_ROW, 16, SW_ATOM);
  const int qblk = RB * SW_ROW / 16;  // a 64-column block of the queries, / 16
  auto q_desc = [&](uint64_t qd, int mt, int kk) {
    return qd + (CWG * 64 * SW_ROW / 16) * mt + (kk >> 2) * qblk + (kk & 3) * 2;
  };
  auto k_desc = [](uint64_t kd, int kk) {
    return kd + (kk >> 2) * (PT * SW_ROW / 16) + (kk & 3) * 2;
  };
  auto v_desc = [](uint64_t vd, int kt) { return vd + kt * (2 * SW_ATOM / 16); };

  // Between a product batch's wgmma.fence and its wait no instruction
  // writes the batch's registers and the batch branches only on
  // warp-uniform values (a compiler-inserted fence on a divergent path
  // serializes every product); S and P live within a piece, O across them.
  float o[MT][16][4];
  float m[MT][2], l[MT][2];  // base-2 running state of rows g and g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[mt][n][j] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const float sl2 = a.inv * LOG2E;
  // the two consumer warpgroups take turns to issue their score products
  // (named barrier CHUNK_BAR + wg completes once the other one has issued
  // its own; warpgroup 1 lets warpgroup 0 go first), so one's softmax runs
  // beside the other's products
  if (wg == 1) named_arrive(CHUNK_BAR, CW * 32);

  int ub = 0, urnd = 0;  // the piece buffer and the fills it had before
  for (int it = t_begin; it < t_end; ++it) {
    const int t0 = it * CT;
    const int last_pc = min(CT / PT - 1, (hi - t0) / PT);
    for (int pc = 0; pc <= last_pc; ++pc) {
      const int tb0 = t0 + PT * pc;
      if (tb0 + PT - 1 < lo) continue;
      mbar_wait(&pfull[ub], urnd & 1);
      named_sync(CHUNK_BAR + wg, CW * 32);
      const uint32_t ba = smem_u32(csm + Lc.buf0 + ub * Lc.buf);
      // the query descriptor made opaque here, so that its 16 steps are
      // added where they are used and not held across the loop
      uint64_t qd = qd0;
      asm volatile("" : "+l"(qd));
      const uint64_t kd = wg_desc(ba + Lc.k, 16, SW_ATOM);

      // ---- which tiles see some of the piece; the 16-dim k-steps the K
      // outlier tile touches; whether the piece holds a V slot. Made
      // warp-uniform by a vote, so that the batches below branch on them
      // on a non-divergent path ----
      const uint32_t* bMask = masks + ub * 16;
      uint32_t km = 0u, vm = 0u;
      for (int w = 0; w < PW; ++w) {
        km |= bMask[w];
        vm |= bMask[8 + w];
      }
      const uint32_t kmask = __reduce_or_sync(FULL, km);
      const bool vany = vfix && __reduce_or_sync(FULL, vm) != 0u;
      bool see[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        see[mt] = __any_sync(FULL, tlive[mt] && tb0 <= tmax[mt] - S &&
                                       (win <= 0 || tb0 + PT - 1 + S > tmin[mt] - win));

      // ---- S = Q.K^T + Q.Kc^T: the K tile, then the K outlier tile over
      // the k-steps it touches, into one accumulator per tile (columns D ..
      // 127 are zero) ----
      float sc[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0.f;
      wg_fence();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (!see[mt]) continue;
#pragma unroll
        for (int kk = 0; kk < MAXD / 16; ++kk)
          wg_m64n32_ss(sc[mt], q_desc(qd, mt, kk), k_desc(kd, kk), 1);
      }
      if (kfix) {
        const uint64_t kcd = kd + (Lc.kc - Lc.k) / 16;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (!see[mt]) continue;
          for (uint32_t mk = kmask; mk; mk &= mk - 1) {
            const int kk = __ffs(mk) - 1;
            wg_m64n32_ss(sc[mt], q_desc(qd, mt, kk), k_desc(kcd, kk), 1);
          }
        }
      }
      wg_commit();
      named_arrive(CHUNK_BAR + (wg ^ 1), CW * 32);
      wg_wait_all();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) reg_fence(sc[mt]);

      // ---- mask, online softmax (base 2) over the piece; P to bf16 A
      // fragments in registers (zero for a tile that sees none of it) ----
      uint32_t pa[MT][2][4];
      bool moved = false;
      float al[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        al[mt][0] = al[mt][1] = 1.f;
        if (!see[mt]) {
#pragma unroll
          for (int kt = 0; kt < 2; ++kt)
#pragma unroll
            for (int j = 0; j < 4; ++j) pa[mt][kt][j] = 0u;
          continue;
        }
        // all of the tile's rows see all of the piece: no mask
        const bool all = tb0 + PT - 1 <= tmin[mt] - S && (win <= 0 || tb0 + S > tmax[mt] - win);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = sc[mt][j][e] * sl2;
            if (!all && !key_ok(tb0 + 8 * j + 2 * tq4 + (e & 1), rp[mt][e >> 1], S, win))
              v = -INFINITY;
            sc[mt][j][e] = v;
            mx[e >> 1] = fmaxf(mx[e >> 1], v);
          }
        float mu[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL, mx[hf], 1));
          mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL, mx[hf], 2));
          const float mn = fmaxf(m[mt][hf], mx[hf]);
          mu[hf] = mn == -INFINITY ? 0.f : mn;
          al[mt][hf] = exp2f(m[mt][hf] - mu[hf]);
          moved |= al[mt][hf] != 1.f;
          m[mt][hf] = mn;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p0 = exp2f(sc[mt][j][0] - mu[0]), p1 = exp2f(sc[mt][j][1] - mu[0]);
          const float p2 = exp2f(sc[mt][j][2] - mu[1]), p3 = exp2f(sc[mt][j][3] - mu[1]);
          sum[0] += p0 + p1;
          sum[1] += p2 + p3;
          pa[mt][j >> 1][2 * (j & 1)] = bf2(p0, p1);
          pa[mt][j >> 1][2 * (j & 1) + 1] = bf2(p2, p3);
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) l[mt][hf] = l[mt][hf] * al[mt][hf] + sum[hf];
      }
      if (__any_sync(FULL, moved)) {  // a row maximum moved: rescale O
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < 16; ++n) {
            o[mt][n][0] *= al[mt][0];
            o[mt][n][1] *= al[mt][0];
            o[mt][n][2] *= al[mt][1];
            o[mt][n][3] *= al[mt][1];
          }
      }

      // ---- O += P.V, then P.V_slots ----
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) reg_fence(o[mt]);
      const uint64_t vd = wg_desc(ba + Lc.v, PT * SW_ROW, SW_ATOM);
      wg_fence();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (!see[mt]) continue;
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) wg_m64n128_rs(o[mt], pa[mt][kt], v_desc(vd, kt));
        if (vany) {
          const uint64_t vsd = vd + (Lc.vsl - Lc.v) / 16;
#pragma unroll
          for (int kt = 0; kt < 2; ++kt) wg_m64n128_rs(o[mt], pa[mt][kt], v_desc(vsd, kt));
        }
      }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) reg_fence(o[mt]);
      mbar_arrive(&pempty[ub]);  // the buffer may be refilled
      if (++ub == a.n_buf) {
        ub = 0;
        ++urnd;
      }
    }
  }

  if (wg == 0) named_sync(CHUNK_BAR, CW * 32);  // warpgroup 1's last turn

  // ---- this split's partials, straight from the fragments ----
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (!tlive[mt]) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lt = l[mt][hf];
      lt += __shfl_xor_sync(FULL, lt, 1);
      lt += __shfl_xor_sync(FULL, lt, 2);
      const int r = 64 * (wg + CWG * mt) + 16 * wi + 8 * hf + g;
      if (r < nrows) {
#pragma unroll
        for (int n = 0; n < 16; ++n)
          if (n < D / 8)
            *reinterpret_cast<float2*>(pacc + (size_t)r * D + 8 * n + 2 * tq4) =
                make_float2(o[mt][n][2 * hf], o[mt][n][2 * hf + 1]);
        if (tq4 == 0) {
          pm[r] = m[mt][hf] == -INFINITY ? -INFINITY : m[mt][hf] * LN2;
          pl[r] = lt;
        }
      }
    }
  }
}

// fd_chunk_sync's row tiles: SMT 16-row mma tiles per consumer warp, RW
// rows a warp; its tiles' bf16 row stride
constexpr int SMT = 2;
constexpr int RW = 16 * SMT;
static_assert(CW * RW == CHUNK_ROWS, "rows");
constexpr int QS = MAXD + 8;

// Dynamic shared memory of fd_chunk_sync (mirrored by chunk_layout in
// ops/kernels/flash_decode.py): 128 B of mbarriers (the ring's, then the
// piece buffers' full and empty ones); the ring of raw 128-token stages;
// the block's queries in bf16 [rows_blk][QS]; n_buf piece buffers of bf16
// tiles [32][QS]: K, V, the K outlier tile (K slots or channels) and the V
// slot tile (V slots), and the producer warps' masks of the outlier tiles'
// nonzero 16-dim groups. Rows of QS = 128 + 8 bf16 keep
// ldmatrix conflict-free and the products' loops free of D: columns from D
// to 127 stay zero.
struct SyncLayout {
  int cb, rows, vs, vo, stage;  // a stage: K codes, V codes at cb, outlier rows, V scale, V offset
  int ring, q, buf0, buf;       // offsets in the block's shared memory; bytes of a buffer
  int k, v, kc, vsl, mask;      // offsets in a buffer
  int bytes;
};

__host__ __device__ inline SyncLayout sync_layout(const FdArgs& a) {
  SyncLayout c;
  c.cb = chunk_code_bytes(a.mode, a.bits, a.D);
  c.rows = 2 * c.cb;
  c.vs = c.rows + rows_copied(a) * CT * 4;
  c.vo = c.vs + CT * 4;
  c.stage = c.vo + CT * 4;
  c.ring = 128;
  c.q = c.ring + a.n_stage * c.stage;
  const int tb = PT * QS * 2;
  c.buf0 = c.q + a.rows_blk * QS * 2;
  c.k = 0;
  c.v = tb;
  c.kc = 2 * tb;
  c.vsl = c.kc + (a.n_kc > 0 || a.n_kslots > 0 ? tb : 0);
  c.mask = c.vsl + (a.n_vslots > 0 ? tb : 0);
  c.buf = c.mask + 2 * SYNC_PW * 4;
  c.bytes = c.buf0 + a.n_buf * c.buf;
  return c;
}

// fd_chunk_sync, the containers' chunk body: one block as fd_chunk's, on
// mma.sync. Producer warps 0 .. PW - 1 keep the ring full (warp 0 refills
// a stage once they have all dequantized it) and turn each 32-token piece
// into bf16 tiles in a piece buffer; consumer warp c = warp - PW owns rows
// r0 + RW c .. r0 + RW (c + 1) - 1 as SMT mma row tiles (lane: rows
// g = lane / 4 and g + 8 of each, columns 2 * (lane % 4) + {0, 1} of every
// 8-wide tile). A buffer's full / empty mbarriers hand it over.
template <int MODE>
__global__ void __launch_bounds__((SYNC_PW + CW) * 32, 1) fd_chunk_sync(FdArgs a) {
  constexpr int PW = SYNC_PW, CNT = (PW + CW) * 32, MT = SMT;
  constexpr int P_REGS = SYNC_P_REGS, C_REGS = SYNC_C_REGS;
  constexpr int TPW = PT / PW;   // tokens per producer warp in the outlier tiles' build
  constexpr int LPT = 32 / TPW;  // lanes per token there
  extern __shared__ __align__(128) unsigned char csm[];
  __shared__ float sKs[MAXD];    // K dequant scale and offset per dim
  __shared__ float sKz[MAXD];
  __shared__ int sCh[MAX_KC];    // static channel n's dim in this head, or -1
  const SyncLayout Lc = sync_layout(a);
  const int D = a.D, half = D / 2, NS = a.n_stage, NSP = a.n_split;
  const int S = a.S, win = a.window, li = a.li, Q = a.Q, Tq = a.Tq;
  uint64_t* full = reinterpret_cast<uint64_t*>(csm);  // ring stages
  uint64_t* pfull = full + MAX_STAGES;                 // piece buffers: dequantized
  uint64_t* pempty = pfull + MAX_BUF;                  //   multiplied
  unsigned char* ring = csm + Lc.ring;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(csm + Lc.q);

  const int s = blockIdx.x, h = blockIdx.y / a.n_rt, rt = blockIdx.y % a.n_rt;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int RB = a.rows_blk, r0 = rt * RB, nrows = min(RB, Q - r0);
  const int pos = a.pos[b];

  // ---- this block's live key tiles: packed tokens [lo, hi] ----
  int pmin, pmax;
  row_span(r0, nrows, Tq, pos, pmin, pmax);
  const int hi = min(pmax - S, a.Tc - 1);
  const int lo = win > 0 ? max(0, pmin - win + 1 - S) : 0;
  const int n_tiles = hi < lo ? 0 : hi / CT - lo / CT + 1;
  const int tps = (n_tiles + NSP - 1) / NSP;
  const int t_begin = lo / CT + s * tps;
  const int t_end = min(lo / CT + n_tiles, t_begin + tps);
  const size_t bh = (size_t)b * a.Hkv + h;
  float* pm = a.part_m + (bh * NSP + s) * Q + r0;
  float* pl = a.part_l + (bh * NSP + s) * Q + r0;
  float* pacc = a.part_acc + ((bh * NSP + s) * Q + r0) * D;
  if (n_tiles == 0 || t_begin >= t_end) {  // zero weight in the merge
    for (int r = tid; r < nrows; r += CNT) {
      pm[r] = -INFINITY;
      pl[r] = 0.f;
    }
    return;
  }

  // ---- per-block constants ----
  const int hg = a.hg, jh = h % hg, grp = h / hg;
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(&full[i], 1);
    for (int i = 0; i < a.n_buf; ++i) {
      mbar_init(&pfull[i], PW * 32);
      mbar_init(&pempty[i], CW * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the queries and every tile start at zero: columns D .. 127 stay so
  for (int i = tid; i < (Lc.bytes - Lc.q) / 16; i += CNT)
    reinterpret_cast<uint4*>(csm + Lc.q)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const float* qb = a.q + (bh * Q + r0) * D;
  for (int i = tid; i < nrows * half; i += CNT) {
    const int r = i / half, d = 2 * (i % half);
    const float2 v = *reinterpret_cast<const float2*>(qb + (size_t)r * D + d);
    *reinterpret_cast<uint32_t*>(sQ + r * QS + d) = bf2(v.x, v.y);
  }
  const int K = 1 << a.bits;
  const float* kl = a.k_lut + (size_t)li * K;
  const float* vl = a.v_lut + (size_t)li * K;
  // the containers' affine codebook folded as in the plain version
  // (common.fold_affine): code c_s -> c_s * step + zero, c_s signed (int4 /
  // int8) or unsigned (int4x2, bias 0)
  const float bias = MODE == MODE_INT4X2 ? 0.f : (float)(1 << (a.bits - 1));
  const float vb = (vl[K - 1] - vl[0]) / (float)(K - 1);
  const float va = vl[0] + bias * vb;
  if (tid < D) {
    const float kb = (kl[K - 1] - kl[0]) / (float)(K - 1);
    const float ka = kl[0] + bias * kb;
    const size_t ci = ((size_t)li * a.Hkv + h) * D + tid;
    const float kr = a.k_range[ci], ko = a.k_offset[ci];
    sKs[tid] = kb * kr;
    sKz[tid] = ka * kr + ko;
  }
  for (int i = tid; i < a.n_kc; i += CNT) {
    const int ch = a.k_chan[grp * a.n_kc + i];
    sCh[i] = ch / D == jh ? ch % D : -1;
  }
  __syncthreads();

  // ---- the ring: tile i of the split into stage (i - t_begin) % NS, by
  // warp 0, one TMA bulk copy per lane (K and V containers, outlier rows,
  // V scale, V offset), completing on the stage's mbarrier, which lane 0
  // arms with the stage's bytes ----
  const int nrw = rows_copied(a);
  auto fill = [&](int i, int st) {
    const bool paired = MODE == MODE_INT4X2;
    const int Hc = paired ? a.Hkv / 2 : a.Hkv, hc = paired ? h >> 1 : h;
    const size_t slab = (size_t)li * a.B + b, hs = slab * Hc + hc;
    const int t0 = i * CT, cb = Lc.cb;
    unsigned char* dst = ring + st * Lc.stage;
    if (lane == 0) mbar_expect_tx(&full[st], Lc.stage);
    for (int c = lane; c < 2 + nrw + 2; c += 32) {
      if (c < 2) {  // 0: K, 1: V
        const size_t o = (hs * a.Tc + t0) * (size_t)(cb / CT);
        bulk_g2s(dst + c * cb, reinterpret_cast<const uint8_t*>(c ? a.vp : a.kp) + o, cb,
                 &full[st]);
      } else if (c < 2 + nrw) {
        const int r = c - 2;
        bulk_g2s(dst + Lc.rows + r * CT * 4,
                 a.kv_out + ((slab * (a.Hkv / hg) + grp) * a.J + r) * a.Tc + t0, CT * 4,
                 &full[st]);
      } else {
        const bool scale = c == 2 + nrw;
        const float* src = (scale ? a.v_scale : a.v_offset) + slab * a.Tc + t0;
        bulk_g2s(dst + (scale ? Lc.vs : Lc.vo), src, CT * 4, &full[st]);
      }
    }
  };

  // ---- the thread's dequantization units: kind (K or V), its column
  // quad (c0, c0 + 1, c0 + D/2, c0 + D/2 + 1) and 4 tokens of a piece ----
  const int lgD = 31 - __clz(D), lgq = lgD - 2;  // D and D/4 quads are powers of 2
  const int upk = 8 << lgq;                      // units of one kind per piece
  const int odd = h & 1;
  const bool pre = !a.post_rope;
  const bool kfix = a.n_kc > 0 || a.n_kslots > 0, vfix = a.n_vslots > 0;
  const float4* rope4 = reinterpret_cast<const float4*>(a.rope);
  const float2* rope2 = reinterpret_cast<const float2*>(a.rope);

  if (warp < PW) {
    // ---- producers: the ring's tiles into bf16 pieces, in order ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(P_REGS));
    if (warp == 0)
      for (int i = t_begin; i < min(t_end, t_begin + NS); ++i) fill(i, i - t_begin);
    int ub = 0, urnd = 0;  // the piece buffer and the fills it had before
    int st = 0, phase = 0;  // the ring stage and its parity
    for (int it = t_begin; it < t_end; ++it) {
      const int t0 = it * CT;
      mbar_wait(&full[st], phase);
      const unsigned char* stg = ring + st * Lc.stage;
      const float* sRows = reinterpret_cast<const float*>(stg + Lc.rows);
      const float* sVs = reinterpret_cast<const float*>(stg + Lc.vs);
      const float* sVo = reinterpret_cast<const float*>(stg + Lc.vo);
      const int last_pc = min(CT / PT - 1, (hi - t0) / PT);  // the stage's last live piece
      for (int pc = 0; pc <= last_pc; ++pc) {
        const int tb0 = t0 + PT * pc;  // the piece's first packed token
        if (tb0 + PT - 1 < lo) continue;  // before the window: uniform over the block
        if (urnd > 0) mbar_wait(&pempty[ub], (urnd - 1) & 1);  // its last piece multiplied
        unsigned char* buf = csm + Lc.buf0 + ub * Lc.buf;
        __nv_bfloat16* bK = reinterpret_cast<__nv_bfloat16*>(buf + Lc.k);
        __nv_bfloat16* bV = reinterpret_cast<__nv_bfloat16*>(buf + Lc.v);
        __nv_bfloat16* bKc = reinterpret_cast<__nv_bfloat16*>(buf + Lc.kc);
        __nv_bfloat16* bVs = reinterpret_cast<__nv_bfloat16*>(buf + Lc.vsl);
        uint32_t* bMask = reinterpret_cast<uint32_t*>(buf + Lc.mask);

        // ---- dequantize the piece once for every row of the block: a unit
        // is 4 tokens x 4 columns of K (rotated) or V, rounded to bf16 ----
        for (int uu = tid; uu < 2 * upk; uu += PW * 32) {
          const int kind = uu >= upk, un = uu - kind * upk;
          const int c0 = 2 * (un & ((1 << lgq) - 1)), tu = un >> lgq;
          const unsigned char* codes = stg + kind * Lc.cb;
          float x[4][4];  // [token of the unit][column]
          int tls[4];
#pragma unroll
          for (int jb = 0; jb < 4; ++jb) {
            tls[jb] = 4 * tu + jb;
            container_codes<MODE>(codes, PT * pc + tls[jb], D, c0, half, odd, x[jb]);
          }
          if (kind == 0) {
            const float2 s01 = *reinterpret_cast<const float2*>(sKs + c0);
            const float2 s23 = *reinterpret_cast<const float2*>(sKs + c0 + half);
            const float2 z01 = *reinterpret_cast<const float2*>(sKz + c0);
            const float2 z23 = *reinterpret_cast<const float2*>(sKz + c0 + half);
#pragma unroll
            for (int jb = 0; jb < 4; ++jb) {
              const int tl = tls[jb];
              float x0 = fmaf(x[jb][0], s01.x, z01.x), x1 = fmaf(x[jb][1], s01.y, z01.y);
              float x2 = fmaf(x[jb][2], s23.x, z23.x), x3 = fmaf(x[jb][3], s23.y, z23.y);
              if (pre) {  // rotate the pairs (c0, c0 + D/2), (c0 + 1, c0 + 1 + D/2)
                const float4 cs = __ldg(rope4 + ((size_t)(tb0 + tl) * half + c0) / 2);
                const float q0 = x0 * cs.x - x2 * cs.y;
                const float q2 = x2 * cs.x + x0 * cs.y;
                const float q1 = x1 * cs.z - x3 * cs.w;
                const float q3 = x3 * cs.z + x1 * cs.w;
                x0 = q0; x1 = q1; x2 = q2; x3 = q3;
              }
              *reinterpret_cast<uint32_t*>(bK + tl * QS + c0) = bf2(x0, x1);
              *reinterpret_cast<uint32_t*>(bK + tl * QS + c0 + half) = bf2(x2, x3);
            }
          } else {
#pragma unroll
            for (int jb = 0; jb < 4; ++jb) {
              const int tl = tls[jb], tt = PT * pc + tl;
              // a token past the live range gets a zero V scale and offset,
              // so its value is 0 whatever its codes
              const bool live = tb0 + tl <= hi;
              const float sc_t = live ? sVs[tt] : 0.f, of_t = live ? sVo[tt] : 0.f;
              const float vs_t = sc_t * vb, vo_t = sc_t * va + of_t;
              *reinterpret_cast<uint32_t*>(bV + tl * QS + c0) =
                  bf2(fmaf(x[jb][0], vs_t, vo_t), fmaf(x[jb][1], vs_t, vo_t));
              *reinterpret_cast<uint32_t*>(bV + tl * QS + c0 + half) =
                  bf2(fmaf(x[jb][2], vs_t, vo_t), fmaf(x[jb][3], vs_t, vo_t));
            }
          }
        }

        // ---- the piece's outliers as sparse bf16 tiles, at the plain
        // version's rounding points: K as rnd(rope(k_add)) (slots of one dim
        // add before the rotation, a dim and its RoPE partner mix before the
        // rounding), V as rnd(v_add). Warp w builds the rows of its TPW
        // tokens, LPT lanes each (zero the row, then one entry per lane), and
        // the masks of the 16-dim column groups its rows touch ----
        if (kfix || vfix) {
          const int tl = TPW * warp + lane / LPT, le = lane % LPT;
          const int tt = PT * pc + tl, ta = tb0 + tl;
          for (int i = le; i < MAXD / 8; i += LPT) {
            if (kfix) *reinterpret_cast<uint4*>(bKc + tl * QS + 8 * i) = make_uint4(0u, 0u, 0u, 0u);
            if (vfix) *reinterpret_cast<uint4*>(bVs + tl * QS + 8 * i) = make_uint4(0u, 0u, 0u, 0u);
          }
          __syncwarp();
          uint32_t km = 0u, vm = 0u;
          if (kfix && ta <= hi) {
            const bool chan = a.n_kc > 0;
            const int ne = chan ? a.n_kc : a.n_kslots;
            // entry e's dim in this head (or -1) and value
            auto dim_of = [&](int e) {
              if (chan) return sCh[e];
              const int gi = slot_gidx(__float_as_uint(sRows[e * CT + tt]), D);
              return (gi >> lgD) == jh ? gi & (D - 1) : -1;
            };
            auto val_of = [&](int e) {
              const float w = sRows[e * CT + tt];
              return chan ? w : slot_value(__float_as_uint(w));
            };
            for (int e = le; e < ne; e += LPT) {
              const int d = dim_of(e);
              if (d < 0) continue;
              // the dims whose addend this entry's positions read: d, and
              // pre-RoPE its partner; the first entry among them writes
              const int i = pre ? d & (half - 1) : d;
              float s_lo = 0.f, s_hi = 0.f;
              bool first = true;
              for (int e2 = 0; e2 < ne && first; ++e2) {
                const int d2 = dim_of(e2);
                if (d2 < 0 || (pre ? d2 & (half - 1) : d2) != i) continue;
                if (e2 < e) {
                  first = false;
                } else if (!pre || d2 < half) {
                  s_lo += val_of(e2);
                } else {
                  s_hi += val_of(e2);
                }
              }
              if (!first) continue;
              if (pre) {
                const float2 cs = __ldg(rope2 + (size_t)ta * half + i);
                bKc[tl * QS + i] = __float2bfloat16_rn(
                    __fsub_rn(__fmul_rn(s_lo, cs.x), __fmul_rn(s_hi, cs.y)));
                bKc[tl * QS + i + half] = __float2bfloat16_rn(
                    __fadd_rn(__fmul_rn(s_hi, cs.x), __fmul_rn(s_lo, cs.y)));
                km |= (1u << (i >> 4)) | (1u << ((i + half) >> 4));
              } else {
                bKc[tl * QS + d] = __float2bfloat16_rn(s_lo);
                km |= 1u << (d >> 4);
              }
            }
          }
          if (vfix && ta <= hi) {
            const float* vw = sRows + a.spk * CT + tt;
            for (int e = le; e < a.n_vslots; e += LPT) {
              const int gi = slot_gidx(__float_as_uint(vw[e * CT]), D);
              if ((gi >> lgD) != jh) continue;
              // slots of one (token, dim) add before rounding: the first
              // writes
              float v = 0.f;
              bool first = true;
              for (int e2 = 0; e2 < a.n_vslots && first; ++e2) {
                if (slot_gidx(__float_as_uint(vw[e2 * CT]), D) != gi) continue;
                if (e2 < e) first = false;
                else v += slot_value(__float_as_uint(vw[e2 * CT]));
              }
              if (!first) continue;
              bVs[tl * QS + (gi & (D - 1))] = __float2bfloat16_rn(v);
              vm |= 1u << ((gi & (D - 1)) >> 4);
            }
          }
          km = __reduce_or_sync(FULL, km);
          vm = __reduce_or_sync(FULL, vm);
          if (lane == 0) {
            bMask[warp] = km;
            bMask[PW + warp] = vm;
          }
        }
        mbar_arrive(&pfull[ub]);  // the piece's tiles are complete
        if (++ub == a.n_buf) {
          ub = 0;
          ++urnd;
        }
        if (pc == last_pc) {  // every producer has read the stage: it takes tile it + NS
          asm volatile("bar.sync 1, %0;" :: "n"(PW * 32) : "memory");
          if (warp == 0 && it + NS < t_end) fill(it + NS, st);
        }
      }
      if (++st == NS) {
        st = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers: the products over each piece, in order ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(C_REGS));
  // ---- the warp's rows (MT row tiles of 16): positions, ldmatrix lane
  // offsets (bytes): Q as A, K as B of Q.K^T (rows = tokens), V as B of
  // P.V (transposed) ----
  const int g = lane >> 2, tq4 = lane & 3, wr0 = RW * (warp - PW);
  const bool wact = wr0 < nrows;
  int rp[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wr0 + 16 * mt + 8 * hf + g;
      rp[mt][hf] = r < nrows ? pos + (r0 + r) % Tq : NEG_ROW;
    }
  int wmin = 0, wmax = NEG_ROW;
  if (wact) row_span(r0 + wr0, min(RW, nrows - wr0), Tq, pos, wmin, wmax);
  const uint32_t qoff =
      smem_u32(sQ) + ((wr0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * QS + 8 * (lane >> 4)) * 2;
  const uint32_t koff = (((lane & 7) + 8 * (lane >> 4)) * QS + 8 * ((lane >> 3) & 1)) * 2;
  const uint32_t voff = (((lane & 7) + 8 * ((lane >> 3) & 1)) * QS + 8 * (lane >> 4)) * 2;

  float o[MT][16][4];
  float m[MT][2], l[MT][2];  // base-2 running state of rows g and g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[mt][n][j] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const float sl2 = a.inv * LOG2E;

  int ub = 0, urnd = 0;  // the piece buffer and the fills it had before
  for (int it = t_begin; it < t_end; ++it) {
    const int t0 = it * CT;
    const int last_pc = min(CT / PT - 1, (hi - t0) / PT);
    for (int pc = 0; pc <= last_pc; ++pc) {
      const int tb0 = t0 + PT * pc;
      if (tb0 + PT - 1 < lo) continue;
      mbar_wait(&pfull[ub], urnd & 1);
      unsigned char* buf = csm + Lc.buf0 + ub * Lc.buf;
      __nv_bfloat16* bK = reinterpret_cast<__nv_bfloat16*>(buf + Lc.k);
      __nv_bfloat16* bV = reinterpret_cast<__nv_bfloat16*>(buf + Lc.v);
      __nv_bfloat16* bKc = reinterpret_cast<__nv_bfloat16*>(buf + Lc.kc);
      __nv_bfloat16* bVs = reinterpret_cast<__nv_bfloat16*>(buf + Lc.vsl);
      uint32_t* bMask = reinterpret_cast<uint32_t*>(buf + Lc.mask);

      // ---- the warp's rows against the piece: S = Q.K^T (+ Q.Kc^T) ----
      const bool wlive = wact && tb0 <= wmax - S && (win <= 0 || tb0 + PT - 1 + S > wmin - win);
      if (wlive) {
        const bool wfull = tb0 + PT - 1 <= wmin - S && (win <= 0 || tb0 + S > wmax - win);
        float sc[MT][4][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0.f;
        // the K tile, then the K outlier tile over the k-steps it touches
        uint32_t kmask = 0u;
        if (kfix)
          for (int w = 0; w < PW; ++w) kmask |= bMask[w];
        auto qk_step = [&](uint32_t kbase, int kk) {
          uint32_t qa[MT][4], r[4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) ldsm4(qa[mt], qoff + (16 * mt * QS + 16 * kk) * 2);
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            ldsm4(r, kbase + (16 * jp * QS + 16 * kk) * 2);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma16816(sc[mt][2 * jp], qa[mt], r[0], r[1]);
              mma16816(sc[mt][2 * jp + 1], qa[mt], r[2], r[3]);
            }
          }
        };
#pragma unroll
        for (int kk = 0; kk < MAXD / 16; ++kk) qk_step(smem_u32(bK) + koff, kk);
        if (__popc(kmask) > 4) {  // dense: the whole tile, pipelined
#pragma unroll
          for (int kk = 0; kk < MAXD / 16; ++kk) qk_step(smem_u32(bKc) + koff, kk);
        } else {
          for (uint32_t mk = kmask; mk; mk &= mk - 1) qk_step(smem_u32(bKc) + koff, __ffs(mk) - 1);
        }

        // ---- mask, online softmax (base 2) over the piece; P to bf16 A
        // fragments in registers ----
        uint32_t pa[MT][2][4];
        bool moved = false;
        float al[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float v = sc[mt][j][e] * sl2;
              if (!wfull && !key_ok(tb0 + 8 * j + 2 * tq4 + (e & 1), rp[mt][e >> 1], S, win))
                v = -INFINITY;
              sc[mt][j][e] = v;
              mx[e >> 1] = fmaxf(mx[e >> 1], v);
            }
          float mu[2], sum[2] = {0.f, 0.f};
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL, mx[hf], 1));
            mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL, mx[hf], 2));
            const float mn = fmaxf(m[mt][hf], mx[hf]);
            mu[hf] = mn == -INFINITY ? 0.f : mn;
            al[mt][hf] = exp2f(m[mt][hf] - mu[hf]);
            moved |= al[mt][hf] != 1.f;
            m[mt][hf] = mn;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p0 = exp2f(sc[mt][j][0] - mu[0]), p1 = exp2f(sc[mt][j][1] - mu[0]);
            const float p2 = exp2f(sc[mt][j][2] - mu[1]), p3 = exp2f(sc[mt][j][3] - mu[1]);
            sum[0] += p0 + p1;
            sum[1] += p2 + p3;
            pa[mt][j >> 1][2 * (j & 1)] = bf2(p0, p1);
            pa[mt][j >> 1][2 * (j & 1) + 1] = bf2(p2, p3);
          }
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) l[mt][hf] = l[mt][hf] * al[mt][hf] + sum[hf];
        }
        if (__any_sync(FULL, moved)) {  // a row maximum moved: rescale O
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int n = 0; n < 16; ++n) {
              o[mt][n][0] *= al[mt][0];
              o[mt][n][1] *= al[mt][0];
              o[mt][n][2] *= al[mt][1];
              o[mt][n][3] *= al[mt][1];
            }
        }

        // ---- O += P.V, then P.V_slots where the piece holds a V slot ----
        bool vany = false;
        if (vfix)
          for (int w = 0; w < PW; ++w) vany |= bMask[PW + w] != 0u;
        auto pv_pass = [&](uint32_t vbase) {
#pragma unroll
          for (int kq = 0; kq < 2; ++kq)
#pragma unroll
            for (int np = 0; np < MAXD / 16; ++np) {
              uint32_t r[4];
              ldsm4_t(r, vbase + (16 * kq * QS + 16 * np) * 2);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                mma16816(o[mt][2 * np], pa[mt][kq], r[0], r[1]);
                mma16816(o[mt][2 * np + 1], pa[mt][kq], r[2], r[3]);
              }
            }
        };
        pv_pass(smem_u32(bV) + voff);
        if (vany) pv_pass(smem_u32(bVs) + voff);
      }
      mbar_arrive(&pempty[ub]);  // the buffer may be refilled
      if (++ub == a.n_buf) {
        ub = 0;
        ++urnd;
      }
    }
  }

  // ---- this split's partials, straight from the fragments ----
  if (wact) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float lt = l[mt][hf];
        lt += __shfl_xor_sync(FULL, lt, 1);
        lt += __shfl_xor_sync(FULL, lt, 2);
        const int r = wr0 + 16 * mt + 8 * hf + g;
        if (r < nrows) {
#pragma unroll
          for (int n = 0; n < 16; ++n)
            if (n < D / 8)
              *reinterpret_cast<float2*>(pacc + (size_t)r * D + 8 * n + 2 * tq4) =
                  make_float2(o[mt][n][2 * hf], o[mt][n][2 * hf + 1]);
          if (tq4 == 0) {
            pm[r] = m[mt][hf] == -INFINITY ? -INFINITY : m[mt][hf] * LN2;
            pl[r] = lt;
          }
        }
      }
  }
}

// One block per (query row, kv head, batch row): the sink prefix and every
// split's partial merged by log-sum-exp, then 1/l. A split of zero weight
// (no live key, or none of its tiles) is not read.
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
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if (lane == 0) s_sc[k] = v * a.inv;
  }
  // split maxima (one split per thread), then the block maximum
  float mloc = -INFINITY;
  for (int sp = d; sp < NS; sp += NT) mloc = fmaxf(mloc, a.part_m[(bh * NS + sp) * Q + r]);
  for (int o = 16; o; o >>= 1) mloc = fmaxf(mloc, __shfl_xor_sync(FULL, mloc, o));
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
    if (w != 0.f) lloc += w * a.part_l[pi];
  }
  for (int o = 16; o; o >>= 1) lloc += __shfl_xor_sync(FULL, lloc, o);
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
    for (int sp = 0; sp < NS; ++sp)
      if (s_w[sp] != 0.f) acc = fmaf(pacc[(size_t)sp * Q * D], s_w[sp], acc);
    a.out[(bh * Q + r) * D + d] = acc / l;
  }
}

template <int MODE, int NB, int G, bool PRE>
cudaError_t launch_decode(const FdArgs& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(fd_decode<MODE, NB, G, PRE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DECODE_SMEM_MAX);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  fd_decode<MODE, NB, G, PRE><<<dim3(a.n_split, a.Hkv / a.hb, a.B), DNT,
                                decode_smem(a), stream>>>(a);
  return cudaGetLastError();
}

template <int MODE, int NB, bool PRE>
cudaError_t dispatch_g(const FdArgs& a, cudaStream_t st) {
  switch (a.Q) {
    case 1: return launch_decode<MODE, NB, 1, PRE>(a, st);
    case 2: return launch_decode<MODE, NB, 2, PRE>(a, st);
    case 4: return launch_decode<MODE, NB, 4, PRE>(a, st);
    case 8: return launch_decode<MODE, NB, 8, PRE>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <int MODE, int NB>
cudaError_t dispatch_rope(const FdArgs& a, cudaStream_t st) {
  return a.post_rope ? dispatch_g<MODE, NB, false>(a, st) : dispatch_g<MODE, NB, true>(a, st);
}

cudaError_t dispatch_decode(const FdArgs& a, cudaStream_t st) {
  const bool pair_ok = a.mode != MODE_INT4X2 || a.hb % 2 == 0;
  if (a.hb < 1 || a.hb > DW || DW % a.hb || a.hg % a.hb || !pair_ok ||
      a.n_stage < 2 || a.n_stage > MAX_STAGES || decode_smem(a) > DECODE_SMEM_MAX)
    return cudaErrorInvalidValue;
  switch (a.mode) {
    case MODE_NUQ:
      switch (a.bits) {
        case 2: return dispatch_rope<MODE_NUQ, 2>(a, st);
        case 3: return dispatch_rope<MODE_NUQ, 3>(a, st);
        case 4: return dispatch_rope<MODE_NUQ, 4>(a, st);
      }
      return cudaErrorInvalidValue;
    case MODE_INT4: return dispatch_rope<MODE_INT4, 0>(a, st);
    case MODE_INT8: return dispatch_rope<MODE_INT8, 0>(a, st);
    case MODE_INT4X2: return dispatch_rope<MODE_INT4X2, 0>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <int MODE, int NB, bool PRE>
cudaError_t launch_gqa(const FdArgs& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(fd_gqa<MODE, NB, PRE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DECODE_SMEM_MAX);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  fd_gqa<MODE, NB, PRE><<<dim3(a.n_split, a.Hkv / a.hb, a.B), DNT, gqa_layout(a).bytes,
                          stream>>>(a);
  return cudaGetLastError();
}

template <int MODE, int NB>
cudaError_t gqa_rope(const FdArgs& a, cudaStream_t st) {
  return a.post_rope ? launch_gqa<MODE, NB, false>(a, st) : launch_gqa<MODE, NB, true>(a, st);
}

// the tensor-core decode body: Tq = 1, 3..8 rows per kv head, bf16 dots
cudaError_t dispatch_gqa(const FdArgs& a, cudaStream_t st) {
  const bool pair_ok = a.mode != MODE_INT4X2 || a.hb % 2 == 0;
  if (a.Tq != 1 || a.n_rt != 1 || a.Q < 3 || a.Q > 8 || !a.dot_bf16 || a.hb < 1 ||
      a.hb > DW || DW % a.hb || a.hg % a.hb || !pair_ok || a.n_stage < 2 ||
      a.n_stage > MAX_STAGES || gqa_layout(a).bytes > DECODE_SMEM_MAX)
    return cudaErrorInvalidValue;
  switch (a.mode) {
    case MODE_NUQ:
      switch (a.bits) {
        case 2: return gqa_rope<MODE_NUQ, 2>(a, st);
        case 3: return gqa_rope<MODE_NUQ, 3>(a, st);
        case 4: return gqa_rope<MODE_NUQ, 4>(a, st);
      }
      return cudaErrorInvalidValue;
    case MODE_INT4: return gqa_rope<MODE_INT4, 0>(a, st);
    case MODE_INT8: return gqa_rope<MODE_INT8, 0>(a, st);
    case MODE_INT4X2: return gqa_rope<MODE_INT4X2, 0>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <int MODE>
cudaError_t launch_partial(const FdArgs& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(fd_partial<MODE, PR, Contig>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(PR, MAXD));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  fd_partial<MODE, PR, Contig><<<dim3(a.n_split, a.Hkv * a.n_rt, a.B), NT,
                                 smem_bytes(PR, a.D), stream>>>(a);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_chunk(const FdArgs& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(fd_chunk<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         CHUNK_SMEM_MAX);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  fd_chunk<NB><<<dim3(a.n_split, a.Hkv * a.n_rt, a.B), (CHUNK_PW + CW) * 32,
                 chunk_layout(a).bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_chunk_sync(const FdArgs& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(fd_chunk_sync<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         CHUNK_SMEM_MAX);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  fd_chunk_sync<MODE><<<dim3(a.n_split, a.Hkv * a.n_rt, a.B), (SYNC_PW + CW) * 32,
                        sync_layout(a).bytes, stream>>>(a);
  return cudaGetLastError();
}

// the tensor-core chunk body of the mode (bf16 dots) over the contiguous
// cache: bit planes on fd_chunk (wgmma, rows in tiles of 64), the
// containers on fd_chunk_sync (mma.sync, rows in tiles of 16)
cudaError_t dispatch_chunk(const FdArgs& a, cudaStream_t st) {
  const bool planes = a.mode == MODE_NUQ;
  const int m = planes ? 64 : 16;
  if (a.rows_blk < m || a.rows_blk > CHUNK_ROWS || a.rows_blk % m ||
      a.n_rt * a.rows_blk < a.Q || (a.n_rt - 1) * a.rows_blk >= a.Q || a.n_stage < 2 ||
      a.n_stage > MAX_STAGES || a.n_buf < 1 || a.n_buf > MAX_BUF ||
      (planes ? chunk_layout(a).bytes : sync_layout(a).bytes) > CHUNK_SMEM_MAX)
    return cudaErrorInvalidValue;
  switch (a.mode) {
    case MODE_NUQ:
      switch (a.bits) {
        case 2: return launch_chunk<2>(a, st);
        case 3: return launch_chunk<3>(a, st);
        case 4: return launch_chunk<4>(a, st);
      }
      return cudaErrorInvalidValue;
    case MODE_INT4: return launch_chunk_sync<MODE_INT4>(a, st);
    case MODE_INT8: return launch_chunk_sync<MODE_INT8>(a, st);
    case MODE_INT4X2: return launch_chunk_sync<MODE_INT4X2>(a, st);
  }
  return cudaErrorInvalidValue;
}

bool is_decode(const FdArgs& a) {
  return a.Tq == 1 && a.n_rt == 1 && (a.Q == 1 || a.Q == 2 || a.Q == 4 || a.Q == 8);
}

// The split kernel of the body the host routed the call to (a decode body,
// or over the contiguous cache a chunk body) and the merge on `stream`.
int run(const FdArgs* a, void* stream) {
  if (a->S > MAX_SINK || a->n_kc > MAX_KC || a->D > MAXD || a->D % 32 ||
      a->Tc % 128 || (a->mode == MODE_NUQ && (a->bits < 2 || a->bits > 4)) ||
      (a->mode == MODE_INT4X2 && (a->bits != 2 || a->Hkv % 2 || a->hg % 2)) ||
      (!a->post_rope && !a->rope))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (a->body == BODY_DECODE) {
    if (is_decode(*a)) e = dispatch_decode(*a, st);
  } else if (a->body == BODY_GQA) {
    e = dispatch_gqa(*a, st);
  } else if (a->body == BODY_CHUNK) {
    if (!a->table && a->dot_bf16) e = dispatch_chunk(*a, st);
  } else if (a->body == BODY_PARTIAL && !a->table) {  // fp32 dots: the SIMT body
    switch (a->mode) {
      case MODE_NUQ: e = launch_partial<MODE_NUQ>(*a, st); break;
      case MODE_INT4: e = launch_partial<MODE_INT4>(*a, st); break;
      case MODE_INT8: e = launch_partial<MODE_INT8>(*a, st); break;
      case MODE_INT4X2: e = launch_partial<MODE_INT4X2>(*a, st); break;
    }
  }
  if (e != cudaSuccess) return (int)e;
  fd_merge<<<dim3(a->Q, a->Hkv, a->B), NT, a->n_split * sizeof(float), st>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

// K1 over the contiguous (L, B, ...) cache, on the body the host routed it
// to (a.body): fd_decode at Tq = 1 with G = Q in {1, 2, 4, 8}, fd_gqa at
// Tq = 1 with 3-8 rows and bf16 dots, else fd_chunk (bf16 dots) or
// fd_partial (fp32 dots). Returns the cudaError_t of the launches (0 on success); nothing is
// synchronised.
extern "C" int fd_attention(const FdArgs* a, void* stream) {
  if (a->table) return (int)cudaErrorInvalidValue;
  return run(a, stream);
}

// K5: decode attention (Tq = 1, fd_decode or fd_gqa) over the (L, NP, ...)
// page pool through the (B, MP) page table, Tc = MP * P.
extern "C" int fd_paged_attention(const FdArgs* a, void* stream) {
  if (!a->table || a->P <= 0 || a->P % 128 || a->MP <= 0 || a->NP <= 0 ||
      a->Tc != a->MP * a->P || (a->body != BODY_DECODE && a->body != BODY_GQA))
    return (int)cudaErrorInvalidValue;
  return run(a, stream);
}
