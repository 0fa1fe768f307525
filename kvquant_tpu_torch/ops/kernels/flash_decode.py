"""One-pass attention over the sink prefix and the quantized cache (port of
kvquant_tpu/ops/pallas/flash_decode.py: flash_attention, flash_decode).

``flash_attention`` keeps the JAX signature and layouts: queries
(B, Hkv, Q, D) roped at each row's position, Q = G*Tq rows ordered g-major,
row r of batch b at position ``pos[b] + r % Tq``; the full stacked
(L, ...) cache arrays and the layer index ``li``. Every row attends over
the exact sink tokens and the packed tokens up to its own position
(optionally a sliding window). Returns (B, Hkv, Q, D) fp32. Tq == 1 is the
decode step (``flash_decode``); Tq > 1 a block of quantized chunked prefill.

Storage modes: nuq bit planes (bits 2-4, any codebook), int4 / int8
containers and the head-paired 2-bit int4x2 container (affine codebook;
int4x2 pairs kv heads within a head group, so its head_group must be even,
as the JAX kernel asserts), keys pre- or post-RoPE, K outliers as slot
words or static channels, V slot words.

  - CPU tensors: the plain PyTorch version ``flash_attention_ref``.
  - CUDA tensors: the hand-written kernel ``csrc/flash_decode.cu``, or an
    exception when it cannot be built or launched; there is no fallback.

On the card a decode step (Tq == 1) of G in ``GQA_ROWS`` (3-8) rows per
kv head with bf16 dots runs the tensor-core decode body ``fd_gqa``
(``gqa_plan``); other steps of G = Q in {1, 2, 4, 8} the SIMT decode body
``fd_decode`` (``decode_plan``); both an async-copy tile ring, one block per
head group slice. Other calls (prefill chunks, and steps of other row
counts) run a tensor-core chunk body with bf16 dots (``dot_bf16``, the
default: up to 256 query rows per block; ``fd_chunk`` on wgmma over bit
planes, ``fd_chunk_sync`` on mma.sync over the containers), or the SIMT body
``fd_partial`` with fp32 dots (64 rows per block), the reference mode that
bf16 tensor cores cannot compute; ``body`` says which (and takes a forced
body for timing) and ``chunk_plan`` gives the block shape. All read the
(cos, sin) table of ``rope_table``, built once per capacity, sink, RoPE
parameters and device.

``flash_attention.launches`` counts kernel launches (one per call on the
card, ``flash_decode`` included), ``flash_attention.chunk_launches`` those
on a chunk body, ``flash_attention.gqa_launches`` those on fd_gqa. The TPU
kernel's constant-band packing (``prep_constants``) exists for a Mosaic
operand limit and is not ported: the CUDA kernel takes its operands in a
struct.
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import NamedTuple

import torch

from ...cache import DeployConfig, k_channel_index
from ...models.llama import rope_cos_sin, rotate_half
from ...quant.nuq import lut_lookup
from ..deployed import _outlier_addend
from ..packing import unpack_codes
from .common import (MAX_KC, MAX_SINK, TILE_TOKENS, fold_affine,
                     signed_codes, channel_addend, check_operands, sm_count)

MODES = {"nuq": 0, "int4": 1, "int8": 2, "int4x2": 3}
TILE = 64  # key tokens per tile in the SIMT body (fp32 dots)
ROWS = 64  # query rows per block in the SIMT body


def _check_config(dcfg: DeployConfig):
    assert dcfg.codes in MODES, dcfg.codes
    if dcfg.codes == "int4x2":
        assert dcfg.head_group % 2 == 0, \
            "int4x2 flash kernel pairs heads within a group"


def _dequant_layer(k_planes, v_planes, kv_out, k_range, k_offset, v_scale,
                   v_offset, k_lut, v_lut, li, dcfg, k_ressc, k_chan):
    """Layer ``li`` as the kernel reads it: (keys, key outlier addend, values,
    value outlier addend), each (B, Hkv, Tc, D) fp32 or None for an absent
    addend. Keys are not yet rotated; values carry the per-token range."""
    if dcfg.codes == "nuq":
        ck = unpack_codes(k_planes[li], dcfg.bits)
        cv = unpack_codes(v_planes[li], dcfg.bits)
        kd = lut_lookup(k_lut[li], ck) * k_range[li][:, None, :] \
            + k_offset[li][:, None, :]
        vd = lut_lookup(v_lut[li], cv) * v_scale[li][:, None, :, None] \
            + v_offset[li][:, None, :, None]
    else:
        k_step, k_zero, va, vb = fold_affine(dcfg, k_lut, v_lut, k_range,
                                             k_offset, li)
        kd = signed_codes(k_planes[li], dcfg) * k_step[:, None, :] \
            + k_zero[:, None, :]
        vs = v_scale[li] * vb
        vo = v_scale[li] * va + v_offset[li]
        vd = signed_codes(v_planes[li], dcfg) * vs[:, None, :, None] \
            + vo[:, None, :, None]
    k_add = v_add = None
    if dcfg.include_sparse:
        rows = kv_out[li]  # (B, NG, J, Tc)
        spk = dcfg.slots_per_kind
        if dcfg.k_outliers == "channels":
            chan = k_chan[li] if k_chan is not None \
                else k_channel_index(k_ressc[li], dcfg)
            k_add = channel_addend(rows[:, :, :spk], chan, dcfg)
        elif dcfg.cap_per_side > 0:
            k_add = _outlier_addend(rows[:, :, :spk], dcfg)
        if dcfg.cap_per_side > 0:
            v_add = _outlier_addend(rows[:, :, spk:], dcfg)
    return kd, k_add, vd, v_add


def flash_attention_ref(
    q_rot, k_planes, v_planes, kv_out, k_range, k_offset, v_scale, v_offset,
    k_sink, v_sink, k_lut, v_lut, li, pos, dcfg: DeployConfig, mcfg,
    Tq: int = 1, block_tokens: int = 1024, k_ressc=None, k_chan=None,
):
    """Plain PyTorch version of the kernel: dequantize layer ``li`` in full,
    rotate pre-RoPE keys at positions S + t (the outlier addend rotated as
    its own term: RoPE is linear), score every row against the sinks and
    the packed tokens under its own causal / window mask, softmax, P.V.
    ``dot_bf16`` rounds every dot operand to bf16 (fp32 accumulation) where
    the kernel does: the rotated keys and their rotated outlier terms
    separately, as the TPU kernel's separate slot dots do, likewise the
    values and their slot terms. ``block_tokens`` is accepted for
    signature parity."""
    _check_config(dcfg)
    li = int(li)
    B, Hkv, Q, D = q_rot.shape
    assert Q % Tq == 0, (Q, Tq)
    S = dcfg.sink
    dev = q_rot.device
    rnd = (lambda x: x.to(torch.bfloat16).to(torch.float32)) \
        if dcfg.dot_bf16 else (lambda x: x)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev).reshape(-1)
    rowpos = pos.expand(B)[:, None] + torch.arange(Q, device=dev) % Tq
    inv = 1.0 / (D ** 0.5)

    kd, k_add, vd, v_add = _dequant_layer(
        k_planes, v_planes, kv_out, k_range, k_offset, v_scale, v_offset,
        k_lut, v_lut, li, dcfg, k_ressc, k_chan)
    Tc = kd.shape[-2]
    rope = lambda x: x
    if not dcfg.post_rope_k:
        ck, sk = rope_cos_sin(S + torch.arange(Tc, dtype=torch.int32,
                                               device=dev), mcfg)
        rope = lambda x: x * ck + rotate_half(x) * sk
    kx = rnd(rope(kd)) if k_add is None else rnd(rope(kd)) + rnd(rope(k_add))
    vx = rnd(vd) if v_add is None else rnd(vd) + rnd(v_add)
    q = rnd(q_rot.to(torch.float32))

    win = mcfg.sliding_window
    t = torch.arange(Tc, device=dev)
    valid = t <= (rowpos - S)[..., None]  # (B, Q, Tc)
    if win is not None:
        valid &= (t + S) > (rowpos - win)[..., None]
    sc = torch.einsum("bhqd,bhtd->bhqt", q, kx) * inv
    sc = sc.masked_fill(~valid[:, None], float("-inf"))
    if S > 0:
        si = torch.arange(S, device=dev)
        svalid = si <= rowpos[..., None]
        if win is not None:
            svalid &= si > (rowpos - win)[..., None]
        ss = torch.einsum("bhqd,bhsd->bhqs", q, rnd(k_sink[li])) * inv
        sc = torch.cat([ss.masked_fill(~svalid[:, None], float("-inf")), sc],
                       dim=-1)
    probs = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhqt,bhtd->bhqd", rnd(probs[..., S:]), vx)
    if S > 0:
        out = out + torch.einsum("bhqs,bhsd->bhqd", rnd(probs[..., :S]),
                                 rnd(v_sink[li]))
    return out


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


class _FdArgs(ctypes.Structure):
    """Mirror of ``FdArgs`` in csrc/flash_decode.cu (same field order)."""
    _fields_ = [
        ("q", _P), ("kp", _P), ("vp", _P), ("kv_out", _P),
        ("k_range", _P), ("k_offset", _P), ("v_scale", _P), ("v_offset", _P),
        ("k_sink", _P), ("v_sink", _P), ("k_lut", _P), ("v_lut", _P),
        ("rope", _P), ("pos", _P), ("k_chan", _P),
        ("part_m", _P), ("part_l", _P), ("part_acc", _P), ("out", _P),
        ("L", _I), ("B", _I), ("Hkv", _I), ("Q", _I), ("Tq", _I), ("D", _I),
        ("Tc", _I), ("S", _I), ("J", _I), ("spk", _I), ("n_kc", _I),
        ("n_kslots", _I), ("n_vslots", _I),
        ("hg", _I), ("mode", _I), ("bits", _I), ("window", _I),
        ("post_rope", _I), ("dot_bf16", _I), ("li", _I), ("n_split", _I),
        ("n_rt", _I), ("inv", ctypes.c_float),
        ("table", _P), ("MP", _I), ("P", _I), ("NP", _I),
        ("hb", _I), ("n_stage", _I), ("rows_blk", _I), ("n_buf", _I),
        ("body", _I),
    ]


@functools.lru_cache(maxsize=None)
def _lib():
    from .build import load

    lib = load("flash_decode")
    for entry in (lib.fd_attention, lib.fd_paged_attention):
        entry.argtypes = [ctypes.POINTER(_FdArgs), ctypes.c_void_p]
        entry.restype = ctypes.c_int
    return lib


def rope_table(mcfg, sink: int, Tc: int, device) -> torch.Tensor:
    """The kernels' (Tc, D/2, 2) fp32 (cos, sin) table of packed tokens
    t = 0..Tc-1 at positions ``sink + t``: ``models.llama.rope_cos_sin``'s
    values (the plain version's), computed on ``device``. Built once per
    (capacity, sink, RoPE parameters, device) and shared by every layer and
    step of K1 and K5."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _rope_table(int(Tc), int(sink), int(mcfg.d_head),
                       float(mcfg.rope_theta), float(mcfg.rope_scaling),
                       device)


@functools.lru_cache(maxsize=4)
def _rope_table(Tc, sink, d_head, theta, scaling, device):
    rope = types.SimpleNamespace(d_head=d_head, rope_theta=theta,
                                 rope_scaling=scaling)
    cos, sin = rope_cos_sin(
        sink + torch.arange(Tc, dtype=torch.int32, device=device), rope)
    half = d_head // 2
    return torch.stack([cos[:, :half], sin[:, :half]], dim=-1).contiguous()


STAGE_BYTES = 32 * 1024  # largest ring stage before heads per block shrink
RING_BYTES = 96 * 1024  # ring per block: two blocks share an SM
SMEM_PER_SM = 228 * 1024  # H100: shared memory of an SM, 1 KB kept per block
DECODE_WAVES = 1  # resident waves of decode blocks per call


def _stage_bytes(dcfg: DeployConfig, D: int, J: int, n_rows: bool, hb: int):
    """Bytes of one ring stage: K and V codes of hb heads (int4x2: hb / 2
    pair containers), the group's outlier rows if ``n_rows``, V scale and
    offset of one tile."""
    tt = 128 if dcfg.codes == "nuq" else 64
    cb = {"nuq": dcfg.bits * 16 * D, "int8": 64 * D}.get(dcfg.codes, 32 * D)
    units = hb // 2 if dcfg.codes == "int4x2" else hb
    return 2 * units * cb + ((J if n_rows else 0) + 2) * tt * 4


def decode_plan(dcfg: DeployConfig, D: int, J: int, n_rows: bool):
    """The decode kernel's block shape: (heads per block hb, ring stages,
    tile tokens). hb is the largest of 8/4/2/1 dividing the head group
    (even for int4x2, whose pairs share a container) whose stage fits
    STAGE_BYTES; the ring takes RING_BYTES in 2-4 stages."""
    hbs = [h for h in (8, 4, 2, 1) if dcfg.head_group % h == 0
           and (dcfg.codes != "int4x2" or h % 2 == 0)]
    for hb in hbs:
        stage = _stage_bytes(dcfg, D, J, n_rows, hb)
        if stage <= STAGE_BYTES:
            break
    return (hb, max(2, min(4, RING_BYTES // stage)),
            128 if dcfg.codes == "nuq" else 64)


GQA_ROWS = (3, 4, 5, 6, 7, 8)  # rows per kv head of a bf16-dot step on fd_gqa
GQA_BLOCKS_PER_SM = 1  # fd_gqa's launch bound: one block, <= 168 registers
GQA_UNIT = 32  # tokens per consumer unit of fd_gqa (csrc GU)
GQA_X_BYTES = 8 * (GQA_UNIT + 1) * 4  # a warp's exchange / P^T tile (csrc GXB)
GQA_VT_STRIDE = GQA_UNIT + 8  # a warp's V slot tile row, bf16 (csrc GVS)
DECODE_WARPS = 8  # consumer warps of a decode block (csrc DW)
DECODE_SMEM_MAX = 200 * 1024  # csrc DECODE_SMEM_MAX


class GqaPlan(NamedTuple):
    """Block shape of a call on fd_gqa: heads per block ``hb`` and tile
    tokens as ``decode_plan``, ring ``stages`` (fewer than decode_plan's
    where GQA_BLOCKS_PER_SM blocks would not fit an SM), ``smem`` dynamic
    shared bytes per block, ``per_sm`` resident blocks an SM holds."""
    hb: int
    stages: int
    tile: int
    smem: int
    per_sm: int


def _gqa_smem(dcfg: DeployConfig, D: int, J: int, G: int, n_rows: bool,
              live: tuple, hb: int, stages: int) -> int:
    """csrc gqa_layout(a).bytes: mbarriers, the ring or the merge scratch,
    the queries transposed (8 rows), the static-channel dims (to 16 B),
    the K step and zero, the warps' exchange / P^T tiles and, with V
    slots, their V^T slot tiles."""
    n_kc, _, n_vslots = live
    ring = max(stages * _stage_bytes(dcfg, D, J, n_rows, hb),
               DECODE_WARPS * G * (D + 2) * 4)
    off = 128 + ring + 4 * hb * 8 * D + 4 * hb * n_kc
    off = -(-off // 16) * 16 + 4 * hb * 2 * D + DECODE_WARPS * GQA_X_BYTES
    if n_vslots:
        off += 2 * DECODE_WARPS * D * GQA_VT_STRIDE
    return off


def gqa_plan(dcfg: DeployConfig, D: int, J: int, G: int) -> GqaPlan:
    """The block shape of fd_gqa for G rows per kv head: decode_plan's
    heads and stages, the stages cut (to two at the least) until
    GQA_BLOCKS_PER_SM blocks share an SM and a block fits
    DECODE_SMEM_MAX. Raises ValueError where the smallest shape does
    not."""
    live = kernel_limits(dcfg, D, J)
    n_rows = any(live)
    hb, stages, tile = decode_plan(dcfg, D, J, n_rows)
    smem = _gqa_smem(dcfg, D, J, G, n_rows, live, hb, stages)
    while stages > 2 and ((smem + 1024) * GQA_BLOCKS_PER_SM > SMEM_PER_SM
                          or smem > DECODE_SMEM_MAX):
        stages -= 1
        smem = _gqa_smem(dcfg, D, J, G, n_rows, live, hb, stages)
    if smem > DECODE_SMEM_MAX:
        raise ValueError(f"flash_attention kernel: fd_gqa needs {smem} B "
                         f"of shared memory > {DECODE_SMEM_MAX}")
    per_sm = max(1, min(GQA_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024)))
    return GqaPlan(hb, stages, tile, smem, per_sm)


def gqa_splits(plan: GqaPlan, B: int, Hkv: int, Tc: int, sms: int) -> int:
    """Token splits of an fd_gqa call: as many as fill the card's resident
    blocks once over B * Hkv / hb head blocks, at most one per tile."""
    return max(1, min(Tc // plan.tile, DECODE_WAVES * plan.per_sm * sms
                      // (B * Hkv // plan.hb)))


def decode_splits(dcfg: DeployConfig, B: int, Hkv: int, G: int, D: int,
                  J: int, n_rows: bool, n_kc: int, Tc: int, sms: int) -> int:
    """Token splits of a decode call: as many as fill the card's resident
    blocks once (DECODE_WAVES) over B * Hkv / hb head blocks, at most one
    per tile; the blocks take their live tiles from ``pos`` on the card.
    Residents per SM: two blocks at G <= 2 (96 registers a thread), one
    above, fewer if shared memory (the mirror of csrc's decode_smem, plus
    the static LUTs) does not hold them."""
    hb, n_stage, tt = decode_plan(dcfg, D, J, n_rows)
    ring = max(n_stage * _stage_bytes(dcfg, D, J, n_rows, hb),
               8 * G * (D + 2) * 4)
    smem = 128 + ring + 4 * (hb * G * D + hb * n_kc) + 128
    per_sm = max(1, min(2 if G <= 2 else 1, SMEM_PER_SM // (smem + 1024)))
    return max(1, min(Tc // tt, DECODE_WAVES * per_sm * sms // (B * Hkv // hb)))


CHUNK_TILE = 128  # key tokens per ring stage of fd_chunk (a nuq packing group)
CHUNK_PIECE = 32  # key tokens per dequantized bf16 piece
CHUNK_M = 64  # rows of a wgmma row tile (m64): fd_chunk's rows come in these
SYNC_M = 16  # rows of an mma.sync row tile: fd_chunk_sync's rows come in these
CHUNK_ROWS = 256  # most query rows per chunk block: 8 consumer warps
CHUNK_SMEM_MAX = 225 * 1024  # csrc CHUNK_SMEM_MAX: dynamic shared bytes
CHUNK_BLOCKS_PER_SM = 1  # 384-512 threads, the consumers at 200-224 registers
# (piece buffers, ring stages) in the order chunk_plan tries them: buffers
# let the producers run ahead of the products, stages ahead of the codes
CHUNK_SHAPES = ((3, 3), (3, 2), (2, 3), (2, 2), (1, 3), (1, 2))
SW_ATOM = 1024  # csrc SW_ATOM: a swizzle atom, the tiles' alignment
CHUNK_HEAD = 128 + 4 * 2 * 8 * 4  # csrc CHUNK_HEAD: mbarriers, outlier masks
SYNC_PW = 4  # csrc SYNC_PW: fd_chunk_sync's producer warps


class ChunkPlan(NamedTuple):
    """Block shape of a call that is not a decode step. ``body`` "mma"
    (fd_chunk / fd_chunk_sync, bf16 dots) or "simt" (fd_partial, fp32
    dots); ``rows`` query rows per block, ``n_rt`` row blocks covering the
    Q rows; ``tile`` key tokens per tile; ``stages`` ring stages and
    ``n_buf`` bf16 piece buffers (mma); ``smem`` dynamic shared bytes per
    block."""
    body: str
    rows: int
    n_rt: int
    tile: int
    stages: int
    n_buf: int
    smem: int


def _simt_smem(D: int) -> int:
    """csrc smem_bytes(ROWS, D) of fd_partial."""
    floats = (TILE * (D + 1) + TILE * D + ROWS * (D + 1) + ROWS * (TILE + 1)
              + 32 + 2 * TILE)
    return 4 * floats + 4 * (ROWS + MAX_KC)


class ChunkLayout(NamedTuple):
    """A chunk body's dynamic shared memory: byte offsets from the block's
    base. ``ring`` the raw stages (after the mbarriers, and for fd_chunk
    the outlier masks), ``q`` the bf16 queries, ``buf0`` the first piece
    buffer, ``buf`` a buffer's bytes (``tiles`` bf16 tiles of 32 rows: K,
    V, the K outlier tile, the V slot tile; fd_chunk_sync's also holds the
    producer warps' outlier masks), ``end`` the layout's end and ``bytes``
    the dynamic shared bytes a launch asks for. fd_chunk's tiles are
    swizzled rows of 128 bf16 from a 1024-aligned base (a swizzle atom
    more is asked for, to align it); fd_chunk_sync's rows of 128 + 8."""
    ring: int
    q: int
    buf0: int
    buf: int
    tiles: int
    end: int
    bytes: int


def chunk_layout(dcfg: DeployConfig, D: int, J: int, rows: int, stages: int,
                 n_buf: int, live: tuple) -> ChunkLayout:
    """The mirror of csrc chunk_layout (bit planes) or sync_layout (the
    containers) for ``rows`` query rows, ``stages`` ring stages and
    ``n_buf`` piece buffers."""
    n_kc, n_kslots, n_vslots = live
    cb = {"nuq": dcfg.bits * 16 * D,
          "int8": CHUNK_TILE * D}.get(dcfg.codes, CHUNK_TILE * D // 2)
    n_rows = J if (n_kc or n_kslots or n_vslots) else 0
    stage = 2 * cb + (n_rows + 2) * CHUNK_TILE * 4
    tiles = 2 + bool(n_kc or n_kslots) + bool(n_vslots)
    if dcfg.codes != "nuq":  # fd_chunk_sync: 128 B of mbarriers
        row = (128 + 8) * 2  # bf16 tile rows of 128 + 8 columns
        q = 128 + stages * stage
        buf0 = q + rows * row
        buf = tiles * CHUNK_PIECE * row + 2 * SYNC_PW * 4
        end = buf0 + n_buf * buf
        return ChunkLayout(128, q, buf0, buf, tiles, end, end)
    row = 128 * 2  # bf16 tile rows of 128 columns for every D
    q = -(-(CHUNK_HEAD + stages * stage) // SW_ATOM) * SW_ATOM
    buf0 = q + rows * row
    buf = tiles * CHUNK_PIECE * row
    end = buf0 + n_buf * buf
    return ChunkLayout(CHUNK_HEAD, q, buf0, buf, tiles, end, end + SW_ATOM)


BODIES = {"decode": 0, "gqa": 1, "mma": 2, "simt": 3}  # csrc BODY_*


def body(dcfg: DeployConfig, Q: int, Tq: int, force: str = None) -> str:
    """The kernel body a call runs on the card: "decode" (fd_decode, one
    step of G in 1/2/4/8 rows per kv head), "gqa" (fd_gqa, one step of G
    in GQA_ROWS rows with bf16 dots, on the tensor cores), else "mma"
    (fd_chunk over bit planes, fd_chunk_sync over the containers) with
    bf16 dots or "simt" (fd_partial) with fp32 dots.
    ``force`` names another body for timing: "mma" / "simt" take any call
    (the chunk bodies at Tq = 1 too), "decode" a step of 1/2/4/8 rows,
    "gqa" a bf16-dot step of 3-8 rows; anything else raises ValueError."""
    if force is not None:
        ok = {"decode": is_decode(Q, Tq, False),
              "gqa": Tq == 1 and 3 <= Q <= 8 and dcfg.dot_bf16,
              "mma": dcfg.dot_bf16, "simt": True}
        if not ok.get(force, False):
            raise ValueError(f"flash_attention kernel: body {force!r} does "
                             f"not run Q={Q}, Tq={Tq}, dot_bf16="
                             f"{dcfg.dot_bf16}")
        return force
    if Tq == 1 and dcfg.dot_bf16 and Q in GQA_ROWS:
        return "gqa"
    if is_decode(Q, Tq, False):
        return "decode"
    return "mma" if dcfg.dot_bf16 else "simt"


def chunk_plan(dcfg: DeployConfig, D: int, J: int, Q: int,
               Tq: int, force: str = None) -> ChunkPlan:
    """Block shape of a call that is not a decode step (Q = G * Tq rows),
    or of a decode step ``force``d onto a chunk body ("mma" / "simt", for
    timing). mma: the fewest row blocks of at most CHUNK_ROWS rows, their
    rows spread evenly in tiles of CHUNK_M (fd_chunk's wgmma row tile, bit
    planes) or SYNC_M (fd_chunk_sync's mma.sync one, the containers); the
    first of CHUNK_SHAPES (piece buffers, ring stages) that CHUNK_SMEM_MAX
    holds.
    Raises ValueError for a decode call or a configuration whose smallest
    shape does not fit."""
    kind = body(dcfg, Q, Tq, force)
    if kind in ("decode", "gqa"):
        raise ValueError(f"chunk_plan: Q={Q}, Tq={Tq} is a decode step")
    if kind == "simt":
        return ChunkPlan("simt", ROWS, -(-Q // ROWS), TILE, 0, 0,
                         _simt_smem(D))
    live = kernel_limits(dcfg, D, J)
    m = CHUNK_M if dcfg.codes == "nuq" else SYNC_M
    tiles = -(-Q // m)
    n_rt = -(-tiles // (CHUNK_ROWS // m))
    rows = m * -(-tiles // n_rt)
    for n_buf, stages in CHUNK_SHAPES:
        smem = chunk_layout(dcfg, D, J, rows, stages, n_buf, live).bytes
        if smem <= CHUNK_SMEM_MAX:
            return ChunkPlan("mma", rows, n_rt, CHUNK_TILE, stages, n_buf,
                             smem)
    raise ValueError(f"flash_attention kernel: the chunk body's shared "
                     f"memory ({smem} B at {rows} rows, one buffer, two "
                     f"stages) exceeds {CHUNK_SMEM_MAX} B: {dcfg.codes} "
                     f"D {D}, {J} outlier rows")


def chunk_splits(plan: ChunkPlan, B: int, Hkv: int, Tc: int,
                 sms: int) -> int:
    """Token splits of a chunk call. mma: as many as fill the card's
    resident blocks once over B * Hkv * n_rt blocks, at most one per
    128-token tile of the capacity (the blocks take their live tiles from
    ``pos`` on the card); simt: about four blocks per SM."""
    blocks = B * Hkv * plan.n_rt
    if plan.body == "simt":
        return max(1, min(-(-4 * sms // blocks), Tc // TILE))
    return max(1, min(Tc // plan.tile,
                      CHUNK_BLOCKS_PER_SM * sms // blocks))


def load_library():
    """Build (on first use) and load the kernel library."""
    return _lib()


def kernel_limits(dcfg: DeployConfig, D: int, J: int):
    """Raise ValueError for a configuration the CUDA kernel does not take;
    returns its live (static K channel, K slot, V slot) row counts."""
    if D not in (32, 64, 128):
        raise ValueError(f"flash_attention kernel: d_head {D} not in "
                         f"32/64/128")
    if dcfg.sink > MAX_SINK:
        raise ValueError(f"flash_attention kernel: sink {dcfg.sink} > "
                         f"{MAX_SINK}")
    if dcfg.codes == "nuq" and dcfg.bits not in (2, 3, 4):
        raise ValueError(f"flash_attention kernel: nuq bits {dcfg.bits} "
                         f"not in 2/3/4")
    n_kc = n_kslots = n_vslots = 0
    if dcfg.include_sparse:
        if dcfg.k_outliers == "channels":
            n_kc = dcfg.n_kc
            if n_kc > MAX_KC:
                raise ValueError(f"flash_attention kernel: n_kc {n_kc} > "
                                 f"{MAX_KC}")
        elif dcfg.cap_per_side > 0:
            n_kslots = dcfg.slots_per_kind
        if dcfg.cap_per_side > 0:
            n_vslots = J - dcfg.slots_per_kind
            assert dcfg.head_group * D <= 512, \
                "slot words carry a 9-bit (head, dim) index"
    return n_kc, n_kslots, n_vslots


def is_decode(Q: int, Tq: int, dot_bf16: bool = True) -> bool:
    """Whether a call runs a decode body (one step, G rows per kv head, all
    in one block: fd_decode at 1/2/4/8 rows, fd_gqa at GQA_ROWS with bf16
    dots) rather than a multi-row body."""
    return Tq == 1 and (Q in (1, 2, 4, 8) or (dot_bf16 and Q in GQA_ROWS))


def run_kernel(entry, q_rot, arrays, pos, k_chan_l, dcfg, mcfg, *, L, Tc, J,
               Tq, li, paged=(None, 0, 0, 0), kind=None):
    """Allocate the output and the partials, fill the ``FdArgs`` struct
    (the cached RoPE table under pre-RoPE keys) and launch ``entry``
    (fd_attention or fd_paged_attention) on the current stream, on the
    body ``kind`` (default ``body(dcfg, Q, Tq)``).
    ``arrays``: k_planes, v_planes, kv_out, k_range, k_offset, v_scale,
    v_offset, k_sink, v_sink, k_lut, v_lut, checked by the caller;
    ``paged``: (table, MP, P, NP). Returns the (B, Hkv, Q, D) fp32
    output."""
    B, Hkv, Q, D = q_rot.shape
    dev = q_rot.device
    n_kc, n_kslots, n_vslots = kernel_limits(dcfg, D, J)
    kind = kind or body(dcfg, Q, Tq)
    rows_blk = n_buf = 0
    if kind == "decode":
        n_rt = 1
        rows = bool(n_kc or n_kslots or n_vslots)
        hb, n_stage, _ = decode_plan(dcfg, D, J, rows)
        ns = decode_splits(dcfg, B, Hkv, Q, D, J, rows, n_kc, Tc,
                           sm_count(dev))
    elif kind == "gqa":
        n_rt = 1
        plan = gqa_plan(dcfg, D, J, Q)
        hb, n_stage = plan.hb, plan.stages
        ns = gqa_splits(plan, B, Hkv, Tc, sm_count(dev))
    else:
        plan = chunk_plan(dcfg, D, J, Q, Tq, force=kind)
        n_rt, hb, n_stage = plan.n_rt, 0, plan.stages
        rows_blk, n_buf = plan.rows, plan.n_buf
        ns = chunk_splits(plan, B, Hkv, Tc, sm_count(dev))
    if kind != "simt":
        # the ring's bulk copies need 16-byte aligned sources
        for name, i in (("k_planes", 0), ("v_planes", 1), ("kv_out", 2),
                        ("v_scale", 5), ("v_offset", 6)):
            if arrays[i].data_ptr() % 16:
                raise ValueError(f"flash_attention kernel: {name} is not "
                                 f"16-byte aligned")
    rope = None if dcfg.post_rope_k else rope_table(mcfg, dcfg.sink, Tc, dev)
    out = torch.empty((B, Hkv, Q, D), dtype=torch.float32, device=dev)
    part_m = torch.empty((B, Hkv, ns, Q), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, Hkv, ns, Q, D), dtype=torch.float32,
                           device=dev)
    table, MP, P, NP = paged
    args = _FdArgs(
        q_rot.data_ptr(), *(t.data_ptr() for t in arrays),
        None if rope is None else rope.data_ptr(), pos.data_ptr(),
        k_chan_l.data_ptr() if n_kc else None,
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(),
        L, B, Hkv, Q, Tq, D, Tc, dcfg.sink, J, dcfg.slots_per_kind, n_kc,
        n_kslots, n_vslots, dcfg.head_group, MODES[dcfg.codes], dcfg.bits,
        mcfg.sliding_window or 0, int(dcfg.post_rope_k), int(dcfg.dot_bf16),
        int(li), ns, n_rt, 1.0 / (D ** 0.5),
        None if table is None else table.data_ptr(), MP, P, NP, hb, n_stage,
        rows_blk, n_buf, BODIES[kind],
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    return out


def _launch(q_rot, k_planes, v_planes, kv_out, k_range, k_offset, v_scale,
            v_offset, k_sink, v_sink, k_lut, v_lut, li, pos, dcfg, mcfg, Tq,
            k_chan_l, force=None):
    B, Hkv, Q, D = q_rot.shape
    L = k_planes.shape[0]
    S, hg = dcfg.sink, dcfg.head_group
    NG = Hkv // hg
    J, Tc = kv_out.shape[-2:]

    if Tc % TILE_TOKENS:
        raise ValueError(f"flash_attention kernel: cache capacity {Tc} is "
                         f"not a multiple of {TILE_TOKENS} tokens")
    if Q % Tq:
        raise ValueError(f"flash_attention kernel: {Q} rows are not a "
                         f"multiple of Tq={Tq}")
    n_kc = kernel_limits(dcfg, D, J)[0]
    if dcfg.codes == "nuq":
        code = ((L, B, Hkv, dcfg.bits, Tc // 32, D), torch.int32)
    else:
        code = ((L, B, dcfg.code_heads, Tc, dcfg.code_cols),
                dcfg.code_dtype)
    expect = {
        "q_rot": (q_rot, (B, Hkv, Q, D), torch.float32),
        "k_planes": (k_planes, *code),
        "v_planes": (v_planes, *code),
        "kv_out": (kv_out, (L, B, NG, J, Tc), torch.float32),
        "k_range": (k_range, (L, Hkv, D), torch.float32),
        "k_offset": (k_offset, (L, Hkv, D), torch.float32),
        "v_scale": (v_scale, (L, B, Tc), torch.float32),
        "v_offset": (v_offset, (L, B, Tc), torch.float32),
        "k_sink": (k_sink, (L, B, Hkv, S, D), torch.float32),
        "v_sink": (v_sink, (L, B, Hkv, S, D), torch.float32),
        "k_lut": (k_lut, (L, 2 ** dcfg.bits), torch.float32),
        "v_lut": (v_lut, (L, 2 ** dcfg.bits), torch.float32),
        "pos": (pos, (B,), torch.int32),
    }
    if n_kc:
        expect["k_chan"] = (k_chan_l, (NG, n_kc), torch.int32)
    check_operands("flash_attention kernel", expect, q_rot.device)

    kind = body(dcfg, q_rot.shape[2], Tq, force)
    out = run_kernel(
        _lib().fd_attention, q_rot,
        (k_planes, v_planes, kv_out, k_range, k_offset, v_scale, v_offset,
         k_sink, v_sink, k_lut, v_lut), pos, k_chan_l, dcfg, mcfg, L=L,
        Tc=Tc, J=J, Tq=Tq, li=li, kind=kind)
    flash_attention.launches += 1
    if kind in ("mma", "simt"):
        flash_attention.chunk_launches += 1
    elif kind == "gqa":
        flash_attention.gqa_launches += 1
    return out


def flash_attention(
    q_rot, k_planes, v_planes, kv_out, k_range, k_offset, v_scale, v_offset,
    k_sink, v_sink, k_lut, v_lut, li, pos, dcfg: DeployConfig, mcfg,
    Tq: int = 1, block_tokens: int = 1024, k_ressc=None, k_chan=None,
    body: str = None,
):
    """Attention of Q = G*Tq query rows per kv head over sink + packed cache
    for layer ``li`` of the stacked arrays. ``pos`` (B,) int (or an int) is
    row 0's position. ``k_chan`` (L, n_groups, n_kc) may carry the static K
    channels precomputed from ``k_ressc`` ("channels" mode). The kernels'
    key tiles are fixed (64 or 128 tokens); ``block_tokens`` is accepted
    for signature parity. ``body`` forces a kernel body on the card
    (timing only, see ``body()``); the CPU runs the plain version."""
    _check_config(dcfg)
    if q_rot.device.type == "cpu":
        return flash_attention_ref(
            q_rot, k_planes, v_planes, kv_out, k_range, k_offset, v_scale,
            v_offset, k_sink, v_sink, k_lut, v_lut, li, pos, dcfg, mcfg,
            Tq=Tq, block_tokens=block_tokens, k_ressc=k_ressc, k_chan=k_chan)
    if q_rot.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device "
                         f"{q_rot.device}")
    li = int(li)
    B = q_rot.shape[0]
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(pos, dtype=torch.int32).reshape(-1)
    pos = pos.to(device=q_rot.device, dtype=torch.int32).expand(B).contiguous()
    k_chan_l = None
    if dcfg.include_sparse and dcfg.k_outliers == "channels":
        k_chan_l = (k_chan[li] if k_chan is not None
                    else k_channel_index(k_ressc[li], dcfg))
        k_chan_l = k_chan_l.to(torch.int32).contiguous()
    return _launch(q_rot.contiguous(), k_planes, v_planes, kv_out, k_range,
                   k_offset, v_scale, v_offset, k_sink, v_sink, k_lut, v_lut,
                   li, pos, dcfg, mcfg, Tq, k_chan_l, force=body)


flash_attention.launches = 0
flash_attention.chunk_launches = 0  # of them, calls on a chunk body
flash_attention.gqa_launches = 0  # of them, steps on fd_gqa


def flash_decode(q_rot, k_planes, v_planes, kv_out, k_range, k_offset,
                 v_scale, v_offset, k_sink, v_sink, k_lut, v_lut, li, pos,
                 dcfg: DeployConfig, mcfg, block_tokens: int = 1024,
                 k_ressc=None, k_chan=None):
    """Decode-step alias: one token per sequence (Tq=1, Q=G rows)."""
    return flash_attention(
        q_rot, k_planes, v_planes, kv_out, k_range, k_offset, v_scale,
        v_offset, k_sink, v_sink, k_lut, v_lut, li, pos, dcfg, mcfg,
        Tq=1, block_tokens=block_tokens, k_ressc=k_ressc, k_chan=k_chan)
