"""Decode-step attention over the quantized cache (port of
kvquant_tpu/ops/pallas/flash_serial.py:flash_serial_decode).

``flash_serial_decode`` keeps the JAX signature and layouts: queries
(B, Hkv, G, D), the full stacked (L, ...) cache arrays, layer index ``li``,
per-row positions ``pos`` (B,). It attends, for every batch row at its own
position, over the exact sink prefix and the packed tokens [0, pos - S]
(optionally a sliding window), and returns (B, Hkv, G, D) fp32.

  - CPU tensors: the plain PyTorch version ``flash_serial_decode_ref``.
  - CUDA tensors: the hand-written kernel ``csrc/flash_serial.cu``, or an
    exception when it cannot be built or launched; there is no fallback.
    The host plan ``fs_plan`` names the body a call runs: ``fs_mma``
    (tensor cores, one wave of blocks) for bf16 dots on int4 / int4x2
    containers, ``fs_partial`` (SIMT) for fp32 dots and int8 containers.

fs_mma runs G = 1 on an instance of its own and G = 2-8 query rows per
kv head as they are (DBRX's 6, MISTRAL_7B's 4: the rows are mma's N); its
merge takes one block per query row. fs_partial is instantiated for 1, 2,
4 and 8 rows; other head ratios run the next instance up, their rows
padded with zero queries and the padding's output dropped
(``common.padded_launches``); G > 8 runs launches of 8 rows on either
body. ``body="fs_mma_padded"`` forces the padding of before for timing:
fs_mma with the rows padded with zero queries to 4 or 8, as fs_partial's are
(``GQA_ROWS`` emptied does the same for every call).
``flash_serial_decode.launches`` counts kernel launches (one per call
on the card for G <= 8), ``flash_serial_decode.route_launches`` the same
per body, ``flash_serial_decode.gqa_launches`` those of fs_mma at 3-8 rows
unpadded. The
TPU kernel's constant-band packing (``prep_constants``) works around a
Mosaic operand limit and is not ported: the CUDA kernel takes its
operands plainly, folds the affine codebook itself and reads the static K
channels as int32 indices. The codebook fold and the plain version's codes
and addends are shared with K1 (``common.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...cache import DeployConfig, k_channel_index
from ..deployed import _outlier_addend
from .common import (MAX_KC, MAX_SINK, TILE_TOKENS, fold_affine,
                     signed_codes, channel_addend, check_operands,
                     decode_rows, padded_launches, sm_count)

CODES = {"int4": 0, "int8": 1, "int4x2": 2}


def _check_config(dcfg: DeployConfig):
    assert dcfg.codes in CODES, (
        "flash_serial supports hardware intN containers only")
    assert dcfg.post_rope_k, "flash_serial requires post-RoPE K storage"
    if dcfg.codes == "int4x2":
        assert dcfg.head_group % 2 == 0


def flash_serial_decode_ref(
    q_rot, k_planes, v_planes, kv_out, k_range, k_offset, v_scale, v_offset,
    k_sink, v_sink, k_lut, v_lut, li, pos, dcfg: DeployConfig, mcfg,
    block_tokens: int = 2048, k_ressc=None, k_chan=None,
):
    """Plain PyTorch version of the kernel: dequantize layer ``li`` in full,
    score against the sinks and the packed tokens, masked softmax, P.V.
    ``dot_bf16`` rounds every dot operand to bf16 (fp32 accumulation) where
    the kernel does. ``block_tokens`` is accepted for signature parity."""
    _check_config(dcfg)
    li = int(li)
    B, Hkv, G, D = q_rot.shape
    S, Tc = dcfg.sink, k_planes.shape[-2]
    dev = q_rot.device
    rnd = (lambda x: x.to(torch.bfloat16).to(torch.float32)) \
        if dcfg.dot_bf16 else (lambda x: x)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev).reshape(B)
    inv = 1.0 / (D ** 0.5)

    k_step, k_zero, va, vb = fold_affine(dcfg, k_lut, v_lut, k_range,
                                         k_offset, li)
    q = q_rot.to(torch.float32)
    ck = signed_codes(k_planes[li], dcfg)
    cv = signed_codes(v_planes[li], dcfg)
    rows = kv_out[li]  # (B, NG, J, Tc)

    # ---- scores over the packed tokens ----
    sc = torch.einsum("bhgd,bhtd->bhgt", rnd(q * k_step[None, :, None]), ck)
    sc = sc + (q * k_zero[None, :, None]).sum(-1, keepdim=True)
    if dcfg.include_sparse:
        spk = dcfg.slots_per_kind
        if dcfg.k_outliers == "channels":
            chan = k_chan[li] if k_chan is not None \
                else k_channel_index(k_ressc[li], dcfg)
            add = channel_addend(rows[:, :, :spk], chan, dcfg)
            sc = sc + torch.einsum("bhgd,bhtd->bhgt", rnd(q), rnd(add))
        elif dcfg.cap_per_side > 0:
            add = _outlier_addend(rows[:, :, :spk], dcfg)
            sc = sc + torch.einsum("bhgd,bhtd->bhgt", rnd(q), rnd(add))
    sc = sc * inv
    t = torch.arange(Tc, device=dev)
    valid = t[None, :] <= (pos - S)[:, None]
    if mcfg.sliding_window is not None:
        valid &= (t[None, :] + S) > (pos - mcfg.sliding_window)[:, None]
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))

    # ---- sink prefix ----
    if S > 0:
        ks, vs = k_sink[li], v_sink[li]  # (B, Hkv, S, D)
        ss = torch.einsum("bhgd,bhsd->bhgs", rnd(q), rnd(ks)) * inv
        si = torch.arange(S, device=dev)
        svalid = si[None, :] <= pos[:, None]
        if mcfg.sliding_window is not None:
            svalid &= si[None, :] > (pos - mcfg.sliding_window)[:, None]
        ss = ss.masked_fill(~svalid[:, None, None, :], float("-inf"))
        sc = torch.cat([ss, sc], dim=-1)
    probs = torch.softmax(sc, dim=-1)
    p_pk = probs[..., S:]

    # ---- P.V ----
    vsc = v_scale[li] * vb  # (B, Tc)
    voff = v_scale[li] * va + v_offset[li]
    out = torch.einsum("bhgt,bhtd->bhgd",
                       rnd(p_pk * vsc[:, None, None, :]), cv)
    out = out + (p_pk * torch.where(valid, voff, torch.zeros_like(voff))
                 [:, None, None, :]).sum(-1, keepdim=True)
    if dcfg.include_sparse and dcfg.cap_per_side > 0:
        vadd = _outlier_addend(rows[:, :, dcfg.slots_per_kind:], dcfg)
        out = out + torch.einsum("bhgt,bhtd->bhgd", rnd(p_pk), rnd(vadd))
    if S > 0:
        out = out + torch.einsum("bhgs,bhsd->bhgd", rnd(probs[..., :S]),
                                 rnd(vs))
    return out


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


class _FsArgs(ctypes.Structure):
    """Mirror of ``FsArgs`` in csrc/flash_serial.cu (same field order)."""
    _fields_ = [
        ("q", _P), ("kp", _P), ("vp", _P), ("kv_out", _P),
        ("k_range", _P), ("k_offset", _P), ("v_scale", _P), ("v_offset", _P),
        ("k_sink", _P), ("v_sink", _P), ("k_lut", _P), ("v_lut", _P),
        ("pos", _P), ("k_chan", _P),
        ("part_m", _P), ("part_l", _P), ("part_acc", _P), ("out", _P),
        ("L", _I), ("B", _I), ("Hkv", _I), ("G", _I), ("D", _I), ("Tc", _I),
        ("S", _I), ("J", _I), ("spk", _I), ("n_kc", _I),
        ("n_kslots", _I), ("n_vslots", _I),
        ("hg", _I), ("codes", _I), ("bits", _I), ("window", _I),
        ("dot_bf16", _I), ("li", _I), ("n_split", _I),
        ("body", _I), ("smem", _I),
        ("inv", ctypes.c_float),
    ]


@functools.lru_cache(maxsize=None)
def _lib():
    from .build import load

    lib = load("flash_serial")
    lib.fs_decode.argtypes = [ctypes.POINTER(_FsArgs), ctypes.c_void_p]
    lib.fs_decode.restype = ctypes.c_int
    return lib


def load_library():
    """Build (on first use) and load the kernel library."""
    return _lib()


# fs_mma's block (csrc/flash_serial.cu MT, MSTAGES, MW, ...)
MMA_TILE = 32  # tokens per tile, one warp step
MMA_STAGES = 2  # ring stages per warp
MMA_WARPS = 4  # warps per block, each streaming every 4th tile of the run
MMA_MIN_BLOCKS = 4  # __launch_bounds__ minimum: registers allow 4 blocks/SM
KC_STAGED = 4  # static K channel rows a tile stages (the rest read in place)
WARP_TILES = 8  # fs_mma: tiles a warp should have before splits exceed half a wave
P_STRIDE = MMA_TILE + 8  # bf16 stride of a row of a warp's P tile
SMEM_MAX = 227 * 1024  # H100: dynamic shared memory one block may use
SMEM_PER_SM = 228 * 1024  # H100: shared memory of an SM, 1 KB kept per block
PARTIAL_THREADS = 128  # fs_partial's block (csrc NT)
BODIES = {"fs_partial": 0, "fs_mma": 1}  # csrc BODY_*
PADDED = "fs_mma_padded"  # fs_mma behind the rows' padding, timing only
ROUTES = (*BODIES, PADDED)  # what ``body=`` may name
GQA_ROWS = (3, 4, 5, 6, 7, 8)  # rows fs_mma runs unpadded above 2 (gqa)


class FsPlan(NamedTuple):
    """The body a K2 call runs on the card and its grid. ``body``:
    "fs_mma" (bf16 dots on int4 / int4x2, tensor cores) or "fs_partial"
    (fp32 dots or int8 containers, SIMT). ``n_split`` token splits per
    (b, kv head); ``smem`` dynamic shared bytes per block (passed to the
    kernel, which refuses a call whose count differs from its body's
    layout); ``per_sm`` blocks an SM holds at once; ``tile`` tokens per
    tile; ``rows`` query rows per kv head of one launch (the G rows
    themselves on fs_mma up to 8, else the padded instance's). fs_mma's
    grid (n_split x Hkv x B) fits one wave of
    per_sm x SMs blocks whenever B x Hkv does."""
    body: str
    n_split: int
    smem: int
    per_sm: int
    tile: int
    rows: int


def _round16(x: int) -> int:
    return (x + 15) & ~15


def _slot_rows(dcfg: DeployConfig, J: int) -> tuple:
    """(static K channels, K slot rows, V slot rows) the kernel applies."""
    n_kc = n_ks = n_vs = 0
    if dcfg.include_sparse:
        if dcfg.k_outliers == "channels":
            n_kc = dcfg.n_kc
        elif dcfg.cap_per_side > 0:
            n_ks = dcfg.slots_per_kind
        if dcfg.cap_per_side > 0:
            n_vs = J - dcfg.slots_per_kind
    return n_kc, n_ks, n_vs


def mma_smem_bytes(G: int, D: int, n_kc: int, n_kslots: int,
                   n_vslots: int) -> int:
    """csrc mma_smem_bytes: per warp a ring of MMA_STAGES tiles (K and V
    codes, V scale and offset, the staged outlier rows; large enough for
    the warp's partial at the end), a bf16 P tile of 8 rows, the stages'
    mbarriers, the V slot sums and the head's channel list."""
    k_rows = min(n_kc, KC_STAGED) if n_kc else n_kslots
    stage = MMA_TILE * D + 8 * MMA_TILE + 4 * MMA_TILE * (k_rows + n_vslots)
    ring = _round16(max(MMA_STAGES * stage, 4 * (G * D + 3 * G)))
    warp = (ring + _round16(8 * P_STRIDE * 2) + 32
            + (4 * G * D if n_vslots else 0)
            + _round16(4 * n_kc * (2 + G)))
    return MMA_WARPS * warp


def partial_smem_bytes(codes: str, G: int, D: int) -> int:
    """csrc partial_smem_bytes: two stages of padded 128-token K and V
    tiles, the query rows, probabilities and reduction scratch."""
    rb = D if codes == "int8" else D // 2
    stride = rb + 16 if (rb // 16) % 2 == 0 else rb
    nw = PARTIAL_THREADS // 32
    return (4 * TILE_TOKENS * stride
            + 4 * (3 * G * D + G * TILE_TOKENS + G * nw + G) + 4 * 2 * MAX_KC)


def fs_body(dcfg: DeployConfig) -> str:
    """The body a call of this configuration runs: the tensor-core body
    for bf16 dots on nibble containers; fp32 dots, and int8 codes (a byte
    does not fit bf16's 7-bit mantissa), on the SIMT body."""
    if dcfg.dot_bf16 and dcfg.codes in ("int4", "int4x2"):
        return "fs_mma"
    return "fs_partial"


def mma_split(n_tiles: int, n_split: int, s: int) -> tuple:
    """fs_mma's tiles [begin, end) of split s among ``n_tiles`` live tiles
    (the kernel's formula): an even share, so every split holds a tile
    whenever n_tiles >= n_split."""
    return s * n_tiles // n_split, (s + 1) * n_tiles // n_split


def fs_plan(dcfg: DeployConfig, B: int, Hkv: int, G: int, D: int, Tc: int,
            device=None, sms: int = None, body: str = None,
            J: int = None) -> FsPlan:
    """The plan of a K2 call of G query rows per kv head: its body
    (``fs_body``, or ``body`` when a caller forces one for timing: any of
    ``ROUTES``) and grid, for the rows one launch takes: G itself on
    fs_mma (8 above), ``decode_rows(G)`` on fs_partial and on the forced
    padded route. fs_mma:
    the resident blocks an SM holds (from the body's shared memory and its
    register bound), and as many token splits as fill them once, at most
    one per 128 tokens of the capacity so that each of a block's warps has
    a tile, and at 2-8 rows no more than give each warp WARP_TILES tiles
    unless that leaves under half a wave (few kv heads at a long capacity:
    DBRX's 8 at 32K take 34, where a wave is 66); fs_partial: about eight blocks an
    SM, at most one split per 128-token tile. ``sms`` defaults to the SM
    count of ``device``; ``J`` (kv_out rows) to the configuration's."""
    rows = decode_rows(G)  # raises for G < 1
    if D not in (32, 64, 128):
        raise ValueError(f"flash_serial kernel: d_head {D} not in 32/64/128")
    kind = body or fs_body(dcfg)
    if kind == PADDED:
        kind = "fs_mma"
    elif kind == "fs_mma":
        rows = min(G, 8)
    if kind == "fs_mma" and fs_body(dcfg) != "fs_mma":
        raise ValueError(f"flash_serial kernel: fs_mma takes bf16 dots on "
                         f"int4 / int4x2, not dot_bf16={dcfg.dot_bf16} "
                         f"{dcfg.codes}")
    if kind not in BODIES:
        raise ValueError(f"flash_serial kernel: unknown body {kind!r}")
    if sms is None:
        sms = sm_count(torch.device(device))
    n_kc, n_ks, n_vs = _slot_rows(dcfg, dcfg.n_slots if J is None else J)
    if kind == "fs_partial":
        smem = partial_smem_bytes(dcfg.codes, rows, D)
        per_sm = max(1, SMEM_PER_SM // (smem + 1024))
        target = 8 * sms
        n_split = max(1, min(-(-target // (B * Hkv)), -(-Tc // TILE_TOKENS)))
        return FsPlan(kind, n_split, smem, per_sm, TILE_TOKENS, rows)
    smem = mma_smem_bytes(rows, D, n_kc, n_ks, n_vs)
    if smem > SMEM_MAX:
        raise ValueError(f"flash_serial kernel: fs_mma needs {smem} B of "
                         f"shared memory > {SMEM_MAX}")
    per_sm = max(1, min(MMA_MIN_BLOCKS, SMEM_PER_SM // (smem + 1024)))
    most = Tc // (MMA_TILE * MMA_WARPS)
    wave = per_sm * sms // (B * Hkv)
    n_split = max(1, min(wave, most))
    if rows > 1:
        # few kv heads at a long capacity: a wave's splits would leave each
        # warp a handful of tiles behind its setup and the merge's loads of
        # every row; take fewer (WARP_TILES a warp), never under half a wave
        n_split = max(1, min(n_split, max(wave // 2, most // WARP_TILES)))
    return FsPlan(kind, n_split, smem, per_sm, MMA_TILE, rows)


def _launch(q_rot, k_planes, v_planes, kv_out, k_range, k_offset, v_scale,
            v_offset, k_sink, v_sink, k_lut, v_lut, li, pos, dcfg, mcfg,
            k_chan_l, body=None):
    B, Hkv, G, D = q_rot.shape
    L, Tc = k_planes.shape[0], k_planes.shape[-2]
    S, hg = dcfg.sink, dcfg.head_group
    dev = q_rot.device
    Hc = dcfg.code_heads
    NG = Hkv // hg
    J = kv_out.shape[-2]

    if Tc % TILE_TOKENS:
        # the kernel copies whole tiles; a partial last tile would read
        # past the end of the last (layer, batch, head) slab
        raise ValueError(f"flash_serial kernel: cache capacity {Tc} is not "
                         f"a multiple of {TILE_TOKENS} tokens")
    # the body and its grid; raises for G or d_head outside the instances
    plan = fs_plan(dcfg, B, Hkv, G, D, Tc, dev, body=body, J=J)
    assert plan.rows == G, (plan, G)  # the caller padded to the instance
    if S > MAX_SINK:
        raise ValueError(f"flash_serial kernel: sink {S} > {MAX_SINK}")
    n_kc, n_kslots, n_vslots = _slot_rows(dcfg, J)
    if n_kc > MAX_KC:
        raise ValueError(f"flash_serial kernel: n_kc {n_kc} > {MAX_KC}")
    if n_vslots:
        assert hg * D <= 512, "slot words carry a 9-bit (head, dim) index"

    expect = {
        "q_rot": (q_rot, (B, Hkv, G, D), torch.float32),
        "k_planes": (k_planes, (L, B, Hc, Tc, dcfg.code_cols), dcfg.code_dtype),
        "v_planes": (v_planes, (L, B, Hc, Tc, dcfg.code_cols), dcfg.code_dtype),
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
    check_operands("flash_serial kernel", expect, dev)

    if plan.body == "fs_mma":
        # a tile arrives by TMA bulk copies from 16-byte aligned sources
        for name, t in (("k_planes", k_planes), ("v_planes", v_planes),
                        ("kv_out", kv_out), ("v_scale", v_scale),
                        ("v_offset", v_offset)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_serial kernel: {name} is not "
                                 f"16-byte aligned")
    ns = plan.n_split
    out = torch.empty((B, Hkv, G, D), dtype=torch.float32, device=dev)
    part_m = torch.empty((B, Hkv, ns, G), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, Hkv, ns, G, D), dtype=torch.float32,
                           device=dev)
    win = mcfg.sliding_window or 0
    args = _FsArgs(
        q_rot.data_ptr(), k_planes.data_ptr(), v_planes.data_ptr(),
        kv_out.data_ptr(), k_range.data_ptr(), k_offset.data_ptr(),
        v_scale.data_ptr(), v_offset.data_ptr(), k_sink.data_ptr(),
        v_sink.data_ptr(), k_lut.data_ptr(), v_lut.data_ptr(),
        pos.data_ptr(), k_chan_l.data_ptr() if n_kc else None,
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(),
        L, B, Hkv, G, D, Tc, S, J, dcfg.slots_per_kind, n_kc,
        n_kslots, n_vslots, hg, CODES[dcfg.codes], dcfg.bits, win,
        int(dcfg.dot_bf16), int(li), ns,
        BODIES[plan.body], plan.smem,
        1.0 / (D ** 0.5),
    )
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fs_decode(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flash_serial kernel ({plan.body}) launch "
                           f"failed: cudaError {err}")
    flash_serial_decode.launches += 1
    flash_serial_decode.route_launches[plan.body] += 1
    if plan.body == "fs_mma" and G in GQA_ROWS and body != PADDED:
        flash_serial_decode.gqa_launches += 1
    return out


def flash_serial_decode(
    q_rot, k_planes, v_planes, kv_out, k_range, k_offset, v_scale, v_offset,
    k_sink, v_sink, k_lut, v_lut, li, pos, dcfg: DeployConfig, mcfg,
    block_tokens: int = 2048, k_ressc=None, k_chan=None, body=None,
):
    """Decode-step attention (Tq = 1) for layer ``li`` of the stacked cache.
    Post-RoPE intN storage only. ``k_chan`` (L, n_groups, n_kc) int32 may
    carry the static K channels precomputed from ``k_ressc`` (the engine
    does this once per step); otherwise they are derived from ``k_ressc``.
    ``block_tokens`` is accepted for signature parity; the kernel's tiles
    are fixed (``fs_plan``). ``body`` forces a route on the card (timing
    only: "fs_partial" for bf16 dots, or "fs_mma_padded", fs_mma behind
    the rows' padding to 4 or 8); by
    default ``fs_body`` picks it."""
    _check_config(dcfg)
    if q_rot.device.type == "cpu":
        return flash_serial_decode_ref(
            q_rot, k_planes, v_planes, kv_out, k_range, k_offset, v_scale,
            v_offset, k_sink, v_sink, k_lut, v_lut, li, pos, dcfg, mcfg,
            block_tokens=block_tokens, k_ressc=k_ressc, k_chan=k_chan)
    if q_rot.device.type != "cuda":
        raise ValueError(f"flash_serial_decode: unsupported device "
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
    if body is not None and body not in ROUTES:
        raise ValueError(f"flash_serial kernel: unknown body {body!r}")

    def launch(q, route):
        return _launch(q, k_planes, v_planes, kv_out, k_range, k_offset,
                       v_scale, v_offset, k_sink, v_sink, k_lut, v_lut, li,
                       pos, dcfg, mcfg, k_chan_l, body=route)

    q = q_rot.contiguous()
    G = q.shape[2]
    route = body or fs_body(dcfg)
    if route == "fs_mma" and 2 < G <= 8 and G not in GQA_ROWS:
        route = PADDED  # the padded route (GQA_ROWS emptied for timing)
    if route == "fs_mma" and G <= 8:
        return launch(q, route)  # the rows as they are, one launch
    return padded_launches(q, lambda x: launch(x, route))


flash_serial_decode.launches = 0
flash_serial_decode.route_launches = {b: 0 for b in BODIES}
flash_serial_decode.gqa_launches = 0  # of them, fs_mma at 3-8 rows unpadded
