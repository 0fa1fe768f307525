"""The two-pass attention kernels of ``kernel="pallas"`` (port of
kvquant_tpu/ops/pallas/attention.py: qk_fused, K3, and pv_fused, K4).

Both take the JAX functions' arguments and layouts with a leading batch
axis B (the JAX callers vmap over B; here one call is one launch):

  - ``qk_fused``: unscaled scores (B, Hkv, R, Tc) = q_rot (B, Hkv, R, D)
    . [RoPE(lut[code]*k_range + k_offset) + RoPE(K slot addend)] over EVERY
    packed token t of the capacity, rotated at position sink + t;
  - ``pv_fused``: out (B, Hkv, R, D) = sum_t (p*v_scale[t])*lut[code]
    + sum_t p*v_offset[t] + p*(V slot addend), over every t as well.

R is G at a decode step and G*Tq_all for a prefill block. The caller scales,
masks dead positions (probs must be zero there), runs the softmax and adds
the sink tokens. Storage: nuq bit planes (bits 2-4), pre-RoPE keys, slot
outliers (kv_out rows [0, slots_per_kind) for K, the rest for V), as the
TPU kernels take.

The slot word's head-in-group field is 2 bits wide (``(u >> 7) & 3``), so
slots decode only for head_group <= 4; with slots and a larger head group
both wrappers raise ValueError (the TPU kernels would decode them wrongly).

Numerics follow the TPU kernels' rounding points under ``dot_bf16``: K3
adds the rotated slot addend to the rotated keys in fp32 and rounds the sum
(and the queries) to bf16; K4 folds v_scale into p and rounds p*scale and
lut[code] to bf16, adds sum_t p*offset in fp32, and contracts the slot
term separately as bf16(p) . bf16(M).

  - CPU tensors: the plain PyTorch versions ``qk_fused_ref`` /
    ``pv_fused_ref``.
  - CUDA tensors: the hand-written kernels ``csrc/attention.cu``, or an
    exception when they cannot be built or launched; there is no fallback.

On the card ``qk_plan`` / ``pv_plan`` pick the body: a decode step of R
in ``QK_GQA_ROWS`` (3-8) rows with bf16 dots runs K3's tensor-core decode
body ``qk_gqa``; other steps of R <= 8 rows the decode bodies ``qk_decode``
/ ``pv_decode``; more rows the tensor-core bodies (bf16 dots) or the SIMT
bodies (fp32 dots).

``qk_fused.launches`` / ``pv_fused.launches`` count kernel launches (one
per call on the card), ``qk_fused.gqa_launches`` those on qk_gqa.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...cache import DeployConfig
from ...models.llama import rope_cos_sin, rotate_half
from ...quant.nuq import lut_lookup
from ..packing import decode_outlier_words, unpack_codes
from .common import TILE_TOKENS, check_operands, decode_rows, sm_count
from .flash_decode import rope_table

TILE = 64  # tokens per tile of the simt bodies and of K4's mma body
ROWS = 64  # query rows per pass of the simt bodies
MAX_SLOTS = 8  # slot rows of one kind per head group the kernels take


def _slot_rows(dcfg: DeployConfig, kv_out, kind: str):
    """The slot rows of one kind (B, NG, n, Tc) the TPU kernel applies, or
    None: ``kind`` "k" rows [0, slots_per_kind), "v" the rest."""
    J = kv_out.shape[-2] if kv_out is not None else 0
    if not (dcfg.include_sparse and J > 0 and dcfg.cap_per_side > 0):
        return None
    spk = dcfg.slots_per_kind
    return kv_out[:, :, :spk] if kind == "k" else kv_out[:, :, spk:]


def _check_config(dcfg: DeployConfig, name: str):
    if dcfg.codes != "nuq":
        raise ValueError(f"{name}: reads nuq bit planes only, not "
                         f"codes={dcfg.codes!r}")
    if dcfg.post_rope_k:
        raise ValueError(f"{name}: the two-pass kernels rotate pre-RoPE "
                         f"keys; post_rope_k storage runs kernel='flash'")
    if dcfg.include_sparse and dcfg.cap_per_side > 0:
        if dcfg.k_outliers != "slots":
            raise ValueError(f"{name}: decodes slot words only, not "
                             f"k_outliers={dcfg.k_outliers!r}")
        if dcfg.head_group > 4:
            raise ValueError(
                f"{name}: the slot word's 2-bit head field decodes "
                f"head_group <= 4, not {dcfg.head_group}")


def slot_addend(rows, n_heads: int, D: int, hg: int, width: int = None):
    """Encoded slot rows (B, NG, n, Tc) -> dense (B, Hkv, Tc, width) fp32
    of the slots each head owns, as the TPU kernels decode a word u: value
    ``u & 0xFFFFFE00``, dim ``u & 0x7F``, head-in-group ``(u >> 7) & 3``
    (ignored at head_group 1). ``width`` (default D) columns of the 128 a
    dim can name: the head's own are the first D."""
    B, NG, n, Tc = rows.shape
    vals, idx = decode_outlier_words(rows)
    dim = (idx & 0x7F).long().transpose(-1, -2)  # (B, NG, Tc, n)
    head = ((idx >> 7) & 3).transpose(-1, -2)
    vals = vals.transpose(-1, -2)
    dense = torch.zeros((B, NG, hg, Tc, 128), dtype=torch.float32,
                        device=rows.device)
    for j in range(hg):
        v = vals if hg == 1 else torch.where(head == j, vals,
                                             torch.zeros_like(vals))
        dense[:, :, j].scatter_add_(-1, dim, v)
    assert NG * hg == n_heads, (NG, hg, n_heads)
    width = D if width is None else width
    return dense[..., :width].reshape(B, n_heads, Tc, width)


def _rounder(dcfg: DeployConfig):
    if dcfg.dot_bf16:
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    return lambda x: x


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def qk_fused_ref(q_rot, k_planes, kv_out, k_range, k_offset, lut,
                 dcfg: DeployConfig, mcfg, block_tokens: int = 1024):
    """Plain PyTorch version of K3: dequantize every packed key, rotate it
    and the K slot addend at position sink + t, add them in fp32, round the
    sum and the queries where ``dot_bf16`` asks, contract in fp32.
    ``block_tokens`` is accepted for signature parity.

    A slot dim d >= D adds nothing at d; the TPU kernel still adds its
    rotate-half term, -v * sin, at d - D/2 when that lies inside the head
    (D <= d < 3D/2), and so does this version."""
    _check_config(dcfg, "qk_fused")
    B, Hkv, R, D = q_rot.shape
    rnd = _rounder(dcfg)
    k = lut_lookup(lut, unpack_codes(k_planes, dcfg.bits)) \
        * k_range[:, None, :] + k_offset[:, None, :]  # (B, Hkv, Tc, D)
    Tc = k.shape[-2]
    ck, sk = rope_cos_sin(dcfg.sink + torch.arange(
        Tc, dtype=torch.int32, device=k.device), mcfg)

    def rope(x):
        return x * ck + rotate_half(x) * sk

    kx = rope(k)
    rows = _slot_rows(dcfg, kv_out, "k")
    if rows is not None:
        half = D // 2
        dense = slot_addend(rows, Hkv, D, dcfg.head_group,
                            min(128, D + half))
        beyond = dense[..., D:]  # dims D .. 3D/2 - 1: their partner term
        kx = kx + rope(dense[..., :D])
        w = beyond.shape[-1]
        if w:
            kx[..., half:half + w] -= beyond * sk[..., :w]
    return torch.einsum("bhrd,bhtd->bhrt", rnd(q_rot.to(torch.float32)),
                        rnd(kx))


def pv_fused_ref(probs, v_planes, v_scale, v_offset, kv_out, lut,
                 dcfg: DeployConfig, block_tokens: int = 1024):
    """Plain PyTorch version of K4: (p*v_scale) . lut[code] with the
    rounding of ``dot_bf16``, plus sum_t p*v_offset in fp32, plus the V
    slot term bf16(p) . bf16(M). ``block_tokens`` is accepted for signature
    parity."""
    _check_config(dcfg, "pv_fused")
    B, Hkv, R, Tc = probs.shape
    D = v_planes.shape[-1]
    rnd = _rounder(dcfg)
    p = probs.to(torch.float32)
    deq = lut_lookup(lut, unpack_codes(v_planes, dcfg.bits))  # (B,Hkv,Tc,D)
    out = torch.einsum("bhrt,bhtd->bhrd", rnd(p * v_scale[:, None, None, :]),
                       rnd(deq))
    out = out + (p * v_offset[:, None, None, :]).sum(-1, keepdim=True)
    rows = _slot_rows(dcfg, kv_out, "v")
    if rows is not None:
        out = out + torch.einsum(
            "bhrt,bhtd->bhrd", rnd(p),
            rnd(slot_addend(rows, Hkv, D, dcfg.head_group)))
    return out




# ---------------------------------------------------------------------------
# the host plan: which body runs a call, and its block shape
# ---------------------------------------------------------------------------

DECODE_TILE = 128  # tokens per ring stage of the decode bodies and per K3 mma tile
DECODE_WARPS = 8  # consumer warps of a decode block (+ one producer warp)
STAGE_BYTES = 32 * 1024  # largest decode ring stage before heads per block shrink
RING_BYTES = 96 * 1024  # decode ring per block: two blocks share an SM
QK_MMA_ROWS = 272  # most query rows per K3 mma block (17 row tiles of 16)
PV_MMA_ROWS = 144  # most rows per K4 mma block (9 row tiles in a warp's registers)
ROW_STRIDE = (128 + 8) * 2  # bytes of a bf16 K / V / query tile row (csrc QS)
P_STRIDE = (TILE + 8) * 2  # bytes of a bf16 row of K4's probability tiles (PS)
SMEM_MAX = 227 * 1024  # H100: dynamic shared memory one block may use
SMEM_PER_SM = 228 * 1024  # H100: shared memory of an SM, 1 KB kept per block
BODIES = {"decode": 0, "mma": 1, "simt": 2, "gqa": 3}  # csrc BODY_*
QK_GQA_ROWS = (3, 4, 5, 6, 7, 8)  # rows of a bf16-dot K3 call on qk_gqa
GQA_X_BYTES = 8 * 33 * 4  # qk_gqa: a warp's slot-term exchange tile (csrc GXB)


class K34Plan(NamedTuple):
    """Block shape of one K3 or K4 call. ``body``: "decode" (R <= 8, both
    dot modes), "gqa" (K3 at R in QK_GQA_ROWS with bf16 dots: qk_gqa, the
    decode ring on the tensor cores), "mma" (R > 8, bf16 dots, tensor
    cores) or "simt" (R > 8, fp32 dots). ``rows``: the decode instance's
    rows per head (1/2/4/8; R on qk_gqa), or query rows per block;
    ``n_rt`` row blocks; ``hc`` kv heads per block (whole head groups);
    ``stages`` ring stages (decode and gqa); ``n_split`` token
    splits; ``smem`` dynamic shared bytes per block (passed to the kernel,
    which refuses a call whose count differs from its bodies' layout);
    ``per_sm`` blocks an SM holds at once. Sized from the capacity Tc,
    never from a live length."""
    body: str
    rows: int
    n_rt: int
    hc: int
    stages: int
    n_split: int
    smem: int
    per_sm: int


def body(dcfg: DeployConfig, R: int, kernel: str,
         force: str = None) -> str:
    """The kernel body a call of R query rows of ``kernel`` ("qk" K3, "pv"
    K4) runs on the card. ``force`` names another for timing: "decode" at
    R <= 8, "gqa" for K3 at 3-8 rows with bf16 dots; anything else raises
    ValueError."""
    if force is not None:
        ok = {"decode": R <= 8,
              "gqa": kernel == "qk" and 3 <= R <= 8 and dcfg.dot_bf16}
        if not ok.get(force, False):
            raise ValueError(f"{kernel} kernel: body {force!r} does not run "
                             f"R={R}, dot_bf16={dcfg.dot_bf16}")
        return force
    if kernel == "qk" and dcfg.dot_bf16 and R in QK_GQA_ROWS:
        return "gqa"
    if R <= 8:
        return "decode"
    return "mma" if dcfg.dot_bf16 else "simt"


def slot_counts(dcfg: DeployConfig, J: int) -> tuple:
    """(K slot rows, V slot rows) the kernels apply for ``J`` kv_out rows
    (0 where the configuration or the call carries no slots)."""
    if not (dcfg.include_sparse and J > 0 and dcfg.cap_per_side > 0):
        return 0, 0
    return dcfg.slots_per_kind, J - dcfg.slots_per_kind


def _stage_bytes(bits: int, D: int, hc: int, n_rows: int, pv: bool) -> int:
    """csrc dring(...).bytes: hc heads' bit planes (4 word rows each), the
    staged slot rows, and K4's V scale and offset, for one 128-token tile."""
    return hc * bits * 16 * D + (n_rows + (2 if pv else 0)) * DECODE_TILE * 4


def _decode_shape(dcfg: DeployConfig, D: int, Hkv: int, n_slot: int,
                  pv: bool) -> tuple:
    """(kv heads per block, ring stages, stage bytes) of a decode block: the
    most of 8/4/2/1 heads that are whole head groups (when slots are staged)
    and divide Hkv whose stage fits STAGE_BYTES, else the fewest; the ring
    takes RING_BYTES in 2-4 stages."""
    unit = dcfg.head_group if n_slot else 1
    hcs = [h for h in (8, 4, 2, 1) if h % unit == 0 and Hkv % h == 0]
    if not hcs:
        raise ValueError(f"K3/K4 kernel: head_group {dcfg.head_group} with "
                         f"slots does not fit a block of 8 heads")
    for hc in hcs:
        stage = _stage_bytes(dcfg.bits, D, hc,
                             n_slot * (hc // dcfg.head_group) if n_slot else 0,
                             pv)
        if stage <= STAGE_BYTES:
            break
    return hc, max(2, min(4, RING_BYTES // stage)), stage


def _splits(n_tiles: int, most: int) -> int:
    """At most ``most`` token splits over ``n_tiles`` tiles, every split
    holding tiles: the kernels give split s the tiles [s*tps, (s+1)*tps)."""
    tps = -(-n_tiles // max(1, min(most, n_tiles)))
    return -(-n_tiles // tps)


def _per_sm(smem: int, most: int) -> int:
    return max(1, min(most, SMEM_PER_SM // (smem + 1024)))


def _row_blocks(R: int, most: int) -> tuple:
    """(row blocks, rows per block): the fewest blocks of at most ``most``
    rows, their rows spread evenly in tiles of 16."""
    tiles = -(-R // 16)
    n_rt = -(-tiles // (most // 16))
    return n_rt, 16 * -(-tiles // n_rt)


def qk_plan(dcfg: DeployConfig, R: int, D: int, Tc: int, B: int, Hkv: int,
            J: int, sms: int, body_: str = None) -> K34Plan:
    """Block shape of a K3 call (R query rows per kv head, capacity Tc, J
    kv_out rows, ``sms`` SMs on the card; ``body_`` forces a body for
    timing). decode: hc heads per block (the (cos, sin) table is read
    B*Hkv/hc times per call, from L2 after the first), splits filling the
    resident blocks once; gqa: the decode ring and heads, R rows, two
    blocks an SM; mma: all rows of a head in one block up to QK_MMA_ROWS,
    splits over 128-token tiles filling the resident blocks once; simt:
    one block per 64-token tile."""
    kind = body(dcfg, R, "qk", body_)
    nks, _ = slot_counts(dcfg, J)
    if kind == "gqa":
        hc, stages, stage = _decode_shape(dcfg, D, Hkv, nks, False)
        smem = 128 + stages * stage + 4 * hc * (8 + 2) * D \
            + DECODE_WARPS * GQA_X_BYTES
        per_sm = _per_sm(smem + 64, 2)
        n_split = _splits(Tc // DECODE_TILE, per_sm * sms // (B * Hkv // hc))
        return K34Plan(kind, R, 1, hc, stages, n_split, smem, per_sm)
    if kind == "decode":
        G = decode_rows(R)
        hc, stages, stage = _decode_shape(dcfg, D, Hkv, nks, False)
        smem = 128 + stages * stage + 4 * hc * (G + 2) * D
        per_sm = _per_sm(smem + 64, 2 if G <= 2 else 1)
        n_split = _splits(Tc // DECODE_TILE, per_sm * sms // (B * Hkv // hc))
        return K34Plan(kind, G, 1, hc, stages, n_split, smem, per_sm)
    if kind == "mma":
        n_rt, rows = _row_blocks(R, QK_MMA_ROWS)
        smem = (rows + DECODE_TILE) * ROW_STRIDE + 64 * 4 * 4 \
            + MAX_SLOTS * DECODE_TILE * 4 + 64
        per_sm = _per_sm(smem, 2)
        n_split = _splits(Tc // DECODE_TILE, per_sm * sms // (B * Hkv * n_rt))
        return K34Plan(kind, rows, n_rt, 1, 0, n_split, smem, per_sm)
    smem = 4 * (TILE * D + TILE * (D + 1) + ROWS * (D + 1) + 16)
    return K34Plan(kind, ROWS, -(-R // ROWS), 1, 0, Tc // TILE, smem,
                   _per_sm(smem, 4))


def pv_plan(dcfg: DeployConfig, R: int, D: int, Tc: int, B: int, Hkv: int,
            J: int, sms: int) -> K34Plan:
    """Block shape of a K4 call, as ``qk_plan``: decode blocks of hc heads
    whose warps meet in the ring's shared memory at the end; mma blocks of
    at most PV_MMA_ROWS rows (9 row tiles of accumulators a warp) over
    64-token tiles; simt blocks of 64 rows, about four per SM. Every body
    writes split partials that pv_merge adds in split order."""
    kind = body(dcfg, R, "pv")
    _, nvs = slot_counts(dcfg, J)
    if kind == "decode":
        G = decode_rows(R)
        hc, stages, stage = _decode_shape(dcfg, D, Hkv, nvs, True)
        smem = 128 + max(stages * stage, DECODE_WARPS * G * (D + 1) * 4)
        per_sm = _per_sm(smem + 64, 2 if G <= 2 else 1)
        n_split = _splits(Tc // DECODE_TILE, per_sm * sms // (B * Hkv // hc))
        return K34Plan(kind, G, 1, hc, stages, n_split, smem, per_sm)
    if kind == "mma":
        n_rt, rows = _row_blocks(R, PV_MMA_ROWS)
        tiles = 2 if nvs else 1
        smem = tiles * (rows * P_STRIDE + TILE * ROW_STRIDE) + 2 * TILE * 4 \
            + rows * 4 + MAX_SLOTS * TILE * 4 + 32 + 64
        per_sm = _per_sm(smem, 2)
        n_split = _splits(Tc // TILE, per_sm * sms // (B * Hkv * n_rt))
        return K34Plan(kind, rows, n_rt, 1, 0, n_split, smem, per_sm)
    n_rt = -(-R // ROWS)
    smem = 4 * (2 * TILE * D + 2 * ROWS * (TILE + 1) + 2 * TILE + 16)
    n_split = _splits(Tc // TILE, -(-4 * sms // (B * Hkv * n_rt)))
    return K34Plan(kind, ROWS, n_rt, 1, 0, n_split, smem, _per_sm(smem, 4))


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


class _QkArgs(ctypes.Structure):
    """Mirror of ``QkArgs`` in csrc/attention.cu (same field order)."""
    _fields_ = [
        ("q", _P), ("kp", _P), ("kv_out", _P), ("k_range", _P),
        ("k_offset", _P), ("lut", _P), ("rope", _P), ("out", _P),
        ("B", _I), ("Hkv", _I), ("R", _I), ("D", _I), ("Tc", _I), ("J", _I),
        ("n_kslots", _I), ("hg", _I), ("bits", _I), ("dot_bf16", _I),
        ("body", _I), ("hc", _I), ("n_split", _I), ("n_stage", _I),
        ("rows_blk", _I), ("n_rt", _I), ("smem", _I),
    ]


class _PvArgs(ctypes.Structure):
    """Mirror of ``PvArgs`` in csrc/attention.cu (same field order)."""
    _fields_ = [
        ("p", _P), ("vp", _P), ("v_scale", _P), ("v_offset", _P),
        ("kv_out", _P), ("lut", _P), ("part", _P), ("out", _P),
        ("B", _I), ("Hkv", _I), ("R", _I), ("D", _I), ("Tc", _I),
        ("p_ld", _I), ("J", _I), ("spk", _I), ("n_vslots", _I), ("hg", _I),
        ("bits", _I), ("dot_bf16", _I), ("body", _I), ("hc", _I),
        ("n_split", _I), ("n_stage", _I), ("rows_blk", _I), ("n_rt", _I),
        ("smem", _I),
    ]


@functools.lru_cache(maxsize=None)
def _lib():
    from .build import load

    lib = load("attention")
    lib.qk_fused.argtypes = [ctypes.POINTER(_QkArgs), ctypes.c_void_p]
    lib.qk_fused.restype = ctypes.c_int
    lib.pv_fused.argtypes = [ctypes.POINTER(_PvArgs), ctypes.c_void_p]
    lib.pv_fused.restype = ctypes.c_int
    return lib


def load_library():
    """Build (on first use) and load the kernel library."""
    return _lib()


def _check_shape(name, D, Tc, bits):
    if Tc % TILE_TOKENS:
        raise ValueError(f"{name} kernel: cache capacity {Tc} is not a "
                         f"multiple of {TILE_TOKENS} tokens")
    if D not in (32, 64, 128):
        raise ValueError(f"{name} kernel: d_head {D} not in 32/64/128")
    if bits not in (2, 3, 4):
        raise ValueError(f"{name} kernel: nuq bits {bits} not in 2/3/4")


def _check_slots(name, n):
    if n > MAX_SLOTS:
        raise ValueError(f"{name} kernel: {n} slot rows of one kind > "
                         f"{MAX_SLOTS} (cap_per_side <= 4)")


def _check_aligned(name, tensors):
    """The decode bodies copy these with TMA bulk copies: 16-byte aligned."""
    for key, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: {key} is not 16-byte aligned")


def _check_plan(name, plan: K34Plan):
    if plan.smem > SMEM_MAX:
        raise ValueError(f"{name} kernel: {plan.body} body needs "
                         f"{plan.smem} B of shared memory > {SMEM_MAX}")


def _run(fn, args, dev, name):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _qk_launch(q_rot, k_planes, kv_out, k_range, k_offset, lut, dcfg, mcfg,
               force=None):
    B, Hkv, R, D = q_rot.shape
    bits, hg = dcfg.bits, dcfg.head_group
    Tc = k_planes.shape[-2] * 32
    dev = q_rot.device
    _check_shape("qk_fused", D, Tc, bits)
    rows = _slot_rows(dcfg, kv_out, "k")
    expect = {
        "q_rot": (q_rot, (B, Hkv, R, D), torch.float32),
        "k_planes": (k_planes, (B, Hkv, bits, Tc // 32, D), torch.int32),
        "k_range": (k_range, (Hkv, D), torch.float32),
        "k_offset": (k_offset, (Hkv, D), torch.float32),
        "lut": (lut, (2 ** bits,), torch.float32),
    }
    J = 0
    if rows is not None:
        J = kv_out.shape[-2]
        _check_slots("qk_fused", rows.shape[-2])
        expect["kv_out"] = (kv_out, (B, Hkv // hg, J, Tc), torch.float32)
    check_operands("qk_fused kernel", expect, dev)
    _check_aligned("qk_fused", {"k_planes": k_planes,
                                "kv_out": kv_out if rows is not None else None})
    if mcfg.d_head != D:
        raise ValueError(f"qk_fused kernel: d_head {mcfg.d_head} of the "
                         f"model, {D} of the queries")
    plan = qk_plan(dcfg, R, D, Tc, B, Hkv, J, sm_count(dev), force)
    _check_plan("qk_fused", plan)
    # K1's cached (cos, sin) table: one build serves both kernels
    rope = rope_table(mcfg, dcfg.sink, Tc, dev)
    out = torch.empty((B, Hkv, R, Tc), dtype=torch.float32, device=dev)
    args = _QkArgs(
        q_rot.data_ptr(), k_planes.data_ptr(),
        kv_out.data_ptr() if rows is not None else None,
        k_range.data_ptr(), k_offset.data_ptr(), lut.data_ptr(),
        rope.data_ptr(), out.data_ptr(),
        B, Hkv, R, D, Tc, J, slot_counts(dcfg, J)[0], hg, bits,
        int(dcfg.dot_bf16), BODIES[plan.body], plan.hc, plan.n_split,
        plan.stages, plan.rows, plan.n_rt, plan.smem,
    )
    _run(_lib().qk_fused, args, dev, "qk_fused")
    qk_fused.launches += 1
    if plan.body == "gqa":
        qk_fused.gqa_launches += 1
    return out


def qk_fused(q_rot, k_planes, kv_out, k_range, k_offset, lut,
             dcfg: DeployConfig, mcfg, block_tokens: int = 1024,
             body: str = None):
    """Scores (B, Hkv, R, Tc) = q_rot (B, Hkv, R, D) . rope(dequant +
    K slots) over every packed token. k_planes (B, Hkv, bits, Tc/32, D)
    int32; kv_out (B, Hkv/head_group, J, Tc) merged encoded slot words (K
    rows first) or None; k_range / k_offset (Hkv, D); lut (2**bits,).
    Unscaled; the caller applies 1/sqrt(D) and the validity mask. The
    kernel's tiles are fixed (``qk_plan``); ``block_tokens`` is accepted for
    signature parity. ``body`` forces a kernel body on the card (timing
    only, see ``body()``); the CPU runs the plain version."""
    _check_config(dcfg, "qk_fused")
    if q_rot.device.type == "cpu":
        return qk_fused_ref(q_rot, k_planes, kv_out, k_range, k_offset, lut,
                            dcfg, mcfg, block_tokens)
    if q_rot.device.type != "cuda":
        raise ValueError(f"qk_fused: unsupported device {q_rot.device}")
    return _qk_launch(q_rot.to(torch.float32).contiguous(), k_planes, kv_out,
                      k_range, k_offset, lut, dcfg, mcfg, force=body)


qk_fused.launches = 0
qk_fused.gqa_launches = 0  # of them, calls on qk_gqa


def _pv_launch(probs, v_planes, v_scale, v_offset, kv_out, lut, dcfg):
    B, Hkv, R, Tc = probs.shape
    D = v_planes.shape[-1]
    bits, hg = dcfg.bits, dcfg.head_group
    dev = probs.device
    _check_shape("pv_fused", D, Tc, bits)
    # rows may be a slice of wider rows (the caller's probabilities after
    # the sink columns): any row stride, unit stride along t
    p_ld = probs.stride(2)
    if not (probs.stride(3) == 1 and probs.stride(1) == R * p_ld
            and probs.stride(0) == Hkv * R * p_ld and p_ld >= Tc):
        probs = probs.contiguous()
        p_ld = Tc
    rows = _slot_rows(dcfg, kv_out, "v")
    expect = {
        "v_planes": (v_planes, (B, Hkv, bits, Tc // 32, D), torch.int32),
        "v_scale": (v_scale, (B, Tc), torch.float32),
        "v_offset": (v_offset, (B, Tc), torch.float32),
        "lut": (lut, (2 ** bits,), torch.float32),
    }
    if probs.dtype != torch.float32:
        raise ValueError(f"pv_fused kernel: probs {probs.dtype}, kernel "
                         f"takes torch.float32")
    if probs.device != dev:
        raise ValueError(f"pv_fused kernel: probs on {probs.device}")
    J = 0
    if rows is not None:
        J = kv_out.shape[-2]
        _check_slots("pv_fused", rows.shape[-2])
        expect["kv_out"] = (kv_out, (B, Hkv // hg, J, Tc), torch.float32)
    check_operands("pv_fused kernel", expect, dev)
    _check_aligned("pv_fused", {
        "v_planes": v_planes, "v_scale": v_scale, "v_offset": v_offset,
        "kv_out": kv_out if rows is not None else None})
    plan = pv_plan(dcfg, R, D, Tc, B, Hkv, J, sm_count(dev))
    _check_plan("pv_fused", plan)
    part = torch.empty((B, Hkv, plan.n_split, R, D), dtype=torch.float32,
                       device=dev)
    out = torch.empty((B, Hkv, R, D), dtype=torch.float32, device=dev)
    args = _PvArgs(
        probs.data_ptr(), v_planes.data_ptr(), v_scale.data_ptr(),
        v_offset.data_ptr(), kv_out.data_ptr() if rows is not None else None,
        lut.data_ptr(), part.data_ptr(), out.data_ptr(),
        B, Hkv, R, D, Tc, p_ld, J, dcfg.slots_per_kind,
        slot_counts(dcfg, J)[1], hg, bits, int(dcfg.dot_bf16),
        BODIES[plan.body], plan.hc, plan.n_split, plan.stages, plan.rows,
        plan.n_rt, plan.smem,
    )
    _run(_lib().pv_fused, args, dev, "pv_fused")
    pv_fused.launches += 1
    return out


def pv_fused(probs, v_planes, v_scale, v_offset, kv_out, lut,
             dcfg: DeployConfig, block_tokens: int = 1024):
    """out (B, Hkv, R, D) = probs (B, Hkv, R, Tc) . (dequant(v_planes) +
    V slots). v_planes (B, Hkv, bits, Tc/32, D) int32; v_scale / v_offset
    (B, Tc) per-token range; kv_out (B, Hkv/head_group, J, Tc) merged
    encoded slot words (V rows after the K rows) or None. probs must be
    zero at invalid positions; its rows may be strided (a column slice of
    a wider tensor). The kernel's tiles are fixed (``pv_plan``);
    ``block_tokens`` is accepted for signature parity."""
    _check_config(dcfg, "pv_fused")
    if probs.device.type == "cpu":
        return pv_fused_ref(probs, v_planes, v_scale, v_offset, kv_out, lut,
                            dcfg, block_tokens)
    if probs.device.type != "cuda":
        raise ValueError(f"pv_fused: unsupported device {probs.device}")
    return _pv_launch(probs, v_planes, v_scale, v_offset, kv_out, lut, dcfg)


pv_fused.launches = 0
