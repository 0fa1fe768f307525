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

``qk_fused.launches`` / ``pv_fused.launches`` count kernel launches (one
per call on the card).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...cache import DeployConfig
from ...models.llama import rope_cos_sin, rotate_half
from ...quant.nuq import lut_lookup
from ..packing import decode_outlier_words, unpack_codes
from .common import TILE_TOKENS, check_operands, inv_freq, n_splits

TILE = 64  # tokens per tile in both kernels
ROWS = 64  # query rows per pass when R is not 1, 2, 4 or 8
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


def slot_addend(rows, n_heads: int, D: int, hg: int):
    """Encoded slot rows (B, NG, n, Tc) -> dense (B, Hkv, Tc, D) fp32 of
    the slots each head owns, as the TPU kernels decode a word u: value
    ``u & 0xFFFFFE00``, dim ``u & 0x7F`` (dims >= D add nothing),
    head-in-group ``(u >> 7) & 3`` (ignored at head_group 1)."""
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
    return dense[..., :D].reshape(B, n_heads, Tc, D)


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
    ``block_tokens`` is accepted for signature parity."""
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
        kx = kx + rope(slot_addend(rows, Hkv, D, dcfg.head_group))
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
# the CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


class _QkArgs(ctypes.Structure):
    """Mirror of ``QkArgs`` in csrc/attention.cu (same field order)."""
    _fields_ = [
        ("q", _P), ("kp", _P), ("kv_out", _P), ("k_range", _P),
        ("k_offset", _P), ("lut", _P), ("inv_freq", _P), ("out", _P),
        ("B", _I), ("Hkv", _I), ("R", _I), ("D", _I), ("Tc", _I), ("S", _I),
        ("J", _I), ("n_kslots", _I), ("hg", _I), ("bits", _I),
        ("dot_bf16", _I), ("hc", _I),
        ("scaling", ctypes.c_float),
    ]


class _PvArgs(ctypes.Structure):
    """Mirror of ``PvArgs`` in csrc/attention.cu (same field order)."""
    _fields_ = [
        ("p", _P), ("vp", _P), ("v_scale", _P), ("v_offset", _P),
        ("kv_out", _P), ("lut", _P), ("part", _P), ("out", _P),
        ("B", _I), ("Hkv", _I), ("R", _I), ("D", _I), ("Tc", _I),
        ("p_ld", _I), ("J", _I), ("spk", _I), ("n_vslots", _I), ("hg", _I),
        ("bits", _I), ("dot_bf16", _I), ("n_split", _I), ("n_rt", _I),
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


def _run(fn, args, dev, name):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _qk_launch(q_rot, k_planes, kv_out, k_range, k_offset, lut, dcfg, mcfg):
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
    # decode steps (few rows) share each tile's rotation across up to 8
    # kv heads of one block; prefill blocks take one head per block
    hc = 1
    if R <= 8:
        hc = next(c for c in (8, 4, 2, 1) if Hkv % c == 0)
    out = torch.empty((B, Hkv, R, Tc), dtype=torch.float32, device=dev)
    args = _QkArgs(
        q_rot.data_ptr(), k_planes.data_ptr(),
        kv_out.data_ptr() if rows is not None else None,
        k_range.data_ptr(), k_offset.data_ptr(), lut.data_ptr(),
        inv_freq(mcfg, dev).data_ptr(), out.data_ptr(),
        B, Hkv, R, D, Tc, dcfg.sink, J,
        rows.shape[-2] if rows is not None else 0, hg, bits,
        int(dcfg.dot_bf16), hc, float(mcfg.rope_scaling),
    )
    _run(_lib().qk_fused, args, dev, "qk_fused")
    qk_fused.launches += 1
    return out


def qk_fused(q_rot, k_planes, kv_out, k_range, k_offset, lut,
             dcfg: DeployConfig, mcfg, block_tokens: int = 1024):
    """Scores (B, Hkv, R, Tc) = q_rot (B, Hkv, R, D) . rope(dequant +
    K slots) over every packed token. k_planes (B, Hkv, bits, Tc/32, D)
    int32; kv_out (B, Hkv/head_group, J, Tc) merged encoded slot words (K
    rows first) or None; k_range / k_offset (Hkv, D); lut (2**bits,).
    Unscaled; the caller applies 1/sqrt(D) and the validity mask. The
    kernel's tile is fixed at 64 tokens; ``block_tokens`` is accepted for
    signature parity."""
    _check_config(dcfg, "qk_fused")
    if q_rot.device.type == "cpu":
        return qk_fused_ref(q_rot, k_planes, kv_out, k_range, k_offset, lut,
                            dcfg, mcfg, block_tokens)
    if q_rot.device.type != "cuda":
        raise ValueError(f"qk_fused: unsupported device {q_rot.device}")
    return _qk_launch(q_rot.to(torch.float32).contiguous(), k_planes, kv_out,
                      k_range, k_offset, lut, dcfg, mcfg)


qk_fused.launches = 0


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
    J = n_v = 0
    if rows is not None:
        J, n_v = kv_out.shape[-2], rows.shape[-2]
        _check_slots("pv_fused", n_v)
        expect["kv_out"] = (kv_out, (B, Hkv // hg, J, Tc), torch.float32)
    check_operands("pv_fused kernel", expect, dev)
    few = R <= 8  # the decode instances: all rows in one block
    n_rt = 1 if few else -(-R // ROWS)
    # many short splits for decode blocks (as K1), fewer for prefill
    ns = n_splits(B * Hkv * n_rt, Tc, dev, 24 if few else 4, TILE)
    part = torch.empty((B, Hkv, ns, R, D), dtype=torch.float32, device=dev)
    out = torch.empty((B, Hkv, R, D), dtype=torch.float32, device=dev)
    args = _PvArgs(
        probs.data_ptr(), v_planes.data_ptr(), v_scale.data_ptr(),
        v_offset.data_ptr(), kv_out.data_ptr() if rows is not None else None,
        lut.data_ptr(), part.data_ptr(), out.data_ptr(),
        B, Hkv, R, D, Tc, p_ld, J, dcfg.slots_per_kind, n_v, hg, bits,
        int(dcfg.dot_bf16), ns, n_rt,
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
    a wider tensor). The kernel's tile is fixed at 64 tokens;
    ``block_tokens`` is accepted for signature parity."""
    _check_config(dcfg, "pv_fused")
    if probs.device.type == "cpu":
        return pv_fused_ref(probs, v_planes, v_scale, v_offset, kv_out, lut,
                            dcfg, block_tokens)
    if probs.device.type != "cuda":
        raise ValueError(f"pv_fused: unsupported device {probs.device}")
    return _pv_launch(probs, v_planes, v_scale, v_offset, kv_out, lut, dcfg)


pv_fused.launches = 0
