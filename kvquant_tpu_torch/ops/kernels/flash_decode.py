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
containers (affine codebook), keys pre- or post-RoPE, K outliers as slot
words or static channels, V slot words. int4x2 (head-paired 2-bit) through
this kernel is not ported yet and raises NotImplementedError.

  - CPU tensors: the plain PyTorch version ``flash_attention_ref``.
  - CUDA tensors: the hand-written kernel ``csrc/flash_decode.cu``, or an
    exception when it cannot be built or launched; there is no fallback.

``flash_attention.launches`` counts kernel launches (one per call on the
card, ``flash_decode`` included). The TPU kernel's constant-band packing
(``prep_constants``) exists for a Mosaic operand limit and is not ported:
the CUDA kernel takes its operands in a struct.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...cache import DeployConfig, k_channel_index
from ...models.llama import rope_cos_sin, rotate_half
from ...quant.nuq import lut_lookup
from ..deployed import _outlier_addend
from ..packing import unpack_codes
from .common import (MAX_KC, MAX_SINK, TILE_TOKENS, fold_affine,
                     signed_codes, channel_addend, check_operands, inv_freq,
                     n_splits)

MODES = {"nuq": 0, "int4": 1, "int8": 2}
TILE = 64  # key tokens per tile in the kernel
ROWS = 64  # query rows per block when Q is not 1, 2, 4 or 8


def _check_config(dcfg: DeployConfig):
    if dcfg.codes == "int4x2":
        raise NotImplementedError(
            "codes='int4x2' through flash_attention (K1's head-paired 2-bit "
            "path) is not ported yet (ROADMAP queue 2, K1); kernel="
            "'flash_serial' decodes int4x2")
    assert dcfg.codes in MODES, dcfg.codes


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
        ("inv_freq", _P), ("rope", _P), ("pos", _P), ("k_chan", _P),
        ("part_m", _P), ("part_l", _P), ("part_acc", _P), ("out", _P),
        ("L", _I), ("B", _I), ("Hkv", _I), ("Q", _I), ("Tq", _I), ("D", _I),
        ("Tc", _I), ("S", _I), ("J", _I), ("spk", _I), ("n_kc", _I),
        ("n_kslots", _I), ("n_vslots", _I),
        ("hg", _I), ("mode", _I), ("bits", _I), ("window", _I),
        ("post_rope", _I), ("dot_bf16", _I), ("li", _I), ("n_split", _I),
        ("n_rt", _I),
        ("inv", ctypes.c_float), ("scaling", ctypes.c_float),
    ]


@functools.lru_cache(maxsize=None)
def _lib():
    from .build import load

    lib = load("flash_decode")
    lib.fd_attention.argtypes = [ctypes.POINTER(_FdArgs), ctypes.c_void_p]
    lib.fd_attention.restype = ctypes.c_int
    return lib


def load_library():
    """Build (on first use) and load the kernel library."""
    return _lib()


def _launch(q_rot, k_planes, v_planes, kv_out, k_range, k_offset, v_scale,
            v_offset, k_sink, v_sink, k_lut, v_lut, li, pos, dcfg, mcfg, Tq,
            k_chan_l):
    B, Hkv, Q, D = q_rot.shape
    L = k_planes.shape[0]
    S, hg = dcfg.sink, dcfg.head_group
    dev = q_rot.device
    NG = Hkv // hg
    J, Tc = kv_out.shape[-2:]

    if Tc % TILE_TOKENS:
        raise ValueError(f"flash_attention kernel: cache capacity {Tc} is "
                         f"not a multiple of {TILE_TOKENS} tokens")
    if D not in (32, 64, 128):
        raise ValueError(f"flash_attention kernel: d_head {D} not in "
                         f"32/64/128")
    if Q % Tq:
        raise ValueError(f"flash_attention kernel: {Q} rows are not a "
                         f"multiple of Tq={Tq}")
    if S > MAX_SINK:
        raise ValueError(f"flash_attention kernel: sink {S} > {MAX_SINK}")
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
            assert hg * D <= 512, "slot words carry a 9-bit (head, dim) index"

    if dcfg.codes == "nuq":
        code = ((L, B, Hkv, dcfg.bits, Tc // 32, D), torch.int32)
    else:
        code = ((L, B, Hkv, Tc, dcfg.code_cols), dcfg.code_dtype)
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
    check_operands("flash_attention kernel", expect, dev)

    few = Q in (1, 2, 4, 8)  # the decode instances: all rows in one block
    n_rt = 1 if few else -(-Q // ROWS)
    # many short splits for decode blocks (measured on the H100: 24 per SM
    # beat 4-16, which leave a ragged last wave); prefill blocks do more
    # work per tile and keep 4 per SM
    ns = n_splits(B * Hkv * n_rt, Tc, dev, 24 if few else 4, TILE)
    freqs = inv_freq(mcfg, dev)
    # the kernel's (cos, sin) table of the packed positions (pre-RoPE keys)
    rope = None if dcfg.post_rope_k else torch.empty(
        (Tc, D // 2, 2), dtype=torch.float32, device=dev)
    out = torch.empty((B, Hkv, Q, D), dtype=torch.float32, device=dev)
    part_m = torch.empty((B, Hkv, ns, Q), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, Hkv, ns, Q, D), dtype=torch.float32,
                           device=dev)
    args = _FdArgs(
        q_rot.data_ptr(), k_planes.data_ptr(), v_planes.data_ptr(),
        kv_out.data_ptr(), k_range.data_ptr(), k_offset.data_ptr(),
        v_scale.data_ptr(), v_offset.data_ptr(), k_sink.data_ptr(),
        v_sink.data_ptr(), k_lut.data_ptr(), v_lut.data_ptr(),
        freqs.data_ptr(), None if rope is None else rope.data_ptr(),
        pos.data_ptr(),
        k_chan_l.data_ptr() if n_kc else None,
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(),
        L, B, Hkv, Q, Tq, D, Tc, S, J, dcfg.slots_per_kind, n_kc,
        n_kslots, n_vslots, hg, MODES[dcfg.codes], dcfg.bits,
        mcfg.sliding_window or 0, int(dcfg.post_rope_k), int(dcfg.dot_bf16),
        int(li), ns, n_rt, 1.0 / (D ** 0.5), float(mcfg.rope_scaling),
    )
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fd_attention(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return out


def flash_attention(
    q_rot, k_planes, v_planes, kv_out, k_range, k_offset, v_scale, v_offset,
    k_sink, v_sink, k_lut, v_lut, li, pos, dcfg: DeployConfig, mcfg,
    Tq: int = 1, block_tokens: int = 1024, k_ressc=None, k_chan=None,
):
    """Attention of Q = G*Tq query rows per kv head over sink + packed cache
    for layer ``li`` of the stacked arrays. ``pos`` (B,) int (or an int) is
    row 0's position. ``k_chan`` (L, n_groups, n_kc) may carry the static K
    channels precomputed from ``k_ressc`` ("channels" mode). The kernel's
    key tile is fixed at 64 tokens; ``block_tokens`` is accepted for
    signature parity."""
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
                   li, pos, dcfg, mcfg, Tq, k_chan_l)


flash_attention.launches = 0


def flash_decode(q_rot, k_planes, v_planes, kv_out, k_range, k_offset,
                 v_scale, v_offset, k_sink, v_sink, k_lut, v_lut, li, pos,
                 dcfg: DeployConfig, mcfg, block_tokens: int = 1024,
                 k_ressc=None, k_chan=None):
    """Decode-step alias: one token per sequence (Tq=1, Q=G rows)."""
    return flash_attention(
        q_rot, k_planes, v_planes, kv_out, k_range, k_offset, v_scale,
        v_offset, k_sink, v_sink, k_lut, v_lut, li, pos, dcfg, mcfg,
        Tq=1, block_tokens=block_tokens, k_ressc=k_ressc, k_chan=k_chan)
