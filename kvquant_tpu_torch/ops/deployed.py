"""Deployed quantized-KV datapath in eager PyTorch (port of
kvquant_tpu/ops/deployed.py).

This is the port's oracle for everything except the attention kernels:
append-side quantization (per-channel K, per-token V range, per-head-group
outlier words or static K channel residuals), full-cache dequantization of
bit planes and integer containers, the ``kernel="xla"`` decode attention,
the row-level append of the flash decode path, the prompt-phase parallel
pack and the block append + attention of quantized chunked prefill. Under
``kernel="pallas"`` the decode and block attention run the two-pass kernels
(ops/kernels/attention: K3 ``qk_fused`` for the scores, the scaling, masks
and softmax here, K4 ``pv_fused`` for the weighted values).

Differences from the JAX functions:
  - caches are updated IN PLACE (``cache_l`` is a set of views of the
    stacked arrays, see KVCache.layer) and also returned;
  - a decode step's ``pos`` is a (B,) int32 tensor on the cache's device
    (an int or B ints are converted once, ``device_positions``); its rows
    are written by device-indexed, predicated writes (``_write_token``, as
    JAX's ``_write_row_b``), so the step reads nothing back to the host;
    likewise ``block_attention`` takes its ``pos0`` as a device tensor and
    writes its block at a device offset (``packing.write_block``);
  - under a rank-local ``mcfg`` (``parallel.shardings.shard_config``) the
    arrays hold this rank's heads and ``quantize_v`` exchanges the per-token
    V range over the tp group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..cache import KVCache, DeployConfig, DeployedQuant, k_channel_index
from ..models.config import ModelConfig
from ..models.llama import rope_cos_sin, rotate_half
from ..parallel.collectives import topk_range, tp_group
from ..quant.nuq import nearest_codes, lut_lookup
from ..utils.topk import top_k
from .packing import (
    unpack_codes, set_token_bits, token_word_bit, place_planes,
    store_codes_int, load_codes_int, place_codes_int,
    pair_codes_int4x2, unpair_codes_int4x2, place_codes_int4x2,
    write_block, write_rows,
    encode_outlier_words, decode_outlier_words, OUTLIER_DIM_MASK,
)


def device_positions(pos, B: int, device) -> torch.Tensor:
    """``pos`` (an int, B ints, or a () / (B,) tensor) as a (B,) int32
    tensor on ``device``; a tensor already there is used as it is."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(pos, dtype=torch.int32)
    pos = pos.to(device=device, dtype=torch.int32)
    if pos.dim() == 0:
        pos = pos.expand(B)
    if pos.shape != (B,):
        raise ValueError(f"positions of shape {tuple(pos.shape)} for a "
                         f"batch of {B}")
    return pos


def block_pos0(pos0, n_packed: int, dcfg: DeployConfig, device
               ) -> torch.Tensor:
    """A block's ``pos0`` (block_attention) as a 0-d int32 tensor on
    ``device``. A host int is first checked on the host: the block's
    ``n_packed`` tokens at the packed offset max(pos0 - sink, 0) fit the
    capacity; it becomes a tensor by a fill, with no copy from the host.
    A tensor is taken as it is: its caller has checked it."""
    if isinstance(pos0, torch.Tensor):
        return pos0.reshape(())
    p0 = max(int(pos0) - dcfg.sink, 0)
    assert p0 + n_packed <= dcfg.cache_tokens, (
        f"block [{p0}, {p0 + n_packed}) exceeds capacity "
        f"{dcfg.cache_tokens}")
    return torch.full((), int(pos0), dtype=torch.int32, device=device)


def _stored_codes(planes, dcfg: DeployConfig):
    """Code storage -> unsigned int32 codes (..., Hkv, Tc, D)."""
    if dcfg.codes == "nuq":
        return unpack_codes(planes, dcfg.bits)
    if dcfg.codes == "int4x2":
        return unpair_codes_int4x2(planes)
    return load_codes_int(planes, dcfg.bits)


def _encode_rows(codes, dcfg: DeployConfig):
    """Unsigned codes (..., Hkv, D) -> container rows (..., H', Dc) for
    the integer containers (bit planes are written by set_token_bits)."""
    if dcfg.codes == "int4x2":
        return pair_codes_int4x2(codes)
    return store_codes_int(codes, dcfg.bits, dcfg.code_dtype)


def _place_codes(arr, codes, p0, dcfg: DeployConfig):
    """Aligned block write of unsigned codes (..., T, Hkv, D) into the code
    storage (..., H', Tc, Dc) or bit planes (..., Hkv, bits, TW, D), in
    place, at a host int or a device tensor ``p0``."""
    if dcfg.codes == "nuq":
        return place_planes(arr, codes, p0, dcfg.bits)
    if dcfg.codes == "int4x2":
        return place_codes_int4x2(arr, codes, p0)
    return place_codes_int(arr, codes, p0, dcfg.bits)



# ---------------------------------------------------------------------------
# per-token quantization (append-side math)
# ---------------------------------------------------------------------------


def _headwise_residual_outliers(xf, resc, deq, cap: int):
    """Per-group fixed-budget outlier extraction: the ``cap`` largest and
    ``cap`` smallest ``resc`` entries (jax.lax.top_k order). Returns
    (ovals, oidx), each (..., 2*cap); non-genuine slots carry value 0."""
    top_v, top_i = top_k(resc, cap)
    bot_v, bot_i = top_k(-resc, cap)
    oidx = torch.cat([top_i, bot_i], dim=-1)
    genuine = torch.cat([top_v > 0.0, bot_v > 0.0], dim=-1)
    x_at = torch.gather(xf, -1, oidx)
    d_at = torch.gather(deq, -1, oidx)
    vals = torch.where(genuine, x_at - d_at, torch.zeros_like(x_at))
    return vals, oidx.to(torch.int32)


def _encode_padded(ovals, oidx, n_slots: int):
    """(..., G, 2*cap) residuals / 9-bit idx -> (..., G, n_slots) encoded
    fp32 words, zero-padded."""
    words = encode_outlier_words(ovals, oidx)
    pad = n_slots - words.shape[-1]
    if pad:
        words = torch.nn.functional.pad(words, (0, pad))
    return words


def _group_outlier_words(x_g, xn_g, deq_g, dcfg: DeployConfig,
                         n_slots: int | None = None):
    """Per-(token, head-group) residual outliers encoded with the 9-bit
    ``head_in_group << 7 | dim`` index. x_g/xn_g/deq_g: (..., n_groups,
    head_group*d_head) raw / normalized / dense-dequantized values."""
    base = torch.abs(xn_g) > 1.0
    resc = torch.where(base, torch.abs(xn_g), torch.zeros_like(xn_g))
    signed = torch.where(xn_g > 0, resc, -resc)
    ovals, oidx = _headwise_residual_outliers(
        x_g, signed, deq_g, dcfg.cap_per_side
    )
    D = dcfg.d_head
    oidx9 = (oidx // D) * 128 + (oidx % D)
    return _encode_padded(
        ovals, oidx9, dcfg.slots_per_kind if n_slots is None else n_slots,
    )


def quantize_k(k, lq: DeployedQuant, dcfg: DeployConfig, k_chan=None):
    """Quantize keys (..., C) -> (codes (..., Hkv, D) int32, outlier rows
    (..., n_groups, slots_per_kind) fp32 or None). "channels" mode: the rows
    are the plain residuals x - dequant at the layer's static channels
    ``k_chan`` (n_groups, n_kc), computed here when not given."""
    Hkv, D = dcfg.n_kv_heads, dcfg.d_head
    kf = k.to(torch.float32).reshape(*k.shape[:-1], Hkv, D)
    zp = ((lq.k_upper + lq.k_lower) * 0.5).reshape(Hkv, D)
    hr = ((lq.k_upper - lq.k_lower) * 0.5).reshape(Hkv, D)
    xn = (kf - zp) / hr
    codes = nearest_codes(xn, lq.k_lut_enc)
    deq = lut_lookup(lq.k_lut_dec, codes) * hr + zp

    out_words = None
    if dcfg.include_sparse:
        gshape = (*k.shape[:-1], dcfg.n_groups, dcfg.head_group * D)
        if dcfg.k_outliers == "channels":
            idx = (k_chan if k_chan is not None
                   else k_channel_index(lq.k_ressc, dcfg))  # (G, n_kc)
            resid = (kf - deq).reshape(gshape)
            out_words = torch.gather(
                resid, -1, idx.expand(*resid.shape[:-1], idx.shape[-1]))
        else:
            out_words = _group_outlier_words(
                kf.reshape(gshape), xn.reshape(gshape), deq.reshape(gshape),
                dcfg,
            )
    return codes, out_words


def quantize_v(v, lq: DeployedQuant, dcfg: DeployConfig, group=None):
    """Quantize values (..., C) -> (codes (..., Hkv, D), outlier words
    (..., n_groups, n_slots - slots_per_kind) or None, scale (...,),
    offset (...,)); the range is the (r+1)-th global extreme each side,
    over the channels of every rank of the tp ``group`` when ``v`` holds
    this rank's heads (``parallel.collectives.topk_range``)."""
    Hkv, D = dcfg.n_kv_heads, dcfg.d_head
    vf = v.to(torch.float32)
    minval, maxval = topk_range(vf, dcfg.v_range_exclude + 1, group)
    offset = (maxval + minval) * 0.5
    scale = (maxval - minval) * 0.5

    vh = vf.reshape(*v.shape[:-1], Hkv, D)
    xn = (vh - offset[..., None]) / scale[..., None]
    codes = nearest_codes(xn, lq.v_lut_enc)
    deq = lut_lookup(lq.v_lut_dec, codes) * scale[..., None] + offset[..., None]

    out_words = None
    if dcfg.include_sparse and dcfg.cap_per_side > 0:
        gshape = (*v.shape[:-1], dcfg.n_groups, dcfg.head_group * D)
        out_words = _group_outlier_words(
            vh.reshape(gshape), xn.reshape(gshape), deq.reshape(gshape),
            dcfg, n_slots=dcfg.n_slots - dcfg.slots_per_kind,
        )
    return codes, out_words, scale[..., 0], offset[..., 0]


# ---------------------------------------------------------------------------
# full-cache dequantization (the eager oracle)
# ---------------------------------------------------------------------------


def _outlier_addend(out_words, dcfg: DeployConfig):
    """(B, n_groups, J, Tc) encoded slots -> dense (B, Hkv, Tc, D) addend.
    Padding slots decode to value 0, so index collisions add nothing."""
    B, Gp, J, Tc = out_words.shape
    D, hg = dcfg.d_head, dcfg.head_group
    vals, idx9 = decode_outlier_words(out_words)
    gidx = ((idx9 >> 7) * D + (idx9 & OUTLIER_DIM_MASK)).long()  # dense group index
    dense = torch.zeros((B, Gp, Tc, hg * D), dtype=torch.float32,
                        device=out_words.device)
    dense.scatter_add_(-1, gidx.transpose(-1, -2), vals.transpose(-1, -2))
    return dense.reshape(B, Gp, Tc, hg, D).transpose(2, 3).reshape(
        B, Gp * hg, Tc, D)


def dequant_k_full(cache_l: KVCache, lq: DeployedQuant, dcfg: DeployConfig,
                   with_outliers: bool = True, k_chan=None):
    """(B, Hkv, Tc, D) fp32 keys (dense [+ sparse]); ``k_chan`` as in
    ``quantize_k``."""
    codes = _stored_codes(cache_l.k_planes, dcfg)
    deq = lut_lookup(lq.k_lut_dec, codes) * lq.k_range[:, None, :] + (
        lq.k_offset[:, None, :])
    if dcfg.include_sparse and with_outliers:
        rows = cache_l.kv_out[:, :, : dcfg.slots_per_kind]
        if dcfg.k_outliers == "channels":
            B, Gp, N, Tc = rows.shape
            D, hg = dcfg.d_head, dcfg.head_group
            idx = (k_chan if k_chan is not None
                   else k_channel_index(lq.k_ressc, dcfg))  # (G, n_kc)
            dense = torch.zeros((B, Gp, Tc, hg * D), dtype=torch.float32,
                                device=rows.device)
            dense.scatter_add_(
                -1, idx[None, :, None, :].expand(B, Gp, Tc, N),
                rows.transpose(-1, -2))
            deq = deq + dense.reshape(B, Gp, Tc, hg, D).transpose(
                2, 3).reshape(B, Gp * hg, Tc, D)
        else:
            deq = deq + _outlier_addend(rows, dcfg)
    return deq


def dequant_v_full(cache_l: KVCache, lq: DeployedQuant, dcfg: DeployConfig,
                   with_outliers: bool = True):
    """(B, Hkv, Tc, D) fp32 values (dense [+ sparse])."""
    codes = _stored_codes(cache_l.v_planes, dcfg)
    deq = lut_lookup(lq.v_lut_dec, codes) * cache_l.v_scale[:, None, :, None] \
        + cache_l.v_offset[:, None, :, None]
    if dcfg.include_sparse and with_outliers and dcfg.cap_per_side > 0:
        deq = deq + _outlier_addend(
            cache_l.kv_out[:, :, dcfg.slots_per_kind:], dcfg)
    return deq


# ---------------------------------------------------------------------------
# decode step, kernel="xla": append + attention over the dequantized cache
# ---------------------------------------------------------------------------


class TokenRows(NamedTuple):
    """Where each sample's token lands, from its position pos (B,):
    ``packed`` pos >= S; ``p`` the packed row clamp(pos - S, 0, Tc - 1)
    (int64) and, for bit planes, its ``word`` row and ``bit``; ``s`` the
    sink row min(pos, S - 1) (None without a sink). A decode step computes
    it once and every layer's writes share it."""
    packed: torch.Tensor
    p: torch.Tensor
    word: torch.Tensor | None
    bit: torch.Tensor | None
    s: torch.Tensor | None


def token_rows(pos, dcfg: DeployConfig) -> TokenRows:
    """The ``TokenRows`` of positions ``pos`` (B,) int32."""
    S, Tc = dcfg.sink, dcfg.cache_tokens
    p = (pos - S).clamp(0, Tc - 1).long()
    word, bit = token_word_bit(p) if dcfg.codes == "nuq" else (None, None)
    return TokenRows(pos >= S, p, word, bit,
                     pos.clamp(max=S - 1).long() if S > 0 else None)


def _write_token(c: dict, dcfg: DeployConfig, at: TokenRows, codes_k,
                 codes_v, k_words, v_words, v_sc, v_off, k_roped, v_h):
    """Write each sample's token into one layer's arrays ``c`` (name ->
    (B, ...) views) at its rows ``at``, in place, predicated as JAX's
    ``_write_row_b``: codes, outlier rows and V range at the packed row,
    which keeps its old value where pos < S; the exact sink rows, which
    keep theirs where pos >= S. Device-indexed: no host read."""
    for name, codes in (("k_planes", codes_k), ("v_planes", codes_v)):
        if dcfg.codes == "nuq":
            set_token_bits(c[name], codes, at.word, at.bit, at.packed)
        else:
            write_rows(c[name], _encode_rows(codes, dcfg), at.p, at.packed,
                       axis=-2)
    if dcfg.include_sparse:
        row0 = 0
        for words in (k_words, v_words):
            if words is not None and words.shape[-1]:
                n = words.shape[-1]
                write_rows(c["kv_out"][:, :, row0:row0 + n], words, at.p,
                           at.packed, axis=3)
            row0 = dcfg.slots_per_kind
    write_rows(c["v_scale"], v_sc, at.p, at.packed, axis=1)
    write_rows(c["v_offset"], v_off, at.p, at.packed, axis=1)
    if at.s is not None:
        sink = ~at.packed
        write_rows(c["k_sink"], k_roped, at.s, sink, axis=2)
        write_rows(c["v_sink"], v_h, at.s, sink, axis=2)


# the axis of each stacked (L, B, ...) array that _write_token indexes by a
# token's packed row (the bit planes by its word)
_ROW_AXIS = {"k_planes": -2, "v_planes": -2, "kv_out": -1, "v_scale": -1,
             "v_offset": -1}


def first_row_keeper(cache: KVCache):
    """Keep what a decode step at position S (``dcfg.sink``) writes: the
    first packed row of every array (word 0 of the bit planes), the sinks
    and the length. Returns a function that puts them back in place."""
    views = [getattr(cache, n).narrow(ax, 0, 1)
             for n, ax in _ROW_AXIS.items()]
    views += [cache.k_sink, cache.v_sink, cache.length]
    kept = [(view, view.clone()) for view in views]

    def restore():
        for view, old in kept:
            view.copy_(old)

    return restore


def _quantize_token(lq: DeployedQuant, dcfg: DeployConfig,
                    mcfg: ModelConfig, k_new, v_new, cos, sin,
                    k_chan=None):
    """One token per sample quantized for the append: (codes_k, codes_v,
    k_words, v_words, v_scale, v_offset, roped keys (B, Hkv, Dh), values
    (B, Hkv, Dh)), the positional arguments of ``_write_token`` after
    ``at``."""
    B = k_new.shape[0]
    Hkv, Dh = dcfg.n_kv_heads, dcfg.d_head
    k_h = k_new.reshape(B, Hkv, Dh).to(torch.float32)
    k_roped = k_h * cos[:, None] + rotate_half(k_h) * sin[:, None]
    k_store = k_roped.reshape(B, Hkv * Dh) if dcfg.post_rope_k else k_new
    codes_k, k_words = quantize_k(k_store, lq, dcfg, k_chan)
    codes_v, v_words, v_sc, v_off = quantize_v(v_new, lq, dcfg,
                                                tp_group(mcfg))
    v_h = v_new.reshape(B, Hkv, Dh).to(torch.float32)
    return codes_k, codes_v, k_words, v_words, v_sc, v_off, k_roped, v_h


def _assert_two_pass(dcfg: DeployConfig):
    """The storage the two-pass kernels (kernel="pallas") read."""
    assert dcfg.codes == "nuq", "two-pass kernels read bit planes only"
    assert not dcfg.post_rope_k, "two-pass kernels rope in-kernel"
    assert dcfg.k_outliers == "slots", (
        "two-pass kernels decode slot words; use kernel='flash' for "
        "k_outliers='channels'")


def _roped_keys(k_full, dcfg: DeployConfig, mcfg: ModelConfig):
    """Dequantized cache keys (..., Tc, D) as the scores see them: stored
    post-RoPE, or rotated here at their absolute positions S + t."""
    if dcfg.post_rope_k:
        return k_full
    Tc = k_full.shape[-2]
    pos_cache = dcfg.sink + torch.arange(Tc, dtype=torch.int32,
                                         device=k_full.device)
    ck, sk = rope_cos_sin(pos_cache, mcfg)
    return k_full * ck + rotate_half(k_full) * sk


def decode_attention(cache_l: KVCache, lq: DeployedQuant, dcfg: DeployConfig,
                     mcfg: ModelConfig, q, k_new, v_new, pos, *, rows=None,
                     cos_sin=None, k_chan=None):
    """Append each sample's token at its position to the single-layer cache
    (in place) and attend over positions 0..pos. q (B, H, Dh) un-roped,
    k_new/v_new (B, C), pos (B,) int32 on the device (or an int / B ints).
    Returns (cache_l, out (B, H, Dh)). kernel "pallas" scores through K3
    and weights the values through K4; every other kernel attends over the
    eagerly dequantized cache. The token's K and V rows are both written
    before the scores: the scores read no V row. ``rows`` (``token_rows``),
    ``cos_sin`` (``rope_cos_sin(pos)``) and the layer's static K channels
    ``k_chan`` (``quantize_k``) may come precomputed."""
    pallas = dcfg.kernel == "pallas"
    if pallas:
        _assert_two_pass(dcfg)
    B = q.shape[0]
    S, Tc = dcfg.sink, dcfg.cache_tokens
    Hkv, Dh = dcfg.n_kv_heads, dcfg.d_head
    G = q.shape[1] // Hkv
    dev = q.device

    post = device_positions(pos, B, dev)
    cos, sin = cos_sin or rope_cos_sin(post, mcfg)  # (B, Dh)
    _write_token(cache_l.arrays(), dcfg, rows or token_rows(post, dcfg),
                 *_quantize_token(lq, dcfg, mcfg, k_new, v_new, cos, sin,
                                  k_chan))
    cache_l.length.copy_(post + 1)

    # ---- scores ----
    q_h = q.reshape(B, Hkv, G, Dh).to(torch.float32)
    q_rot = q_h * cos[:, None, None] + rotate_half(q_h) * sin[:, None, None]
    inv = 1.0 / (Dh ** 0.5)
    if pallas:
        from .kernels.attention import qk_fused

        scores = qk_fused(q_rot, cache_l.k_planes, cache_l.kv_out,
                          lq.k_range, lq.k_offset, lq.k_lut_dec, dcfg,
                          mcfg) * inv
    else:
        k_full = _roped_keys(dequant_k_full(cache_l, lq, dcfg, k_chan=k_chan),
                             dcfg, mcfg)
        scores = torch.einsum("bhgd,bhtd->bhgt", q_rot, k_full) * inv
    if S > 0:
        sink_sc = torch.einsum("bhgd,bhsd->bhgs", q_rot, cache_l.k_sink) * inv
        scores = torch.cat([sink_sc, scores], dim=-1)  # (B,Hkv,G,S+Tc)

    idx = torch.arange(S + Tc, dtype=torch.int32, device=dev)
    valid = idx[None, :] <= post[:, None]
    if mcfg.sliding_window is not None:
        valid &= idx[None, :] > (post[:, None] - mcfg.sliding_window)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)

    # ---- weighted values ----
    if pallas:
        from .kernels.attention import pv_fused

        out = pv_fused(probs[..., S:], cache_l.v_planes, cache_l.v_scale,
                       cache_l.v_offset, cache_l.kv_out, lq.v_lut_dec, dcfg)
    else:
        out = torch.einsum("bhgt,bhtd->bhgd", probs[..., S:],
                           dequant_v_full(cache_l, lq, dcfg))
    if S > 0:
        out = out + torch.einsum("bhgs,bhsd->bhgd", probs[..., :S],
                                 cache_l.v_sink)
    return cache_l, out.reshape(B, Hkv * G, Dh)


# ---------------------------------------------------------------------------
# flash-decode append: row-level writes into the FULL (L, ...) cache arrays
# ---------------------------------------------------------------------------


def append_token_flash(arrs: dict, lq: DeployedQuant, dcfg: DeployConfig,
                       mcfg: ModelConfig, k_new, v_new, pos, li: int, *,
                       rows=None, cos_sin=None, k_chan=None) -> dict:
    """Append one token per sample at layer ``li`` directly into the
    stacked (L, B, ...) arrays (in place; ``arrs`` is returned). ``pos``
    (B,) int32 on the device (or an int / B ints): one device-indexed,
    predicated write per array serves a uniform and per-sample positions.
    Tokens inside the sink prefix go to the exact sink rows and leave the
    packed arrays untouched. ``rows`` (``token_rows``), ``cos_sin``
    (``rope_cos_sin(pos)``) and the layer's static K channels ``k_chan``
    (``quantize_k``) may come precomputed."""
    B = k_new.shape[0]
    pos = device_positions(pos, B, k_new.device)
    cos, sin = cos_sin or rope_cos_sin(pos, mcfg)
    _write_token({name: a[li] for name, a in arrs.items()}, dcfg,
                 rows or token_rows(pos, dcfg),
                 *_quantize_token(lq, dcfg, mcfg, k_new, v_new, cos, sin,
                                  k_chan))
    return arrs


# ---------------------------------------------------------------------------
# prompt-phase parallel pack
# ---------------------------------------------------------------------------


def prefill_pack(cache_l: KVCache, lq: DeployedQuant, dcfg: DeployConfig,
                 mcfg: ModelConfig, k, v):
    """Pack a whole prompt's pre-RoPE k / v projections (B, T0, C) into the
    single-layer cache in place: exact sink rows for the first S tokens,
    quantized codes, outlier rows and V ranges for the rest."""
    B, T0, C = k.shape
    S, Tc = dcfg.sink, dcfg.cache_tokens
    Hkv, Dh = dcfg.n_kv_heads, dcfg.d_head
    assert T0 > S, "prompt must extend beyond the sink prefix"
    Tp = T0 - S
    assert Tp <= Tc

    cos, sin = rope_cos_sin(
        torch.arange(T0, dtype=torch.int32, device=k.device), mcfg)
    kh = k.reshape(B, T0, Hkv, Dh).to(torch.float32)
    kh = kh * cos[:, None] + rotate_half(kh) * sin[:, None]
    if S > 0:
        cache_l.k_sink.copy_(kh[:, :S].transpose(1, 2))
        cache_l.v_sink.copy_(
            v[:, :S].reshape(B, S, Hkv, Dh).to(torch.float32).transpose(1, 2))

    k_store = kh.reshape(B, T0, Hkv * Dh)[:, S:] if dcfg.post_rope_k \
        else k[:, S:]
    codes_k, k_words = quantize_k(k_store, lq, dcfg)
    codes_v, v_words, v_sc, v_off = quantize_v(v[:, S:], lq, dcfg,
                                                tp_group(mcfg))
    _place_codes(cache_l.k_planes, codes_k, 0, dcfg)
    _place_codes(cache_l.v_planes, codes_v, 0, dcfg)
    if dcfg.include_sparse:
        kv_words = k_words if v_words is None else torch.cat(
            [k_words, v_words], dim=-1)
        # (B, Tp, G, J) -> (B, G, J, Tp) token axis last
        cache_l.kv_out[..., :kv_words.shape[-1], :Tp] = \
            kv_words.permute(0, 2, 3, 1)
    cache_l.v_scale[:, :Tp] = v_sc
    cache_l.v_offset[:, :Tp] = v_off
    cache_l.length.fill_(T0)
    return cache_l


# ---------------------------------------------------------------------------
# block append + attention: a whole 128-aligned token block at once (the
# basis of quantized chunked prefill)
# ---------------------------------------------------------------------------


def block_attention(cache_l: KVCache, lq: DeployedQuant, dcfg: DeployConfig,
                    mcfg: ModelConfig, q, k_new, v_new, pos0,
                    sink_fill: bool = False):
    """Pack a block of tokens into the single-layer cache (in place) and
    attend for every query of the block over cache positions 0..its own,
    so each query sees the dequantized values a later decode step would.

    q (B, Tq_all, H, Dh) un-roped; k_new / v_new (B, Tq_all, C) pre-RoPE;
    ``pos0`` is the absolute position of the block's first NON-sink token
    (``pos0 - sink`` 128-aligned), an int or a 0-d / (1,) int32 tensor on
    the device; with ``sink_fill`` the first ``sink`` rows are the sink
    tokens (block 0 of a prefill). The block is written at the packed
    offset max(pos0 - sink, 0) by device-indexed writes and nothing is read
    back to the host, so a CUDA graph captures the call at a device
    ``pos0`` (a tensor's caller checks that the block fits the capacity,
    an int is checked here, ``block_pos0``). kernel
    "flash" / "flash_serial" attends through K1 (``kernels.flash_decode.
    flash_attention``), "pallas" through the two-pass kernels K3 / K4
    (``kernels.attention``), "xla" over the eagerly dequantized cache.
    Returns (cache_l, out (B, Tq_all, H*Dh) fp32)."""
    pallas = dcfg.kernel == "pallas"
    if pallas:
        _assert_two_pass(dcfg)
    B, Tq_all = q.shape[:2]
    S, Tc = dcfg.sink, dcfg.cache_tokens
    Hkv, Dh = dcfg.n_kv_heads, dcfg.d_head
    G = q.shape[2] // Hkv
    ns = S if sink_fill else 0
    Tq = Tq_all - ns  # packed tokens
    assert Tq % 128 == 0, Tq
    dev = q.device
    pos0 = block_pos0(pos0, Tq, dcfg, dev)
    positions = (pos0 - ns) + torch.arange(Tq_all, dtype=torch.int32,
                                           device=dev)
    cos, sin = rope_cos_sin(positions, mcfg)  # (Tq_all, Dh)

    if sink_fill and S > 0:
        k_s = k_new[:, :S].reshape(B, S, Hkv, Dh).to(torch.float32)
        k_s = k_s * cos[:S, None] + rotate_half(k_s) * sin[:S, None]
        cache_l.k_sink.copy_(k_s.transpose(1, 2))
        cache_l.v_sink.copy_(v_new[:, :S].reshape(B, S, Hkv, Dh)
                             .to(torch.float32).transpose(1, 2))

    kq, vq = k_new[:, ns:], v_new[:, ns:]
    if dcfg.post_rope_k:
        kh = k_new.reshape(B, Tq_all, Hkv, Dh).to(torch.float32)
        kh = kh * cos[:, None] + rotate_half(kh) * sin[:, None]
        kq = kh.reshape(B, Tq_all, Hkv * Dh)[:, ns:]
    codes_k, k_words = quantize_k(kq, lq, dcfg)  # (B, Tq, Hkv, D)
    codes_v, v_words, v_sc, v_off = quantize_v(vq, lq, dcfg,
                                                tp_group(mcfg))

    p0 = (pos0 - S).clamp(min=0)  # packed offset of the block
    _place_codes(cache_l.k_planes, codes_k, p0, dcfg)
    _place_codes(cache_l.v_planes, codes_v, p0, dcfg)
    if dcfg.include_sparse:
        kv_words = k_words if v_words is None else torch.cat(
            [k_words, v_words], dim=-1)
        # (B, Tq, G, J) -> (B, G, J, Tq) token axis last
        write_block(cache_l.kv_out[..., :kv_words.shape[-1], :],
                    kv_words.permute(0, 2, 3, 1), p0, axis=-1)
    write_block(cache_l.v_scale, v_sc, p0, axis=1)
    write_block(cache_l.v_offset, v_off, p0, axis=1)
    cache_l.length.copy_((pos0 + Tq).expand(B))

    # ---- attention for every query of the block ----
    q_h = q.reshape(B, Tq_all, Hkv, G, Dh).to(torch.float32)
    q_rot = q_h * cos[:, None, None] + rotate_half(q_h) * sin[:, None, None]
    q_rot = q_rot.permute(0, 2, 3, 1, 4)  # (B, Hkv, G, Tq_all, Dh)

    if dcfg.kernel in ("flash", "flash_serial"):
        # one K1 call over the whole block: every row masked to its own
        # position in-kernel, nothing of O(Tq x Tc) materialized; rows are
        # g-major, row r at position pos_first + r % Tq_all
        from .kernels.flash_decode import flash_attention

        pos_first = (pos0 - ns).expand(B)
        out = flash_attention(
            q_rot.reshape(B, Hkv, G * Tq_all, Dh).contiguous(),
            cache_l.k_planes[None], cache_l.v_planes[None],
            cache_l.kv_out[None], lq.k_range[None], lq.k_offset[None],
            cache_l.v_scale[None], cache_l.v_offset[None],
            cache_l.k_sink[None], cache_l.v_sink[None],
            lq.k_lut_dec[None], lq.v_lut_dec[None], 0, pos_first, dcfg, mcfg,
            Tq=Tq_all, k_ressc=lq.k_ressc[None],
        ).reshape(B, Hkv, G, Tq_all, Dh)
    else:
        inv = 1.0 / (Dh ** 0.5)
        if pallas:
            # the block's rows g-major, as one (G*Tq_all)-row K3 call
            from .kernels.attention import qk_fused, pv_fused

            scores = qk_fused(
                q_rot.reshape(B, Hkv, G * Tq_all, Dh), cache_l.k_planes,
                cache_l.kv_out, lq.k_range, lq.k_offset, lq.k_lut_dec, dcfg,
                mcfg).reshape(B, Hkv, G, Tq_all, Tc) * inv
        else:
            kx = _roped_keys(dequant_k_full(cache_l, lq, dcfg), dcfg, mcfg)
            scores = torch.einsum("bhgqd,bhtd->bhgqt", q_rot, kx) * inv
        if S > 0:
            sink_sc = torch.einsum("bhgqd,bhsd->bhgqs", q_rot,
                                   cache_l.k_sink) * inv
            scores = torch.cat([sink_sc, scores], dim=-1)
        idx = torch.arange(S + Tc, dtype=torch.int32, device=dev)
        valid = idx[None, :] <= positions[:, None]  # (Tq_all, S + Tc)
        if mcfg.sliding_window is not None:
            valid &= idx[None, :] > positions[:, None] - mcfg.sliding_window
        probs = torch.softmax(scores.masked_fill(~valid, float("-inf")),
                              dim=-1)
        if pallas:
            out = pv_fused(
                probs[..., S:].reshape(B, Hkv, G * Tq_all, Tc),
                cache_l.v_planes, cache_l.v_scale, cache_l.v_offset,
                cache_l.kv_out, lq.v_lut_dec, dcfg,
            ).reshape(B, Hkv, G, Tq_all, Dh)
        else:
            out = torch.einsum("bhgqt,bhtd->bhgqd", probs[..., S:],
                               dequant_v_full(cache_l, lq, dcfg))
        if S > 0:
            out = out + torch.einsum("bhgqs,bhsd->bhgqd", probs[..., :S],
                                     cache_l.v_sink)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Tq_all, Hkv * G * Dh)
    return cache_l, out
