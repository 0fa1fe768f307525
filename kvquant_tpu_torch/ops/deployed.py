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
  - positions are host integers: ``pos`` is an int (every sequence at the
    same position) or a sequence/tensor of B ints (per-sample positions).
"""

from __future__ import annotations

import torch

from ..cache import KVCache, DeployConfig, DeployedQuant, k_channel_index
from ..models.config import ModelConfig
from ..models.llama import rope_cos_sin, rotate_half
from ..quant.nuq import nearest_codes, lut_lookup
from ..utils.topk import top_k
from .packing import (
    unpack_codes, set_token_codes, set_token_codes_at_layer,
    set_token_codes_at_layer_uniform, place_planes,
    store_codes_int, load_codes_int, place_codes_int,
    pair_codes_int4x2, unpair_codes_int4x2, place_codes_int4x2,
    set_token_rows, set_token_rows_at_layer,
    encode_outlier_words, decode_outlier_words, OUTLIER_DIM_MASK,
)


def host_positions(pos, B: int) -> list[int]:
    """``pos`` (int, sequence or tensor) as B host integers."""
    if isinstance(pos, torch.Tensor):
        pos = pos.tolist()
    if isinstance(pos, (list, tuple)):
        assert len(pos) == B, (len(pos), B)
        return [int(p) for p in pos]
    return [int(pos)] * B


def _stored_codes(planes, dcfg: DeployConfig):
    """Code storage -> unsigned int32 codes (..., Hkv, Tc, D)."""
    if dcfg.codes == "nuq":
        return unpack_codes(planes, dcfg.bits)
    if dcfg.codes == "int4x2":
        return unpair_codes_int4x2(planes)
    return load_codes_int(planes, dcfg.bits)


def _encode_rows(codes, dcfg: DeployConfig):
    """Unsigned codes (..., Hkv, D) -> container rows (..., H', Dc) for
    the integer containers (bit planes are written by set_token_codes)."""
    if dcfg.codes == "int4x2":
        return pair_codes_int4x2(codes)
    return store_codes_int(codes, dcfg.bits, dcfg.code_dtype)


def _place_codes(arr, codes, p0: int, dcfg: DeployConfig):
    """Aligned block write of unsigned codes (..., T, Hkv, D) into the code
    storage (..., H', Tc, Dc) or bit planes (..., Hkv, bits, TW, D), in
    place."""
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


def quantize_k(k, lq: DeployedQuant, dcfg: DeployConfig):
    """Quantize keys (..., C) -> (codes (..., Hkv, D) int32, outlier rows
    (..., n_groups, slots_per_kind) fp32 or None). "channels" mode: the rows
    are the plain residuals x - dequant at the layer's static channels."""
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
            idx = k_channel_index(lq.k_ressc, dcfg)  # (G, n_kc)
            resid = (kf - deq).reshape(gshape)
            out_words = torch.gather(
                resid, -1, idx.expand(*resid.shape[:-1], idx.shape[-1]))
        else:
            out_words = _group_outlier_words(
                kf.reshape(gshape), xn.reshape(gshape), deq.reshape(gshape),
                dcfg,
            )
    return codes, out_words


def quantize_v(v, lq: DeployedQuant, dcfg: DeployConfig):
    """Quantize values (..., C) -> (codes (..., Hkv, D), outlier words
    (..., n_groups, n_slots - slots_per_kind) or None, scale (...,),
    offset (...,)); the range is the (r+1)-th global extreme each side."""
    Hkv, D = dcfg.n_kv_heads, dcfg.d_head
    vf = v.to(torch.float32)
    r = dcfg.v_range_exclude
    # values only: torch.topk's tie order does not matter here
    maxval = torch.topk(vf, r + 1, dim=-1).values[..., -1:]
    minval = -torch.topk(-vf, r + 1, dim=-1).values[..., -1:]
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
                   with_outliers: bool = True):
    """(B, Hkv, Tc, D) fp32 keys (dense [+ sparse])."""
    codes = _stored_codes(cache_l.k_planes, dcfg)
    deq = lut_lookup(lq.k_lut_dec, codes) * lq.k_range[:, None, :] + (
        lq.k_offset[:, None, :])
    if dcfg.include_sparse and with_outliers:
        rows = cache_l.kv_out[:, :, : dcfg.slots_per_kind]
        if dcfg.k_outliers == "channels":
            B, Gp, N, Tc = rows.shape
            D, hg = dcfg.d_head, dcfg.head_group
            idx = k_channel_index(lq.k_ressc, dcfg)  # (G, n_kc)
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


def _append_layer(cache_l: KVCache, dcfg: DeployConfig, codes, words, row0,
                  planes_name, p: list[int], not_sink: list[bool]):
    """Per-sample row writes of one kind (K or V) into a layer cache."""
    planes = getattr(cache_l, planes_name)
    if dcfg.codes == "nuq":
        for b, (pb, ok) in enumerate(zip(p, not_sink)):
            set_token_codes(planes[b], codes[b], pb, ok)
    else:
        rows = _encode_rows(codes, dcfg)
        for b, (pb, ok) in enumerate(zip(p, not_sink)):
            set_token_rows(planes[b], rows[b], pb, ok)
    for b, (pb, ok) in enumerate(zip(p, not_sink)):
        if ok and words is not None:
            cache_l.kv_out[b, :, row0:row0 + words.shape[-1], pb] = words[b]


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
                     mcfg: ModelConfig, q, k_new, v_new, pos):
    """Append each sample's token at its position to the single-layer cache
    (in place) and attend over positions 0..pos. q (B, H, Dh) un-roped,
    k_new/v_new (B, C). Returns (cache_l, out (B, H, Dh)). kernel "pallas"
    scores through K3 and weights the values through K4; every other
    kernel attends over the eagerly dequantized cache."""
    pallas = dcfg.kernel == "pallas"
    if pallas:
        _assert_two_pass(dcfg)
    B = q.shape[0]
    S, Tc = dcfg.sink, dcfg.cache_tokens
    Hkv, Dh = dcfg.n_kv_heads, dcfg.d_head
    G = q.shape[1] // Hkv
    dev = q.device

    pl = host_positions(pos, B)
    not_sink = [p >= S for p in pl]
    p = [min(max(x - S, 0), Tc - 1) for x in pl]
    post = torch.tensor(pl, dtype=torch.int32, device=dev)
    cos, sin = rope_cos_sin(post, mcfg)  # (B, Dh)

    # ---- append K ----
    k_h = k_new.reshape(B, Hkv, Dh).to(torch.float32)
    k_roped = k_h * cos[:, None] + rotate_half(k_h) * sin[:, None]
    k_store = k_roped.reshape(B, Hkv * Dh) if dcfg.post_rope_k else k_new
    codes_k, k_words = quantize_k(k_store, lq, dcfg)
    for b in range(B):
        if S > 0 and not not_sink[b]:
            cache_l.k_sink[b, :, pl[b]] = k_roped[b]
    _append_layer(cache_l, dcfg, codes_k,
                  k_words if dcfg.include_sparse else None, 0,
                  "k_planes", p, not_sink)

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
        k_full = _roped_keys(dequant_k_full(cache_l, lq, dcfg), dcfg, mcfg)
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

    # ---- append V ----
    codes_v, v_words, v_sc, v_off = quantize_v(v_new, lq, dcfg)
    v_h = v_new.reshape(B, Hkv, Dh).to(torch.float32)
    for b in range(B):
        if not_sink[b]:
            cache_l.v_scale[b, p[b]] = v_sc[b]
            cache_l.v_offset[b, p[b]] = v_off[b]
        elif S > 0:
            cache_l.v_sink[b, :, pl[b]] = v_h[b]
    _append_layer(cache_l, dcfg, codes_v,
                  v_words if dcfg.include_sparse else None,
                  dcfg.slots_per_kind, "v_planes", p, not_sink)
    cache_l.length.copy_(post + 1)

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
                       mcfg: ModelConfig, k_new, v_new, pos, li: int) -> dict:
    """Append one token at layer ``li`` directly into the stacked (L, B, ...)
    arrays (in place; ``arrs`` is returned). An int ``pos`` takes one
    batch-wide row write per array; per-sample positions write each
    sample's row in turn. Tokens inside the sink prefix go to the exact
    sink rows and leave the packed arrays untouched."""
    B = k_new.shape[0]
    S, Tc = dcfg.sink, dcfg.cache_tokens
    Hkv, Dh = dcfg.n_kv_heads, dcfg.d_head
    dev = k_new.device

    pl = host_positions(pos, B)
    cos, sin = rope_cos_sin(torch.tensor(pl, dtype=torch.int32, device=dev),
                            mcfg)
    k_h = k_new.reshape(B, Hkv, Dh).to(torch.float32)
    k_roped = k_h * cos[:, None] + rotate_half(k_h) * sin[:, None]
    k_store = k_roped.reshape(B, Hkv * Dh) if dcfg.post_rope_k else k_new
    codes_k, k_words = quantize_k(k_store, lq, dcfg)
    codes_v, v_words, v_sc, v_off = quantize_v(v_new, lq, dcfg)
    nuq = dcfg.codes == "nuq"
    rows_k = codes_k if nuq else _encode_rows(codes_k, dcfg)  # (B, H', Dc)
    rows_v = codes_v if nuq else _encode_rows(codes_v, dcfg)
    put_uniform = set_token_codes_at_layer_uniform if nuq else (
        lambda a, r, li_, p_: set_token_rows(a[li_], r, p_))
    put_sample = set_token_codes_at_layer if nuq else set_token_rows_at_layer
    v_h = v_new.reshape(B, Hkv, Dh).to(torch.float32)
    spk = dcfg.slots_per_kind

    if not isinstance(pos, (list, tuple, torch.Tensor)):
        # uniform position: one batch-wide row write per array
        p0 = min(max(pl[0] - S, 0), Tc - 1)
        if pl[0] >= S:
            put_uniform(arrs["k_planes"], rows_k, li, p0)
            put_uniform(arrs["v_planes"], rows_v, li, p0)
            if dcfg.include_sparse:
                arrs["kv_out"][li, :, :, :spk, p0] = k_words
                if v_words is not None:
                    arrs["kv_out"][li, :, :, spk:spk + v_words.shape[-1],
                                   p0] = v_words
            arrs["v_scale"][li, :, p0] = v_sc
            arrs["v_offset"][li, :, p0] = v_off
        elif S > 0:
            arrs["k_sink"][li, :, :, pl[0], :] = k_roped
            arrs["v_sink"][li, :, :, pl[0], :] = v_h
        return arrs

    # per-sample positions (serving slot pools): one row write per sample
    for b in range(B):
        if pl[b] >= S:
            pb = min(pl[b] - S, Tc - 1)
            put_sample(arrs["k_planes"][:, b], rows_k[b], li, pb)
            put_sample(arrs["v_planes"][:, b], rows_v[b], li, pb)
            if dcfg.include_sparse:
                arrs["kv_out"][li, b, :, :spk, pb] = k_words[b]
                if v_words is not None:
                    arrs["kv_out"][li, b, :, spk:spk + v_words.shape[-1],
                                   pb] = v_words[b]
            arrs["v_scale"][li, b, pb] = v_sc[b]
            arrs["v_offset"][li, b, pb] = v_off[b]
        elif S > 0:
            arrs["k_sink"][li, b, :, pl[b], :] = k_roped[b]
            arrs["v_sink"][li, b, :, pl[b], :] = v_h[b]
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
    codes_v, v_words, v_sc, v_off = quantize_v(v[:, S:], lq, dcfg)
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
                    mcfg: ModelConfig, q, k_new, v_new, pos0: int,
                    sink_fill: bool = False):
    """Pack a block of tokens into the single-layer cache (in place) and
    attend for every query of the block over cache positions 0..its own,
    so each query sees the dequantized values a later decode step would.

    q (B, Tq_all, H, Dh) un-roped; k_new / v_new (B, Tq_all, C) pre-RoPE;
    ``pos0`` is the absolute position of the block's first NON-sink token
    (``pos0 - sink`` 128-aligned); with ``sink_fill`` the first ``sink``
    rows are the sink tokens (block 0 of a prefill). kernel "flash" /
    "flash_serial" attends through K1 (``kernels.flash_decode.
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
    pos0 = int(pos0)
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
    codes_v, v_words, v_sc, v_off = quantize_v(vq, lq, dcfg)

    p0 = max(pos0 - S, 0)  # packed offset of the block
    assert p0 + Tq <= Tc, f"block [{p0}, {p0 + Tq}) exceeds capacity {Tc}"
    _place_codes(cache_l.k_planes, codes_k, p0, dcfg)
    _place_codes(cache_l.v_planes, codes_v, p0, dcfg)
    if dcfg.include_sparse:
        kv_words = k_words if v_words is None else torch.cat(
            [k_words, v_words], dim=-1)
        # (B, Tq, G, J) -> (B, G, J, Tq) token axis last
        cache_l.kv_out[..., :kv_words.shape[-1], p0:p0 + Tq] = \
            kv_words.permute(0, 2, 3, 1)
    cache_l.v_scale[:, p0:p0 + Tq] = v_sc
    cache_l.v_offset[:, p0:p0 + Tq] = v_off
    cache_l.length.fill_(pos0 + Tq)

    # ---- attention for every query of the block ----
    q_h = q.reshape(B, Tq_all, Hkv, G, Dh).to(torch.float32)
    q_rot = q_h * cos[:, None, None] + rotate_half(q_h) * sin[:, None, None]
    q_rot = q_rot.permute(0, 2, 3, 1, 4)  # (B, Hkv, G, Tq_all, Dh)

    if dcfg.kernel in ("flash", "flash_serial"):
        # one K1 call over the whole block: every row masked to its own
        # position in-kernel, nothing of O(Tq x Tc) materialized; rows are
        # g-major, row r at position pos_first + r % Tq_all
        from .kernels.flash_decode import flash_attention

        pos_first = torch.full((B,), pos0 - ns, dtype=torch.int32, device=dev)
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
