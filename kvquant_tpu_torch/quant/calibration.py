"""Calibration: fit per-layer K / V quantizers from captured activations
(port of kvquant_tpu/quant/calibration.py, the reference's SimQuant.quantize
semantics).

K (per channel, thresholds shared along the token axis):
  1. percentile thresholds at t = 1-(1-sparsity)/2 along tokens;
  2. optional capped-outlier recomputation: the top-cap rescaled
     magnitudes per token (and the sink tokens) replaced by the channel
     median, the trimmed min / max as the final thresholds;
  3. normalize to [-1, 1] with the threshold midrange, mask outliers and
     sink tokens, fit 2**bits normalized centroids (weighted k-means, or
     NormalFloat / uniform grids);
  4. optional Q-Norm: an affine (scale, offset) matching the pre-quant
     mean / stdev over non-outliers.
V (per token): the same flow with per-token thresholds (informational: the
runtime V range is dynamic).

Medians and quantiles are ``jnp.median`` / ``jnp.quantile``'s (quant.nuq)
and top-k selections ``jax.lax.top_k``'s order (utils.topk), so a
NormalFloat fit equals the JAX package's and a uniform one does up to an
ulp in its grid (``uniform_lut``); k-means seeds differ (quant.kmeans).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.topk import top_k
from .artifacts import KQuantizer, LayerQuantizers, QuantizerSet, VQuantizer
from .kmeans import weighted_kmeans_1d
from .nuq import median, nearest_values, nf_signposts, quantile


def collect_kv_activations(params, cfg, batches, rope_k: bool = False):
    """Run the model over calibration batches capturing the pre-RoPE K / V
    projections: (k_acts, v_acts) (L, N_tokens, C) fp32 on the params'
    device, token rows concatenated across batches. ``rope_k`` rotates the
    captured keys at their sequence positions first (the calibration signal
    of post-RoPE K storage)."""
    from ..models import get_forward

    forward = get_forward(cfg)
    dev = params.embed.device
    ks, vs = [], []
    with torch.no_grad():
        for tokens in batches:
            aux = forward(params, cfg, torch.as_tensor(tokens).to(dev),
                          capture_kv=True)[1]
            k_act = aux["k_acts"]  # (L, B, T, C)
            if rope_k:
                k_act = rope_k_activations(k_act, cfg)
            L = k_act.shape[0]
            ks.append(k_act.reshape(L, -1, k_act.shape[-1]))
            vs.append(aux["v_acts"].reshape(L, -1, aux["v_acts"].shape[-1]))
    return torch.cat(ks, dim=1), torch.cat(vs, dim=1)


def rope_k_activations(k_acts, cfg):
    """(L, B, T, C) pre-RoPE keys -> the same, rotated at positions 0..T-1."""
    from ..models.llama import rope_cos_sin, rotate_half

    L, B, T, C = k_acts.shape
    Hkv, Dh = cfg.n_kv_heads, cfg.d_head
    cos, sin = rope_cos_sin(torch.arange(T, dtype=torch.int32,
                                         device=k_acts.device), cfg)
    kh = k_acts.reshape(L, B, T, Hkv, Dh).to(torch.float32)
    kh = kh * cos[:, None] + rotate_half(kh) * sin[:, None]
    return kh.reshape(L, B, T, C)


def _qnorm_affine(xn, q, keep_w):
    """Q-Norm scale / offset so the quantized stats match the pre-quant
    stats over non-outliers."""
    wsum = torch.sum(keep_w)
    m1 = torch.sum(xn * keep_w) / wsum
    s1 = torch.sqrt(torch.sum(((xn - m1) * keep_w) ** 2) / wsum)
    m2 = torch.sum(q * keep_w) / wsum
    s2 = torch.sqrt(torch.sum(((q - m2) * keep_w) ** 2) / wsum)
    scale = s1 / s2
    return scale, -m2 * scale + m1


def uniform_lut(bits: int, device=None) -> torch.Tensor:
    """``jnp.linspace(-1, 1, 2**bits)``'s formula in fp32:
    ``-1*(1 - i/n) + 1*(i/n)``, the last entry exactly 1 (XLA's CPU
    division may round an entry one ulp otherwise)."""
    n = 2 ** bits - 1
    step = torch.arange(n, dtype=torch.float32, device=device) / float(n)
    out = -1.0 * (1 - step) + 1.0 * step
    return torch.cat([out, torch.ones(1, dtype=torch.float32, device=device)])


def fit_channel_quantizer(
    acts,  # (N_tokens, C) fp32: all calibration tokens concatenated
    bits: int,
    *,
    axis: int = 0,  # axis along which thresholds are shared (0: per channel)
    sparsity_threshold: float = 0.99,
    include_sparse: bool = True,
    cap_outliers: bool = False,
    first_few_fp16: int = -1,
    sample_seqlen: int = 2048,  # sink positions repeat every sample
    fisher=None,  # (N_tokens, C) or None
    qnorm: bool = False,
    seed: int = 0,
    kmeans_iters: int = 50,
    mode: str = "nuq",  # "nuq" (weighted k-means), "nf" (NormalFloat), or
                        # "uniform" (evenly spaced grid)
):
    """Returns dict(upper, lower, lut (2**bits,), normscale, normoffset[,
    ressc]) as numpy arrays / floats."""
    acts = torch.as_tensor(acts).to(torch.float32)
    dev = acts.device
    t = 1.0 - (1.0 - sparsity_threshold) / 2.0 if include_sparse else 1.0

    upper = quantile(acts, t, axis)
    lower = quantile(acts, 1.0 - t, axis)

    n_tok, C = acts.shape
    sink_mask = None
    if first_few_fp16 > 0:
        pos_in_sample = torch.arange(n_tok, device=dev) % sample_seqlen
        sink_mask = (pos_in_sample < first_few_fp16)[:, None]

    if cap_outliers and axis == 0:
        # tokenwise cap -> median fill -> trimmed thresholds
        zp = (upper + lower) * 0.5
        dist = (upper - lower) * 0.5
        resc = torch.abs((acts - zp) / dist)
        cap = max(1, int(math.ceil((1.0 - t) * C)))
        omask = torch.zeros(acts.shape, dtype=torch.bool, device=dev)
        omask.scatter_(-1, top_k(resc, cap)[1], True)
        omask.scatter_(-1, top_k(-resc, cap)[1], True)
        if sink_mask is not None:
            omask |= sink_mask
        trimmed = torch.where(omask, median(acts, 0, keepdim=True), acts)
        upper = torch.amax(trimmed, dim=0)
        lower = torch.amin(trimmed, dim=0)

    zp = ((upper + lower) * 0.5).unsqueeze(axis)
    rng = ((upper - lower) * 0.5).unsqueeze(axis)
    xn = (acts - zp) / rng

    outlier_mask = (xn > 1.0) | (xn < -1.0)
    if sink_mask is not None:
        outlier_mask |= sink_mask

    w = torch.ones_like(acts) if fisher is None else torch.as_tensor(
        fisher, dtype=torch.float32, device=dev)
    w = torch.where(outlier_mask, torch.zeros_like(w), w)

    if mode == "nf":
        lut = torch.as_tensor(nf_signposts(bits), device=dev)
    elif mode == "uniform":
        lut = uniform_lut(bits, dev)
    else:
        lut, _ = weighted_kmeans_1d(xn.reshape(-1), w.reshape(-1),
                                    k=2 ** bits, iters=kmeans_iters,
                                    seed=seed)

    out = dict(
        upper=upper.cpu().numpy().astype(np.float32),
        lower=lower.cpu().numpy().astype(np.float32),
        lut=lut.cpu().numpy().astype(np.float32),
        normscale=None,
        normoffset=None,
    )
    if axis == 0:
        # per-channel expected squared residual after quantization: the
        # selection signal of static-channel K outliers (Fisher-weighted
        # when given, so selection tracks loss impact)
        deq_n = nearest_values(torch.clamp(xn, -1.0, 1.0), lut)
        r = (xn - deq_n) * rng
        wsc = torch.ones_like(r) if fisher is None else torch.as_tensor(
            fisher, dtype=torch.float32, device=dev)
        out["ressc"] = torch.mean(wsc * r * r, dim=0).cpu().numpy().astype(
            np.float32)
    if qnorm:
        q = nearest_values(xn, lut)
        keep = torch.where(outlier_mask, 0.0, 1.0)
        scale, off = _qnorm_affine(xn, q, keep)
        out["normscale"] = float(scale)
        out["normoffset"] = float(off)
    return out


def fit_quantizers(
    k_acts,  # (L, N_tokens, C) key activations (pre-RoPE, or roped)
    v_acts,  # (L, N_tokens, C)
    bits: int,
    *,
    sparsity_threshold: float = 0.99,
    include_sparse: bool = True,
    cap_outliers: bool = True,
    first_few_fp16: int = -1,
    sample_seqlen: int = 2048,
    fisher_k=None,  # (L, N_tokens, C) squared gradients, or None
    fisher_v=None,
    qnorm: bool = False,
    seed: int = 0,
    kmeans_iters: int = 50,
    mode: str = "nuq",
    meta: dict | None = None,
) -> QuantizerSet:
    layers = []
    for i in range(k_acts.shape[0]):
        kq = fit_channel_quantizer(
            k_acts[i], bits, axis=0,
            sparsity_threshold=sparsity_threshold,
            include_sparse=include_sparse, cap_outliers=cap_outliers,
            first_few_fp16=first_few_fp16, sample_seqlen=sample_seqlen,
            fisher=None if fisher_k is None else fisher_k[i],
            qnorm=qnorm, seed=seed, kmeans_iters=kmeans_iters, mode=mode,
        )
        vq = fit_channel_quantizer(
            v_acts[i], bits, axis=1,
            sparsity_threshold=sparsity_threshold,
            include_sparse=include_sparse, cap_outliers=False,
            first_few_fp16=first_few_fp16, sample_seqlen=sample_seqlen,
            fisher=None if fisher_v is None else fisher_v[i],
            qnorm=qnorm, seed=seed, kmeans_iters=kmeans_iters, mode=mode,
        )
        layers.append(LayerQuantizers(
            k=KQuantizer(upper=kq["upper"], lower=kq["lower"], lut=kq["lut"],
                         normscale=kq["normscale"],
                         normoffset=kq["normoffset"], ressc=kq.get("ressc")),
            v=VQuantizer(lut=vq["lut"], normscale=vq["normscale"],
                         normoffset=vq["normoffset"], upper=vq["upper"],
                         lower=vq["lower"]),
        ))
    return QuantizerSet(
        layers=layers, bits=bits, sparsity_threshold=sparsity_threshold,
        cap_outliers=cap_outliers, first_few_fp16=max(0, first_few_fp16),
        meta=meta or {},
    )
