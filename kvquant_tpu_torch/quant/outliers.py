"""Outlier detection (port of kvquant_tpu/quant/outliers.py): the per-token
slot budget, static thresholds, dynamic percentiles, capped per-token and
per-head budgets, attention-sink retention.

The capped selections rank with ``utils.topk.top_k`` (``jax.lax.top_k``'s
order: +0.0 above -0.0, ties to the lower index), so the same elements are
kept where several tie."""

from __future__ import annotations

import torch

from ..utils.topk import top_k
from .nuq import sink_rows, quantile


def outlier_budget_per_side(kv_hidden: int, sparsity_threshold: float) -> int:
    """Per-side outlier slot count for one token: int(((1-s)/2)*hidden)+1,
    e.g. hidden=4096, s=0.99 -> 21 (42 total slots/token)."""
    return int(((1.0 - sparsity_threshold) / 2.0) * kv_hidden) + 1


def _per_slice(v, x: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-slice thresholds (C,) as fp32, unsqueezed along ``axis``."""
    return torch.as_tensor(v, dtype=torch.float32,
                           device=x.device).reshape(-1).unsqueeze(axis)


def static_outlier_mask(x, lower, upper, axis: int = 0):
    """Elements strictly outside per-slice thresholds shared along ``axis``
    (per-channel K outliers use the token axis)."""
    lower = _per_slice(lower, x, axis).to(x.dtype)
    upper = _per_slice(upper, x, axis).to(x.dtype)
    return (x < lower) | (x > upper)


def dynamic_outlier_mask(x, thresh: float = 0.999, axis: int = -1):
    """Percentile-threshold mask, computed online (non-strict comparisons)."""
    t = 1.0 - (1.0 - thresh) / 2.0
    x = x.to(torch.float32)
    upper = quantile(x, t, axis, keepdim=True)
    lower = quantile(x, 1.0 - t, axis, keepdim=True)
    return (x <= lower) | (x >= upper)


def _two_sided_keep(signed: torch.Tensor, cap: int) -> torch.Tensor:
    """The top-``cap`` of ``signed`` and of ``-signed`` along the last axis,
    each kept only where its value is > 0."""
    top_v, top_i = top_k(signed, cap)
    bot_v, bot_i = top_k(-signed, cap)
    idx = torch.cat([top_i, bot_i], dim=-1)
    val = torch.cat([top_v, bot_v], dim=-1)
    kept = torch.zeros_like(signed).scatter(
        -1, idx, torch.where(val > 0, 1.0, 0.0))
    return kept > 0


def _headwise_signed(xn: torch.Tensor) -> torch.Tensor:
    """|xn| beyond 1 with xn's sign, 0 inside [-1, 1]."""
    resc = torch.where(xn.abs() > 1.0, xn.abs(), torch.zeros_like(xn))
    return torch.where(xn > 0, resc, -resc)


def capped_outlier_mask_headwise(x, lower, upper, cap_per_side: int,
                                 n_kv_heads: int):
    """Static-threshold outliers with a fixed per-(token, kv-head) budget,
    the deployed storage scheme. x: (..., C) with C = Hkv*D; lower / upper
    (C,). Returns a bool mask of the selected (stored-exact) elements."""
    *lead, C = x.shape
    D = C // n_kv_heads
    xf = x.to(torch.float32)
    lower = torch.as_tensor(lower, dtype=torch.float32,
                            device=x.device).reshape(-1)
    upper = torch.as_tensor(upper, dtype=torch.float32,
                            device=x.device).reshape(-1)
    zp = (upper + lower) * 0.5
    hr = (upper - lower) * 0.5
    xn = ((xf - zp) / hr).reshape(*lead, n_kv_heads, D)
    return _two_sided_keep(_headwise_signed(xn), cap_per_side).reshape(
        *lead, C)


def headwise_range_outlier_mask(x, minval, maxval, cap_per_side: int,
                                n_kv_heads: int):
    """Per-head fixed-budget selection of elements beyond a per-token range,
    the deployed V scheme. x: (..., C); minval / maxval (..., 1)."""
    *lead, C = x.shape
    D = C // n_kv_heads
    xf = x.to(torch.float32)
    offset = (maxval + minval) * 0.5
    scale = (maxval - minval) * 0.5
    xn = ((xf - offset) / scale).reshape(*lead, n_kv_heads, D)
    return _two_sided_keep(_headwise_signed(xn), cap_per_side).reshape(
        *lead, C)


def capped_outlier_mask(x, lower, upper, cap_per_side: int, axis: int = 0):
    """Static-threshold outliers capped to ``cap_per_side`` per side along
    the last axis. Returns (mask, rescaled): ``rescaled`` is the threshold-
    normalized value (x - zp) / halfrange at the outliers, 0 elsewhere."""
    lower = _per_slice(lower, x, axis)
    upper = _per_slice(upper, x, axis)
    x = x.to(torch.float32)
    base = (x < lower) | (x > upper)
    zp = (upper + lower) * 0.5
    dist = (upper - lower) * 0.5
    rescaled = torch.where(base, (x - zp) / dist, torch.zeros_like(x))
    top_v, top_i = top_k(rescaled, cap_per_side)
    bot_v, bot_i = top_k(-rescaled, cap_per_side)
    idx = torch.cat([top_i, bot_i], dim=-1)
    val = torch.cat([top_v, -bot_v], dim=-1)
    kept = torch.zeros_like(rescaled).scatter(-1, idx, val)
    return kept != 0.0, rescaled


def apply_sink_mask(mask, sink: int, token_axis: int = 0):
    """Mark the first ``sink`` tokens (along ``token_axis``) retained-exact."""
    if sink <= 0:
        return mask
    return mask | sink_rows(mask, sink, token_axis)
