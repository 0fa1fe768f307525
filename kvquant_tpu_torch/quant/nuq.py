"""Quantization math (port of kvquant_tpu/quant/nuq.py): codebook lookups of
the deployed datapath, and the simulated-quantization primitives of the
oracle (NormalFloat signposts, dynamic median-recentred ranges, integer
zero-point and LUT fake quantization).

``quantile`` / ``median`` reproduce ``jnp.quantile`` (linear interpolation)
and ``jnp.median`` (midpoint) in the same fp32 operations: sort, positions
``q * (n - 1)``, ``fma(low, 1 - w, high * w)``. ``torch.median`` returns the
lower middle of an even count and ``torch.quantile`` interpolates with
another formula and refuses inputs above 2**24 elements, so neither is used.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import ndtri  # float64 host-side (static table only)


def nearest_codes(x: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Index of the nearest entry of the ascending 1-D ``lut`` for every
    element of ``x`` (int32): the count of fp32 midpoints
    ``(lut[i]+lut[i+1])*0.5`` that ``x`` strictly exceeds, the JAX
    package's rule, so ties at a midpoint resolve identically and NaN (a
    zero-range channel's 0/0) exceeds none. One ``bucketize`` instead of
    the JAX package's 2**bits - 1 compares."""
    mids = (lut[:-1] + lut[1:]) * 0.5
    code = torch.bucketize(x, mids.to(x.dtype)).to(torch.int32)
    return code.masked_fill(torch.isnan(x), 0)


def lut_lookup(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``lut[codes]`` (fp32) for a 1-D codebook."""
    return lut.to(torch.float32)[codes.long()]


def nearest_values(x: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Round every element of ``x`` to its nearest entry of sorted ``lut``."""
    return lut_lookup(lut, nearest_codes(x, lut))


def nf_signposts(bits: int) -> np.ndarray:
    """NormalFloat signpost values in [-1, 1], 2**bits entries (the JAX
    package's construction: evenly spaced normal quantiles on each half,
    inverse-CDF'd, each half renormalized, the duplicate 0 merged)."""
    if bits < 2:
        raise ValueError("bits must be >= 2")
    half = 2 ** (bits - 1)
    lo_off = 0.5 * (1 / 32 + 1 / 30)
    hi_off = 1.0 - lo_off

    neg_q = lo_off + (0.5 - lo_off) / (half - 1) * np.arange(half)
    pos_q = np.concatenate(
        [0.5 + (hi_off - 0.5) / half * np.arange(half), [hi_off]]
    )
    neg = ndtri(neg_q)  # ascending, last value is ndtri(0.5) == 0
    pos = ndtri(pos_q)  # ascending, first value is 0
    neg = (neg + abs(neg[-1])) / (abs(neg[0]) - abs(neg[-1]))
    pos = (pos - abs(pos[0])) / (abs(pos[-1]) - abs(pos[0]))
    out = np.concatenate([neg, pos[1:]])  # drop duplicated 0
    assert out.shape == (2 ** bits,)
    return np.asarray(out, dtype=np.float32)


def _sorted_nan_poisoned(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` sorted along ``dim``, every slice holding a NaN all NaN (the
    JAX functions' NaN rule)."""
    x = x.to(torch.float32)
    nan = torch.isnan(x).any(dim=dim, keepdim=True)
    x = torch.where(nan, torch.full_like(x, float("nan")), x)
    return torch.sort(x, dim=dim).values


def quantile(x: torch.Tensor, q: float, dim: int,
             keepdim: bool = False) -> torch.Tensor:
    """``jnp.quantile(x, q, axis=dim, keepdims=keepdim)`` (linear)."""
    a = _sorted_nan_poisoned(x, dim)
    n = a.shape[dim]
    qq = torch.tensor(q, dtype=torch.float32) * torch.tensor(
        n - 1, dtype=torch.float32)
    low, high = torch.floor(qq), torch.ceil(qq)
    hw = qq - low
    lw = torch.tensor(1.0, dtype=torch.float32) - hw
    lo = int(min(max(float(low), 0.0), n - 1))
    hi = int(min(max(float(high), 0.0), n - 1))
    # XLA fuses low * lw into one fma with the high term: the product is
    # exact in float64, so one float64 add and one rounding reproduce it
    out = (a.narrow(dim, lo, 1).double() * float(lw)
           + (a.narrow(dim, hi, 1) * hw).double()).to(torch.float32)
    return out if keepdim else out.squeeze(dim)


def median(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """``jnp.median(x, axis=dim, keepdims=keepdim)``: the mean of the two
    middle values of an even count."""
    a = _sorted_nan_poisoned(x, dim)
    n = a.shape[dim]
    out = (a.narrow(dim, (n - 1) // 2, 1) + a.narrow(dim, n // 2, 1)) * 0.5
    return out if keepdim else out.squeeze(dim)


def dynamic_minmax(x, axis, outlier_mask=None):
    """Per-slice min/max along ``axis``; outlier positions replaced by the
    slice median first so they don't skew the quantization range."""
    x = x.to(torch.float32)
    if outlier_mask is not None:
        med = median(x, axis, keepdim=True)
        x = torch.where(outlier_mask, med, x)
    return (torch.amin(x, dim=axis, keepdim=True),
            torch.amax(x, dim=axis, keepdim=True))


def _expand(v: torch.Tensor, axis: int) -> torch.Tensor:
    """Unsqueeze pre-reduced per-slice stats along ``axis`` (no-op if already
    broadcastable with a keepdims reduction)."""
    if v.dim() == 0:
        return v
    return v.unsqueeze(axis) if v.dim() < 2 or v.shape[axis] != 1 else v


def _as_f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def quant_zp(x, bits: int, axis: int = -1, minval=None, maxval=None,
             outlier_mask=None, dynamic: bool = False, clamp: bool = False):
    """Simulated asymmetric integer quantization. Outlier positions (where
    ``outlier_mask``) pass through exactly; ``clamp`` rounds / clamps the
    zero point."""
    x = x.to(torch.float32)
    if dynamic:
        minval, maxval = dynamic_minmax(x, axis, outlier_mask)
    else:
        minval = _expand(_as_f32(minval, x), axis)
        maxval = _expand(_as_f32(maxval, x), axis)
    qx = (2 ** bits - 1) / (maxval - minval)
    offset = minval * qx
    if clamp:
        offset = torch.clamp(torch.round(offset), -(2 ** bits - 1), 0)
    dense = torch.where(outlier_mask, torch.zeros_like(x), x) \
        if outlier_mask is not None else x
    q = torch.clamp(torch.round(qx * dense - offset), 0, 2 ** bits - 1)
    deq = _finite_or_zero((q + offset) / qx)
    if outlier_mask is not None:
        deq = torch.where(outlier_mask, x, deq)
    return deq


def sink_rows(x: torch.Tensor, sink: int, token_axis: int) -> torch.Tensor:
    """Boolean, broadcastable against ``x``: token index < ``sink`` along
    ``token_axis``."""
    ax = token_axis % x.dim()
    shape = [1] * x.dim()
    shape[ax] = x.shape[ax]
    return (torch.arange(x.shape[ax], device=x.device) < sink).reshape(shape)


def quant_lut(x, lut, axis: int = -1, minval=None, maxval=None,
              outlier_mask=None, dynamic: bool = False, normscale=None,
              normoffset=None, sink: int = 0, token_axis: int = 0):
    """Simulated LUT quantization (NUQ codebooks and NormalFloat): shift /
    scale into [-1, 1] with the static or dynamic range along ``axis``,
    round to the nearest sorted LUT entry, optionally Q-Norm rescale
    (``q*normscale + normoffset``), map back. Outlier positions and the
    first ``sink`` tokens along ``token_axis`` pass through exactly."""
    x = x.to(torch.float32)
    lut = torch.sort(_as_f32(lut, x).reshape(-1)).values
    if dynamic:
        minval, maxval = dynamic_minmax(x, axis, outlier_mask)
    else:
        minval = _expand(_as_f32(minval, x), axis)
        maxval = _expand(_as_f32(maxval, x), axis)
    offset = (maxval + minval) * 0.5
    rangeval = (maxval - minval) * 0.5
    q = nearest_values((x - offset) / rangeval, lut)
    if normscale is not None:
        q = q * normscale + normoffset
    deq = _finite_or_zero(q * rangeval + offset)
    if outlier_mask is not None:
        deq = torch.where(outlier_mask, x, deq)
    if sink > 0:
        deq = torch.where(sink_rows(x, sink, token_axis), x, deq)
    return deq
