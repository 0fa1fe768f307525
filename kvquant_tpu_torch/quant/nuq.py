"""Codebook primitives of the deployed datapath (port of
kvquant_tpu/quant/nuq.py:28-59)."""

from __future__ import annotations

import torch


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
