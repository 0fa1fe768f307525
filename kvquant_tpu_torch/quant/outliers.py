"""Outlier budget (port of kvquant_tpu/quant/outliers.py:24; the masks of
that module belong to the simulated-quant path of a later slice)."""

from __future__ import annotations


def outlier_budget_per_side(kv_hidden: int, sparsity_threshold: float) -> int:
    """Per-side outlier slot count for one token: int(((1-s)/2)*hidden)+1,
    e.g. hidden=4096, s=0.99 -> 21 (42 total slots/token)."""
    return int(((1.0 - sparsity_threshold) / 2.0) * kv_hidden) + 1
