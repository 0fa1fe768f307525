"""Rates and tails over all the work of a window: every token emitted in
it, every gap between two tokens of one request in it, every request due
in it. Percentiles interpolate linearly between order statistics (numpy's
default)."""

from __future__ import annotations

import math

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile; +inf counts as a value (a request that never
    got its first token misses every limit)."""
    v = np.asarray(list(values), np.float64)
    if v.size == 0:
        return math.nan
    if np.isinf(v).any():
        v = np.sort(v)
        k = (v.size - 1) * q / 100.0
        lo, hi = v[int(math.floor(k))], v[int(math.ceil(k))]
        return float(lo if lo == hi else lo + (hi - lo) * (k - math.floor(k)))
    return float(np.percentile(v, q))


def tokens_in(reqs, t0: float, t1: float) -> int:
    return sum(sum(1 for t in r.token_t if t0 < t <= t1) for r in reqs)


def gaps_in(reqs, t0: float, t1: float) -> list[float]:
    """Seconds between consecutive tokens of one request, both emitted in
    (t0, t1]."""
    out = []
    for r in reqs:
        ts = [t for t in r.token_t if t0 < t <= t1]
        out.extend(b - a for a, b in zip(ts, ts[1:]))
    return out


def ttfts(reqs, t0: float, t1: float) -> list[float]:
    """Due time to first token of every request due in [t0, t1); inf for
    one that never got a token."""
    return [(r.token_t[0] - r.due) if r.token_t else math.inf
            for r in reqs if t0 <= r.due < t1]
