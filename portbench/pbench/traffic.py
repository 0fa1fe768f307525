"""Seeded traffic: request sizes, prompt tokens and arrival times.

One generator reads any traffic file. Sizes come from a fixed pool of
``pool`` values per distribution, taken at the quantiles (i + 0.5) / pool,
and (open loop) inter-arrival gaps from a pool of Exp(rate) quantiles.
Every seed runs the same pools, in an order drawn from the run's seed:
sizes in strata (every ``strata`` consecutive requests hold one size from
each ``strata``-th of the pool, so any stretch of a run has the mix of the
whole), gaps in a plain random order, so arrivals bunch and thin out as a
Poisson process's do. The seed changes the tokens and the order, not how
much work there is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class Req:
    """One request as the generator makes it: ``prompt`` (T,) int32 token
    ids, ``answer`` the tokens to serve, ``due`` seconds after the start of
    the schedule (open loop; 0 in a closed loop)."""
    idx: int
    prompt: np.ndarray
    answer: int
    due: float = 0.0


def quantile(dist: dict, q: np.ndarray) -> np.ndarray:
    """The ``dist`` of a traffic file at quantiles ``q``: ``uniform`` or
    ``loguniform`` over [min, max], rounded to whole tokens."""
    lo, hi = float(dist["min"]), float(dist["max"])
    if dist["dist"] == "uniform":
        x = lo + (hi - lo) * q
    elif dist["dist"] == "loguniform":
        x = np.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * q)
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def pool(dist: dict, n: int) -> np.ndarray:
    return quantile(dist, (np.arange(n) + 0.5) / n)


def stratified(rng, values: np.ndarray, strata: int) -> np.ndarray:
    """``values`` (sorted, a multiple of ``strata`` long) in an order drawn
    from ``rng`` in which every run of ``strata`` consecutive entries
    holds one value of each stratum (each ``len / strata`` consecutive
    sorted values), so any stretch of the stream has the pool's mix."""
    n = len(values)
    per = n // strata
    cols = np.stack([rng.permutation(per) for _ in range(strata)])  # (s, per)
    idx = cols + (np.arange(strata) * per)[:, None]
    return np.concatenate([values[rng.permutation(idx[:, b])]
                           for b in range(per)])


class Traffic:
    """The requests of one run, in submission order, from ``spec`` (a
    traffic file), the run's ``seed`` and the model's ``vocab``. Prompt
    lengths, answer lengths and (open loop) inter-arrival gaps each come
    from their pool in an order of their own, drawn from the seed anew for
    every pass over the pool: ``stratified`` for the sizes, a permutation
    for the gaps."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec = spec
        self.vocab = vocab
        n = int(spec.get("pool", 64))
        self.strata = int(spec.get("strata", 8))
        if n % self.strata:
            raise ValueError(f"pool {n} is not a multiple of strata "
                             f"{self.strata}")
        self._rng = np.random.default_rng([seed, 2])
        self._order_rng = np.random.default_rng([seed, 4])
        self._pools = {"prompt": pool(spec["prompt"], n),
                       "answer": pool(spec["answer"], n)}
        if spec["loop"] == "open":
            q = (np.arange(n) + 0.5) / n
            self._pools["gap"] = -np.log1p(-q) / float(spec["rate_per_s"])
        self._n = n
        self._order = {}
        self._made = 0
        self._t = 0.0

    @property
    def max_prompt(self) -> int:
        return int(self._pools["prompt"].max())

    @property
    def max_answer(self) -> int:
        return int(self._pools["answer"].max())

    def _draw(self, name: str, k: int):
        if k % self._n == 0:  # a new pass over the pool
            vals = self._pools[name]
            self._order[name] = (self._order_rng.permutation(vals)
                                 if name == "gap" else stratified(
                                     self._order_rng, vals, self.strata))
        return self._order[name][k % self._n]

    def warm(self, n_tokens: int, answer: int) -> Req:
        """A request outside the mix (index 10**9) that runs every shape
        the mix will: served once before an open loop's schedule starts,
        so no kernel builds or graph captures while arrivals wait."""
        prompt = self._rng.integers(0, self.vocab, n_tokens,
                                    dtype=np.int64).astype(np.int32)
        return Req(10 ** 9, prompt, answer)

    def next(self) -> Req:
        """The next request: its sizes (and gap) from the pools, its prompt
        tokens uniform over the vocabulary, its due time the previous one's
        plus the gap (open loop)."""
        k = self._made
        T0, answer = int(self._draw("prompt", k)), int(self._draw("answer",
                                                                  k))
        if "gap" in self._pools:
            self._t += float(self._draw("gap", k))
        prompt = self._rng.integers(0, self.vocab, T0,
                                    dtype=np.int64).astype(np.int32)
        self._made += 1
        return Req(k, prompt, answer, self._t)
