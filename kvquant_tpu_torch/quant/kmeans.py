"""Weighted 1-D k-means for NUQ codebook fitting (port of
kvquant_tpu/quant/kmeans.py).

The reference fits sklearn ``KMeans(n_clusters=2**bits)`` with Fisher
information as sample weights on the flattened, range-normalized,
outlier-free activations. Here, as in the JAX package: weighted k-means++
seeding, then Lloyd iterations whose assignment is a midpoint search over
the sorted centroids and whose update is a weighted bincount.

The seeding draws from a ``torch.Generator`` seeded with ``seed``; the JAX
package draws from ``jax.random``, so the two seeds differ and so may the
local optimum Lloyd settles in. ``_lloyd`` takes the initial centers, so
the two loops can be compared from the same start.
"""

from __future__ import annotations

import torch


def _assign(x: torch.Tensor, centers_sorted: torch.Tensor) -> torch.Tensor:
    mids = (centers_sorted[1:] + centers_sorted[:-1]) * 0.5
    return torch.searchsorted(mids, x, right=False)


def _draw(p: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One index drawn with probability proportional to ``p`` (>= 0), by
    inverse CDF in float64 (no category limit, unlike multinomial)."""
    c = torch.cumsum(p.to(torch.float64), 0)
    u = torch.rand((), generator=gen, dtype=torch.float64,
                   device=p.device) * c[-1]
    return torch.clamp(torch.searchsorted(c, u, right=True), max=p.numel() - 1)


def _lloyd(x: torch.Tensor, w: torch.Tensor, centers: torch.Tensor,
           iters: int):
    """``iters`` Lloyd iterations from sorted ``centers``: (centers sorted,
    weighted inertia of the last assignment)."""
    k = centers.numel()
    inertia = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        a = _assign(x, centers)
        # bincount sums in per-block shared-memory histograms on a card,
        # where index_add_'s global atomics contend for k addresses:
        # cli.calibrate at LLaMA-2-7B width over 2 x 2048 tokens
        # (chip_smoke.py phase 23, an H100) took 60.1 s with index_add_,
        # 13.0 s with bincount
        wsum = torch.bincount(a, weights=w, minlength=k).to(torch.float32)
        xsum = torch.bincount(a, weights=w * x, minlength=k).to(
            torch.float32)
        new = torch.where(wsum > 0, xsum / torch.clamp(wsum, min=1e-30),
                          centers)
        centers = torch.sort(new).values
        inertia = torch.sum(w * (x - centers[_assign(x, centers)]) ** 2)
    return centers, inertia


def weighted_kmeans_1d(x: torch.Tensor, weights: torch.Tensor | None = None,
                       *, k: int, iters: int = 50, seed: int = 0):
    """Cluster 1-D points ``x`` (N,) with non-negative sample ``weights``
    into ``k`` centroids. Returns (centroids sorted (k,) fp32, inertia).
    Zero-weight points (masked outliers and sink tokens) influence neither
    the seeding nor the updates."""
    x = x.reshape(-1).to(torch.float32)
    w = (torch.ones_like(x) if weights is None
         else weights.reshape(-1).to(torch.float32))
    gen = torch.Generator(device=x.device).manual_seed(seed)

    # weighted k-means++ seeding (the JAX package's +1e-30 keeps an
    # all-zero weight vector drawable)
    first = x[_draw(w + 1e-30, gen)]
    centers = [first]
    d2 = (x - first) ** 2
    for _ in range(k - 1):
        c = x[_draw(w * d2 + 1e-30, gen)]
        centers.append(c)
        d2 = torch.minimum(d2, (x - c) ** 2)
    centers = torch.sort(torch.stack(centers)).values
    return _lloyd(x, w, centers, iters)
