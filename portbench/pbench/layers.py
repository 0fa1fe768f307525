"""Per-layer quantities of a run, shared by the metric readers under
``metrics/``. ``run`` holds the model's widths ``m``, the ``scheme``, the
traced groups (``groups``, each with its steps, kernel times and K1 time
by body), the request logs (``reqs``), the open loop's lateness (``late``)
and the steps (``steps``) of [``t0``, ``t1``): the part of the window
before the first traced group, which the host-clock metrics read."""

from __future__ import annotations

import numpy as np

from . import arith, stats


def step_flops(run, st) -> float:
    """Model FLOPs of the useful tokens of a step: the real prompt rows of
    its chunk and the decode rows of its active slots."""
    f = 0.0
    if st.chunk is not None:
        f += arith.prompt_flops(run.m, st.chunk.lo, st.chunk.hi)
    if st.decoded:
        for p in st.pos[st.active]:
            f += arith.token_flops(run.m, int(p) + 1)
    return f


def mfu_pct(run):
    """Useful model FLOPs of the untraced steps over their wall seconds at
    the card's bf16 peak."""
    steps = run.steps
    wall = sum(s.t1 - s.t0 for s in steps)
    if not wall:
        return None
    return 100.0 * sum(step_flops(run, s) for s in steps) / (
        wall * arith.PEAK_BF16_FLOPS)


def k1_decode_pct(run):
    """Bound of the traced steps' K1 decode calls over their time on
    fd_gqa (with their fd_merge)."""
    bound = t = 0.0
    for g in run.groups:
        t += g.k1.get("fd_gqa", 0.0)
        for st in g.steps:
            if st.decoded:
                bound += arith.roofline_seconds(*arith.k1_decode_bound(
                    run.m, run.scheme, st.pos))
    return 100.0 * bound / t if t and bound else None


def k1_chunk_pct(run):
    """Bound of the traced steps' K1 chunk calls over their time on
    fd_chunk (with their fd_merge)."""
    bound = t = 0.0
    for g in run.groups:
        t += g.k1.get("fd_chunk", 0.0)
        for st in g.steps:
            c = st.chunk
            if c is not None:
                bound += arith.roofline_seconds(*arith.k1_chunk_bound(
                    run.m, run.scheme, c.lo, c.n_rows))
    return 100.0 * bound / t if t and bound else None


def kernel_seconds(run, *names) -> float:
    return sum(v for g in run.groups for k, v in g.by_name.items()
               if any(n in k for n in names))


def experts_pct(run):
    """All experts' weight bytes per traced decode step at the card's
    bandwidth, over moe_glu + moe_down time."""
    n = sum(1 for g in run.groups for st in g.steps if st.decoded)
    t = kernel_seconds(run, "moe_glu", "moe_down")
    if not n or not t:
        return None
    return 100.0 * n * arith.expert_bytes_per_step(run.m) / (
        arith.HBM_BYTES_PER_S * t)


def kernels_per_step(run):
    n = sum(len(g.steps) for g in run.groups)
    return sum(g.n_kernels for g in run.groups) / n if n else None


def idle_pct(run):
    """1 - the traced steps' kernel time over the wall those steps take
    untraced. The profiler's cost per kernel stretches a traced step's
    wall (between kernels, not inside them), so each traced step's wall
    is the median untraced loop iteration of its kind (with or without a
    prompt chunk; step start to the next step's start, the host's
    bookkeeping between steps included) before the first traced group.
    Kernel times inflated by the trace would read as less idle."""
    walls = {}
    for a, b in zip(run.steps, run.steps[1:]):
        walls.setdefault(a.chunk is not None, []).append(b.t0 - a.t0)
    traced = [st for g in run.groups for st in g.steps]
    busy = sum(g.busy_s for g in run.groups)
    if not traced or not busy or any(
            (st.chunk is not None) not in walls for st in traced):
        return None
    med = {k: float(np.median(v)) for k, v in walls.items()}
    return 100.0 * (1.0 - busy / sum(med[st.chunk is not None]
                                     for st in traced))


def occupancy_pct(run):
    dec = [st for st in run.steps if st.decoded]
    if not dec:
        return None
    return 100.0 * sum(int(st.active.sum()) for st in dec) / (
        len(dec) * run.n_slots)


def queue_wait_p90_ms(run):
    w = [r.left_queue - r.due for r in run.reqs.values()
         if run.t0 <= r.due < run.t1 and r.left_queue is not None]
    return stats.percentile(w, 90) * 1e3 if w else None


def late_p90_ms(run):
    w = [late for due, late in run.late if run.t0 <= due < run.t1]
    return stats.percentile(w, 90) * 1e3 if w else None
