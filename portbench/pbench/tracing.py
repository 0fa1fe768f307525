"""The traced run's device trace: ``torch.profiler`` over a few groups of
consecutive server steps spread over the window, recording the device's
activity alone (kernels and copies, through CUPTI; no host operators, so
the host runs as it does untraced), kept in memory and reduced once the
window has closed (reducing a group takes seconds, which inside the window
would hold up the load generator). No trace file is written.

For each group it keeps the steps it covers, every device kernel's name
and duration, the union of the kernel intervals (busy seconds) inside the
group's wall interval on the host clock (from the start of its first loop
iteration to the end of its last), the idle gaps inside that interval
labelled by the harness span open on the host at their midpoint
(``server.step``, ``loadgen``, ``bookkeeping``; ``harness`` elsewhere),
and K1's time by body: each ``fd_merge`` belongs to the split kernel
launched before it. Device times are put on the host clock by placing the
group's first device event at the start of its first iteration: the
device starts later than the host by the host's work before the first
launch, so the gaps' labels may be off by that (a fraction of a
millisecond).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

K1_BODIES = ("fd_gqa", "fd_chunk", "fd_decode", "fd_partial")


@dataclass
class Group:
    steps: list
    window_s: float = 0.0
    busy_s: float = 0.0
    n_kernels: int = 0
    by_name: dict = field(default_factory=dict)  # kernel -> seconds
    k1: dict = field(default_factory=dict)  # body -> seconds, merge incl.
    gaps: list = field(default_factory=list)  # (span, seconds)


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events, steps, spans, lo: float, hi: float) -> Group:
    """A ``Group`` from a finished profile's ``events()`` (device events,
    times in microseconds from the trace's start), its ``steps``, the host
    ``spans`` (name, start, end) and its wall interval [lo, hi], all on
    the host clock in seconds."""
    g = Group(steps=steps, window_s=hi - lo)
    kernels = sorted((e.time_range.start * 1e-6, e.time_range.end * 1e-6,
                      e.name) for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    if not kernels:
        return g
    shift = lo - kernels[0][0]
    kernels = [(s + shift, e + shift, n) for s, e, n in kernels]
    last = None
    for s, e, name in kernels:
        g.n_kernels += not name.startswith(("Memcpy", "Memset"))
        g.by_name[name] = g.by_name.get(name, 0.0) + (e - s)
        body = next((b for b in K1_BODIES if b in name), None)
        if body is not None:
            last = body
        if body is None and "fd_merge" in name:
            body = last
        if body is not None:
            g.k1[body] = g.k1.get(body, 0.0) + (e - s)
    busy = _union([(max(s, lo), min(e, hi)) for s, e, _ in kernels
                   if e > lo and s < hi])
    g.busy_s = sum(e - s for s, e in busy)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            inner = [(e - s, n) for n, s, e in spans if s <= mid <= e]
            g.gaps.append((min(inner)[1] if inner else "harness", b - a))
    return g


class Tracer:
    """Profiles ``per_group`` consecutive loop iterations at each of
    ``groups`` marks spread evenly over the second half of the window [t0,
    t0 + seconds]: the profiler's start and stop hold up the host (an open
    loop's arrivals wait), so the host-clock metrics of a traced run read
    the part before ``clean_until``. The loops call ``before(rec)`` and
    ``after(rec)`` around each iteration."""

    def __init__(self, t0: float, seconds: float, groups: int,
                 per_group: int):
        half = seconds / 2
        self.marks = [t0 + half + (i + 0.5) * half / groups
                      for i in range(groups)]
        self.clean_until = self.marks[0]
        self.per_group = per_group
        self.chunk_seen = False
        self.groups: list[Group] = []
        self._prof = None
        self._taken = []  # (finished profile, steps, spans, lo, hi)
        self._left = 0
        self._steps, self._spans = [], []
        self._lo = self._hi = 0.0

    @staticmethod
    def warm():
        """Start and stop the profiler once, so the first group does not
        pay for its set-up (counted in set-up)."""
        with torch.profiler.profile(activities=_activities()):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def before(self, rec):
        """Start a group at a mark. Once the marks are spent, a step that
        runs a prompt chunk is profiled alone if none of the groups held
        one."""
        if self._prof is None:
            n = 0
            if self.marks and rec.clock() >= self.marks[0]:
                self.marks.pop(0)
                n = self.per_group
            elif (not self.marks and not self.chunk_seen
                  and rec.next_chunk()[0] is not None):
                n = 1
            if n:
                torch.cuda.synchronize()
                self._prof = torch.profiler.profile(activities=_activities(),
                                                acc_events=True)
                self._prof.start()
                self._left, self._steps, self._spans = n, [], []
                rec.span = self._span_of(rec)
                self._lo = rec.clock()

    def _span_of(self, rec):
        spans = self._spans

        @contextlib.contextmanager
        def span(name):
            t = rec.clock()
            try:
                yield
            finally:
                spans.append((name, t, rec.clock()))
        return span

    def after(self, rec):
        if self._prof is None:
            return
        self._hi = rec.clock()
        step = rec.steps[-1]
        self._steps.append(step)
        self.chunk_seen |= step.chunk is not None
        self._left -= 1
        if self._left == 0:
            self._stop(rec)

    def _stop(self, rec):
        torch.cuda.synchronize()
        self._prof.stop()
        rec.span = lambda name: contextlib.nullcontext()
        self._taken.append((self._prof, self._steps, self._spans, self._lo,
                            self._hi))
        self._prof = None

    def finish(self, rec):
        """After the window: end a group the window cut short, then reduce
        every group."""
        if self._prof is not None:
            self._stop(rec)
        self.groups = [reduce_events(p.events(), st, sp, lo, hi)
                       for p, st, sp, lo, hi in self._taken if st]
        self._taken = []


def trace_cost(groups, untraced) -> dict:
    """Median wall (ms) of the traced steps and of the untraced ``steps``
    before the first group, apart for steps that ran a prompt chunk and
    steps that only decoded, with their counts: what the profiler adds to
    a step."""
    import numpy as np

    out = {}
    for kind, has_chunk in (("decode", False), ("chunk", True)):
        for side, steps in (("traced", [s for g in groups for s in g.steps]),
                            ("untraced", untraced)):
            w = [(s.t1 - s.t0) * 1e3 for s in steps
                 if (s.chunk is not None) == has_chunk]
            out[f"{kind}_{side}_ms"] = float(np.median(w)) if w else None
            out[f"{kind}_{side}_n"] = len(w)
    return out


def _activities():
    return [torch.profiler.ProfilerActivity.CUDA]
