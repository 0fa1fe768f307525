"""Profiling helpers (port of kvquant_tpu/utils/profiling.py).

  - device_timed(fn, *args, iters): seconds per call of ``fn(*args)``;
    on a card, CUDA events around ``iters`` back-to-back calls after a
    warm-up call; on the CPU, ``time.perf_counter`` around the same loop.
  - trace(path): a ``torch.profiler`` context that writes a Chrome trace
    (``trace.json``) into the directory ``path`` and yields the profiler.
    A profiler that fails to start raises: a profile that silently did
    not happen is no profile.
  - cost_analysis(fn, *args) / traffic_report(fn, *args): what one
    profiled call shows. JAX reads XLA's cost model there (bytes accessed,
    flops, transcendentals); torch has no such model, so those keys are
    absent. Reported instead: the kernel launches, the kernel time and the
    time per kernel name (top 10). On a card these are CUDA kernels and
    device time; on the CPU they are the ATen operators and their CPU
    time, and the result says ``device: "cpu"``.
  - SPANS: the process-wide ``SpanRecorder`` of the serving path
    (``serve.Server``): named host spans, the device time of the graph
    replays they wrap, and the host gaps during which the device waits on
    the host. On by default; ``SPANS.enabled = False`` switches it off.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import os
import time
from collections import deque
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile


def _on_cuda(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def _activities(cuda: bool) -> list:
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


def device_timed(fn, *args, iters: int = 20) -> float:
    """Seconds per call of ``fn(*args)`` over ``iters`` back-to-back calls
    after one warm-up call (CUDA events when an argument lies on a card)."""
    fn(*args)
    if _on_cuda(args):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(path: str):
    """Profile the body (with device activity when a card is present); on
    exit write ``path``/trace.json (Chrome trace format). Yields the
    ``torch.profiler.profile`` object."""
    cuda = torch.cuda.is_available()
    os.makedirs(path, exist_ok=True)
    with profile(activities=_activities(cuda), acc_events=True) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


def kernel_summary(prof, cuda: bool) -> dict:
    """{"device", "launches", "kernel_ms", "by_kernel": [(name, ms), ...]}
    of a finished profile: CUDA kernels and their device time, or, for a
    CPU run, ATen operators and their self CPU time."""
    if cuda:
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
        us = {e.key: e.self_device_time_total for e in ev}
    else:
        ev = [e for e in prof.key_averages()
              if e.key.startswith("aten::") and e.self_cpu_time_total > 0]
        us = {e.key: e.self_cpu_time_total for e in ev}
    top = sorted(us.items(), key=lambda kv: -kv[1])[:10]
    return {"device": "cuda" if cuda else "cpu",
            "launches": sum(e.count for e in ev),
            "kernel_ms": sum(us.values()) / 1e3,
            "by_kernel": [(k, v / 1e3) for k, v in top]}


def cost_analysis(fn, *args) -> dict:
    """``kernel_summary`` of one profiled call of ``fn(*args)`` after a
    warm-up call. XLA's bytes accessed / flops / transcendentals have no
    torch source and are absent."""
    cuda = _on_cuda(args)
    fn(*args)
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=_activities(cuda), acc_events=True) as prof:
        fn(*args)
        if cuda:
            torch.cuda.synchronize()
    return kernel_summary(prof, cuda)


def traffic_report(fn, *args, label: str = "fn") -> dict:
    """Print and return ``cost_analysis(fn, *args)``."""
    ca = cost_analysis(fn, *args)
    print(f"[{label}] {ca['device']}: launches={ca['launches']} "
          f"time={ca['kernel_ms']:.3f}ms")
    for name, ms in ca["by_kernel"]:
        print(f"[{label}]   {ms:9.3f} ms  {name[:90]}")
    return ca


# ---------------------------------------------------------------------------
# spans of the serving path
# ---------------------------------------------------------------------------


class Span(NamedTuple):
    """A finished span: ``id``, ``name``, host-clock ``t0`` / ``t1``
    (seconds), ``parent`` (the enclosing span's id, or None for a root),
    ``rid`` (the request it belongs to, or None), ``device_s``: the
    device time between its CUDA events (None without events, or before
    the next blocking read), and ``rows``: the rows of each replay it
    wrapped, in launch order (``SpanRecorder.replayed``; None where it
    recorded none). The ring holds the same fields as a plain tuple,
    without ``device_s`` and ``rows``; ``read`` joins them."""

    id: int
    name: str
    t0: float
    t1: float
    parent: int | None
    rid: int | None
    device_s: float | None = None
    rows: tuple | None = None


class Gap(NamedTuple):
    """A host gap: from a blocking device-to-host read (``t0``) to the
    program's next enqueue or launch of device work (``t1``), the device's
    stream empty all along."""

    t0: float
    t1: float


class _Open:
    """An open span, its own context manager. Only the finished span's
    plain tuple goes into the ring: nothing there refers back to the
    recorder, and nothing outlives the span but that tuple."""

    __slots__ = ("rec", "name", "rid", "stream", "id", "t0", "parent", "ev",
                 "rows")

    def __init__(self, rec, name, rid, stream):
        self.rec, self.name, self.rid, self.stream = rec, name, rid, stream
        self.ev = self.rows = None

    def __enter__(self):
        rec = self.rec
        self.t0 = rec.clock()
        self.id = next(rec._ids)
        stack = rec._stack
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        if self.stream is not None:
            rec._await = self
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self.ev is not None:
            self.ev[1].record(self.stream)
            rec._pending.append((self.id, self.ev))
        elif rec._await is self:
            rec._await = None
        if self.rows is not None:
            rec._rows.append((self.id, tuple(self.rows)))
        rec._stack.pop()
        rec._ring.append((self.id, self.name, self.t0, rec.clock(),
                          self.parent, self.rid))
        return False


class _Null:
    """The span of a switched-off recorder: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _cuda_event():
    return torch.cuda.Event(enable_timing=True)


class SpanRecorder:
    """Named host spans of the serving path, kept in memory.

    The clock is ``time.perf_counter()`` (seconds), the clock a load
    generator in the same process reads. ``span(name, rid=None,
    stream=None)`` is a context manager; spans nest, and each records its
    parent. A span given the CUDA ``stream`` its graph replays on (a timed
    span) gets a pair of CUDA events recorded on that stream, outside any
    graph: the start at ``launch()``, which the replay calls right before
    it is enqueued (after its inputs are copied in), the end as the span
    closes. Their elapsed time, the replay's device time with its launch
    latency, becomes the span's ``device_s`` at the program's next
    blocking read (``device_idle``), when they have completed. The stream
    is passed in because ``torch.cuda.current_stream()`` costs ~0.07 ms
    of host time on an H100 host, on the critical path before a launch.
    A timed span that launches nothing records no device time. The
    recorder never synchronizes by itself.

    Host gaps: ``device_idle()``, called where a blocking device-to-host
    read returns, marks the device idle from there; the program's next
    enqueue of device work closes the mark as one ``Gap``: ``enqueue()``
    before a reset or a slot write, ``launch()`` before a step's compute
    (the host's input copies before it count as gap: the device waits on
    them). ``read`` splits the gaps by the span open at each instant: the
    part outside every root span passed outside the program (between two
    ``Server.step()`` calls).

    Replays: ``replayed(rows)``, called as a replay of ``rows`` rows (or
    its eager counterpart) is enqueued, adds it to the innermost open
    span (the span's ``rows``).

    Finished spans and gaps go into bounded rings of ``capacity`` each, as
    plain tuples; no file is written. ``read(t0, t1)`` is the one reader.
    ``enabled = False`` switches the recorder off: a span then costs one
    attribute check and records nothing."""

    def __init__(self, capacity: int = 1 << 16, clock=time.perf_counter,
                 event=_cuda_event):
        self.enabled = True
        self.clock = clock
        self._event = event
        self._ring: deque = deque(maxlen=capacity)
        self._gaps: deque = deque(maxlen=capacity)
        self._device: deque = deque(maxlen=capacity)  # (span id, seconds)
        self._rows: deque = deque(maxlen=capacity)  # (span id, rows)
        self._ids = itertools.count()
        self._stack: list[_Open] = []
        self._await = None  # the open timed span, before its launch
        self._pending: list = []  # (span id, events) not read yet
        self._free: list = []  # event pairs whose times were read
        self._idle = None  # host clock of the open gap's blocking read

    def span(self, name: str, rid=None, stream=None):
        if not self.enabled:
            return _NULL
        return _Open(self, name, rid, stream)

    def launch(self):
        """A step's compute is about to be enqueued: close the open gap,
        and record the start event of the open timed span."""
        if self._idle is not None:
            self.enqueue()
        op = self._await
        if op is not None:
            self._await = None
            free = self._free
            op.ev = free.pop() if free else (self._event(), self._event())
            op.ev[0].record(op.stream)

    def replayed(self, rows: int):
        """The innermost open span's next replay runs ``rows`` rows."""
        if self.enabled and self._stack:
            op = self._stack[-1]
            if op.rows is None:
                op.rows = []
            op.rows.append(int(rows))

    def device_idle(self):
        """A blocking device-to-host read has returned: the stream is
        empty. Reads the finished timed spans' device time and opens a
        gap (unless one is open: the device has been idle since then)."""
        if not self.enabled:
            return
        if self._idle is None:
            self._idle = self.clock()
        keep = []
        for sid, (start, end) in self._pending:
            if end.query():
                self._device.append((sid, start.elapsed_time(end) / 1e3))
                self._free.append((start, end))
            else:
                keep.append((sid, (start, end)))
        self._pending = keep

    def enqueue(self):
        """The program is about to enqueue device work: close the open gap."""
        if self._idle is None:
            return
        if self.enabled:
            self._gaps.append((self._idle, self.clock()))
        self._idle = None

    def read(self, t0: float, t1: float) -> dict:
        """The spans that start in [t0, t1) (``Span``, oldest first, each
        with its device time once read) and the gaps that overlap it
        (``spans``, ``gaps``), and ``summary``:

        - ``wall_s``: t1 - t0; ``complete``: whether the rings still hold
          the whole interval (False once spans or gaps that began after t0
          were dropped);
        - ``by_name``: for each span name, ``count``, ``host_s`` (their
          host time), ``self_s`` (less their children's), and over the
          spans with a device time ``device_n``, ``device_s`` and
          ``device_median_s``;
        - ``host_gap``: ``n``, ``s`` (the gaps' time inside [t0, t1)),
          ``pct`` (of ``wall_s``), ``by_span``: that time by the innermost
          span open at each instant, ``outside`` where none is, and
          ``outside_s``, the ``outside`` part."""
        dev_of, rows_of = dict(self._device), dict(self._rows)
        ring = [Span(*s, dev_of.get(s[0]), rows_of.get(s[0]))
                for s in self._ring]
        spans = sorted((s for s in ring if t0 <= s.t0 < t1),
                       key=lambda s: s.t0)
        inside = [Gap(*g) for g in self._gaps if g[0] < t1 and g[1] > t0]
        complete = all(len(r) < r.maxlen or r[0][i] <= t0  # oldest t0
                       for r, i in ((self._ring, 2), (self._gaps, 0)) if r)
        by_name: dict[str, dict] = {}
        child_s: dict[int, float] = {}
        for s in spans:
            if s.parent is not None:
                child_s[s.parent] = child_s.get(s.parent, 0.0) + s.t1 - s.t0
        dev: dict[str, list] = {}
        for s in spans:
            e = by_name.setdefault(s.name, dict(count=0, host_s=0.0,
                                                self_s=0.0))
            e["count"] += 1
            e["host_s"] += s.t1 - s.t0
            e["self_s"] += s.t1 - s.t0 - child_s.get(s.id, 0.0)
            if s.device_s is not None:
                dev.setdefault(s.name, []).append(s.device_s)
        for name, v in dev.items():
            v.sort()
            n = len(v)
            by_name[name].update(device_n=n, device_s=sum(v),
                                 device_median_s=(v[(n - 1) // 2]
                                                  + v[n // 2]) / 2)
        gs = 0.0
        by_span: dict[str, float] = {}
        segs = _segments(ring) if inside else []
        starts = [x[0] for x in segs]
        for g in inside:
            a, b = max(g.t0, t0), min(g.t1, t1)
            gs += b - a
            for name, sec in _overlaps(segs, starts, a, b).items():
                by_span[name] = by_span.get(name, 0.0) + sec
        wall = t1 - t0
        return dict(spans=spans, gaps=inside, summary=dict(
            wall_s=wall, complete=complete, by_name=by_name,
            host_gap=dict(n=len(inside), s=gs,
                          outside_s=by_span.get("outside", 0.0),
                          pct=100.0 * gs / wall if wall > 0 else None,
                          by_span=by_span)))


def _segments(spans) -> list:
    """The host clock cut into (start, end, name) pieces by the innermost
    open span of ``spans`` (which nest, as spans of one thread do):
    ``outside`` between roots."""
    segs, stack, t = [], [], None

    def cut(upto):
        if t is not None and upto > t:
            segs.append((t, upto, stack[-1].name if stack else "outside"))
        return upto

    for s in sorted(spans, key=lambda s: (s.t0, s.id)):
        while stack and stack[-1].t1 <= s.t0:
            t = cut(stack[-1].t1)
            stack.pop()
        t = cut(s.t0)
        stack.append(s)
    while stack:
        t = cut(stack[-1].t1)
        stack.pop()
    return segs


def _overlaps(segs, starts, a: float, b: float) -> dict:
    """Seconds of [a, b] in each name of ``segs`` (``_segments``, their
    ``starts`` beside them), ``outside`` where no piece lies."""
    out: dict[str, float] = {}
    covered = 0.0
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(segs) and segs[i][0] < b:
        lo, hi, name = segs[i]
        d = min(hi, b) - max(lo, a)
        if d > 0:
            out[name] = out.get(name, 0.0) + d
            covered += d
        i += 1
    if b - a - covered > 0:
        out["outside"] = out.get("outside", 0.0) + (b - a - covered)
    return out


SPANS = SpanRecorder()
