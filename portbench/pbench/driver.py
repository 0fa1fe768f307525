"""Drive a ``serve.Server`` through its public surface and record what it
did, step by step, on the host clock.

The server is read only between ``step()`` calls, through its public state
(``queue``, ``admitting``, ``active``, ``pos``, ``last_tok``, ``out``,
``decode_steps``, ``n``, ``dcfg``, ``admit_chunk``). From the state before
a step the recorder works out which prompt chunk the step runs (the first
admission in line once free slots have taken queued requests, as the
server's chunked admission does) and which token and position every slot
decodes; after the step it checks that the server did just that, so a
change of the server's schedule stops the run instead of being recorded
wrongly. The record is what the metrics and the reference replay read.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Chunk:
    """The prompt chunk a step ran: request ``rid`` in ``slot``, chunk
    ``ci`` of ``n_chunks``; its real rows are positions [lo, hi) of the
    prompt, and the call holds ``n_rows`` rows with the padding."""
    rid: int
    slot: int
    ci: int
    n_chunks: int
    lo: int
    hi: int
    n_rows: int

    @property
    def last(self) -> bool:
        return self.ci + 1 == self.n_chunks


@dataclass
class Step:
    """One ``step()``: host clock at its start and end, the chunk it ran
    (or None) and, when it decoded, every slot's request (``rid``, -1 for a
    slot never admitted), position, input token and whether the request
    was active (a slot that is not decodes junk at a frozen position)."""
    t0: float
    t1: float
    chunk: Chunk | None
    decoded: bool
    rid: np.ndarray | None = None
    pos: np.ndarray | None = None
    tok: np.ndarray | None = None
    active: np.ndarray | None = None


@dataclass
class ReqLog:
    rid: int
    prompt: np.ndarray
    answer: int
    due: float  # host clock at which it was due (open loop) or submitted
    submitted: float = 0.0
    left_queue: float | None = None
    token_t: list = field(default_factory=list)
    finished: float | None = None


class Recorder:
    def __init__(self, srv, request_cls, clock=time.perf_counter):
        self.srv = srv
        self.Request = request_cls
        self.clock = clock
        self.reqs: dict[int, ReqLog] = {}
        self.inflight: list[int] = []
        self.steps: list[Step] = []
        self.finished_now: list[int] = []
        self.owner = np.full(srv.n, -1, np.int64)  # last request per slot
        self.span = lambda name: contextlib.nullcontext()

    # -- submission -----------------------------------------------------
    def submit(self, req, due: float | None = None):
        """Submit a ``traffic.Req`` now; ``due`` its due time on the host
        clock (now when None)."""
        now = self.clock()
        self.reqs[req.idx] = ReqLog(req.idx, req.prompt, req.answer,
                                    now if due is None else due, now)
        self.srv.submit(self.Request(rid=req.idx, prompt=req.prompt,
                                     max_new_tokens=req.answer))
        self.inflight.append(req.idx)

    def busy(self) -> bool:
        s = self.srv
        return bool(s.queue) or bool(s.admitting) or any(
            a is not None for a in s.active)

    # -- one step -------------------------------------------------------
    def next_chunk(self):
        s = self.srv
        S, width = s.dcfg.sink, s.admit_chunk
        line = [(a.req, a.slot, a.ci, a.n_chunks) for a in s.admitting]
        busy = {a.slot for a in s.admitting}
        queue = list(s.queue)
        started = []
        for b in range(s.n):
            if s.active[b] is None and b not in busy and queue:
                req = queue.pop(0)
                line.append((req, b, 0, -(-(len(req.prompt) - S) // width)))
                busy.add(b)
                started.append(req.rid)
        if not line:
            return None, started
        req, slot, ci, n_chunks = line[0]
        T0 = len(req.prompt)
        if ci == 0:
            lo, n_rows = 0, S + width
        else:
            lo, n_rows = S + ci * width, width
        return Chunk(req.rid, slot, ci, n_chunks, lo,
                     min(lo + n_rows, T0), n_rows), started

    def step(self) -> Step:
        s = self.srv
        chunk, started = self.next_chunk()
        rid = np.array([-1 if a is None else a.rid for a in s.active])
        pos, tok = s.pos.astype(np.int64), s.last_tok.astype(np.int64)
        n_dec = s.decode_steps
        t0 = self.clock()
        with self.span("server.step"):
            s.step()
        t1 = self.clock()
        with self.span("bookkeeping"):
            for r in started:
                self.reqs[r].left_queue = t0
            st = Step(t0, t1, chunk, s.decode_steps > n_dec)
            if chunk is not None and chunk.last:
                b = chunk.slot
                rid[b], self.owner[b] = chunk.rid, chunk.rid
                pos[b] = len(self.reqs[chunk.rid].prompt)
                tok[b] = s.out[chunk.rid].tokens[0]
            if st.decoded:
                st.rid = np.where(rid >= 0, rid, self.owner)
                st.pos, st.tok, st.active = pos, tok, rid >= 0
                moved = s.pos.astype(np.int64)[st.active]
                if not np.array_equal(moved, pos[st.active] + 1):
                    raise RuntimeError("the server's positions did not "
                                       "follow the recorded schedule")
            self._collect(t1)
        self.steps.append(st)
        return st

    def _collect(self, t: float):
        out = self.srv.out
        keep = []
        for r in self.inflight:
            log = self.reqs[r]
            n = len(out[r].tokens)
            log.token_t.extend([t] * (n - len(log.token_t)))
            if n >= log.answer:
                log.finished = t
            else:
                keep.append(r)
        self.finished_now = [r for r in self.inflight if r not in keep]
        self.inflight = keep

    def tokens(self, rid: int) -> np.ndarray:
        out = self.out if self.srv is None else self.srv.out
        return np.asarray(out[rid].tokens, np.int64)

    def release(self):
        """Keep the served tokens and let the server go."""
        self.out = {r: c for r, c in self.srv.out.items()}
        self.srv = None


def fill(rec: Recorder, traffic, clients: int):
    """Closed loop, set-up: every client's first request, stepped until
    all of them are admitted."""
    for _ in range(clients):
        rec.submit(traffic.next())
    while rec.srv.queue or rec.srv.admitting:
        rec.step()
        for _ in rec.finished_now:
            rec.submit(traffic.next())


def closed_loop(rec: Recorder, traffic, until: float, hooks=None):
    """Step until the host clock passes ``until``; each finished request's
    client sends its next one before the next step. ``hooks`` (the traced
    run's ``tracing.Tracer``) is called around each iteration."""
    while rec.clock() < until:
        if hooks is not None:
            hooks.before(rec)
        rec.step()
        with rec.span("loadgen"):
            for _ in rec.finished_now:
                rec.submit(traffic.next())
        if hooks is not None:
            hooks.after(rec)


class OpenLoop:
    """Open loop: requests are submitted when due, whatever the server is
    doing. ``start`` is the host clock of the schedule's time 0; ``late``
    collects how late each submission ran behind its due time."""

    def __init__(self, rec: Recorder, traffic, start: float):
        self.rec, self.traffic, self.start = rec, traffic, start
        self.late: list[tuple[float, float]] = []  # (due, seconds late)
        self.pending = traffic.next()

    def submit_due(self):
        with self.rec.span("loadgen"):
            now = self.rec.clock()
            while self.start + self.pending.due <= now:
                due = self.start + self.pending.due
                self.rec.submit(self.pending, due)
                self.late.append((due, self.rec.clock() - due))
                self.pending = self.traffic.next()

    def run(self, until: float, hooks=None):
        while self.rec.clock() < until:
            self.submit_due()
            if not self.rec.busy():
                wait = self.start + self.pending.due - self.rec.clock()
                if wait > 0:
                    time.sleep(min(wait, 0.001))
                continue
            if hooks is not None:
                hooks.before(self.rec)
            self.rec.step()
            if hooks is not None:
                hooks.after(self.rec)
