"""The ``mistral7b-nuq3-longdoc`` cell's closed loop without a card: how
far ``output_tok_s`` and ``itl_p99_ms`` spread from seed to seed when
every step takes the time measured on the card.

    python3 longdoc_sim.py [--seeds 24] [--set 6] [--seconds 51]
        [--answer loguniform,32,512] [--prompt uniform,2048,16384]
        [--decode-ms 140] [--sub-ms 120,10.85]

The benchmark harness's own loop (``portbench/pbench``: ``fill``,
``closed_loop``, ``Recorder``), traffic generator and statistics run
unchanged over a stand-in for ``serve.Server``: its public state and its
schedule (one admission chunk a step, the whole prompt in one chunk at
the cell's ``admit_chunk``, every active slot decoding one token a step),
and a clock that each step moves on by a decode step's time plus, when
it admits, an admission's: ``a n + b n^2`` ms for a prompt of n
sub-chunks of ``serve.ADMIT_SUB_CHUNK`` rows. The defaults are fits to
Mistral-7B-Instruct-v0.2 on an H100 80GB HBM3 at 700 W
(``admission_ablation.py``: 131 / 872 / 1665 ms at 1 / 5 / 8 sub-chunks;
a decode replay of 120 rows ~138 ms, PERF.md). ``--answer`` and
``--prompt`` replace the traffic file's laws, ``--seconds`` the window,
to see what the spread comes from. Seeds are 2**31 + i. Spread: IQR /
median, the quartiles of ``statistics.quantiles(n=4)``; per set of
``--set`` consecutive seeds and over all of them. The last line is one
JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from collections import deque
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "portbench"))

from pbench import driver, stats  # noqa: E402
from pbench.traffic import Traffic  # noqa: E402

CELL = "mistral7b-nuq3-longdoc"
SUB_CHUNK = 2048  # serve.ADMIT_SUB_CHUNK


def _load(*parts):
    with open(os.path.join(ROOT, "portbench", *parts)) as f:
        return json.load(f)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int


@dataclass
class _Completion:
    rid: int
    tokens: list = field(default_factory=list)


@dataclass
class _Admission:
    req: Request
    slot: int
    n_chunks: int
    ci: int = 0


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class StandIn:
    """``serve.Server``'s public state and chunked schedule; a step moves
    ``clock`` on by ``decode_s`` (when a slot is active) and
    ``admit_s(n_sub)`` (when it runs an admission chunk)."""

    def __init__(self, n, sink, admit_chunk, clock, decode_s, admit_s):
        self.n, self.admit_chunk = n, admit_chunk
        self.dcfg = SimpleNamespace(sink=sink)
        self.clock, self.decode_s, self.admit_s = clock, decode_s, admit_s
        self.queue: deque = deque()
        self.active = [None] * n
        self.admitting: list[_Admission] = []
        self.out: dict[int, _Completion] = {}
        self.pos = np.zeros(n, np.int32)
        self.last_tok = np.zeros(n, np.int32)
        self.remaining = np.zeros(n, np.int64)
        self.decode_steps = 0

    def submit(self, req):
        self.queue.append(req)
        self.out[req.rid] = _Completion(req.rid)

    def _emit(self, b):
        self.out[self.active[b].rid].tokens.append(0)
        self.remaining[b] -= 1
        if self.remaining[b] <= 0:
            self.active[b] = None

    def step(self):
        S, chunk = self.dcfg.sink, self.admit_chunk
        busy = {a.slot for a in self.admitting}
        for b in range(self.n):
            if self.active[b] is None and b not in busy and self.queue:
                req = self.queue.popleft()
                self.admitting.append(_Admission(
                    req, b, -(-(len(req.prompt) - S) // chunk)))
                busy.add(b)
        dt = 0.0
        if self.admitting:
            a = self.admitting[0]
            T0, lo = len(a.req.prompt), S + a.ci * chunk
            dt += self.admit_s(-(-(min(lo + chunk, T0) - lo) // SUB_CHUNK))
            a.ci += 1
            if a.ci == a.n_chunks:
                self.admitting.pop(0)
                b = a.slot
                self.active[b] = a.req
                self.pos[b] = T0
                self.remaining[b] = a.req.max_new_tokens
                self._emit(b)
        live = [b for b in range(self.n) if self.active[b] is not None]
        if live:
            dt += self.decode_s
            self.decode_steps += 1
            for b in live:
                self.pos[b] += 1
                self._emit(b)
        self.clock.t += dt


def law(text: str) -> dict:
    dist, lo, hi = text.split(",")
    return {"dist": dist, "min": float(lo), "max": float(hi)}


def one_run(traffic_spec, wl, sink, seed, seconds, decode_s, admit_s):
    clock = Clock()
    srv = StandIn(wl["slots"], sink, wl["admit_chunk"], clock, decode_s,
                  admit_s)
    rec = driver.Recorder(srv, Request, clock=clock)
    traffic = Traffic(traffic_spec, seed, 32000)
    driver.fill(rec, traffic, traffic_spec["clients"])
    t0 = clock()
    t1 = t0 + seconds
    driver.closed_loop(rec, traffic, t1)
    reqs = list(rec.reqs.values())
    n_adm = sum(1 for s in rec.steps if s.chunk is not None and s.t0 >= t0)
    return dict(seed=seed,
                output_tok_s=stats.tokens_in(reqs, t0, t1) / seconds,
                itl_p99_ms=stats.percentile(stats.gaps_in(reqs, t0, t1),
                                            99) * 1e3,
                steps=sum(1 for s in rec.steps if s.t0 >= t0),
                admissions=n_adm, setup_steps=sum(
                    1 for s in rec.steps if s.t1 <= t0))


def spread(v) -> float:
    q = statistics.quantiles(v, n=4)
    return (q[2] - q[0]) / statistics.median(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--set", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--answer", type=law, default=None)
    ap.add_argument("--prompt", type=law, default=None)
    ap.add_argument("--decode-ms", type=float, default=140.0)
    ap.add_argument("--sub-ms", default="120,10.85",
                    help="a,b: an admission of n sub-chunks takes "
                         "a n + b n^2 ms")
    args = ap.parse_args(argv)
    wl = _load("workloads", f"{CELL}.json")
    spec = _load("traffic", f"{wl['traffic']}.json")
    sink = _load("schemes", f"{wl['scheme']}.json")["sink"]
    for k in ("answer", "prompt"):
        if getattr(args, k) is not None:
            spec[k] = getattr(args, k)
    a, b = (float(x) for x in args.sub_ms.split(","))
    runs = []
    for i in range(args.seeds):
        r = one_run(spec, wl, sink, 2 ** 31 + i, args.seconds,
                    args.decode_ms / 1e3,
                    lambda n: (a * n + b * n * n) / 1e3)
        runs.append(r)
        print(f"seed {r['seed']}: output_tok_s {r['output_tok_s']:.2f}, "
              f"itl_p99_ms {r['itl_p99_ms']:.1f}; {r['steps']} steps, "
              f"{r['admissions']} admissions in the window; set-up "
              f"{r['setup_steps']} steps", flush=True)
    out = {}
    for k in ("output_tok_s", "itl_p99_ms"):
        v = [r[k] for r in runs]
        sets = [spread(v[j:j + args.set])
                for j in range(0, len(v) - args.set + 1, args.set)]
        out[k] = dict(median=statistics.median(v), spread=spread(v),
                      set_spreads=sets)
        print(f"{k}: median {out[k]['median']:.2f}, IQR / median "
              f"{100 * out[k]['spread']:.2f}% over {len(v)} seeds; sets of "
              f"{args.set}: " + ", ".join(f"{100 * s:.2f}%" for s in sets))
    print(json.dumps(dict(cell=CELL, seconds=args.seconds,
                          answer=spec["answer"], prompt=spec["prompt"],
                          decode_ms=args.decode_ms, sub_ms=[a, b], **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
