#!/usr/bin/env python3
"""The port's benchmark: one cell of BENCHMARK.json, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. It makes the cell's weights, quantizer thresholds and requests from
the seed, builds ``kvquant_tpu_torch.serve.Server`` over them, runs the
traffic's set-up, measures for ``--seconds`` with the traffic running,
then judges what the server served against the plain reference
(``reference/``) and prints one JSON line last: the cell's end-to-end
metrics (``--trace 0``) or its per-layer metrics (``--trace 1``, with a
device trace of a few groups of steps spread over the window).

Nothing here imports JAX or the JAX package; a run that finds either in
``sys.modules`` once the window has closed fails. A run that finds no card
fails: nothing falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
for p in (HERE, CHECKOUT):
    if p not in sys.path:
        sys.path.insert(0, p)
# build and kernel caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "_cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, "_cache", "torch_ext")

import numpy as np  # noqa: E402

from pbench import arith, driver, spec, stats  # noqa: E402
from pbench.correct import judge  # noqa: E402
from pbench.model import (build_server, capacity_tokens,  # noqa: E402
                          k_thresholds, make_weights)
from pbench.traffic import Traffic  # noqa: E402

FOREIGN = ("jax", "jaxlib", "flax", "kvquant_tpu")
TRACE_GROUPS, TRACE_STEPS = 4, 2
DRAIN_S = 60.0  # how long after the window the judged requests may take


def foreign_modules() -> list[str]:
    """Top-level names in ``sys.modules`` of JAX, Flax or the JAX package
    (the part before the first dot, compared whole)."""
    return sorted({k.split(".")[0] for k, v in list(sys.modules.items())
                   if v is not None} & set(FOREIGN))


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def sync(device):
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def drain(rec, loop, attempted, need_done: int, limit_s: float = DRAIN_S):
    """After the window: step on (an open loop keeps its schedule, a
    closed loop sends nothing more) until every attempted request has its
    first token and ``need_done`` requests (the judged ones) have
    finished, or ``limit_s`` has passed."""
    end = rec.clock() + limit_s
    while rec.clock() < end and rec.busy():
        done = sum(1 for r in rec.reqs.values() if r.finished)
        if done >= need_done and all(rec.reqs[r].token_t for r in attempted):
            return
        if loop is not None:
            loop.submit_due()
        rec.step()


def checked(limits: dict, verdict: dict) -> tuple[dict, bool]:
    """Each number the cell's ``limits`` name beside its limit, and
    whether every one is finite and within it."""
    checks = {k: {"value": verdict.get(k), "limit": lim}
              for k, lim in limits.items()}
    return checks, all(x["value"] is not None and math.isfinite(x["value"])
                       and x["value"] <= x["limit"] for x in checks.values())


def run_cell(c: dict, seed: int, seconds: float, trace: bool,
             device="cuda", dtype=None, control: bool = False,
             check: bool = True) -> dict:
    """One run of cell ``c`` (``spec.cell``); returns the result object
    (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    ``breakdown``, ``checks``) and ``verdict`` (the judge's numbers).
    ``dtype`` (bf16 unless given) is for the tests' fp32 runs;
    ``control`` also judges the fp8 control in the program's place, by the
    same ``checked`` limits (``control``: its ``correct`` and ``checks``;
    ``limits.py`` and the tests, never a benchmark run); without
    ``check`` nothing is judged (``sweep.py``). ``load`` is the backlog
    (requests queued or being admitted) at the window's start and end."""
    import torch

    from kvquant_tpu_torch.serve import Request

    m = arith.model_dims(c["config"])
    wl, tr, scheme = c["workload"], c["traffic"], c["scheme"]
    traffic = Traffic(tr, seed, m["V"])
    w = make_weights(m, seed, device, dtype=dtype or torch.bfloat16)
    k_up, k_lo = k_thresholds(m, scheme, seed)
    srv = build_server(c["config_path"], m, scheme, w, k_up, k_lo,
                       wl["slots"], capacity_tokens(traffic),
                       wl["admit_chunk"], device)
    rec = driver.Recorder(srv, Request)
    tracer = None
    if trace:
        from pbench.tracing import Tracer

        Tracer.warm()
    loop = None
    if tr["loop"] == "closed":
        driver.fill(rec, traffic, tr["clients"])
    else:
        # every shape first (a sink chunk, a later chunk, decode), then the
        # schedule: nothing builds or captures while arrivals wait
        S, width = scheme["sink"], wl["admit_chunk"]
        rec.submit(traffic.warm(S + width + 1, 2))
        while rec.busy():
            rec.step()
        loop = driver.OpenLoop(rec, traffic, rec.clock())
        loop.run(rec.clock() + tr["warmup_s"])
    sync(device)
    t0 = rec.clock()
    setup_s = t0 - T_START
    backlog = lambda: len(srv.queue) + len(srv.admitting)  # noqa: E731
    load = dict(start=backlog())
    t1 = t0 + seconds
    if trace:
        tracer = Tracer(t0, seconds, TRACE_GROUPS, TRACE_STEPS)
    gc.collect()
    gc.freeze()  # the set-up's objects out of the collector's way
    if loop is None:
        driver.closed_loop(rec, traffic, t1, tracer)
    else:
        loop.run(t1, tracer)
    closed = rec.clock()
    gc.unfreeze()
    if tracer is not None:
        tracer.finish(rec)
    load["end"] = backlog()
    attempted = [r.rid for r in rec.reqs.values()
                 if r.due < t1 and not (r.finished and r.finished <= t0)]
    drain(rec, loop, attempted, wl["judge"]["requests"])
    failed = sum(1 for r in attempted if not rec.reqs[r].token_t)
    mem = torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0
    log(f"window {t0 - T_START:.3f} .. {closed - T_START:.3f} s after "
        f"start; {len(rec.steps)} steps in all; attempted {len(attempted)}, "
        f"failed {failed}; peak {mem / 2**30:.2f} GiB")

    clean = tracer.clean_until if tracer else t1
    run = SimpleNamespace(
        m=m, scheme=scheme, n_slots=srv.n, t0=t0, t1=clean, reqs=rec.reqs,
        steps=[s for s in rec.steps if s.t0 >= t0 and s.t1 <= clean],
        groups=tracer.groups if tracer else [],
        late=loop.late if loop else [])
    metrics, breakdown, dev, values = {}, None, {}, {}
    if trace:
        for mt in c["per_layer"]:
            v = spec.metric_reader(mt["name"])(run)
            if v is not None:
                metrics[mt["name"]] = {"value": v, "unit": mt["unit"]}
        g = run.groups
        dev = dict(busy_s=sum(x.busy_s for x in g),
                   window_s=sum(x.window_s for x in g))
        from pbench.tracing import trace_cost

        log("trace cost (step wall, median ms): " + json.dumps(
            trace_cost(g, run.steps)) + f"; {len(g)} groups, busy "
            f"{dev['busy_s']:.6f} s of {dev['window_s']:.6f} s")
        ops = {}
        for x in g:
            for k, v in x.by_name.items():
                ops[k] = ops.get(k, 0.0) + v
        gaps = sorted((gp for x in g for gp in x.gaps), key=lambda z: -z[1])
        breakdown = dict(
            device_ops=[[k[:200], v] for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:10]],
            idle_gaps=[[k, v] for k, v in gaps[:10]])
    else:
        reqs = list(rec.reqs.values())
        values = dict(
            output_tok_s=stats.tokens_in(reqs, t0, t1) / seconds,
            itl_p99_ms=stats.percentile(stats.gaps_in(reqs, t0, t1),
                                        99) * 1e3,
            ttft_p95_ms=stats.percentile(stats.ttfts(reqs, t0, t1),
                                         95) * 1e3,
            setup_s=setup_s)
        for mt in c["end_to_end"]:
            metrics[mt["name"]] = {"value": values[mt["name"]],
                                   "unit": mt["unit"]}

    # the program's state goes before the reference runs
    rec.release()
    del srv, run
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if not check:
        return dict(result=dict(metrics=metrics), load=load, values=values)
    t_ref = time.perf_counter()
    verdict = judge(rec, m, scheme, w, k_up, k_lo, seed,
                    wl["judge"]["requests"], control=control)
    verdict["seconds"] = time.perf_counter() - t_ref
    checks, correct = checked(wl["limits"], verdict)
    result = dict(
        correct=bool(correct), attempted=len(attempted), failed=failed,
        metrics=metrics,
        device=dict(platform="gpu" if torch.cuda.is_available() else "cpu",
                    kind=(torch.cuda.get_device_name(0)
                          if torch.cuda.is_available() else "cpu"),
                    count=c["entry"]["chips"], memory_peak_bytes=int(mem),
                    **dev))
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    out = dict(result=result, verdict=verdict, load=load)
    if control:
        ctrl_checks, ctrl_correct = checked(wl["limits"], verdict["control"])
        out["control"] = dict(correct=ctrl_correct, checks=ctrl_checks)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = spec.cell(spec.benchmark(CHECKOUT), args.workload)
    import torch

    need = c["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"needs {need} card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {power_limit()}")
    out = run_cell(c, args.seed, args.seconds, bool(args.trace))
    found = foreign_modules()
    if found:
        log(f"modules that must not load were loaded: {', '.join(found)}")
        return 3
    res, v = out["result"], out["verdict"]
    log("judge: " + json.dumps(v))
    for name, chk in res["checks"].items():
        log(f"check {name} {chk['value']} limit {chk['limit']}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
