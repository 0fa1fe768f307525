"""Whole-prompt admission of Mistral-7B-Instruct-v0.2 on one NVIDIA card:
the device time of one admission chunk at several sub-widths, and the
checks of the sub-chunks and of the one-row LM head against the padded
chunk.

    python3 admission_ablation.py [--widths 1024,2048,4096,16384]
        [--lengths 2048,9216,16384] [--reps 3] [--seed N]

The weights are the benchmark's (``portbench/pbench/model.py``: bf16
drawn from the seed), the scheme ``portbench/schemes/nuq3-k1.json``, the
capacity and ``admit_chunk`` those of the ``mistral7b-nuq3-longdoc``
cell. Each sub-width (``serve.ADMIT_SUB_CHUNK``) gets a ``serve.Server``
of one slot; its first admission, of the longest prompt, captures both
graph shapes. Per width and prompt length: the median device ms of
``reps`` admissions (the ``engine.chunk`` span's CUDA events: every
replay of the chunk and the copies between them), the rows run, and the
prompt's real rows' model TFLOP/s. The width 16384 runs every prompt as
one padded chunk of 16389 rows, as the servers before sub-chunks did,
with the one-row LM head. Checks against it, at each width: the first
token's logits (max |diff|, argmax) and the share of the slot's 3-bit
codes that agree. One profiled admission at each width splits its device
time by kernel: K1's fd_chunk (+ fd_merge) beside its bound, GEMMs, the
rest, and the 15 kernels that take longest.
The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "portbench"))

from pbench import arith  # noqa: E402
from pbench.model import build_server, k_thresholds, make_weights  # noqa
from kvquant_tpu_torch import engine, serve  # noqa: E402
from kvquant_tpu_torch.ops.packing import unpack_codes  # noqa: E402
from kvquant_tpu_torch.utils.profiling import SPANS  # noqa: E402

CFG = os.path.join(ROOT, "portbench", "configs", "mistral-7b-v0.2")
SCHEME = os.path.join(ROOT, "portbench", "schemes", "nuq3-k1.json")
CHUNK, MAX_LEN = 16384, 16897  # the cell's admit_chunk and capacity


def log(msg):
    print(msg, flush=True)


def admit(srv, rid, prompt):
    """``prompt`` admitted alone (one token, no decode step): the
    admission chunk's device seconds, the rows of its replays and the
    first token's logits."""
    seen = {}
    sample = srv._sample_with

    def keep(req, logits):
        seen["logits"] = np.array(logits, np.float32)
        return sample(req, logits)

    srv._sample_with = keep
    t0 = SPANS.clock()
    srv.run([serve.Request(rid=rid, prompt=prompt, max_new_tokens=1)])
    torch.cuda.synchronize()
    SPANS.device_idle()
    (sp,) = [s for s in SPANS.read(t0, SPANS.clock())["spans"]
             if s.name == "engine.chunk"]
    srv._sample_with = sample
    return sp.device_s, sp.rows, seen["logits"]


def codes(srv, n):
    """The slot's K and V codes at its first ``n`` packed positions, int8,
    unpacked a layer at a time."""
    c, bits = srv.cache, srv.dcfg.bits
    return [torch.stack([unpack_codes(x[li, 0], bits)[..., :n, :].to(
        torch.int8) for li in range(x.shape[0])])
        for x in (c.k_planes, c.v_planes)]


def profiled(srv, m, scheme, rid, prompt):
    """One admission under the profiler: device seconds by kind, and K1's
    fd_chunk bound over the rows the replays ran."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, rows, _ = admit(srv, rid, prompt)
    by, names = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = ("fd_chunk" if "fd_chunk" in e.name or "fd_merge" in e.name
             else "gemm" if any(x in e.name for x in (
                 "gemm", "nvjet", "cutlass", "sm90_xmma")) else "other")
        s = e.time_range.elapsed_us() * 1e-6
        by[k] = by.get(k, 0.0) + s
        names[e.name[:90]] = names.get(e.name[:90], 0.0) + s
    bound, first = 0.0, 0
    for n in rows:
        bound += arith.roofline_seconds(*arith.k1_chunk_bound(
            m, scheme, first, n))
        first += n
    return dict(by_kind_s=by, top=sorted(names.items(),
                                         key=lambda kv: -kv[1])[:15],
                k1_bound_s=bound,
                k1_roofline_pct=100.0 * bound / by["fd_chunk"]
                if by.get("fd_chunk") else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default="1024,2048,4096,16384")
    ap.add_argument("--lengths", default="2048,9216,16384")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 7)
    args = ap.parse_args(argv)
    widths = [int(x) for x in args.widths.split(",")]
    lengths = [int(x) for x in args.lengths.split(",")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    log(f"card: {card}; torch {torch.__version__}")
    with open(os.path.join(CFG, "config.json")) as f:
        m = arith.model_dims(json.load(f))
    with open(SCHEME) as f:
        scheme = json.load(f)
    w = make_weights(m, args.seed, "cuda")
    k_up, k_lo = k_thresholds(m, scheme, args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = {t: rng.integers(0, m["V"], t).astype(np.int32)
               for t in lengths}
    longest = max(lengths)
    out, base = dict(card=card, widths={}), {}
    rid = 0
    for width in sorted(widths, reverse=True):  # the padded chunk first
        serve.ADMIT_SUB_CHUNK = width
        srv = build_server(CFG, m, scheme, w, k_up, k_lo, 1, MAX_LEN, CHUNK,
                           "cuda")
        admit(srv, rid, prompts[longest])  # captures both shapes
        rid += 1
        res = {}
        for t in lengths:
            dev, rows = [], None
            for _ in range(args.reps):
                s, rows, lg = admit(srv, rid, prompts[t])
                rid += 1
                dev.append(s)
            n = t - scheme["sink"]
            cs = codes(srv, n)
            if t not in base:
                base[t] = (lg, cs)
            lg0, cs0 = base[t]
            ms = statistics.median(dev) * 1e3
            res[t] = dict(
                device_ms=ms, runs_ms=[x * 1e3 for x in dev],
                rows=sum(rows), replays=len(rows),
                tflops=arith.prompt_flops(m, 0, t) / (ms * 1e-3) / 1e12,
                logit_max_diff=float(np.abs(lg - lg0).max()),
                argmax_same=bool(lg.argmax() == lg0.argmax()),
                codes_agree=[float((a == b).float().mean())
                             for a, b in zip(cs, cs0)])
            log(f"width {width} T {t}: {ms:.2f} ms ({res[t]['tflops']:.1f} "
                f"TFLOP/s of the real rows), {res[t]['rows']} rows in "
                f"{len(rows)} replays; against the padded chunk: logits "
                f"max |diff| {res[t]['logit_max_diff']:.4g}, argmax same "
                f"{res[t]['argmax_same']}, codes agree "
                f"{res[t]['codes_agree']}")
            del cs
        prof = profiled(srv, m, scheme, rid, prompts[longest])
        rid += 1
        log(f"width {width} T {longest} profiled: {json.dumps(prof)}")
        # the one-row head against the full logits of the same sink chunk
        adm, S, sw = srv._adm, srv.dcfg.sink, srv.sub_chunk
        toks = np.zeros(S + sw, np.int32)  # padded as the server pads
        row = min(longest, S + sw) - 1
        toks[:row + 1] = prompts[longest][:row + 1]
        blk = torch.as_tensor(toks, device="cuda")[None]
        adm.start()
        _, full = engine.prefill_chunk(srv.params, srv.cfg, srv.dcfg, srv.dq,
                                       adm.cache, blk, S, True)
        adm.start()
        one = adm.chunk(blk, S, True, row)
        head = float((one[0] - full[0, row]).abs().max())
        log(f"width {width}: one-row head (graph) against row {row} of the "
            f"eager full logits: max |diff| {head:.4g}")
        out["widths"][width] = dict(lengths=res, profiled=prof,
                                    head_max_diff=head,
                                    capture_mib=sum(g.pool_mib for g in
                                                    adm.graphs.values()))
        del srv, adm, full, one
        gc.collect()
        torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
