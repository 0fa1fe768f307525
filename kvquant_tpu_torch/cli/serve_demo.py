"""Continuous-batching serving demo CLI (port of kvquant_tpu/cli/
serve_demo.py): N requests with different prompt lengths and budgets share
a fixed slot pool; slots decode at independent positions in one step.

  python -m kvquant_tpu_torch.cli.serve_demo --quantizers q.npz --slots 4 \
      --requests 8 [--paged] [--device cpu]

``--paged`` serves from the page pool (paged.PagedServer: decode through
the paged kernel K5, chunked admission through K1); without it the slot
pool (serve.Server, ``--kernel``, default flash). The requests are drawn
from ``--seed`` with numpy as the JAX CLI draws them; the model is a random
init (cli/common.py). At the end it prints the serving path's spans over
the run (``utils.profiling.SPANS``: count, host ms and device ms of each,
the host gaps' total, share and part outside the program); the page pool
records none. ``main`` returns the completions {rid: Completion}.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from . import common
from .generate import deploy_config
from .. import serve
from ..cache import deployed_from_quantizers
from ..quant.artifacts import load_quantizers
from ..utils.profiling import SPANS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(ap)
    common.add_storage_args(ap)
    ap.add_argument("--quantizers", required=True)
    ap.add_argument("--kernel", default="flash",
                    choices=["flash", "flash_serial", "pallas", "xla"])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--admit-mode", default="chunked",
                    choices=["chunked", "sync"],
                    help="chunked: one prompt chunk per step (active slots "
                         "never stall); sync: whole-prompt prefill per admit")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--maxlen", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="page-pool cache (memory proportional to cached "
                         "tokens, free-list reuse) instead of the slot-pool "
                         "cache")
    ap.add_argument("--pages", type=int, default=None,
                    help="pool pages (default: slots * pages-per-slot)")
    ap.add_argument("--page-tokens", type=int, default=1024)
    args = ap.parse_args(argv)

    params, cfg = common.load_model(args)
    qs = load_quantizers(args.quantizers)
    maxlen = args.maxlen or (args.prompt_len + args.max_new_tokens + 64)
    dcfg = deploy_config(args, qs, cfg, maxlen)
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                  device=args.device)

    rng = np.random.default_rng(args.seed)
    reqs = [
        serve.Request(
            rid=i,
            prompt=rng.integers(
                0, cfg.vocab_size,
                size=int(args.prompt_len * rng.uniform(0.5, 1.0)),
            ).astype(np.int32),
            max_new_tokens=int(args.max_new_tokens * rng.uniform(0.5, 1.0)),
        )
        for i in range(args.requests)
    ]

    if args.paged:
        from ..paged import PagedServer, paged_pool_bytes

        dcfg = dataclasses.replace(dcfg, page_tokens=args.page_tokens,
                                   kernel="flash")
        mp = max(1, -(-(maxlen - dcfg.sink) // args.page_tokens))
        n_pages = args.pages or args.slots * mp
        srv = PagedServer(params, cfg, dcfg, dq, n_pages=n_pages,
                          n_slots=args.slots, max_pages_per_slot=mp,
                          admit_mode=args.admit_mode, device=args.device)
        pb = paged_pool_bytes(dcfg, cfg.n_layers, n_pages, args.slots)
        print(f"paged pool: {n_pages} pages x {args.page_tokens} tok "
              f"({pb/2**20:.1f} MiB)")
    else:
        srv = serve.Server(params, cfg, dcfg, dq, n_slots=args.slots,
                           admit_mode=args.admit_mode, device=args.device)
    t0 = time.perf_counter()
    results = srv.run(reqs)
    t1 = time.perf_counter()
    dt = t1 - t0
    total = sum(len(c.tokens) for c in results.values())
    print(f"served {len(reqs)} requests / {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s aggregate, {args.slots} slots)")
    for rid in sorted(results):
        print(f"  req {rid}: {len(results[rid].tokens)} tokens")
    print_spans(SPANS.read(t0, t1)["summary"])
    return results


def print_spans(summary: dict):
    """The recorder's ``read(...)["summary"]``, one line a span name."""
    by = summary["by_name"]
    if not by:
        print("spans: none recorded")
        return
    print(f"spans over {summary['wall_s'] * 1e3:.1f} ms "
          f"(count, host ms, device ms):")
    for name, e in by.items():
        dev = (f"{e['device_s'] * 1e3:10.3f}" if e.get("device_n")
               else f"{'-':>10}")
        print(f"  {name:20s} {e['count']:6d} {e['host_s'] * 1e3:10.3f} {dev}")
    g = summary["host_gap"]
    print(f"host gaps: {g['n']} gaps, {g['s'] * 1e3:.3f} ms "
          f"({g['pct']:.2f}% of the run), {g['outside_s'] * 1e3:.3f} ms "
          f"of it outside the program")


if __name__ == "__main__":
    main()
