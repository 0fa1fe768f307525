#!/usr/bin/env python3
"""Find an open-loop cell's knee once: run the cell's traffic at each of a
few fixed rates and print, per rate, the end-to-end metrics and the
backlog (requests queued or being admitted) at the window's start and
end. The knee is the highest rate whose backlog does not grow; the cell's
traffic file then fixes its rate at about four fifths of it.

    python3 portbench/sweep.py --workload <cell> --seconds <s> \
        --rates 2,4,6,8 [--seed n]

Not part of a benchmark run; nothing is judged.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import run as bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    base = bench.spec.cell(bench.spec.benchmark(bench.CHECKOUT),
                           args.workload)
    for rate in [float(r) for r in args.rates.split(",")]:
        c = dict(base, traffic=dict(base["traffic"], rate_per_s=rate))
        out = bench.run_cell(c, args.seed, args.seconds, False, check=False)
        print(json.dumps(dict(rate_per_s=rate, load=out["load"],
                              **out["values"])), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
