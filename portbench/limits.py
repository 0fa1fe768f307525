#!/usr/bin/env python3
"""The readings a cell's correctness limit is set from: for each seed, one
run of the cell as ``run.py`` makes it (``--seconds`` of traffic), then the
gaps of the program's served tokens and (``--control-seeds``) of the fp8
control's first choices at the same positions, both against the fp32
reference, and each side's ``correct`` by the cell's limits as they stand:
the control, put in the program's place, has to come out not correct.

    python3 portbench/limits.py --workload <cell> --seconds <s> \
        --seeds 11,12,13 [--control-seeds 11,12,13]

One JSON line per seed. The lower reading is the largest program gap over
a dozen seeds or more, the upper the smallest control gap (three seeds or
more); the limit in ``workloads/<cell>.json`` lies between them. Not part
of a benchmark run.
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    c = bench.spec.cell(bench.spec.benchmark(bench.CHECKOUT), args.workload)
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        out = bench.run_cell(c, seed, args.seconds, False,
                             control=seed in ctrl)
        print(json.dumps(dict(seed=seed, **out["verdict"],
                              correct=out["result"]["correct"],
                              control_correct=out.get("control", {}).get(
                                  "correct"),
                              metrics=out["result"]["metrics"])), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
