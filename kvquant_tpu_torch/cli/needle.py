"""Needle-in-haystack evaluation CLI (port of kvquant_tpu/cli/needle.py;
the reference's lwm/eval_haystack_pytorch_quant.py).

  python -m kvquant_tpu_torch.cli.needle --quantizers q.npz \
      --ctx 2048,4096 --depths 0,25,50,75,100 --results results.json \
      [--device cpu]
"""

from __future__ import annotations

import argparse

from . import common
from .generate import add_kernel_arg
from .passkey import quantized_generate_fn
from ..evals.needle import NeedleHaystackTester, accuracy_grid


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(ap)
    common.add_storage_args(ap)
    ap.add_argument("--quantizers", required=True)
    add_kernel_arg(ap)
    ap.add_argument("--ctx", default="2048,4096")
    ap.add_argument("--depths", default="0,25,50,75,100")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--results", default=None, help="resumable JSON path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    params, cfg = common.load_model(args)
    tok = common.load_tokenizer(args)
    ctxs = [int(c) for c in args.ctx.split(",")]
    depths = [float(d) for d in args.depths.split(",")]

    tester = NeedleHaystackTester(
        quantized_generate_fn(args, params, cfg, max(ctxs) + 64), tok,
        context_lengths=ctxs, depth_percents=depths, rounds=args.rounds,
        results_path=args.results, seed=args.seed,
    )
    grid = accuracy_grid(tester.run())
    for (ctx, depth), acc in sorted(grid.items()):
        print(f"ctx {ctx} depth {depth:5.1f}%: {acc:.2%}")
    return grid


if __name__ == "__main__":
    main()
