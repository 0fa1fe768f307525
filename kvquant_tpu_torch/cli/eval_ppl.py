"""Simulated-quantization perplexity evaluation CLI (port of
kvquant_tpu/cli/eval_ppl.py; the reference's quant/llama_simquant.py eval
path).

  python -m kvquant_tpu_torch.cli.eval_ppl --quantizers q.npz \
      [--deployed --kernel flash] [--device cpu]

The simulated ppl runs the model with fake-quantized K / V
(evals.ppl.perplexity). ``--deployed`` also decodes the first window token
by token through the packed cache (engine.deployed_ppl, the reference's
--check oracle): through the two-pass kernels K3 / K4 by default
(``--kernel pallas``), through K1 with ``--kernel flash``.
"""

from __future__ import annotations

import argparse

import torch

from . import common
from .generate import add_kernel_arg, deploy_config
from ..evals.ppl import perplexity
from ..models.llama import simquant_from_quantizers
from ..quant.artifacts import load_quantizers


def main(argv=None):
    """Returns (simulated or fp16 ppl, deployed ppl or None)."""
    ap = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(ap)
    common.add_storage_args(ap)
    common.add_data_args(ap)
    ap.add_argument("--quantizers", default=None,
                    help="npz artifact; omit for the fp16 baseline ppl")
    ap.add_argument("--v-mode", default="topk",
                    choices=["topk", "percentile"])
    ap.add_argument("--max-windows", type=int, default=8)
    ap.add_argument("--deployed", action="store_true",
                    help="also run the real packed-cache decode ppl "
                         "(the reference's --check oracle)")
    add_kernel_arg(ap)
    args = ap.parse_args(argv)

    params, cfg = common.load_model(args)
    _, test = common.load_data(args, cfg)
    test = torch.as_tensor(test[: args.max_windows])

    sq = qs = None
    if args.quantizers:
        qs = load_quantizers(args.quantizers)
        sq = simquant_from_quantizers(
            qs, v_mode=args.v_mode, n_kv_heads=cfg.n_kv_heads,
            k_outliers=args.k_outliers, n_kc=args.n_kc, device=args.device)
        print(f"quantizers: {qs.bits}-bit, sparsity "
              f"{qs.sparsity_threshold}, sink {qs.first_few_fp16}")

    ppl = perplexity(params, cfg, test, simquant=sq)
    tag = "quantized" if sq else "fp16"
    print(f"{tag} ppl over {test.shape[0]}x{test.shape[1]} tokens: {ppl:.4f}")

    dep = None
    if args.deployed and qs is not None:
        from .. import engine
        from ..cache import deployed_from_quantizers

        dcfg = deploy_config(args, qs, cfg, test.shape[1] + 32)
        dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                      device=args.device)
        dep = engine.deployed_ppl(params, cfg, dcfg, dq, test[:1],
                                  device=args.device)
        print(f"deployed ppl (first window, kernel={args.kernel}): "
              f"{dep:.4f}")
    return ppl, dep


if __name__ == "__main__":
    main()
