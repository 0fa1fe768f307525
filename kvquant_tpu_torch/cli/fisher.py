"""Fisher-information calibration CLI (port of kvquant_tpu/cli/fisher.py;
the reference's gradients/run-fisher.py).

Computes per-element squared activation gradients of the CLM loss for the
K / V projections over the calibration samples and saves them as an npz
with the JAX CLI's keys and dtypes (``fisher_k``, ``fisher_v`` fp32
(L, N_tokens, C), ``seqlen`` int32), which ``cli.calibrate --fisher`` of
either package reads.

  python -m kvquant_tpu_torch.cli.fisher --nsamples 16 --seqlen 2048 \
      --output fisher.npz [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import common
from ..fisher.fisher import fisher_info


def main(argv=None):
    """Returns (fisher_k, fisher_v) (also written to --output)."""
    ap = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(ap)
    common.add_data_args(ap)
    ap.add_argument("--output", required=True, help=".npz output path")
    ap.add_argument("--batch", type=int, default=1,
                    help="samples per fwd+bwd step")
    args = ap.parse_args(argv)

    params, cfg = common.load_model(args)
    train, _ = common.load_data(args, cfg)

    batches = [torch.as_tensor(train[i:i + args.batch])
               for i in range(0, len(train), args.batch)]
    fk, fv = fisher_info(params, cfg, batches)
    np.savez(args.output, fisher_k=fk.cpu().numpy(),
             fisher_v=fv.cpu().numpy(), seqlen=np.int32(args.seqlen))
    print(f"saved fisher info {tuple(fk.shape)} -> {args.output}")
    return fk, fv


if __name__ == "__main__":
    main()
