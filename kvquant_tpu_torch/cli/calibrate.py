"""Calibration + quantizer generation CLI (port of
kvquant_tpu/cli/calibrate.py; the reference's quant/llama_simquant.py
--quantize path: activation capture -> thresholds -> codebooks ->
artifact).

  python -m kvquant_tpu_torch.cli.calibrate --abits 2 --mode uniform \
      --post-rope-k --nsamples 16 --output q.npz [--fisher f.npz] \
      [--device cpu]

The artifact is the JAX package's npz format: either package loads a file
the other wrote. ``--fisher`` takes an npz with ``fisher_k`` / ``fisher_v``
(L, N_tokens, C) squared gradients over the same calibration stream.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import common
from ..quant.artifacts import save_quantizers
from ..quant.calibration import collect_kv_activations, fit_quantizers


def main(argv=None):
    """Returns the fitted QuantizerSet (also written to --output)."""
    ap = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(ap)
    common.add_quant_args(ap)
    common.add_data_args(ap)
    ap.add_argument("--fisher", default=None,
                    help=".npz of fisher_k / fisher_v (sample-weights the "
                         "k-means)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--kmeans-iters", type=int, default=50)
    ap.add_argument("--mode", default="nuq", choices=["nuq", "nf", "uniform"],
                    help="nuq: Fisher-weighted k-means codebooks; nf: "
                         "NormalFloat signposts (reference --nf); uniform: "
                         "evenly spaced integer grid (reference quant_fn_zp)")
    args = ap.parse_args(argv)

    params, cfg = common.load_model(args)
    train, _ = common.load_data(args, cfg)

    k_acts, v_acts = collect_kv_activations(
        params, cfg, [torch.as_tensor(train)], rope_k=args.post_rope_k)
    fisher_k = fisher_v = None
    if args.fisher:
        with np.load(args.fisher) as z:
            fisher_k, fisher_v = z["fisher_k"], z["fisher_v"]
        assert fisher_k.shape == tuple(k_acts.shape), (
            fisher_k.shape, tuple(k_acts.shape),
            "fisher must be computed over the same calibration stream")

    qs = fit_quantizers(
        k_acts, v_acts, bits=args.abits,
        sparsity_threshold=args.sparsity_threshold,
        include_sparse=args.include_sparse, cap_outliers=args.cap_outliers,
        first_few_fp16=args.first_few_fp16, sample_seqlen=args.seqlen,
        fisher_k=fisher_k, fisher_v=fisher_v, qnorm=args.qnorm,
        seed=args.seed, kmeans_iters=args.kmeans_iters, mode=args.mode,
        meta=dict(model=args.model or "toy", dataset=args.dataset,
                  post_rope_k=args.post_rope_k),
    )
    save_quantizers(args.output, qs)
    print(f"saved {len(qs)}-layer {args.abits}-bit quantizers -> "
          f"{args.output}")
    return qs


if __name__ == "__main__":
    main()
