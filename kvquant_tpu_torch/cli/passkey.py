"""Passkey-retrieval evaluation CLI (port of kvquant_tpu/cli/passkey.py;
the reference's quant/eval_passkey_simquant.py).

  python -m kvquant_tpu_torch.cli.passkey --quantizers q.npz \
      --ctx 2048,4096 --trials 50 [--device cpu]

Without --quantizers the fp16 baseline (baseline_fp16) decodes instead.
"""

from __future__ import annotations

import argparse

import torch

from . import common
from .generate import add_kernel_arg, deploy_config
from .. import engine
from ..cache import deployed_from_quantizers
from ..evals.passkey import eval_passkey
from ..quant.artifacts import load_quantizers


def quantized_generate_fn(args, params, cfg, max_len: int):
    """generate_fn(prompt_ids (1, T), max_new_tokens) -> token ids through
    the deployed engine (greedy, fp16 prefill)."""
    qs = load_quantizers(args.quantizers)
    dcfg = deploy_config(args, qs, cfg, max_len)
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                  device=args.device)

    def generate_fn(ids, max_new_tokens):
        out, _ = engine.generate(
            params, cfg, dcfg, dq, torch.as_tensor(ids, dtype=torch.int32),
            engine.GenerateConfig(max_new_tokens=max_new_tokens),
            device=args.device)
        return out[0].cpu().numpy()

    return generate_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(ap)
    common.add_storage_args(ap)
    ap.add_argument("--quantizers", default=None,
                    help="omit for the fp16 baseline")
    add_kernel_arg(ap)
    ap.add_argument("--ctx", default="2048,4096",
                    help="comma-separated context lengths")
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    params, cfg = common.load_model(args)
    tok = common.load_tokenizer(args)
    ctxs = [int(c) for c in args.ctx.split(",")]

    if args.quantizers:
        generate_fn = quantized_generate_fn(args, params, cfg, max(ctxs) + 64)
    else:
        from .. import baseline_fp16

        def generate_fn(ids, max_new_tokens):
            cache = baseline_fp16.create_fp16_cache(
                cfg, ids.shape[1] + max_new_tokens + 1, 1,
                device=args.device)
            cache, logits = baseline_fp16.prefill(
                params, cfg, cache, torch.as_tensor(ids, dtype=torch.int32))
            toks = []
            pos = ids.shape[1]
            for _ in range(max_new_tokens):
                t = torch.argmax(logits, -1).to(torch.int32)
                toks.append(int(t[0]))
                cache, logits = baseline_fp16.decode_step(params, cfg, cache,
                                                          t, pos)
                pos += 1
            return toks

    results = eval_passkey(generate_fn, tok, ctx_lengths=ctxs,
                           n_trials=args.trials, seed=args.seed)
    for r in results:
        print(f"ctx {r.ctx_tokens}: accuracy {r.accuracy:.2%}")
    return results


if __name__ == "__main__":
    main()
