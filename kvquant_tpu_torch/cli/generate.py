"""Long-context generation CLI (port of kvquant_tpu/cli/generate.py; the
reference's lwm/llama_inference.py: load the quantizer checkpoint, build
the deployment config, generate).

  python -m kvquant_tpu_torch.cli.generate --quantizers q.npz \
      --prompt "..." --max-new-tokens 64 [--device cpu]

The model is a random init (see cli/common.py): its weights are drawn from
a torch generator, not the JAX CLI's PRNGKey(0), so the text differs from
the JAX CLI's for the same flags.
"""

from __future__ import annotations

import argparse

import torch

from . import common
from .. import engine
from ..cache import DeployConfig, deployed_from_quantizers
from ..quant.artifacts import load_quantizers


def add_kernel_arg(ap: argparse.ArgumentParser):
    ap.add_argument("--kernel", default="pallas",
                    choices=["flash", "flash_serial", "pallas", "xla"],
                    help="attention datapath: pallas (the two-pass Hopper "
                         "kernels K3/K4), flash (K1), flash_serial (K2, "
                         "post-RoPE intN), xla (eager PyTorch)")


def deploy_config(args, qs, cfg, max_len: int, **kw) -> DeployConfig:
    """The CLIs' DeployConfig from the storage flags and the artifact
    (``kw``: further ``DeployConfig.create`` arguments)."""
    return DeployConfig.create(
        bits=qs.bits, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        max_len=max_len, sink=qs.first_few_fp16, kernel=args.kernel,
        head_group=args.head_group, codes=args.codes,
        post_rope_k=(args.post_rope_k
                     or bool(qs.meta.get("post_rope_k", False))),
        k_outliers=args.k_outliers, n_kc=args.n_kc, **kw,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(ap)
    common.add_storage_args(ap)
    ap.add_argument("--quantizers", required=True)
    add_kernel_arg(ap)
    ap.add_argument("--prompt", default="The quick brown fox")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--maxlen", type=int, default=None)
    ap.add_argument("--prefill-mode", default="fp16",
                    choices=["fp16", "quantized"],
                    help="fp16: reference flash-then-pack semantics; "
                         "quantized: chunked quantized-trajectory prefill "
                         "(memory-bounded, decode-consistent)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    params, cfg = common.load_model(args)
    tok = common.load_tokenizer(args)
    qs = load_quantizers(args.quantizers)

    ids = torch.tensor([tok.encode(args.prompt)], dtype=torch.int32)
    maxlen = args.maxlen or (ids.shape[1] + args.max_new_tokens + 32)
    dcfg = deploy_config(args, qs, cfg, maxlen)
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                  device=args.device)
    gcfg = engine.GenerateConfig(
        max_new_tokens=args.max_new_tokens, temperature=args.temperature,
        top_p=args.top_p,
    )
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    out, _ = engine.generate(params, cfg, dcfg, dq, ids, gcfg, generator=gen,
                             prefill_mode=args.prefill_mode,
                             device=args.device)
    text = tok.decode(out[0].tolist())
    print(text)
    return text


if __name__ == "__main__":
    main()
