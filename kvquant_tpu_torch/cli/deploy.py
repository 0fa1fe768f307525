"""Deployed-inference benchmark and correctness check CLI (port of
kvquant_tpu/cli/deploy.py; the reference's deployment/llama.py: a
token-by-token benchmark and ``--check``, deployed against simulated
perplexity through the real packed-cache datapath).

  python -m kvquant_tpu_torch.cli.deploy --quantizers q.npz --benchmark 64 \
      --check --kernel flash [--prefill N] [--profile DIR] [--device cpu]

The timed decode is an eager loop of ``engine.decode_step`` with greedy
argmax (the JAX CLI jits a scan of the same steps): one warm-up pass, then
the timed pass between two ``torch.cuda.synchronize()``. The cache is
updated in place, so each pass rewrites the rows of the one before from
the same prefilled state. ``--profile DIR`` traces one more pass with
``torch.profiler`` into DIR/trace.json and prints kernel launches and
device ms per step in place of XLA's cost analysis. The parallel flags
are accepted; anything but one device raises NotImplementedError (ROADMAP
queue 1 item 12).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from . import common
from .generate import deploy_config
from .. import engine
from ..cache import cache_bytes, create_cache, deployed_from_quantizers
from ..evals.ppl import perplexity
from ..models.llama import simquant_from_quantizers
from ..ops.kernels import launch_counts
from ..quant.artifacts import load_quantizers
from ..utils.profiling import kernel_summary, trace


def _decode(params, cfg, dcfg, dq, cache, tok, t0: int, steps: int):
    """``steps`` greedy decode steps from ``tok`` at position ``t0``;
    returns the last logits."""
    for i in range(steps):
        cache, logits = engine.decode_step(params, cfg, dcfg, dq, cache, tok,
                                           t0 + i)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return logits


def main(argv=None):
    """Returns a dict: cache_mib, sim_ppl / dep_ppl (with --check),
    tok_s, launches (kernel launches of the timed pass, by TPU kernel
    number), profile (``utils.profiling.kernel_summary``, with --profile)."""
    ap = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(ap)
    common.add_storage_args(ap)
    common.add_data_args(ap)
    common.add_parallel_args(ap)
    ap.add_argument("--quantizers", required=True)
    ap.add_argument("--kernel", default="flash",
                    choices=["flash", "flash_serial", "pallas", "xla"])
    ap.add_argument("--benchmark", type=int, default=64,
                    help="decode steps to time; the tokens are the first "
                         "max(prefill + benchmark, 16) of the first eval "
                         "window, so --seqlen must be at least that")
    ap.add_argument("--prefill", type=int, default=0,
                    help="prompt tokens to prefill before timing")
    ap.add_argument("--maxlen", type=int, default=None,
                    help="cache capacity (default prefill+benchmark+32)")
    ap.add_argument("--check", action="store_true",
                    help="also compute deployed ppl vs simulated ppl")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace one more decode pass with torch.profiler "
                         "into DIR/trace.json (Chrome trace format) and "
                         "print kernel launches and device ms per step")
    args = ap.parse_args(argv)

    common.setup_parallel(args)
    params, cfg = common.load_model(args)
    qs = load_quantizers(args.quantizers)
    maxlen = args.maxlen or (args.prefill + args.benchmark + 32)
    dcfg = deploy_config(args, qs, cfg, maxlen,
                         sparsity_threshold=qs.sparsity_threshold)
    dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                  device=args.device)
    cuda = params.embed.is_cuda
    out = {}

    acct = cache_bytes(dcfg, cfg.n_layers, 1)
    out["cache_mib"] = acct["total"] / 2**20
    print(f"cache: {acct['total']/2**20:.1f} MiB "
          f"({acct['ratio']:.2f}x smaller than fp16)")

    _, test = common.load_data(args, cfg)
    tokens = torch.as_tensor(
        test[:1, : max(args.prefill + args.benchmark, 16)]).to(
            params.embed.device)

    if args.check:
        sq = simquant_from_quantizers(qs, n_kv_heads=cfg.n_kv_heads,
                                      head_group=dcfg.head_group,
                                      k_outliers=dcfg.k_outliers,
                                      n_kc=dcfg.n_kc, device=args.device)
        out["sim_ppl"] = perplexity(params, cfg, tokens, simquant=sq)
        out["dep_ppl"] = engine.deployed_ppl(
            params, cfg, dcfg, dq, tokens, prefill_tokens=args.prefill,
            device=args.device)
        print(f"check: simulated ppl {out['sim_ppl']:.4f}  deployed ppl "
              f"{out['dep_ppl']:.4f}")

    steps = args.benchmark
    t0 = max(args.prefill, 1)
    cache = create_cache(dcfg, cfg.n_layers, 1, device=args.device)
    if args.prefill > dcfg.sink:
        cache, logits = engine.prefill(params, cfg, dcfg, dq, cache,
                                       tokens[:, : args.prefill])
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        tok = tokens[:, 0]

    def run():
        logits = _decode(params, cfg, dcfg, dq, cache, tok, t0, steps)
        if cuda:
            torch.cuda.synchronize()
        return logits

    run()  # warm-up
    if args.profile:
        with trace(args.profile) as prof:
            run()
        s = out["profile"] = kernel_summary(prof, cuda)
        print(f"profile ({steps} steps, {s['device']}): "
              f"{s['launches'] / steps:.0f} kernel launches/step, "
              f"{s['kernel_ms'] / steps:.3f} ms/step kernel time; trace "
              f"written to {os.path.join(args.profile, 'trace.json')}")
    before = launch_counts()
    t = time.perf_counter()
    logits = run()
    dt = time.perf_counter() - t
    out["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
    out["tok_s"] = steps / dt
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits in the timed decode")
    print(f"decode: {steps/dt:.2f} tok/s ({dt/steps*1e3:.2f} ms/token "
          f"mean, kernel={args.kernel})")
    ran = ", ".join(f"{k} {v}" for k, v in out["launches"].items() if v)
    print(f"kernel launches in the timed pass: "
          f"{ran or 'none (plain PyTorch versions)'}")
    return out


if __name__ == "__main__":
    main()
