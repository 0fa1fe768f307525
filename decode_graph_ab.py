"""Two checkouts of kvquant_tpu_torch against each other on one NVIDIA
card: the eager decode step's device time and kernels, and the wall time
of the short generate calls that the passkey and needle evals make.

    python3 decode_graph_ab.py --root DIR --tag NAME

Imports kvquant_tpu_torch from DIR (a checkout, or an unpacked
`git archive` of one; by default this script's own directory) and
chip_smoke.py's helpers from this script's directory. At LLaMA-2-7B
width (random bf16 weights from seed 0), B=1:

  - eager: ``engine.decode_step`` at host-int positions, as ``generate``
    passes them, over a filled 32K cache, for the speed config (K2),
    faithful nuq3 through K1 and K3 / K4 and 2-bit int4x2 through K1: the
    profiler's kernel ms and kernels a step (chip_smoke.step_profile).
    Where the checkout computes the static K channels once per step
    builder (``cache.static_channels``), they are passed in, as its
    ``decode_stepper`` does;
  - generate: ``engine.generate`` of 9 greedy tokens (a 5-digit passkey
    plus 4, as evals.passkey asks) after the prefill of a random prompt
    of 2K (3 prompts, the fp16 prefill the passkey CLI runs) and 32K (1
    prompt, the quantized prefill: the fp16 prefill of 32K tokens does
    not fit an 80 GB card at this width, in either checkout), faithful
    nuq3 through ``pallas`` (cli.passkey's default) and ``flash``: the
    wall seconds of each call between two synchronizes, and of the
    prefill inside it.

The kernels are built from DIR's csrc as chip_smoke.py phase 1 builds
them. Run one process per checkout, in the order parent, change, change,
parent, in one call. Prints one line per measurement and, last, one JSON
object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
NEW_TOKENS = 9
PATHS = (  # (tag, chip_smoke config maker, kernel)
    ("K2 speed int4", "speed_config", "flash_serial"),
    ("K1 nuq3", "faithful_config", "flash"),
    ("K3/K4 nuq3", "faithful_config", "pallas"),
    ("K1 int4x2", "speed2_config", "flash"),
)
PROMPTS = {2048: 3, 32768: 1}  # context -> prompts


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose kvquant_tpu_torch is measured")
    ap.add_argument("--tag", default="change")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_graph_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import kvquant_tpu_torch
    from kvquant_tpu_torch import cache as kcache, engine
    from kvquant_tpu_torch.models import init_params
    from kvquant_tpu_torch.models.config import LLAMA2_7B

    cs = load_smoke()
    cs.phase_device_and_build({})
    # a checkout whose phase 1 leaves its longest build running
    getattr(cs, "finish_builds", lambda report: None)({})
    out = {"tag": args.tag, "package": kvquant_tpu_torch.__file__,
           "eager_32k": {}, "generate": {}}
    cfg = LLAMA2_7B
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16, device="cuda")
    static = getattr(kcache, "static_channels", None)

    ctx = 32768
    for tag, make, kernel in PATHS:
        _, dcfg, qs = getattr(cs, make)(ctx + 16, cfg.n_layers)
        dcfg = cs.dataclasses.replace(dcfg, kernel=kernel)
        dq = kcache.deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                             device="cuda")
        cache = cs.filled_cache(dcfg, cfg.n_layers, ctx, 3)
        kw = {} if static is None else {"k_chan": static(dq, dcfg)}
        tok = torch.zeros((1,), dtype=torch.int32, device="cuda")
        kms, kern = cs.step_profile(lambda: engine.decode_step(
            params, cfg, dcfg, dq, cache, tok, ctx, **kw), n=3)
        out["eager_32k"][tag] = {"kernel_ms": kms, "kernels": kern}
        cs.log(f"[{args.tag}] eager {tag} 32K: {kms:.3f} device kernel ms, "
               f"{kern:.0f} kernels a step")
        del cache, dq
        torch.cuda.empty_cache()

    prefill_s = []
    real = {n: getattr(engine, n) for n in ("prefill", "prefill_quantized")}

    def timed(fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
            return r
        return run

    for n, fn in real.items():
        setattr(engine, n, timed(fn))
    rng = np.random.default_rng(15)
    for kernel in ("pallas", "flash"):
        for ctx, n in PROMPTS.items():
            _, dcfg, qs = cs.faithful_config(ctx + NEW_TOKENS + 64,
                                             cfg.n_layers)
            dcfg = cs.dataclasses.replace(dcfg, kernel=kernel)
            dq = kcache.deployed_from_quantizers(
                qs, cfg.n_kv_heads, cfg.d_head, device="cuda")
            calls = []
            for _ in range(n):
                ids = torch.as_tensor(rng.integers(
                    0, cfg.vocab_size, (1, ctx), dtype=np.int32))
                prefill_s.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.generate(
                    params, cfg, dcfg, dq, ids,
                    engine.GenerateConfig(max_new_tokens=NEW_TOKENS),
                    prefill_mode="fp16" if ctx <= 4096 else "quantized")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                calls.append({"wall_s": wall, "prefill_s": prefill_s[0],
                              "decode_s": wall - prefill_s[0]})
                torch.cuda.empty_cache()
            key = f"{kernel} {ctx}"
            out["generate"][key] = calls
            cs.log(f"[{args.tag}] generate {key}: {NEW_TOKENS} tokens a "
                   f"call; wall s {[round(c['wall_s'], 4) for c in calls]}, "
                   f"of it after the prefill "
                   f"{[round(c['decode_s'], 4) for c in calls]}")
            del dq
    for n, fn in real.items():
        setattr(engine, n, fn)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
