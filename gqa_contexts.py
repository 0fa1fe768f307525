"""K4 and K2 at DBRX's G 6 over capacities of 2K to 32K tokens, each new
route beside the route of before forced in the same call, on one NVIDIA
card.

    python3 gqa_contexts.py

One DBRX layer (8 kv heads, D 128, 6 query rows per kv head): K4 on
pv_gqa beside pv_decode's 8-row instance (the faithful nuq3 config, kernel
"pallas", bf16 dots), K2 on fs_mma at its 6 rows beside the rows padded to
8 (the speed config, bf16 dots), each held to
its plain version at every capacity; CUDA events as chip_smoke.py phase 25
times them (the lower of two medians). chip_smoke.py times 32K only; this
script says whether the routes hold at the short contexts a DBRX decode
also runs (a 2K prompt's steps). The last line is one JSON object with
every time.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import torch

import chip_smoke as cs

CONTEXTS = (2048, 4096, 8192, 16384, 32768)


def main() -> int:
    if not torch.cuda.is_available():
        print("gqa_contexts: no CUDA device", file=sys.stderr)
        return 2
    from kvquant_tpu_torch.models.config import ModelConfig
    from kvquant_tpu_torch.ops.kernels import attention as at
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    one = ModelConfig(vocab_size=64, d_model=6144, n_layers=1, n_heads=48,
                      n_kv_heads=8, d_head=128, d_ff=64,
                      max_seq_len=max(CONTEXTS) + 128, rope_theta=500000.0)
    gen = torch.Generator(device=dev).manual_seed(5)

    def best(fn):
        return min(cs.device_ms(fn), cs.device_ms(fn))

    times = {}
    for ctx in CONTEXTS:
        _, dcfg, _ = cs.faithful_config(ctx + 8, 1, one)
        dp = dataclasses.replace(dcfg, kernel="pallas")
        o = cs.k34_operands(dp, 1, 6, dp.cache_tokens, gen, dev)

        def k4(body=None, fn=at.pv_fused):
            return fn(o["probs"], o["v_planes"], o["v_scale"], o["v_offset"],
                      o["kv_out"], o["v_lut"], dp,
                      **({"body": body} if body else {}))
        cs.agree(f"K4 R6 Tc {dp.cache_tokens} (pv_gqa)", k4(),
                 k4(fn=at.pv_fused_ref), True)
        times[f"K4 R6 ctx {ctx}"] = t = {"pv_gqa": best(k4),
                                         "pv_decode": best(lambda: k4(
                                             "decode"))}
        print(f"K4 R6 Tc {dp.cache_tokens}: pv_gqa {t['pv_gqa']:.4f} ms, "
              f"8-row pv_decode {t['pv_decode']:.4f} ms", flush=True)
        del o

        dcfg2, _ = cs.dbrx_speed_config(one, ctx + 8, 1)
        ops = cs.kernel_operands(dcfg2, one, 1, 1, 6, dcfg2.cache_tokens,
                                 gen, dev)
        chan = fs.k_channel_index(ops["k_ressc"], dcfg2).to(torch.int32)
        q = torch.randn((1, 8, 6, 128), generator=gen, device=dev)
        pos = torch.tensor([ctx - 1], dtype=torch.int32, device=dev)

        def k2(body=None, fn=fs.flash_serial_decode):
            return fn(q, ops["k_planes"], ops["v_planes"], ops["kv_out"],
                      ops["k_range"], ops["k_offset"], ops["v_scale"],
                      ops["v_offset"], ops["k_sink"], ops["v_sink"],
                      ops["k_lut"], ops["v_lut"], 0, pos, dcfg2, one,
                      k_chan=chan, **({"body": body} if body else {}))
        cs.agree(f"K2 G6 ctx {ctx} (fs_mma, 6 rows)", k2(),
                 k2(fn=fs.flash_serial_decode_ref), True)
        plan = fs.fs_plan(dcfg2, 1, 8, 6, 128, dcfg2.cache_tokens, dev)
        times[f"K2 G6 ctx {ctx}"] = t = {"fs_mma": best(k2),
                                         "padded": best(lambda: k2(
                                             fs.PADDED)),
                                         "n_split": plan.n_split}
        print(f"K2 G6 ctx {ctx}: fs_mma at 6 rows {t['fs_mma']:.4f} ms, "
              f"padded to 8 rows {t['padded']:.4f} ms "
              f"({plan!r})", flush=True)
        del ops
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "g6_ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
