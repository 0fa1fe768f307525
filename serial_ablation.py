"""Where K2's tensor-core body (fs_mma in
kvquant_tpu_torch/csrc/flash_serial.cu) spends its time, on one NVIDIA card.

    python3 serial_ablation.py

Builds copies of csrc/flash_serial.cu reduced to the speed config's
instance (int4, D 128, one query row per kv head), each with one part
switched off by a text edit of the copy, then times K2 at one LLaMA-2-7B
layer (chip_smoke.speed_config: hg 16, 16 static channels, bf16 dots) at
32K tokens (CUDA events, as chip_smoke.py phase 5) for each copy, and for
the base copy with the plan's split count scaled. A switched-off copy
computes a wrong result: its time says what the part costs, nothing else.
The copies go to the ignored build directory
kvquant_tpu_torch/_build/ablation/. The last line is one JSON object with
every time.

Copies (each edit must match the source, or the script stops):
  base      the source as it is (fs_mma, then fs_merge);
  nomerge   fs_mma alone, no merge kernel;
  noscore   no score mma (K codes neither decoded nor multiplied);
  nopv      no P.V mma (V codes neither decoded nor multiplied);
  copyonly  neither: the tile ring, the softmax and the fp32 terms only;
  streamonly  the tile ring alone: each tile is waited for, nothing read;
  tTsSbB    other shapes: T tokens a tile, S ring stages, B blocks an SM
            in __launch_bounds__ (the plan's constants patched to match).
Knobs (base copy): the plan's n_split x 1/2, x 2, x 4 (more than one
wave); fs_partial forced, the SIMT body, for reference.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs
from decode_ablation import build_copy

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "kvquant_tpu_torch", "csrc", "flash_serial.cu")
OUT = os.path.join(ROOT, "kvquant_tpu_torch", "_build", "ablation")


def reduce(src: str) -> str:
    """Only the int4, D 128, G 1 instances of both bodies."""
    cut = [f"    case {g}: return launch_body<CODES, D, {g}>(a, st);\n"
           for g in (2, 4, 8)]
    cut += [f"    case {d}: return dispatch_g<CODES, {d}>(a, st);\n"
            for d in (32, 64)]
    cut += [f"    case CODES_{m}: e = dispatch_d<CODES_{m}>(*a, st); break;\n"
            for m in ("INT8", "INT4X2")]
    for line in cut:
        if line not in src:
            raise SystemExit(f"serial_ablation: source changed: {line!r}")
        src = src.replace(line, "")
    return src


STREAM = ("mbar_wait(&bars[k % MSTAGES], (k / MSTAGES) & 1);",
          "mbar_wait(&bars[k % MSTAGES], (k / MSTAGES) & 1);\n"
          "    __syncwarp();\n    continue;")


def ring(tile: int, stages: int, blocks: int) -> list:
    return [("constexpr int MT = 32;", f"constexpr int MT = {tile};"),
            ("constexpr int MSTAGES = 2;", f"constexpr int MSTAGES = {stages};"),
            ("constexpr int MMA_MIN_BLOCKS = 4;",
             f"constexpr int MMA_MIN_BLOCKS = {blocks};")]


SCORE = ("mma16816(sc[rt], fa, qb[2 * j + e][0], qb[2 * j + e][1]);", "")
PV = ("for (int mt = 0; mt < NMT; ++mt) mma16816(acc[mt], fa[mt], pb0, pb1);",
      "")
EDITS = {
    "base": [],
    "nomerge": [("  fs_merge<<<", "  if (false) fs_merge<<<")],
    "noscore": [SCORE],
    "nopv": [PV],
    "copyonly": [SCORE, PV],
    "streamonly": [STREAM],
    "t32s3b3": ring(32, 3, 3),
    "t32s2b5": ring(32, 2, 5),
    "t64s2b3": ring(64, 2, 3),
}
# the plan's constants of the copies whose shared memory or register bound
# differ from the source's (ops/kernels/flash_serial.py)
PLAN = {"t32s3b3": dict(MMA_STAGES=3, MMA_MIN_BLOCKS=3),
        "t32s2b5": dict(MMA_MIN_BLOCKS=5),
        "t64s2b3": dict(MMA_TILE=64, P_STRIDE=72, MMA_MIN_BLOCKS=3)}


def main() -> int:
    if not torch.cuda.is_available():
        print("serial_ablation: no CUDA device", file=sys.stderr)
        return 2
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(len(EDITS)) as ex:
        libs = dict(zip(EDITS, ex.map(
            lambda n: build_copy(n, reduce=reduce, edits=EDITS, src_path=SRC),
            EDITS)))

    dev = torch.device("cuda")
    ctx = 32768
    cfg, dcfg, _ = cs.speed_config(ctx + 8, 1)
    gen = torch.Generator(device=dev).manual_seed(7)
    ops = cs.kernel_operands(dcfg, cfg, 1, 1, 1, dcfg.cache_tokens, gen, dev)
    q = torch.randn((1, cfg.n_kv_heads, 1, cfg.d_head), generator=gen,
                    device=dev)
    pos = torch.tensor([ctx - 1], dtype=torch.int32, device=dev)
    chan = fs.k_channel_index(ops["k_ressc"], dcfg).to(torch.int32)

    def run(body=None):
        return fs.flash_serial_decode(
            q, ops["k_planes"], ops["v_planes"], ops["kv_out"],
            ops["k_range"], ops["k_offset"], ops["v_scale"], ops["v_offset"],
            ops["k_sink"], ops["v_sink"], ops["k_lut"], ops["v_lut"], 0, pos,
            dcfg, cfg, k_chan=chan, body=body)

    plan_fn, lib_of, times = fs.fs_plan, fs._lib, {}
    knobs = {"split1": 1.0, "split0.5": 0.5, "split2": 2.0, "split4": 4.0}
    try:
        for name, so in libs.items():
            lib = ctypes.CDLL(so)
            lib.fs_decode.argtypes = [ctypes.POINTER(fs._FsArgs),
                                      ctypes.c_void_p]
            lib.fs_decode.restype = ctypes.c_int
            fs._lib = lambda lib=lib: lib  # noqa: E731
            saved = {k: getattr(fs, k) for k in PLAN.get(name, {})}
            for k, v in PLAN.get(name, {}).items():
                setattr(fs, k, v)
            for knob, f in (knobs.items() if name == "base"
                            else [("split1", 1.0)]):
                fs.fs_plan = lambda *a, f=f, **k: (lambda p: p._replace(
                    n_split=max(1, int(p.n_split * f))))(plan_fn(*a, **k))
                ms = cs.device_ms(run)
                key = f"{name}/{knob}"
                times[key] = ms
                plan = plan_fn(dcfg, 1, 32, 1, 128, dcfg.cache_tokens, dev)
                print(f"{key:20s} {ms:.4f} ms  {plan!r}", flush=True)
            for k, v in saved.items():
                setattr(fs, k, v)
            if name == "base":
                fs.fs_plan = plan_fn
                times["base/fs_partial"] = cs.device_ms(
                    lambda: run("fs_partial"))
                print(f"{'base/fs_partial':20s} "
                      f"{times['base/fs_partial']:.4f} ms", flush=True)
    finally:
        fs._lib, fs.fs_plan = lib_of, plan_fn
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "k2_ms_32k": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
