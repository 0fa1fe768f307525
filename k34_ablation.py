"""Where K3 (qk_fused) and K4 (pv_fused) of
kvquant_tpu_torch/csrc/attention.cu spend their time, on one NVIDIA card.

    python3 k34_ablation.py

Builds copies of csrc/attention.cu, each with one part of a body switched
off by a text edit of the copy, then times K3 and K4 at one LLaMA-2-7B
layer (nuq3, pre-RoPE keys, slots cap 2, head group 4, bf16 dots): a decode
row (R = 1) over a 32K capacity and a 261-row prefill chunk over 2304
tokens (CUDA events, as chip_smoke.py phase 13), for each copy. A
switched-off copy computes a wrong result: its time says what the part
costs, nothing else. The copies go to the ignored build directory
kvquant_tpu_torch/_build/k34_ablation/. The last line is one JSON object
with every time.

Copies (each edit must match the source, or the script stops):
  base        the source as it is;
  dec_nofix   decode: no K slot fix-ups (K3), no V slot ballot (K4);
  mma_nodeq   chunk: no dequantization of the key / value tiles;
  mma_nomma   chunk: no products (K3 writes no scores);
  mma_noslot  chunk: no slot marks (K3), no slot tile (K4);
  pv_nostage  chunk, K4: no staging of the probability tiles.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs
import decode_ablation

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "kvquant_tpu_torch", "csrc", "attention.cu")
OUT = os.path.join(ROOT, "kvquant_tpu_torch", "_build", "k34_ablation")

EDITS = {
    "base": [],
    "dec_nofix": [
        ("      if (nks > 0) {\n        const float* wt = sRows + tt;",
         "      if (false) {\n        const float* wt = sRows + tt;"),
        ("        if (nvs > 0) {\n          float* xp = sX[warp][0];",
         "        if (false) {\n          float* xp = sX[warp][0];")],
    "mma_nodeq": [
        ("#pragma unroll 4\n    for (int jb = 0; jb < nbt; ++jb) {",
         "    for (int jb = 0; jb < 0; ++jb) {"),
        ("      for (int jb = 0; jb < nbt; ++jb)\n#pragma unroll\n"
         "        for (int wr = 0; wr < 4; ++wr) {\n          int e = 0;",
         "      for (int jb = 0; jb < 0; ++jb)\n#pragma unroll\n"
         "        for (int wr = 0; wr < 4; ++wr) {\n          int e = 0;")],
    "mma_nomma": [
        ("    for (int mt = warp >> 2; mt < nmt; mt += 2) {\n      float c[4][4];",
         "    for (int mt = warp >> 2; mt < 0; mt += 2) {\n      float c[4][4];"),
        ("    if (wact) {\n      uint32_t bv", "    if (false) {\n      uint32_t bv")],
    "mma_noslot": [
        ("    if (nks > 0 && tid < DT) {\n      for (int j = 0; j < nks; ++j) {\n",
         "    if (false) {\n      for (int j = 0; j < nks; ++j) {\n"),
        ("  const bool slots = nvs > 0;", "  const bool slots = false;")],
    "pv_nostage": [
        ("for (int rb = warp; rb < RB; rb += PU * (CNT / 32)) {",
         "for (int rb = warp; rb < 0; rb += PU * (CNT / 32)) {")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("k34_ablation: no CUDA device", file=sys.stderr)
        return 2
    from kvquant_tpu_torch.ops.kernels import attention as at

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(len(EDITS)) as ex:
        libs = dict(zip(EDITS, ex.map(
            lambda n: decode_ablation.build_copy(n, lambda s: s, EDITS, OUT, SRC),
            EDITS)))

    dev = torch.device("cuda")
    cases = []
    for kind, ctx, r in (("decode", 32768, 1), ("chunk", 2048, 261)):
        cfg, dcfg, _ = cs.faithful_config(ctx + 8, 1)
        dcfg = dataclasses.replace(dcfg, kernel="pallas")
        o = cs.k34_operands(dcfg, 1, r, dcfg.cache_tokens,
                            torch.Generator(device=dev).manual_seed(7), dev)
        cases.append((f"{kind}/{dcfg.cache_tokens}", cfg, dcfg, o))

    lib_of, times = at._lib, {}
    try:
        for name, so in libs.items():
            lib = ctypes.CDLL(so)
            lib.qk_fused.argtypes = [ctypes.POINTER(at._QkArgs),
                                     ctypes.c_void_p]
            lib.pv_fused.argtypes = [ctypes.POINTER(at._PvArgs),
                                     ctypes.c_void_p]
            lib.qk_fused.restype = lib.pv_fused.restype = ctypes.c_int
            at._lib = lambda lib=lib: lib  # noqa: E731
            for tag, cfg, dcfg, o in cases:
                for kern, fn in (
                        ("K3", lambda: cs.run_qk(at.qk_fused, o, dcfg, cfg)),
                        ("K4", lambda: cs.run_pv(at.pv_fused, o, dcfg))):
                    key = f"{name}/{kern}/{tag}"
                    times[key] = cs.device_ms(fn)
                    print(f"{key:32s} {times[key]:.4f} ms", flush=True)
    finally:
        at._lib = lib_of
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
