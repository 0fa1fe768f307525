"""Where the tensor-core decode bodies spend their time: fd_gqa (K1 / K5,
kvquant_tpu_torch/csrc/flash_decode.cu) and qk_gqa (K3, csrc/attention.cu),
on one NVIDIA card.

    python3 gqa_ablation.py

Builds copies of the two sources reduced to their nuq3 instances, each with
one part of the body switched off (or one launch bound changed) by a text
edit of the copy, then times K1 decode (G 6) and K3 (R 6) at one DBRX
layer (8 kv heads, D 128, the faithful nuq3 config: pre-RoPE keys, slots
cap 2, head group 4) over a 32K cache (CUDA events, as chip_smoke.py
phase 25) for each copy. A switched-off copy computes a wrong result: its
time says what the part costs, nothing else. The copies go to the ignored
build directory kvquant_tpu_torch/_build/ablation/. The last line is one
JSON object with every time.

Copies (each edit must match the source, or the script stops):
  base      the sources as they are;
  bound     each body at the other launch bound (fd_gqa two blocks an SM at
            96 registers, K1's plan with it; qk_gqa one block at 168);
  norope    no rotation of pre-RoPE keys (no (cos, sin) table reads);
  noslot    no K slot or V slot work (K1; K3: no slot fix-up);
  nokslot   K1 without its K slot terms;
  novslot   K1 without its V slot tile (neither written nor multiplied);
  nopv      K1 without P.V (values neither dequantized nor multiplied);
  nokey     K1 without the key dequantization and the score products.
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
from decode_ablation import OUT, flatten

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "kvquant_tpu_torch", "csrc")


def reduce_fd(src: str) -> str:
    """flash_decode.cu with only fd_gqa's nuq3 instances (and the merge)."""
    cut = [f"    case {g}: return launch_decode<MODE, NB, {g}, PRE>(a, st);\n"
           for g in (1, 2, 4, 8)]
    cut += [f"        case {b}: return gqa_rope<MODE_NUQ, {b}>(a, st);\n"
            for b in (2, 4)]
    cut += [f"    case MODE_{m}: return gqa_rope<MODE_{m}, 0>(a, st);\n"
            for m in ("INT4", "INT8", "INT4X2")]
    cut += [f"      case MODE_{m}: e = launch_partial<MODE_{m}>(*a, st); "
            f"break;\n" for m in ("NUQ", "INT4", "INT8", "INT4X2")]
    cut += [f"        case {b}: return launch_chunk<MODE_NUQ, {b}>(a, st);\n"
            for b in (2, 3, 4)]
    cut += [f"    case MODE_{m}: return launch_chunk<MODE_{m}, 0>(a, st);\n"
            for m in ("INT4", "INT8", "INT4X2")]
    for line in cut:
        if line not in src:
            raise SystemExit(f"gqa_ablation: source changed: {line!r}")
        src = src.replace(line, "")
    return src


def reduce_at(src: str) -> str:
    return src


# (copy, source) -> edits; a copy without an entry for a source uses base
EDITS = {
    ("base", "flash_decode"): [],
    ("base", "attention"): [],
    ("bound", "flash_decode"): [("__launch_bounds__(DNT, 1) fd_gqa",
                                 "__launch_bounds__(DNT, 2) fd_gqa")],
    ("bound", "attention"): [("__launch_bounds__(DNT, 2) qk_gqa",
                              "__launch_bounds__(DNT, 1) qk_gqa")],
    ("norope", "flash_decode"): [("  if (PRE) {\n    const float4 c01",
                                  "  if (false) {\n    const float4 c01"),
                                 ("  if (PRE) {\n    r.c01", "  if (false) {\n    r.c01")],
    ("norope", "attention"): [("  if (PRE) {\n    const float4 c01",
                               "  if (false) {\n    const float4 c01"),
                              ("  if (PRE) {\n    r.c01", "  if (false) {\n    r.c01")],
    ("noslot", "flash_decode"): [
        ("for (int sl = 0; sl < a.n_kslots; ++sl) {\n              const uint32_t w",
         "for (int sl = 0; sl < 0; ++sl) {\n              const uint32_t w"),
        ("const bool vlive = a.n_vslots > 0 && t0 + tok(lane) <= hi;",
         "const bool vlive = false;")],
    ("noslot", "attention"): [("      if (nks > 0) {\n        const int tt = 4 * lane + un;",
                               "      if (false) {\n        const int tt = 4 * lane + un;")],
    ("nokslot", "flash_decode"): [
        ("for (int sl = 0; sl < a.n_kslots; ++sl) {\n              const uint32_t w",
         "for (int sl = 0; sl < 0; ++sl) {\n              const uint32_t w")],
    ("novslot", "flash_decode"): [
        ("const bool vlive = a.n_vslots > 0 && t0 + tok(lane) <= hi;",
         "const bool vlive = false;")],
    ("nopv", "flash_decode"): [("          if (mt < D / 16) {\n            // the codes",
                                "          if (false) {\n            // the codes")],
    ("nokey", "flash_decode"): [("    if (j < D / 32) {\n      const int c = 16 * j + 4 * tq;\n"
                                 "      Rot4 rot[4];",
                                 "    if (false) {\n      const int c = 16 * j + 4 * tq;\n"
                                 "      Rot4 rot[4];")],
}
REDUCE = {"flash_decode": reduce_fd, "attention": reduce_at}


def build_copy(key) -> str:
    """Compile copy ``key`` = (name, source) into OUT; returns the path."""
    from kvquant_tpu_torch.ops.kernels import build

    name, stem = key
    src = REDUCE[stem](flatten(os.path.join(CSRC, f"{stem}.cu")))
    for old, new in EDITS[key]:
        if old not in src:
            raise SystemExit(f"gqa_ablation: {name}: source changed: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    path = os.path.join(OUT, f"gqa_{stem}_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = path[:-3] + ".so"
    res = subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS, *build.FLAGS,
                          "-o", so, path], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"gqa_ablation: nvcc failed for {name}:\n"
                         f"{res.stderr[-3000:]}")
    return so


def bind(so: str, stem: str):
    from kvquant_tpu_torch.ops.kernels import attention as at
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd

    lib = ctypes.CDLL(so)
    if stem == "flash_decode":
        lib.fd_attention.argtypes = [ctypes.POINTER(fd._FdArgs),
                                     ctypes.c_void_p]
        lib.fd_attention.restype = ctypes.c_int
    else:
        lib.qk_fused.argtypes = [ctypes.POINTER(at._QkArgs), ctypes.c_void_p]
        lib.qk_fused.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("gqa_ablation: no CUDA device", file=sys.stderr)
        return 2
    from kvquant_tpu_torch.models.config import ModelConfig
    from kvquant_tpu_torch.ops.kernels import attention as at
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(8) as ex:
        libs = dict(zip(EDITS, ex.map(build_copy, EDITS)))

    dev = torch.device("cuda")
    ctx, G = 32768, 6
    one = ModelConfig(vocab_size=64, d_model=8 * G * 128, n_layers=1,
                      n_heads=8 * G, n_kv_heads=8, d_head=128, d_ff=64,
                      max_seq_len=ctx + 8, rope_theta=500000.0)
    _, dcfg, _ = cs.faithful_config(ctx + 8, 1, one)
    gen = torch.Generator(device=dev).manual_seed(7)
    ops = cs.k1_operands(dcfg, 1, 1, dcfg.cache_tokens, gen, dev)
    q = torch.randn((1, 8, G, 128), generator=gen, device=dev)
    pos = torch.tensor([ctx - 1], dtype=torch.int32, device=dev)
    dp = dataclasses.replace(dcfg, kernel="pallas")
    o = cs.k34_operands(dp, 1, G, dp.cache_tokens, gen, dev)

    fd_lib, at_lib, per_sm = fd._lib, at._lib, fd.GQA_BLOCKS_PER_SM
    times = {}
    try:
        for (name, stem), so in libs.items():
            lib = bind(so, stem)
            if stem == "flash_decode":
                fd._lib = lambda lib=lib: lib  # noqa: E731
                fd.GQA_BLOCKS_PER_SM = 2 if name == "bound" else per_sm
                run = lambda: cs.call(fd.flash_attention, q, ops, 0, pos,  # noqa
                                      dcfg, one)
                key = f"{name}/K1 G{G}"
            else:
                at._lib = lambda lib=lib: lib  # noqa: E731
                run = lambda: cs.run_qk(at.qk_fused, o, dp, one)  # noqa
                key = f"{name}/K3 R{G}"
            times[key] = min(cs.device_ms(run), cs.device_ms(run))
            print(f"{key:16s} {times[key]:.4f} ms", flush=True)
    finally:
        fd._lib, at._lib, fd.GQA_BLOCKS_PER_SM = fd_lib, at_lib, per_sm
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "gqa_ms_32k": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
