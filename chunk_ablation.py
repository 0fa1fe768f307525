"""Where the chunk body of K1 (fd_chunk in
kvquant_tpu_torch/csrc/flash_decode.cu) spends its time, on one NVIDIA card.

    python3 chunk_ablation.py

Builds copies of csrc/flash_decode.cu reduced to the two LLaMA-2-7B chunk
instances (nuq3 bit planes and the int4x2 container), each with one part
of the body switched off by a text edit of the copy, then times K1 on a
256-row chunk of one LLaMA-2-7B layer (bf16 dots) at 2K and 32K tokens
(CUDA events, as chip_smoke.py phase 9) for each copy. A switched-off copy
computes a wrong result: its time says what the part costs, nothing else.
The copies go to the ignored build directory
kvquant_tpu_torch/_build/chunk_ablation/. The last line is one JSON
object with every time.

Copies (each edit must match the source, or the script stops):
  base      the source as it is;
  nodeq     no dequantization of K / V codes (the tiles keep stale values);
  nofix     no K outlier tile or V slot tile (neither built nor multiplied);
  noqk      no Q.K^T mma over the dequantized keys;
  nopv      no P.V mma (values and V slots);
  nomma     no scores, softmax or P.V: the ring and the dequantization alone;
  nowait    no wait on the ring's mbarriers (the tiles may be stale);
  noexp     no exp2 in the softmax (the probabilities are the exponents).
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
import decode_ablation

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "kvquant_tpu_torch", "csrc", "flash_decode.cu")
OUT = os.path.join(ROOT, "kvquant_tpu_torch", "_build", "chunk_ablation")


def reduce(src: str) -> str:
    """Only the nuq3 and int4x2 chunk instances: no decode body, no SIMT
    body, no other chunk instance."""
    cut = [f"    case {g}: return launch_decode<MODE, NB, {g}, PRE>(a, st);\n"
           for g in (1, 2, 4, 8)]
    cut += [f"      case MODE_{m}: e = launch_partial<MODE_{m}>(*a, st); "
            f"break;\n" for m in ("NUQ", "INT4", "INT8", "INT4X2")]
    cut += [f"        case {b}: return launch_chunk<MODE_NUQ, {b}>(a, st);\n"
            for b in (2, 4)]
    cut += [f"    case MODE_{m}: return launch_chunk<MODE_{m}, 0>(a, st);\n"
            for m in ("INT4", "INT8")]
    for line in cut:
        if line not in src:
            raise SystemExit(f"chunk_ablation: source changed: {line!r}")
        src = src.replace(line, "")
    return src


EDITS = {
    "base": [],
    "nodeq": [("for (int uu = tid; uu < 2 * upk; uu += PW * 32) {",
               "for (int uu = tid; uu < 0; uu += PW * 32) {")],
    "nofix": [("const bool kfix = a.n_kc > 0 || a.n_kslots > 0, "
               "vfix = a.n_vslots > 0;",
               "const bool kfix = false, vfix = false;")],
    "noqk": [("for (int kk = 0; kk < MAXD / 16; ++kk) qk_step(smem_u32(bK) ",
              "for (int kk = 0; kk < 0; ++kk) qk_step(smem_u32(bK) ")],
    "nopv": [("        pv_pass(smem_u32(bV) + voff);\n        if (vany) pv_pass",
              "        if (false) pv_pass")],
    "nomma": [("const bool wlive = wact &&", "const bool wlive = false &&")],
    "nowait": [("    mbar_wait(&full[st], phase);\n", "")],
    "noexp": [("const float p0 = exp2f(sc[mt][j][0] - mu[0]), "
               "p1 = exp2f(sc[mt][j][1] - mu[0]);",
               "const float p0 = sc[mt][j][0] - mu[0], p1 = sc[mt][j][1] - mu[0];"),
              ("const float p2 = exp2f(sc[mt][j][2] - mu[1]), "
               "p3 = exp2f(sc[mt][j][3] - mu[1]);",
               "const float p2 = sc[mt][j][2] - mu[1], p3 = sc[mt][j][3] - mu[1];")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chunk_ablation: no CUDA device", file=sys.stderr)
        return 2
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(len(EDITS)) as ex:
        libs = dict(zip(EDITS, ex.map(
            lambda n: decode_ablation.build_copy(n, reduce, EDITS, OUT),
            EDITS)))

    dev = torch.device("cuda")
    cases = []
    for tag, config in (("nuq3", cs.faithful_config),
                        ("int4x2", cs.speed2_config)):
        for ctx in (2048, 32768):
            cfg, dcfg, _ = config(ctx + 264, 1)
            gen = torch.Generator(device=dev).manual_seed(7)
            ops = cs.k1_operands(dcfg, 1, 1, dcfg.cache_tokens, gen, dev)
            q = torch.randn((1, cfg.n_kv_heads, 256, cfg.d_head),
                            generator=gen, device=dev)
            pos = torch.tensor([ctx], dtype=torch.int32, device=dev)
            cases.append((f"{tag}/{ctx}", cfg, dcfg, ops, q, pos))

    lib_of, times = fd._lib, {}
    try:
        for name, so in libs.items():
            lib = ctypes.CDLL(so)
            lib.fd_attention.argtypes = [ctypes.POINTER(fd._FdArgs),
                                         ctypes.c_void_p]
            lib.fd_attention.restype = ctypes.c_int
            fd._lib = lambda lib=lib: lib  # noqa: E731
            for tag, cfg, dcfg, ops, q, pos in cases:
                ms = cs.device_ms(lambda: cs.call(
                    lambda *a, **k: fd.flash_attention(*a, Tq=256, **k), q,
                    ops, 0, pos, dcfg, cfg))
                key = f"{name}/{tag}"
                times[key] = ms
                print(f"{key:24s} {ms:.4f} ms", flush=True)
    finally:
        fd._lib = lib_of
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "chunk_ms_256_rows": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
