"""Where the decode body of K1 / K5 (fd_decode in
kvquant_tpu_torch/csrc/flash_decode.cu) spends its time, on one NVIDIA card.

    python3 decode_ablation.py

Builds copies of csrc/flash_decode.cu reduced to the two LLaMA-2-7B decode
instances (nuq3 pre-RoPE and int4x2 post-RoPE, one query row per kv head),
each with one part of the body switched off by a text edit of the copy,
then times K1 decode at one LLaMA-2-7B layer at 32K tokens (CUDA events,
as chip_smoke.py phase 9) for each copy and for the grid and ring knobs of
ops/kernels/flash_decode.py. A switched-off copy computes a wrong result:
its time says what the part costs, nothing else. The copies go to the
ignored build directory kvquant_tpu_torch/_build/ablation/. The last line
is one JSON object with every time.

Copies (each edit must match the source, or the script stops):
  base      the source as it is;
  norope    no rotation of pre-RoPE keys;
  noslot    no K slot, static channel or V slot work;
  nobf      no bf16 rounding of the dot operands;
  nopv      no P.V (values neither dequantized nor summed);
  noevict   the codes' bulk copies without the L2 evict-first hint;
  reg112    112 registers a thread instead of two blocks per SM.
Knobs (base copy): DECODE_WAVES 1 / 2 / 4; STAGE_BYTES 64 KB (four nuq3
heads per block instead of two).
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

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "kvquant_tpu_torch", "csrc", "flash_decode.cu")
OUT = os.path.join(ROOT, "kvquant_tpu_torch", "_build", "ablation")


def reduce(src: str) -> str:
    """Only the G=1 nuq3 and int4x2 decode instances, no chunk bodies."""
    cut = [f"    case {g}: return launch_decode<MODE, NB, {g}, PRE>(a, st);\n"
           for g in (2, 4, 8)]
    cut += [f"        case {b}: return dispatch_rope<MODE_NUQ, {b}>(a, st);\n"
            for b in (2, 4)]
    cut += [f"    case MODE_{m}: return dispatch_rope<MODE_{m}, 0>(a, st);\n"
            for m in ("INT4", "INT8")]
    cut += [f"      case MODE_{m}: e = launch_partial<MODE_{m}>(*a, st); "
            f"break;\n" for m in ("NUQ", "INT4", "INT8", "INT4X2")]
    cut += [f"        case {b}: return launch_chunk<MODE_NUQ, {b}>(a, st);\n"
            for b in (2, 3, 4)]
    cut += [f"    case MODE_{m}: return launch_chunk<MODE_{m}, 0>(a, st);\n"
            for m in ("INT4", "INT8", "INT4X2")]
    for line in cut:
        if line not in src:
            raise SystemExit(f"decode_ablation: source changed: {line!r}")
        src = src.replace(line, "")
    return src


EDITS = {
    "base": [],
    "norope": [("if (PRE) {  // rotate the pairs", "if (false) {  //")],
    "noslot": [("if (a.n_vslots > 0) {", "if (false) {"),
               ("for (int sl = 0; sl < a.n_kslots; ++sl) {",
                "for (int sl = 0; sl < 0; ++sl) {"),
               ("for (int n = 0; n < a.n_kc; ++n) {\n            const int dim",
                "for (int n = 0; n < 0; ++n) {\n            const int dim")],
    "nobf": [("const bool bf = a.dot_bf16 != 0;\n  const int pos = a.pos[b];",
              "const bool bf = false;\n  const int pos = a.pos[b];")],
    "nopv": [("        for (int w4 = 0; w4 < 4; ++w4) {\n          uint32_t cw[4][NWD];\n"
              "          if (MODE == MODE_NUQ) nuq_bytes<NB>(sVc",
              "        for (int w4 = 0; w4 < 0; ++w4) {\n          uint32_t cw[4][NWD];\n"
              "          if (MODE == MODE_NUQ) nuq_bytes<NB>(sVc")],
    "noevict": [(".mbarrier::complete_tx::bytes.L2::cache_hint \"\n"
                 "      \"[%0], [%1], %2, [%3], pol;",
                 ".mbarrier::complete_tx::bytes \"\n"
                 "      \"[%0], [%1], %2, [%3];")],
    "reg112": [("__launch_bounds__(DNT, G >= 4 ? 1 : 2) fd_decode",
                "__maxnreg__(112) fd_decode")],
}


def build_copy(name: str, reduce=reduce, edits=EDITS, out=OUT) -> str:
    """Compile the reduced source with the edits of copy ``name`` into
    ``out``; returns the library's path."""
    from kvquant_tpu_torch.ops.kernels import build

    src = reduce(open(SRC).read())
    for old, new in edits[name]:
        if old not in src:
            raise SystemExit(f"ablation: {name}: source changed: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    path = os.path.join(out, f"fd_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = path[:-3] + ".so"
    res = subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS, *build.FLAGS,
                          "-o", so, path], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"ablation: nvcc failed for {name}:\n"
                         f"{res.stderr[-3000:]}")
    return so


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_ablation: no CUDA device", file=sys.stderr)
        return 2
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(len(EDITS)) as ex:
        libs = dict(zip(EDITS, ex.map(build_copy, EDITS)))

    dev = torch.device("cuda")
    cases = []
    for tag, config in (("nuq3", cs.faithful_config),
                        ("int4x2", cs.speed2_config)):
        ctx = 32768
        cfg, dcfg, _ = config(ctx + 9, 1)
        gen = torch.Generator(device=dev).manual_seed(7)
        ops = cs.k1_operands(dcfg, 1, 1, dcfg.cache_tokens, gen, dev)
        q = torch.randn((1, cfg.n_kv_heads, 1, cfg.d_head), generator=gen,
                        device=dev)
        pos = torch.tensor([ctx - 1], dtype=torch.int32, device=dev)
        cases.append((tag, cfg, dcfg, ops, q, pos))

    knobs = {"waves1": (1, fd.STAGE_BYTES), "waves2": (2, fd.STAGE_BYTES),
             "waves4": (4, fd.STAGE_BYTES), "stage64k": (1, 64 * 1024)}
    defaults = (fd.DECODE_WAVES, fd.STAGE_BYTES)
    lib_of, times = fd._lib, {}
    try:
        for name, so in libs.items():
            lib = ctypes.CDLL(so)
            lib.fd_attention.argtypes = [ctypes.POINTER(fd._FdArgs),
                                         ctypes.c_void_p]
            lib.fd_attention.restype = ctypes.c_int
            fd._lib = lambda lib=lib: lib  # noqa: E731
            for knob, (waves, stage) in (knobs.items() if name == "base"
                                         else [("waves1", knobs["waves1"])]):
                fd.DECODE_WAVES, fd.STAGE_BYTES = waves, stage
                for tag, cfg, dcfg, ops, q, pos in cases:
                    ms = cs.device_ms(lambda: cs.call(
                        fd.flash_attention, q, ops, 0, pos, dcfg, cfg))
                    key = f"{name}/{knob}/{tag}"
                    times[key] = ms
                    print(f"{key:26s} {ms:.4f} ms", flush=True)
    finally:
        fd._lib = lib_of
        fd.DECODE_WAVES, fd.STAGE_BYTES = defaults
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "decode_ms_32k": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
