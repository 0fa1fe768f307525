"""Where the chunk body of K1 (fd_chunk in
kvquant_tpu_torch/csrc/flash_decode.cu) spends its time, on one NVIDIA card.

    python3 chunk_ablation.py [copy ...]

Builds copies of csrc/flash_decode.cu reduced to the two chunk instances
the cases run (nuq3 bit planes on fd_chunk, the int4x2 container on
fd_chunk_sync), each with one part of the body switched off by a text edit
of the copy, then times K1 (CUDA events, as chip_smoke.py phase 9) for
each copy on:

  - a 256-row chunk of one LLaMA-2-7B layer (bf16 dots) at 2K and 32K
    tokens, nuq3 and int4x2 (phases 9 and 21's shapes), and there a
    40-row chunk (a prefill's last chunk, under one 64-row tile);
  - the mistral7b-nuq3-longdoc cell's last sub-chunk of a 16K admission at
    Mistral-7B-v0.2 widths: G 4, Hkv 8, D 128, nuq3 with K / V slots (cap
    2 per head group of 4), sink 5, 2048 rows at position 5 + 7 x 2048 =
    14,341 (the last row sees 16,389 keys).

A switched-off copy computes a wrong result: its time says what the part
costs, nothing else. Name copies to build only those (default: all). The
copies go to the ignored build directory
kvquant_tpu_torch/_build/chunk_ablation/. The last line is one JSON object
with every time.

Copies (each edit must match the source, or the script stops; an edit
changes every place its text matches: nodeq, nofix and nomma reach
fd_chunk_sync too, noqk, nopv and prod fd_chunk alone):
  base      the source as it is;
  nodeq     no dequantization of K / V codes (the tiles keep stale values);
  nofix     no K outlier tile or V slot tile (neither built nor multiplied);
  noqk      no score product (neither Q.K^T nor Q.K_add^T);
  nopv      no value product (neither P.V nor P.V_add);
  nomma     no products or softmax: the ring, the dequantization and the
            outlier tiles alone (the producers' pace);
  prod      the products alone: no dequantization, no outlier tiles built,
            every k-step of the K outlier tile and the V slot tile
            multiplied (the consumers' pace, as with random slot dims).

``build_libs`` / ``cases`` / ``time_libs`` take another source's reduce and
edits, so the same cases time an older fd_chunk from its own checkout.
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
SRC = os.path.join(ROOT, "kvquant_tpu_torch", "csrc", "flash_decode.cu")
OUT = os.path.join(ROOT, "kvquant_tpu_torch", "_build", "chunk_ablation")
LONGDOC_POS = 5 + 7 * 2048  # the last sub-chunk of a 16,384-token prompt
TAIL_ROWS = 40  # rows of a prefill's last chunk, under one m64 tile


def reduce(src: str) -> str:
    """Only the nuq3 and int4x2 chunk instances: no decode body, no SIMT
    body, no other chunk instance."""
    cut = [f"    case {g}: return launch_decode<MODE, NB, {g}, PRE>(a, st);\n"
           for g in (1, 2, 4, 8)]
    cut += [f"      case MODE_{m}: e = launch_partial<MODE_{m}>(*a, st); "
            f"break;\n" for m in ("NUQ", "INT4", "INT8", "INT4X2")]
    cut += [f"        case {b}: return launch_chunk<{b}>(a, st);\n"
            for b in (2, 4)]
    cut += [f"    case MODE_{m}: return launch_chunk_sync<MODE_{m}>(a, st);\n"
            for m in ("INT4", "INT8")]
    for line in cut:
        if line not in src:
            raise SystemExit(f"chunk_ablation: source changed: {line!r}")
        src = src.replace(line, "")
    return src


NODEQ = ("for (int uu = tid; uu < 2 * upk; uu += PW * 32) {",
         "for (int uu = tid; uu < 0; uu += PW * 32) {")
EDITS = {
    "base": [],
    "nodeq": [NODEQ],
    "nofix": [("const bool kfix = a.n_kc > 0 || a.n_kslots > 0, "
               "vfix = a.n_vslots > 0;",
               "const bool kfix = false, vfix = false;")],
    "noqk": [("wg_m64n32_ss(sc[mt], q_desc(qd, mt, kk), k_desc(kd, kk), 1);",
              ";"),
             ("wg_m64n32_ss(sc[mt], q_desc(qd, mt, kk), k_desc(kcd, kk), 1);",
              ";")],
    "nopv": [("for (int kt = 0; kt < 2; ++kt) wg_m64n128_rs(o[mt], pa[mt][kt], "
              "v_desc(vd, kt));", ";"),
             ("for (int kt = 0; kt < 2; ++kt) wg_m64n128_rs(o[mt], pa[mt][kt], "
              "v_desc(vsd, kt));", ";")],
    "nomma": [("      mbar_wait(&pfull[ub], urnd & 1);\n",
               "      mbar_wait(&pfull[ub], urnd & 1);\n      if (true) {\n"
               "        mbar_arrive(&pempty[ub]);\n"
               "        if (++ub == a.n_buf) {\n          ub = 0;\n"
               "          ++urnd;\n        }\n        continue;\n      }\n")],
    "prod": [NODEQ, ("        if (kfix || vfix) {\n          // with both tiles",
                     "        if (false) {\n          // with both tiles"),
             ("kmask = __reduce_or_sync(FULL, km);",
              "kmask = (1u << (MAXD / 16)) - 1u;"),
             ("vany = vfix && __reduce_or_sync(FULL, vm) != 0u;",
              "vany = vfix;")],
}


def build_libs(names, reduce=reduce, edits=EDITS, out=OUT, src_path=SRC):
    """Build the copies ``names`` of ``src_path`` in parallel: name -> .so."""
    os.makedirs(out, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as ex:
        return dict(zip(names, ex.map(
            lambda n: decode_ablation.build_copy(n, reduce, edits, out,
                                                 src_path), names)))


def cases(dev):
    """(tag, ModelConfig, DeployConfig, operands, queries, pos, Tq) of each
    timed call."""
    from kvquant_tpu_torch.models.hf_loader import config_from_hf

    out = []
    for tag, config in (("nuq3", cs.faithful_config),
                        ("int4x2", cs.speed2_config)):
        for ctx in (2048, 32768):
            cfg, dcfg, _ = config(ctx + 264, 1)
            gen = torch.Generator(device=dev).manual_seed(7)
            ops = cs.k1_operands(dcfg, 1, 1, dcfg.cache_tokens, gen, dev)
            q = torch.randn((1, cfg.n_kv_heads, 256, cfg.d_head),
                            generator=gen, device=dev)
            pos = torch.tensor([ctx], dtype=torch.int32, device=dev)
            out.append((f"{tag}/{ctx}", cfg, dcfg, ops, q, pos, 256))
            # a prefill's last chunk, under one 64-row tile
            out.append((f"{tag}/{ctx}t{TAIL_ROWS}", cfg, dcfg, ops,
                        q[:, :, :TAIL_ROWS].contiguous(), pos, TAIL_ROWS))
    mistral = dataclasses.replace(config_from_hf(
        os.path.join(ROOT, cs.LONGDOC_CONFIG)), n_layers=1)
    cfg, dcfg, _ = cs.faithful_config(16384 + 513, 1, mistral)
    gen = torch.Generator(device=dev).manual_seed(7)
    ops = cs.k1_operands(dcfg, 1, 1, dcfg.cache_tokens, gen, dev)
    G, tq = cfg.q_per_kv, 2048
    q = torch.randn((1, cfg.n_kv_heads, G * tq, cfg.d_head), generator=gen,
                    device=dev)
    pos = torch.tensor([LONGDOC_POS], dtype=torch.int32, device=dev)
    out.append(("longdoc/16389", cfg, dcfg, ops, q, pos, tq))
    return out


def time_libs(libs, calls):
    """K1's device ms per (copy, case) with each copy's library in place of
    the wrapper's."""
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd

    lib_of, times = fd._lib, {}
    try:
        for name, so in libs.items():
            lib = ctypes.CDLL(so)
            lib.fd_attention.argtypes = [ctypes.POINTER(fd._FdArgs),
                                         ctypes.c_void_p]
            lib.fd_attention.restype = ctypes.c_int
            fd._lib = lambda lib=lib: lib  # noqa: E731
            for tag, cfg, dcfg, ops, q, pos, tq in calls:
                n = 4 if tq > 256 else 20
                ms = cs.device_ms(lambda: cs.call(
                    lambda *a, **k: fd.flash_attention(*a, Tq=tq, **k), q,
                    ops, 0, pos, dcfg, cfg), n=n)
                key = f"{name}/{tag}"
                times[key] = ms
                print(f"{key:28s} {ms:.4f} ms", flush=True)
    finally:
        fd._lib = lib_of
    return times


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chunk_ablation: no CUDA device", file=sys.stderr)
        return 2
    names = list(argv if argv is not None else sys.argv[1:]) or list(EDITS)
    unknown = [n for n in names if n not in EDITS]
    if unknown:
        print(f"chunk_ablation: unknown copies {unknown}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    libs = build_libs(names)
    times = time_libs(libs, cases(torch.device("cuda")))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "chunk_ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
