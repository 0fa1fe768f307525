"""How the MoE expert products' kernel (csrc/moe_experts.cu) is shaped, on
one NVIDIA card: its two bodies side by side, and the tensor-core body's
ring depth and tile width.

    python3 moe_ablation.py [copies]

Builds copies of csrc/moe_experts.cu with other shapes of the tensor-core
body (text edits of the copy) and times each at one DBRX layer (E 16, D
6144, F 10752, bf16) at 1, 2, 4 and 8 capacity rows an expert, with the
experts a batch of 1, 2, 8 and 16 tokens (top 4 of 16) keeps live: 4, 8,
14 and 16, each full. Device ms between CUDA events
(chip_smoke.device_ms), each beside its byte bound (the live experts'
weights, the rows in and out, at 3.35 TB/s) and its max |copy - plain|;
the SIMT body (the base copy's) is timed beside them at every C. The
copies go to the ignored build directory kvquant_tpu_torch/_build/
ablation/. The last line is one JSON object with every time. Name copies
to build only those (the base copy always runs).

Copies (each edit must match the source, or the script stops):
  base          the source as it is (256-column tiles, 32-row stages, 4
                consumer and 2 producer warps, a 96 KB ring: 2 stages of
                moe_glu_mma, 5 of moe_down_mma, two blocks an SM);
  pw1           1 producer warp;
  cw8           8 consumer warps;
  r80           an 80 KB ring (2 and 4 stages; three blocks an SM);
  r192          a 192 KB ring (5 and 11 stages; one block an SM);
  r192cw8       a 192 KB ring, 8 consumer warps;
  tn512r192     512-column tiles (1 KB runs), a 192 KB ring (2 and 5
                stages; one block an SM);
  tn512bk16     512-column tiles, 16-row stages (2 and 5 stages; two blocks
                an SM).
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs
from decode_ablation import build_copy

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "kvquant_tpu_torch", "csrc", "moe_experts.cu")
OUT = os.path.join(ROOT, "kvquant_tpu_torch", "_build", "ablation")
RING = "constexpr int MT_RING = 96 * 1024;"
TN = "constexpr int MT_TN = 256;"
PW = "constexpr int MT_PW = 2;"
CW = "constexpr int MT_CW = 4;"
BK = "constexpr int MT_BK = 32;"
R192 = (RING, "constexpr int MT_RING = 192 * 1024;")
TN512 = (TN, "constexpr int MT_TN = 512;")
EDITS = {
    "base": [],
    "pw1": [(PW, "constexpr int MT_PW = 1;")],
    "cw8": [(CW, "constexpr int MT_CW = 8;")],
    "r80": [(RING, "constexpr int MT_RING = 80 * 1024;")],
    "r192": [R192],
    "r192cw8": [R192, (CW, "constexpr int MT_CW = 8;")],
    "tn512r192": [TN512, R192],
    "tn512bk16": [TN512, (BK, "constexpr int MT_BK = 16;")],
}
E, D, F = 16, 6144, 10752
LIVE = {1: 4, 2: 8, 4: 14, 8: 16}  # experts a batch of 1 / 2 / 8 / 16 keeps


def bind(so):
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.moe_experts.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                I, P]
    lib.moe_experts_scratch.argtypes = [I, I, I, P]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_ablation: no CUDA device", file=sys.stderr)
        return 2
    from kvquant_tpu_torch.ops.kernels import moe_experts as mx

    names = ["base"] + [n for n in sys.argv[1:] if n != "base"] \
        if len(sys.argv) > 1 else list(EDITS)
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(
            lambda n: bind(build_copy(n, reduce=lambda s: s, edits=EDITS,
                                      out=OUT, src_path=SRC)), names)))
    scratch = {}
    for name, lib in libs.items():
        out = (ctypes.c_longlong * 4)()
        err = lib.moe_experts_scratch(E, D, F, out)
        if err:
            raise RuntimeError(f"{name}: scratch query cudaError {err}")
        scratch[name] = (
            torch.empty((out[0],), dtype=torch.float32, device="cuda"),
            torch.zeros((out[1],), dtype=torch.int32, device="cuda"))
        cs.log(f"{name}: grids {out[2]} / {out[3]} blocks, partials "
               f"{out[0] * 4 / 2**20:.1f} MiB")
    g = torch.Generator(device="cuda").manual_seed(0)
    w = [(torch.randn(s, generator=g, device="cuda") / s[1] ** 0.5).to(
        torch.bfloat16) for s in ((E, D, F), (E, D, F), (E, F, D))]
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for C, n_live in LIVE.items():
        xe = torch.randn((E, C, D), generator=g, device="cuda").to(
            torch.bfloat16)
        count = torch.zeros((E,), dtype=torch.int32, device="cuda")
        count[torch.randperm(E, generator=g, device="cuda")[:n_live]] = C
        want = mx.moe_experts_plain(xe, count, *w)
        y = torch.empty((E, C, D), dtype=torch.bfloat16, device="cuda")
        row = res[C] = {"live": n_live, "bound_ms": (
            n_live * 3 * D * F + 2 * E * C * D) * 2
            / cs.HBM_BYTES_PER_S * 1e3}
        runs = [(f"{n}", libs[n], "mma") for n in libs] + [
            ("simt", libs["base"], "simt")]
        for name, lib, route in runs:
            x = mx.kernel_rows_operand(xe, route)
            CR = C if route == "mma" else mx.kernel_rows(C)
            a = (torch.empty((E, C, F), dtype=torch.bfloat16, device="cuda")
                 if route == "mma" else
                 torch.empty((E, F, CR), dtype=torch.bfloat16, device="cuda"))
            part, ticks = scratch[name if route == "mma" else "base"]

            def run(lib=lib, x=x, CR=CR, a=a, part=part, ticks=ticks,
                    route=route, name=name):
                err = lib.moe_experts(
                    x.data_ptr(), count.data_ptr(), w[0].data_ptr(),
                    w[1].data_ptr(), w[2].data_ptr(), a.data_ptr(),
                    y.data_ptr(), part.data_ptr(), ticks.data_ptr(), E, C,
                    CR, D, F, mx.DTYPES[torch.bfloat16], mx.BODIES[route],
                    stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")

            run()
            torch.cuda.synchronize()
            err = float((y.float() - want.float()).abs().max())
            row[name] = {"ms": cs.device_ms(run, n=10), "max_abs_err": err}
        cs.log(f"C {C}, {n_live} live: bound {row['bound_ms']:.4f} ms; "
               + ", ".join(
                   f"{n} {row[n]['ms']:.4f} ms "
                   f"({row['bound_ms'] / row[n]['ms']:.1%}, err "
                   f"{row[n]['max_abs_err']:.1e})"
                   for n, _, _ in runs))
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, timeout=60)
    cs.log(smi.stdout.strip())
    print(json.dumps({"moe_ablation": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
