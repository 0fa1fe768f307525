"""How the MoE expert products' kernel (moe_glu, moe_down in
kvquant_tpu_torch/csrc/moe_experts.cu) is shaped, on one NVIDIA card.

    python3 moe_ablation.py

Builds copies of csrc/moe_experts.cu with other block shapes (text edits
of the copy) and times each at one DBRX layer (E 16, D 6144, F 10752,
bf16), 4 of the 16 experts live (the router's top_k of one token), at
1, 2, 3 and 8 capacity rows an expert (device ms between CUDA events,
chip_smoke.device_ms), each beside its byte bound (the live experts'
weights, the rows in and out, at 3.35 TB/s), its max |copy - plain| and
per-expert torch.matmul on the same rows (the route a host-side dispatch
would take). The copies go to the ignored build directory
kvquant_tpu_torch/_build/ablation/. The last line is one JSON object with
every time.

Copies (each edit must match the source, or the script stops):
  base   the source as it is (U 2 weight row steps in flight, 64-column
         tiles, 8 warps a block, 4 at 8 rows);
  u4     4 row steps in flight;
  t32    32-column tiles (64 bytes of a bf16 row a warp step);
  w8     8 warps at every row count;
  w4     4 warps at every row count.
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
WARPS = "  return CR >= 8 ? 4 : 8;"
EDITS = {
    "base": [],
    "u4": [("constexpr int U = 2;", "constexpr int U = 4;")],
    "t32": [("constexpr int TILE = 64;", "constexpr int TILE = 32;")],
    "w8": [(WARPS, "  return 8;")],
    "w4": [(WARPS, "  return 4;")],
}
E, D, F, TOP_K = 16, 6144, 10752, 4


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_ablation: no CUDA device", file=sys.stderr)
        return 2
    from kvquant_tpu_torch.ops.kernels import moe_experts as mx

    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(len(EDITS)) as ex:
        libs = dict(zip(EDITS, ex.map(
            lambda n: build_copy(n, reduce=lambda s: s, edits=EDITS,
                                 out=OUT, src_path=SRC), EDITS)))
    g = torch.Generator(device="cuda").manual_seed(0)
    w = [(torch.randn(s, generator=g, device="cuda") / s[1] ** 0.5).to(
        torch.bfloat16) for s in ((E, D, F), (E, D, F), (E, F, D))]
    res = {}
    for C in (1, 2, 3, 8):
        CR = mx.kernel_rows(C)
        xe = torch.randn((E, C, D), generator=g, device="cuda").to(
            torch.bfloat16)
        x = torch.nn.functional.pad(xe.transpose(1, 2),
                                    (0, CR - C)).contiguous()
        count = torch.zeros((E,), dtype=torch.int32, device="cuda")
        live = torch.randperm(E, generator=g, device="cuda")[:TOP_K]
        count[live] = C
        want = mx.moe_experts_plain(xe, count, *w)
        a = torch.empty((E, F, CR), dtype=torch.bfloat16, device="cuda")
        y = torch.empty((E, C, D), dtype=torch.bfloat16, device="cuda")
        row = res[C] = {"bound_ms": (TOP_K * 3 * D * F + 2 * E * C * D) * 2
                        / cs.HBM_BYTES_PER_S * 1e3}
        for name, so in libs.items():
            lib = ctypes.CDLL(so)
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.moe_experts.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I,
                                        I, P]

            def run(lib=lib):
                err = lib.moe_experts(
                    x.data_ptr(), count.data_ptr(), w[0].data_ptr(),
                    w[1].data_ptr(), w[2].data_ptr(), a.data_ptr(),
                    y.data_ptr(), E, C, CR, D, F, mx.DTYPES[torch.bfloat16],
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")

            run()
            torch.cuda.synchronize()
            row[name] = {"ms": cs.device_ms(run, n=10),
                         "max_abs_err": float((y.float() - want.float())
                                              .abs().max())}
        rows = {int(e): xe[int(e)] for e in live.tolist()}

        def per_expert():
            for e, r in rows.items():
                (torch.nn.functional.silu(r @ w[0][e]) * (r @ w[1][e])) \
                    @ w[2][e]

        row["per_expert_matmul_ms"] = cs.device_ms(per_expert, n=10)
        cs.log(f"C {C}: bound {row['bound_ms']:.4f} ms; " + ", ".join(
            f"{n} {row[n]['ms']:.4f} ms ({row['bound_ms'] / row[n]['ms']:.1%}"
            f", err {row[n]['max_abs_err']:.1e})" for n in EDITS)
            + f"; per-expert torch.matmul {row['per_expert_matmul_ms']:.4f}")
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, timeout=60)
    cs.log(smi.stdout.strip())
    print(json.dumps({"moe_ablation": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
