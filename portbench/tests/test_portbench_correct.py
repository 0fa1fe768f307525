"""The comparison that decides ``correct``, driven through whole runs of
tiny cells on the CPU (the harness's look for a card skipped):

  - the program run in fp32 (dots in fp32 too) serves exactly the
    reference's first choices, LLaMA-schema and DBRX-schema (capacity
    drops included), so the reference is the program's semantics;
  - the fp8 control, put in the program's place, fails the limit;
  - the timed path broken underneath (a decode step that leaves the cache
    as it was, half of the batch left out with the mean of the rest in its
    place, a token altered where it is produced) comes out not correct.

One cell of four chips would add the fault of the exchange between chips
left out; every cell here is one chip.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import run as bench
from pbench import spec


def _run(base, bench_json, name, seed=3, control=False, fp32=True,
         seconds=2.0, requests=6, limits=None):
    c = spec.cell(bench_json, name, base)
    if fp32:  # exact: the fp32 program serves the reference's tokens
        c["scheme"] = dict(c["scheme"], dot_bf16=False)
        c["workload"]["limits"] = limits or {"gap": 0.0}
    c["workload"]["judge"]["requests"] = requests
    return bench.run_cell(c, seed, seconds, False, device="cpu",
                          dtype=torch.float32 if fp32 else None,
                          control=control)


@pytest.mark.parametrize("name", ["tiny-llama-closed", "tiny-dbrx-closed",
                                  "tiny-llama-open"])
def test_fp32_program_serves_the_reference_tokens(tiny_base, name):
    base, bj = tiny_base
    out = _run(base, bj, name)
    v = out["verdict"]
    assert v["tokens"] >= 12 and v["gap"] == 0.0 and v["agree"] == 1.0
    assert out["result"]["correct"] is True
    if "dbrx" in name:
        assert v["dropped"] > 0  # the capacity rule did bind


def test_bf16_run_is_judged_and_reports(tiny_base):
    base, bj = tiny_base
    out = _run(base, bj, "tiny-llama-closed", fp32=False)
    res = out["result"]
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(res)[-1] == "checks"
    assert res["failed"] == 0 and res["attempted"] > 0
    assert {"output_tok_s", "itl_p99_ms", "setup_s"} <= set(res["metrics"])
    assert np.isfinite(res["checks"]["gap"]["value"])


@pytest.mark.parametrize("seed", [1, 2, 4])
def test_control_is_not_correct(tiny_base, seed):
    """The control in the program's place, judged by the same limits and
    the same code that decides a run's ``correct``."""
    base, bj = tiny_base
    limits = spec.workload("tiny-llama-closed", base)["limits"]
    out = _run(base, bj, "tiny-llama-closed", seed=seed, control=True,
               requests=6, limits=limits)
    v = out["verdict"]
    assert v["gap"] <= limits["gap"] < v["control"]["gap"]
    assert out["result"]["correct"] is True
    assert out["control"]["correct"] is False
    assert out["control"]["checks"]["gap"]["value"] == v["control"]["gap"]


def _no_append(monkeypatch):
    from kvquant_tpu_torch.ops import deployed

    monkeypatch.setattr(deployed, "append_token_flash",
                        lambda arrs, *a, **k: arrs)


def _half_batch(monkeypatch):
    from kvquant_tpu_torch import engine

    real = engine.decode_step

    def step(*a, **k):
        cache, logits = real(*a, **k)
        h = logits.shape[0] // 2 or 1
        logits = logits.clone()
        logits[h:] = logits[:h].mean(0)
        return cache, logits

    monkeypatch.setattr(engine, "decode_step", step)


def _altered_token(monkeypatch):
    from kvquant_tpu_torch import serve

    real = serve.Server._sample_with
    calls = [0]

    def sample(self, req, logits):
        calls[0] += 1
        tok = real(self, req, logits)
        return (tok + 1) % len(logits) if calls[0] % 5 == 0 else tok

    monkeypatch.setattr(serve.Server, "_sample_with", sample)


@pytest.mark.parametrize("fault", [_no_append, _half_batch, _altered_token])
@pytest.mark.parametrize("name", ["tiny-llama-closed", "tiny-dbrx-closed"])
def test_broken_timed_path_is_not_correct(tiny_base, monkeypatch, fault,
                                          name):
    base, bj = tiny_base
    fault(monkeypatch)
    out = _run(base, bj, name)
    assert out["result"]["correct"] is False


@pytest.mark.card
def test_control_fails_each_cell_at_its_size(card):
    """On a card: one seed of each cell with the control judged too; the
    program correct, the control, in its place, not."""
    bj = spec.benchmark()
    for w in bj["workloads"]:
        c = spec.cell(bj, w["name"])
        out = bench.run_cell(c, 424242, bj["run_seconds"], False,
                             control=True)
        assert out["result"]["correct"] is True, (w["name"], out["verdict"])
        assert out["control"]["correct"] is False, (w["name"],
                                                     out["verdict"])
