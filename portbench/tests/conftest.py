"""Tests of the benchmark's own code, on the CPU at tiny sizes.

    python -m pytest portbench/tests -q

Tests marked ``card`` need an NVIDIA card and skip without one (decided
in the ``card`` fixture, not at import). ``tiny_base`` is a throwaway
benchmark folder (a tiny LLaMA-schema config, a tiny DBRX-schema config,
the real scheme, small traffic mixes and cells) made as files, as a later
change would add them."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
for p in (PORTBENCH, os.path.dirname(PORTBENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_LLAMA = {
    "model_type": "mistral", "hidden_size": 64, "intermediate_size": 96,
    "num_hidden_layers": 2, "num_attention_heads": 8,
    "num_key_value_heads": 4, "max_position_embeddings": 4096,
    "rms_norm_eps": 1e-5, "rope_theta": 1000000.0, "sliding_window": None,
    "tie_word_embeddings": False, "vocab_size": 128,
}
TINY_DBRX = {
    "model_type": "dbrx", "d_model": 96, "n_heads": 12, "n_layers": 2,
    "max_seq_len": 4096, "vocab_size": 128,
    "attn_config": {"kv_n_heads": 4, "rope_theta": 500000},
    "ffn_config": {"ffn_hidden_size": 64, "moe_num_experts": 8,
                   "moe_top_k": 2},
}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture
def tiny_base(tmp_path):
    return make_tiny_base(str(tmp_path))


def make_tiny_base(root: str):
    """A benchmark folder under ``root`` with two tiny cells,
    ``tiny-llama-closed`` and ``tiny-dbrx-closed``, and an open-loop
    ``tiny-llama-open``; returns (its path, its BENCHMARK.json)."""
    base = os.path.join(root, "pb")
    shutil.copytree(os.path.join(PORTBENCH, "schemes"),
                    os.path.join(base, "schemes"))
    shutil.copytree(os.path.join(PORTBENCH, "metrics"),
                    os.path.join(base, "metrics"))
    _write(os.path.join(base, "configs", "tiny-llama", "config.json"),
           TINY_LLAMA)
    _write(os.path.join(base, "configs", "tiny-dbrx", "config.json"),
           TINY_DBRX)
    closed = {"loop": "closed", "clients": 3,
              "prompt": {"dist": "uniform", "min": 40, "max": 300},
              "answer": {"dist": "loguniform", "min": 4, "max": 12},
              "pool": 8}
    _write(os.path.join(base, "traffic", "tiny-closed.json"), closed)
    _write(os.path.join(base, "traffic", "tiny-open.json"), dict(
        closed, loop="open", rate_per_s=10.0, warmup_s=0.2))
    judge = {"requests": 6}
    cells = []
    for name, cfg, tr in (("tiny-llama-closed", "tiny-llama", "tiny-closed"),
                          ("tiny-dbrx-closed", "tiny-dbrx", "tiny-closed"),
                          ("tiny-llama-open", "tiny-llama", "tiny-open")):
        _write(os.path.join(base, "workloads", f"{name}.json"), dict(
            config=cfg, scheme="nuq3-k1", traffic=tr, slots=3,
            admit_chunk=128, judge=judge, limits={"gap": 0.05}))
        cells.append({"name": name, "config": cfg, "traffic": tr,
                      "chips": 1, "why": "test"})
    with open(os.path.join(PORTBENCH, os.pardir, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"] = cells
    for mt in bench["end_to_end"] + bench["per_layer"]:
        mt.pop("workloads", None)
    return base, bench
