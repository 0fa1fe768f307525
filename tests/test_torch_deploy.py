"""The port's deployment surface against the JAX package: cli/deploy.py,
utils/profiling.py, cli/common's parallel flags, models/config.MISTRAL_7B
and a sliding-window trajectory through K1's plain version:

  - cli.deploy at the committed toy quantizers' widths on the CPU, for
    --kernel flash and pallas, with --check: its "cache:" line is the one
    JAX's cache_bytes gives for the same flags; the simulated and deployed
    ppl are finite, and within 0.5 in log of each other without a prefill
    (with one, as in the JAX CLI, the simulated ppl scores every position
    and the deployed one only those after the prefill); the timed decode
    runs, launches no kernel on the CPU, and --profile writes a Chrome
    trace; --tp 2, --dp 2 and --distributed raise NotImplementedError;
  - utils.profiling on the CPU (tests/test_aux.py:102-108's case):
    cost_analysis returns a dict (launches and time of the ATen
    operators, no XLA keys), device_timed a positive time, trace a file;
  - MISTRAL_7B equals JAX's field by field;
  - TINY_GQA with a sliding window of 16 under a 24-token prompt: greedy
    generate through kernel="flash" gives JAX's tokens, fp16 and
    quantized prefill, fp32 dots.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvquant_tpu import engine as jeng
from kvquant_tpu.cache import (DeployConfig as JDeployConfig,
                               cache_bytes as jcache_bytes,
                               deployed_from_quantizers as jdeployed)
from kvquant_tpu.models import TINY_GQA as J_GQA, init_params as jinit
from kvquant_tpu.models.config import MISTRAL_7B as J_MISTRAL
from kvquant_tpu.quant.artifacts import load_quantizers as jload
from kvquant_tpu.quant.artifacts import save_quantizers
from kvquant_tpu.quant.calibration import (collect_kv_activations,
                                           fit_quantizers)

from kvquant_tpu_torch import engine
from kvquant_tpu_torch.cache import DeployConfig, deployed_from_quantizers
from kvquant_tpu_torch.models import TINY_GQA, params_from_numpy
from kvquant_tpu_torch.models.config import MISTRAL_7B
from kvquant_tpu_torch.quant.artifacts import load_quantizers
from kvquant_tpu_torch.utils import profiling

torch.set_num_threads(1)

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts")
Q3 = os.path.join(ART, "toy_quantizers_3bit.npz")
TOY = ["--toy-layers", "4", "--toy-dmodel", "256", "--toy-heads", "8",
       "--toy-kv-heads", "4", "--toy-vocab", "512", "--device", "cpu",
       "--quantizers", Q3, "--nsamples", "2", "--seqlen", "64"]


@pytest.mark.parametrize("prefill", [0, 24])
@pytest.mark.parametrize("kernel", ["flash", "pallas"])
def test_cli_deploy_on_cpu(kernel, prefill, tmp_path, capsys):
    from kvquant_tpu_torch.cli import deploy

    prof = str(tmp_path / "prof")
    out = deploy.main(TOY + ["--kernel", kernel, "--check", "--benchmark",
                             "4", "--prefill", str(prefill), "--profile",
                             prof])
    text = capsys.readouterr().out

    qs = jload(Q3)
    jd = JDeployConfig.create(
        bits=qs.bits, n_kv_heads=4, d_head=32, max_len=prefill + 4 + 32,
        sink=qs.first_few_fp16, head_group=4, codes="nuq",
        post_rope_k=bool(qs.meta.get("post_rope_k", False)),
        k_outliers="slots", n_kc=4,
        sparsity_threshold=qs.sparsity_threshold, kernel=kernel)
    acct = jcache_bytes(jd, 4, 1)
    want = (f"cache: {acct['total']/2**20:.1f} MiB "
            f"({acct['ratio']:.2f}x smaller than fp16)")
    assert text.splitlines()[0] == want
    assert out["cache_mib"] == acct["total"] / 2**20

    sim, dep = out["sim_ppl"], out["dep_ppl"]
    assert np.isfinite([sim, dep]).all()
    if prefill == 0:  # then both score the same 15 next tokens
        assert abs(np.log(dep / sim)) < 0.5, (dep, sim)
    assert f"check: simulated ppl {sim:.4f}  deployed ppl {dep:.4f}" in text
    assert out["tok_s"] > 0 and f"kernel={kernel})" in text
    assert not any(out["launches"].values())
    assert "kernel launches in the timed pass: none" in text
    assert out["profile"]["device"] == "cpu"
    assert out["profile"]["launches"] > 0
    with open(os.path.join(prof, "trace.json")) as fh:
        assert json.load(fh)["traceEvents"]


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--dp", "2"],
                                   ["--distributed"]])
def test_cli_deploy_refuses_parallel(flags):
    from kvquant_tpu_torch.cli import deploy

    with pytest.raises(NotImplementedError, match="item 12"):
        deploy.main(TOY + ["--benchmark", "1"] + flags)


def test_setup_parallel_one_device():
    import argparse

    from kvquant_tpu_torch.cli import common

    ap = argparse.ArgumentParser()
    common.add_parallel_args(ap)
    for argv in ([], ["--tp", "1"], ["--dp", "1", "--tp", "1"]):
        assert common.setup_parallel(ap.parse_args(argv)) is None


def test_profiling_on_cpu(tmp_path, capsys):
    def f(x):
        return torch.sum(x * 2.0)[None]

    x = torch.ones((128, 128))
    ca = profiling.cost_analysis(f, x)
    assert isinstance(ca, dict) and ca["device"] == "cpu"
    assert ca["launches"] >= 2 and ca["kernel_ms"] > 0
    names = [n for n, _ in ca["by_kernel"]]
    assert "aten::mul" in names and "aten::sum" in names
    assert not {"bytes accessed", "flops", "transcendentals"} & set(ca)
    assert profiling.device_timed(f, x, iters=5) > 0
    rep = profiling.traffic_report(f, x, label="f")
    assert rep["launches"] == ca["launches"]
    assert capsys.readouterr().out.startswith("[f] cpu: launches=")
    with profiling.trace(str(tmp_path / "t")) as prof:
        f(x)
    assert prof is not None
    assert os.path.getsize(tmp_path / "t" / "trace.json") > 0


def test_mistral_7b_matches_jax():
    assert dataclasses.asdict(MISTRAL_7B) == dataclasses.asdict(J_MISTRAL)
    assert (MISTRAL_7B.kv_hidden, MISTRAL_7B.q_per_kv) == (1024, 4)


@pytest.mark.parametrize("prefill_mode", ["fp16", "quantized"])
def test_sliding_window_generate_matches_jax(prefill_mode, tmp_path):
    """A window of 16 under a 24-token prompt: every step past the first
    attends to a strict suffix of the cache (nuq3, pre-RoPE K, slots, hg
    2, K1's plain version against JAX's kernel in interpret mode)."""
    jcfg = dataclasses.replace(J_GQA, sliding_window=16)
    tcfg = dataclasses.replace(TINY_GQA, sliding_window=16)
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    cal = jax.random.randint(jax.random.PRNGKey(7), (2, 40), 0,
                             jcfg.vocab_size)
    k, v = collect_kv_activations(params, jcfg, [cal])
    qs = fit_quantizers(k, v, bits=3, sparsity_threshold=0.99,
                        cap_outliers=True, first_few_fp16=5, sample_seqlen=40,
                        mode="uniform")
    path = str(tmp_path / "q.npz")
    save_quantizers(path, qs)
    d = dict(bits=3, n_kv_heads=2, d_head=8, max_len=300, sink=5,
             kernel="flash", dot_bf16=False, head_group=2, codes="nuq",
             k_outliers="slots", cap_per_side=2)
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab_size, (1, 24),
                                               dtype=np.int32)
    gcfg = dict(max_new_tokens=16)
    want, _ = jeng.generate(params, jcfg, JDeployConfig.create(**d),
                            jdeployed(qs, 2, 8), jnp.asarray(prompt),
                            jeng.GenerateConfig(**gcfg),
                            prefill_mode=prefill_mode)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    got, cache = engine.generate(
        tparams, tcfg, DeployConfig.create(**d),
        deployed_from_quantizers(load_quantizers(path), 2, 8, device="cpu"),
        torch.as_tensor(prompt), engine.GenerateConfig(**gcfg),
        prefill_mode=prefill_mode, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()
    assert cache.length.tolist() == [24 + 16]
