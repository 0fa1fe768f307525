"""The deployed engine, the slot-pool server and the CLIs on MoE models
(kvquant_tpu_torch/engine.py, serve.py, cli/) against the JAX package, on
TINY_MOE (4 / 2 heads, dense experts) and a G 6 MoE of three layers (12 / 2
heads, sparse dispatch, LayerNorm): the JAX init and JAX-fitted uniform
quantizers carried across as numpy / npz, fp32 weights and dots.

  - greedy tokens identical to JAX's (tests/test_moe.py:57-111) through
    every attention datapath: "xla" (the eager oracle), "flash" (K1),
    "pallas" (K3 / K4) on nuq3 pre-RoPE slot storage, and "flash_serial"
    (K2) on int4 post-RoPE channel storage, each with the fp16 and the
    quantized prefill;
  - serve.Server admits and decodes MoE requests with JAX's server's
    tokens, equal to the port's isolated generation;
  - cli.generate runs with --moe (its random model is an MoEConfig with
    the JAX CLI's fields) and with --model on a DBRX-schema checkpoint,
    where its text equals the JAX CLI's on the same files.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvquant_tpu import engine as jeng
from kvquant_tpu import serve as jserve
from kvquant_tpu.cache import (DeployConfig as JDeployConfig,
                               deployed_from_quantizers as jdeployed)
from kvquant_tpu.models import moe as jmoe
from kvquant_tpu.quant.artifacts import save_quantizers
from kvquant_tpu.quant.calibration import (collect_kv_activations as jcollect,
                                           fit_quantizers as jfit)

from kvquant_tpu_torch import engine, serve
from kvquant_tpu_torch.cache import DeployConfig, deployed_from_quantizers
from kvquant_tpu_torch.models import moe
from kvquant_tpu_torch.quant.artifacts import load_quantizers

torch.set_num_threads(1)

G6 = dict(vocab_size=256, d_model=96, n_layers=3, n_heads=12, n_kv_heads=2,
          d_head=8, d_ff=64, max_seq_len=512, n_experts=4, top_k=2,
          ffn_mode="sparse", norm_type="layernorm", rope_theta=500000.0)
MODELS = {"tiny": (jmoe.TINY_MOE, moe.TINY_MOE),
          "g6": (jmoe.MoEConfig(**G6), moe.MoEConfig(**G6))}
# kernel -> (bits, DeployConfig storage); the quantizers of "flash_serial"
# are fitted on roped keys
STORAGE = {
    "nuq3": (3, dict(codes="nuq", post_rope_k=False, k_outliers="slots",
                     cap_per_side=2)),
    "int4": (4, dict(codes="int4", post_rope_k=True, k_outliers="channels",
                     n_kc=2, cap_per_side=0)),
}
KERNELS = {"xla": "nuq3", "flash": "nuq3", "pallas": "nuq3",
           "flash_serial": "int4"}


@pytest.fixture(scope="module", params=list(MODELS))
def model(request, tmp_path_factory):
    jcfg, tcfg = MODELS[request.param]
    jp = jmoe.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = moe.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
    cal = jax.random.randint(jax.random.PRNGKey(7), (2, 48), 0, 256)
    quant = {}
    for name, (bits, _) in STORAGE.items():
        k_acts, v_acts = jcollect(jp, jcfg, [cal], rope_k=name == "int4")
        qs = jfit(k_acts, v_acts, bits=bits, cap_outliers=True,
                  first_few_fp16=5, sample_seqlen=48, kmeans_iters=8,
                  mode="uniform")
        if name == "int4":
            qs.meta["post_rope_k"] = True
        path = str(tmp_path_factory.mktemp("q") / f"{name}.npz")
        save_quantizers(path, qs)
        quant[name] = (jdeployed(qs, jcfg.n_kv_heads, jcfg.d_head),
                       deployed_from_quantizers(load_quantizers(path),
                                                tcfg.n_kv_heads, tcfg.d_head,
                                                device="cpu"))
    return dict(jax=(jp, jcfg), torch=(tp, tcfg), quant=quant,
                which=request.param)


def _dcfgs(cfg, kernel, max_len=293):
    bits, storage = STORAGE[KERNELS[kernel]]
    d = dict(bits=bits, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
             max_len=max_len, sink=5, kernel=kernel, head_group=2,
             dot_bf16=False, **storage)
    return JDeployConfig.create(**d), DeployConfig.create(**d)


@pytest.mark.parametrize("prefill_mode", ["fp16", "quantized"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_greedy_tokens_match_jax(model, kernel, prefill_mode):
    (jp, jcfg), (tp, tcfg) = model["jax"], model["torch"]
    jq, tq = model["quant"][KERNELS[kernel]]
    jd, td = _dcfgs(jcfg, kernel)
    prompt = np.random.default_rng(31).integers(0, 256, (1, 16),
                                                dtype=np.int32)
    want, _ = jeng.generate(jp, jcfg, jd, jq, jnp.asarray(prompt),
                            jeng.GenerateConfig(max_new_tokens=12),
                            prefill_mode=prefill_mode)
    got, cache = engine.generate(tp, tcfg, td, tq, torch.as_tensor(prompt),
                                 engine.GenerateConfig(max_new_tokens=12),
                                 prefill_mode=prefill_mode, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()
    assert cache.length.tolist() == [16 + 12]


@pytest.mark.parametrize("admit_mode", ["sync", "chunked"])
def test_server_matches_jax_and_isolated(model, admit_mode):
    """3 requests, 2 slots, kernel "flash": the third is admitted
    mid-flight at per-sample positions (chunked admission prefills through
    the quantized trajectory)."""
    (jp, jcfg), (tp, tcfg) = model["jax"], model["torch"]
    jq, tq = model["quant"]["nuq3"]
    jd, td = _dcfgs(jcfg, "flash")
    rng = np.random.default_rng(3)
    reqs = [(i, rng.integers(0, 256, n).astype(np.int32), m)
            for i, (n, m) in enumerate([(12, 6), (17, 4), (9, 5)])]
    out = {}
    for side, mod, args, extra in (
            ("jax", jserve, (jp, jcfg, jd, jq), {}),
            ("torch", serve, (tp, tcfg, td, tq), {"device": "cpu"})):
        srv = mod.Server(*args, n_slots=2, admit_mode=admit_mode,
                         admit_chunk=256, **extra)
        res = srv.run([mod.Request(rid=i, prompt=p, max_new_tokens=m)
                       for i, p, m in reqs])
        out[side] = {rid: c.tokens for rid, c in res.items()}
    assert out["torch"] == out["jax"]
    mode = "fp16" if admit_mode == "sync" else "quantized"
    for rid, p, m in reqs:
        iso, _ = engine.generate(tp, tcfg, td, tq, torch.as_tensor(p)[None],
                                 engine.GenerateConfig(max_new_tokens=m),
                                 prefill_mode=mode, device="cpu")
        assert out["torch"][rid] == iso[0].tolist()


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

MOE_ARGS = ["--toy-layers", "2", "--toy-dmodel", "96", "--toy-heads", "12",
            "--toy-kv-heads", "2", "--toy-vocab", "256", "--moe",
            "--toy-experts", "4", "--toy-top-k", "2", "--dtype", "float32"]


def test_cli_moe_model_and_generate(tmp_path, capsys):
    """--moe builds the JAX CLI's MoEConfig (fields equal) with the port's
    random weights, and cli.generate decodes through it on every
    datapath."""
    import argparse

    from kvquant_tpu.cli import common as jcommon
    from kvquant_tpu_torch.cli import common, generate

    ap = argparse.ArgumentParser()
    common.add_model_args(ap)
    params, cfg = common.load_model(ap.parse_args(MOE_ARGS + ["--device",
                                                              "cpu"]))
    jap = argparse.ArgumentParser()
    jcommon.add_model_args(jap)
    _, jcfg = jcommon.load_model(jap.parse_args(MOE_ARGS))
    assert isinstance(cfg, moe.MoEConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert isinstance(params, moe.MoE) and params.embed.dtype == torch.float32

    jp = jmoe.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    cal = jax.random.randint(jax.random.PRNGKey(1), (1, 48), 0, 256)
    qs = jfit(*jcollect(jp, jcfg, [cal]), bits=3, cap_outliers=True,
              first_few_fp16=5, sample_seqlen=48, kmeans_iters=4,
              mode="uniform")
    path = str(tmp_path / "q.npz")
    save_quantizers(path, qs)
    for kernel in ("pallas", "flash", "xla"):
        text = generate.main(MOE_ARGS + [
            "--device", "cpu", "--quantizers", path, "--kernel", kernel,
            "--head-group", "2", "--prompt", "a b c d e f g h",
            "--max-new-tokens", "3"])
        assert len(text.split()) == 3
    assert len(capsys.readouterr().out.strip().splitlines()) == 3


def _write_dbrx(path, rng):
    """A DBRX-schema checkpoint of F32 tensors (G 6, 4 experts, top 2)."""
    from safetensors.numpy import save_file

    D, H, Hkv, L, E, F, V = 96, 12, 2, 2, 4, 64, 256
    Dh = D // H
    (path / "config.json").write_text(json.dumps({
        "model_type": "dbrx", "d_model": D, "n_heads": H, "n_layers": L,
        "vocab_size": V, "max_seq_len": 512,
        "attn_config": {"kv_n_heads": Hkv, "rope_theta": 500000.0,
                        "clip_qkv": 8},
        "ffn_config": {"ffn_hidden_size": F, "moe_num_experts": E,
                       "moe_top_k": 2}}))

    def r(*shape):
        return (rng.standard_normal(shape) * 0.08).astype(np.float32)

    t = {"transformer.wte.weight": r(V, D),
         "transformer.norm_f.weight": 1 + r(D),
         "lm_head.weight": r(V, D)}
    for i in range(L):
        p = f"transformer.blocks.{i}."
        t[p + "norm_attn_norm.attn.Wqkv.weight"] = r((H + 2 * Hkv) * Dh, D)
        t[p + "norm_attn_norm.attn.out_proj.weight"] = r(D, H * Dh)
        t[p + "norm_attn_norm.norm_1.weight"] = 1 + r(D)
        t[p + "norm_attn_norm.norm_2.weight"] = 1 + r(D)
        t[p + "ffn.router.layer.weight"] = r(E, D)
        for n in ("w1", "v1", "w2"):
            t[p + f"ffn.experts.mlp.{n}"] = r(E * F, D)
    save_file(t, str(path / "model.safetensors"))


@pytest.mark.parametrize("kernel", ["pallas", "flash"])
def test_cli_model_dir_matches_jax_cli(kernel, tmp_path, capsys):
    """cli.generate --model DIR on a DBRX-schema checkpoint: the same text
    as the JAX CLI on the same files and quantizers (the word tokenizer:
    transformers is not installed, so both fall back to it)."""
    from kvquant_tpu.cli import generate as jgenerate
    from kvquant_tpu.models.hf_loader import load_hf_checkpoint
    from kvquant_tpu_torch.cli import generate

    ckpt = tmp_path / "dbrx"
    ckpt.mkdir()
    _write_dbrx(ckpt, np.random.default_rng(17))
    jp, jcfg = load_hf_checkpoint(str(ckpt), dtype=jnp.float32)
    cal = jax.random.randint(jax.random.PRNGKey(2), (1, 48), 0, 256)
    qs = jfit(*jcollect(jp, jcfg, [cal]), bits=3, cap_outliers=True,
              first_few_fp16=5, sample_seqlen=48, kmeans_iters=4,
              mode="uniform")
    path = str(tmp_path / "q.npz")
    save_quantizers(path, qs)
    argv = ["--model", str(ckpt), "--dtype", "float32", "--quantizers", path,
            "--kernel", kernel, "--head-group", "2", "--max-new-tokens", "6",
            "--prompt", "the pass key is 1 2 3 4 5 and the sky is blue"]
    jgenerate.main(argv)
    want = capsys.readouterr().out.strip()
    got = generate.main(argv + ["--device", "cpu"])
    assert got == want and len(got.split()) == 6
    capsys.readouterr()
