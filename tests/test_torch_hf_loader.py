"""The port's HF checkpoint loader (kvquant_tpu_torch/models/hf_loader.py)
against the JAX package's (kvquant_tpu/models/hf_loader.py) on the same
files, written with the installed ``safetensors`` as
tests/test_hf_loader.py and tests/test_moe.py write theirs:

  - LLaMA single-file, sharded (an index of two shards), tied embeddings
    with RoPE extension, and the DBRX schema: the same config and every
    parameter bit for bit equal to JAX's, from F32 and F16 files, as fp32
    and as bf16 parameters; the loaded model's logits equal to JAX's;
  - BF16 files (which the JAX loader's numpy path cannot read) equal to
    ``safetensors.torch``'s read;
  - ``config_from_hf`` on the published DBRX numbers (d_model 6144, 48 /
    8 heads, vocab 100352, 16 experts top-4, ffn 10752, 40 layers) equal to
    JAX's;
  - the reader works with the ``safetensors`` package made unimportable.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvquant_tpu.models import get_forward as jget_forward
from kvquant_tpu.models.hf_loader import (config_from_hf as jconfig,
                                          load_hf_checkpoint as jload)

from kvquant_tpu_torch.models import get_forward, moe
from kvquant_tpu_torch.models.hf_loader import (SafetensorsFile,
                                                config_from_hf,
                                                load_hf_checkpoint)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _llama_tensors(rng, dtype, tie):
    D, H, Hkv, L, F, V = 64, 8, 2, 3, 160, 512
    Dh = D // H

    def r(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(dtype)

    t = {"model.embed_tokens.weight": r(V, D),
         "model.norm.weight": (np.abs(r(D)) + 0.5).astype(dtype)}
    if not tie:
        t["lm_head.weight"] = r(V, D)
    for i in range(L):
        p = f"model.layers.{i}."
        t[p + "self_attn.q_proj.weight"] = r(H * Dh, D)
        t[p + "self_attn.k_proj.weight"] = r(Hkv * Dh, D)
        t[p + "self_attn.v_proj.weight"] = r(Hkv * Dh, D)
        t[p + "self_attn.o_proj.weight"] = r(D, H * Dh)
        t[p + "mlp.gate_proj.weight"] = r(F, D)
        t[p + "mlp.up_proj.weight"] = r(F, D)
        t[p + "mlp.down_proj.weight"] = r(D, F)
        t[p + "input_layernorm.weight"] = (np.abs(r(D)) + 0.5).astype(dtype)
        t[p + "post_attention_layernorm.weight"] = (
            np.abs(r(D)) + 0.5).astype(dtype)
    cfg = {"model_type": "llama", "vocab_size": V, "hidden_size": D,
           "num_hidden_layers": L, "num_attention_heads": H,
           "num_key_value_heads": Hkv, "intermediate_size": F,
           "rms_norm_eps": 1e-6, "rope_theta": 123456.0,
           "max_position_embeddings": 2048, "tie_word_embeddings": tie,
           "rope_scaling": {"type": "linear", "factor": 2.0},
           "sliding_window": 512}
    return t, cfg


def _dbrx_tensors(rng, dtype, tie=False):
    D, H, Hkv, L, E, F, V = 96, 12, 2, 2, 4, 64, 256
    Dh = D // H

    def r(*shape):
        return (rng.standard_normal(shape) * 0.08).astype(dtype)

    t = {"transformer.wte.weight": r(V, D),
         "transformer.norm_f.weight": (1 + r(D)).astype(dtype)}
    if not tie:
        t["lm_head.weight"] = r(V, D)
    for i in range(L):
        p = f"transformer.blocks.{i}."
        t[p + "norm_attn_norm.attn.Wqkv.weight"] = r((H + 2 * Hkv) * Dh, D)
        t[p + "norm_attn_norm.attn.out_proj.weight"] = r(D, H * Dh)
        t[p + "norm_attn_norm.norm_1.weight"] = (1 + r(D)).astype(dtype)
        t[p + "norm_attn_norm.norm_2.weight"] = (1 + r(D)).astype(dtype)
        t[p + "ffn.router.layer.weight"] = r(E, D)
        for n in ("w1", "v1", "w2"):
            t[p + f"ffn.experts.mlp.{n}"] = r(E * F, D)
    cfg = {"model_type": "dbrx", "d_model": D, "n_heads": H, "n_layers": L,
           "vocab_size": V, "max_seq_len": 512, "tie_word_embeddings": tie,
           "attn_config": {"kv_n_heads": Hkv, "rope_theta": 500000.0,
                           "clip_qkv": 8},
           "ffn_config": {"ffn_hidden_size": F, "moe_num_experts": E,
                          "moe_top_k": 2}}
    return t, cfg


def _write(path, tensors, cfg, sharded=False):
    from safetensors.numpy import save_file

    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg))
    if not sharded:
        save_file(tensors, str(path / "model.safetensors"))
        return
    names = sorted(tensors)
    shards = {"model-00001-of-00002.safetensors": names[:len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    for fname, ns in shards.items():
        save_file({n: tensors[n] for n in ns}, str(path / fname))
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {n: s for s, ns in shards.items() for n in ns}}))


def _tree(params):
    """The port's module as the JAX pytree layout (numpy)."""
    t = {"embed": params.embed, "final_norm": params.final_norm,
         "layers": dict(params.layers)}
    if params.lm_head is not None:
        t["lm_head"] = params.lm_head
    return {k: ({n: v.float().numpy() for n, v in x.items()}
                if isinstance(x, dict) else x.float().numpy())
            for k, x in t.items()}


def _same(tp, jp):
    tt = _tree(tp)
    jt = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
    assert set(tt) == set(jt) and set(tt["layers"]) == set(jt["layers"])
    for k in ("embed", "final_norm", "lm_head"):
        if k in jt:
            np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    for k in jt["layers"]:
        np.testing.assert_array_equal(tt["layers"][k], jt["layers"][k],
                                      err_msg=k)


CASES = {
    "llama": lambda rng, dt: _llama_tensors(rng, dt, tie=False),
    "llama-tied": lambda rng, dt: _llama_tensors(rng, dt, tie=True),
    "dbrx": lambda rng, dt: _dbrx_tensors(rng, dt),
}


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("file_dtype", ["F32", "F16"])
@pytest.mark.parametrize("case", list(CASES))
def test_params_equal_jax_loader(case, file_dtype, sharded, tmp_path):
    tensors, cfg = CASES[case](np.random.default_rng(3),
                               {"F32": np.float32, "F16": np.float16}
                               [file_dtype])
    _write(tmp_path, tensors, cfg, sharded)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        tp, tcfg = load_hf_checkpoint(str(tmp_path), dtype=tdt,
                                      device="cpu")
        jp, jcfg = jload(str(tmp_path), dtype=jdt)
        assert type(tcfg).__name__ == type(jcfg).__name__
        assert tcfg.__dict__ == jcfg.__dict__
        assert tp.embed.dtype == tdt and tp.final_norm.dtype == torch.float32
        _same(tp, jp)
    if case == "dbrx":
        assert isinstance(tp, moe.MoE) and tcfg.ffn_mode == "sparse"


@pytest.mark.parametrize("case", list(CASES))
def test_loaded_forward_matches_jax(case, tmp_path):
    tensors, cfg = CASES[case](np.random.default_rng(5), np.float32)
    _write(tmp_path, tensors, cfg)
    tp, tcfg = load_hf_checkpoint(str(tmp_path), dtype=torch.float32,
                                  device="cpu")
    jp, jcfg = jload(str(tmp_path), dtype=jnp.float32)
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 24),
                                             dtype=np.int32)
    want, _ = jget_forward(jcfg)(jp, jcfg, jnp.asarray(toks))
    got, _ = get_forward(tcfg)(tp, tcfg, torch.as_tensor(toks))
    scale = float(np.abs(np.asarray(want)).max())
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-5 * scale


def test_rope_extension_and_tied_head(tmp_path):
    tensors, cfg = _llama_tensors(np.random.default_rng(7), np.float32, True)
    _write(tmp_path, tensors, cfg)
    tp, tcfg = load_hf_checkpoint(str(tmp_path), dtype=torch.float32,
                                  max_seq_len=8192, device="cpu")
    jp, jcfg = jload(str(tmp_path), dtype=jnp.float32, max_seq_len=8192)
    assert tcfg.max_seq_len == jcfg.max_seq_len == 8192
    # the file's linear factor 2, times 8192 / 2048
    assert tcfg.rope_scaling == jcfg.rope_scaling == pytest.approx(8.0)
    assert tp.lm_head is None and "lm_head" not in jp
    assert torch.equal(tp.head(), tp.embed.T)


@pytest.mark.parametrize("case", ["llama", "dbrx"])
def test_bf16_files_equal_safetensors_torch(case, tmp_path):
    """BF16 tensors (the published DBRX weights' dtype): the reader's bits
    equal safetensors.torch's, and the loaded parameters are those bits
    placed as the loader places them."""
    from safetensors.torch import load_file, save_file

    tensors, cfg = CASES[case](np.random.default_rng(8), np.float32)
    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in
          tensors.items()}
    tmp_path.mkdir(exist_ok=True)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    save_file(bf, str(tmp_path / "model.safetensors"))
    ref = load_file(str(tmp_path / "model.safetensors"))
    f = SafetensorsFile(str(tmp_path / "model.safetensors"))
    assert sorted(f.header) == sorted(ref)
    for k, v in ref.items():
        got = f.get_tensor(k)
        assert got.dtype == torch.bfloat16 and torch.equal(got, v), k
    tp, tcfg = load_hf_checkpoint(str(tmp_path), dtype=torch.bfloat16,
                                  device="cpu")
    if case == "dbrx":
        E, Fd, D = tcfg.n_experts, tcfg.d_ff, tcfg.d_model
        w1 = ref["transformer.blocks.1.ffn.experts.mlp.w1"]
        w2 = ref["transformer.blocks.1.ffn.experts.mlp.w2"]
        assert torch.equal(tp.layers["w_gate"][1],
                           w1.reshape(E, Fd, D).transpose(1, 2))
        assert torch.equal(tp.layers["w_down"][1], w2.reshape(E, Fd, D))
        assert torch.equal(
            tp.layers["w_qkv"][0],
            ref["transformer.blocks.0.norm_attn_norm.attn.Wqkv.weight"].T)
        assert torch.equal(tp.final_norm,
                           ref["transformer.norm_f.weight"].float())
    else:
        assert torch.equal(tp.layers["wk"][2],
                           ref["model.layers.2.self_attn.k_proj.weight"].T)
    assert torch.equal(tp.lm_head, ref["lm_head.weight"].T)


def test_dbrx_published_config_equals_jax(tmp_path):
    """databricks/dbrx-base's config.json numbers (G 6, d_head 128)."""
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "dbrx", "d_model": 6144, "n_heads": 48,
        "n_layers": 40, "max_seq_len": 32768, "vocab_size": 100352,
        "attn_config": {"kv_n_heads": 8, "rope_theta": 500000,
                        "clip_qkv": 8},
        "ffn_config": {"ffn_hidden_size": 10752, "moe_num_experts": 16,
                       "moe_top_k": 4}}))
    t, j = config_from_hf(str(tmp_path)), jconfig(str(tmp_path))
    assert isinstance(t, moe.MoEConfig)
    assert t.__dict__ == j.__dict__
    assert (t.d_head, t.q_per_kv, t.n_experts, t.top_k) == (128, 6, 16, 4)


def test_reader_needs_no_safetensors_package(tmp_path):
    """Load a sharded DBRX checkpoint in a process where ``import
    safetensors`` fails."""
    tensors, cfg = _dbrx_tensors(np.random.default_rng(9), np.float16)
    _write(tmp_path, tensors, cfg, sharded=True)
    code = (
        "import sys\n"
        "sys.modules['safetensors'] = None\n"
        "import torch\n"
        "from kvquant_tpu_torch.models.hf_loader import load_hf_checkpoint\n"
        f"p, c = load_hf_checkpoint({str(tmp_path)!r}, dtype=torch.float32,"
        " device='cpu')\n"
        "assert c.n_experts == 4\n"
        "assert p.layers['w_up'].shape == (2, 4, 96, 64)\n"
        "assert 'jax' not in sys.modules\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
