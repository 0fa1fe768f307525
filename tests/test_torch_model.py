"""Port of the full-precision prefill forward
(kvquant_tpu_torch/models/llama.py) against kvquant_tpu.models.llama.forward
on the same weights and tokens, fp32. Tolerance: atol 2e-5, rtol 1e-5 on
logits and captured K/V (fp32 sums in different orders)."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kvquant_tpu.models import llama as jllama
from kvquant_tpu.models.config import TINY_LLAMA as J_TINY, TINY_GQA as J_GQA
from kvquant_tpu.utils.toymodel import TOY_CFG as J_TOY

from kvquant_tpu_torch.models import llama as tllama
from kvquant_tpu_torch.models.config import TINY_LLAMA, TINY_GQA
from kvquant_tpu_torch.utils.toymodel import TOY_CFG, load_toy_checkpoint

torch.set_num_threads(1)

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts")
TOL = dict(atol=2e-5, rtol=1e-5)


def _both(jcfg, tcfg, tokens, jparams=None, **kw):
    if jparams is None:
        jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg,
                                     dtype=jnp.float32)
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    jl, jaux = jllama.forward(jparams, jcfg, jnp.asarray(tokens),
                              capture_kv=True, **kw)
    tl, taux = tllama.forward(params, tcfg, torch.as_tensor(tokens),
                              capture_kv=True, **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k_acts", "v_acts"):
        np.testing.assert_allclose(taux[name].numpy(), np.asarray(jaux[name]),
                                   **TOL)


def _tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T),
                                                dtype=np.int32)


@pytest.mark.parametrize("jcfg,tcfg", [(J_TINY, TINY_LLAMA),
                                       (J_GQA, TINY_GQA)], ids=["mha", "gqa"])
def test_forward_matches_jax(jcfg, tcfg):
    _both(jcfg, tcfg, _tokens(tcfg, 2, 24))


def test_forward_sliding_window():
    _both(dataclasses.replace(J_GQA, sliding_window=6),
          dataclasses.replace(TINY_GQA, sliding_window=6), _tokens(TINY_GQA, 2, 24))


@pytest.mark.parametrize("window", [None, 10])
def test_forward_forced_attn_chunk(window):
    _both(dataclasses.replace(J_TINY, sliding_window=window),
          dataclasses.replace(TINY_LLAMA, sliding_window=window),
          _tokens(TINY_LLAMA, 2, 32), attn_chunk=8)


def test_rope_scaling_cos_sin():
    jcfg = dataclasses.replace(J_TINY, rope_theta=500000.0, rope_scaling=4.0)
    tcfg = dataclasses.replace(TINY_LLAMA, rope_theta=500000.0,
                               rope_scaling=4.0)
    pos = np.arange(0, 5000, 37, dtype=np.int32)
    jc, js = jllama.rope_cos_sin(jnp.asarray(pos), jcfg)
    tc, ts = tllama.rope_cos_sin(torch.as_tensor(pos), tcfg)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)


def test_toy_checkpoint_through_params_from_numpy():
    tree, loss, seed = load_toy_checkpoint(os.path.join(ART, "toy_model.npz"))
    assert TOY_CFG == dataclasses.replace(TOY_CFG, **dataclasses.asdict(J_TOY))
    jparams = jax.tree.map(jnp.asarray, tree)
    _both(J_TOY, TOY_CFG, _tokens(TOY_CFG, 1, 20, seed=3), jparams=jparams)
