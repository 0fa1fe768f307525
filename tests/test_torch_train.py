"""Training in the port (models/llama.params_to_numpy / trainable,
utils/toymodel.train_toy_model / save_toy_checkpoint / cached_toy_model)
against the JAX package, on TINY_LLAMA / TINY_GQA weights drawn by JAX and
carried across as numpy:

  - params_to_numpy inverts params_from_numpy (bitwise), and trainable
    gives an fp32 copy whose every parameter requires grad;
  - a checkpoint written by the port loads in JAX's load_toy_checkpoint
    and JAX's logits equal the port's within 1e-5 (absolute, logits of
    magnitude ~1); the reverse direction likewise;
  - from the same initial weights, 1, 2 and 3 steps of the port's
    train_toy_model and of JAX's (optax.adam) give per-step losses within
    1e-5 relative (measured ~1e-7), and the parameters after 3 steps agree
    within 1e-5 absolute, 1% of one lr = 1e-3 Adam step (measured 9e-7:
    Adam's first step is lr * g / (|g| + eps), so a near-zero gradient
    could amplify a rounding difference up to a fraction of lr; none
    does here);
  - cached_toy_model trains and writes a checkpoint on a miss, which both
    packages then load;
  - BigramLM.sample (rows' cumsums computed once in the port) draws JAX's
    tokens bit for bit at the recipe's shapes: training batches 16 x 256
    and the eval / calibration windows.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvquant_tpu.models import TINY_GQA as J_GQA, TINY_LLAMA as J_TINY
from kvquant_tpu.models import init_params as jinit
from kvquant_tpu.models.llama import forward as jforward
from kvquant_tpu.utils import toymodel as jtoy

from kvquant_tpu_torch.models import (TINY_GQA, TINY_LLAMA, forward,
                                      params_from_numpy, params_to_numpy,
                                      trainable)
from kvquant_tpu_torch.utils import toymodel
from kvquant_tpu_torch.utils.toymodel import TOY_CFG

torch.set_num_threads(1)

CFGS = {"mha": (J_TINY, TINY_LLAMA), "gqa": (J_GQA, TINY_GQA)}
STEPS, BATCH, SEQ = 3, 2, 32


def _tree(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        jinit(jax.random.PRNGKey(seed), jcfg,
                              dtype=jnp.float32))


def _leaves(tree, prefix=""):
    return toymodel._flatten(tree, prefix)


@pytest.mark.parametrize("which", list(CFGS))
def test_params_to_numpy_inverts_params_from_numpy(which):
    jcfg, tcfg = CFGS[which]
    tree = _tree(jcfg)
    back = params_to_numpy(params_from_numpy(tree, tcfg, device="cpu"))
    a, b = _leaves(tree), _leaves(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_params_to_numpy_bf16_weights_come_back_as_fp32():
    tree = _tree(J_TINY)
    p = params_from_numpy(tree, TINY_LLAMA, device="cpu",
                          dtype=torch.bfloat16)
    back = params_to_numpy(p)
    assert back["layers"]["wq"].dtype == np.float32
    want = torch.tensor(tree["layers"]["wq"]).to(torch.bfloat16).float()
    assert np.array_equal(back["layers"]["wq"], want.numpy())


def test_trainable_is_an_fp32_copy_that_requires_grad():
    p = params_from_numpy(_tree(J_TINY), TINY_LLAMA, device="cpu",
                          dtype=torch.bfloat16)
    t = trainable(p)
    params = list(t.parameters())
    assert len(params) == len(list(p.parameters())) == 12
    assert all(x.requires_grad and x.dtype == torch.float32 for x in params)
    assert not any(x.requires_grad for x in p.parameters())
    t.embed.data.zero_()
    assert p.embed.abs().max() > 0  # no aliasing


@pytest.mark.parametrize("which", list(CFGS))
def test_port_checkpoint_loads_in_jax(tmp_path, which):
    jcfg, tcfg = CFGS[which]
    params = params_from_numpy(_tree(jcfg, seed=1), tcfg, device="cpu")
    path = str(tmp_path / "ck.npz")
    toymodel.save_toy_checkpoint(path, params, loss=1.25, seed=7)
    jtree, loss, seed = jtoy.load_toy_checkpoint(path)
    assert (loss, seed) == (1.25, 7)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 24),
                                               dtype=np.int32)
    jl, _ = jforward(jtree, jcfg, jnp.asarray(tokens))
    tl, _ = forward(params, tcfg, torch.as_tensor(tokens))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=0,
                               atol=1e-5)
    # the same file through the port's reader: the same arrays
    ttree, _, _ = toymodel.load_toy_checkpoint(path)
    a, b = _leaves(params_to_numpy(params)), _leaves(ttree)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("which", list(CFGS))
def test_jax_checkpoint_loads_in_the_port(tmp_path, which):
    jcfg, tcfg = CFGS[which]
    jp = jinit(jax.random.PRNGKey(2), jcfg, dtype=jnp.float32)
    path = str(tmp_path / "ck.npz")
    jtoy.save_toy_checkpoint(path, jax.tree.map(np.asarray, jp), 2.5, 3)
    tree, loss, seed = toymodel.load_toy_checkpoint(path)
    assert (loss, seed) == (2.5, 3)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 24),
                                               dtype=np.int32)
    jl, _ = jforward(jp, jcfg, jnp.asarray(tokens))
    tl, _ = forward(params_from_numpy(tree, tcfg, device="cpu"), tcfg,
                    torch.as_tensor(tokens))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=0,
                               atol=1e-5)


@pytest.fixture(scope="module", params=list(CFGS))
def trained(request):
    """Per-step losses and final params of both packages over 1..STEPS
    steps from JAX's initial weights at seed 0."""
    jcfg, tcfg = CFGS[request.param]
    init = _tree(jcfg)
    out = {"jax": [], "port": []}
    for k in range(1, STEPS + 1):
        jp, jlm, jl = jtoy.train_toy_model(jcfg, steps=k, batch=BATCH,
                                           seq_len=SEQ, seed=0)
        tp, tlm, tl = toymodel.train_toy_model(tcfg, steps=k, batch=BATCH,
                                               seq_len=SEQ, seed=0,
                                               init=init, device="cpu")
        out["jax"].append(jl)
        out["port"].append(tl)
    assert np.array_equal(jlm.trans, tlm.trans)
    return dict(jax_params=jax.tree.map(np.asarray, jp), port_params=tp,
                **out)


def test_train_toy_model_losses_match_jax(trained):
    assert len(trained["port"]) == STEPS
    np.testing.assert_allclose(trained["port"], trained["jax"], rtol=1e-5)
    # the steps moved the model: the losses are not all the same
    assert len(set(trained["port"])) > 1


def test_train_toy_model_params_match_jax(trained):
    p = trained["port_params"]
    assert not any(x.requires_grad for x in p.parameters())
    a = _leaves(trained["jax_params"])
    b = _leaves(params_to_numpy(p))
    assert a.keys() == b.keys()
    init = _leaves(_tree(J_TINY if p.cfg == TINY_LLAMA else J_GQA))
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5, err_msg=k)
    # and they did move (by Adam steps of up to lr = 1e-3)
    assert max(float(np.abs(b[k] - init[k]).max()) for k in b) > 1e-4


def test_train_toy_model_draws_its_own_init_from_seed():
    a, _, la = toymodel.train_toy_model(TINY_LLAMA, steps=2, batch=BATCH,
                                        seq_len=SEQ, seed=4, device="cpu")
    b, _, lb = toymodel.train_toy_model(TINY_LLAMA, steps=2, batch=BATCH,
                                        seq_len=SEQ, seed=4, device="cpu")
    assert la == lb and np.isfinite(la)
    assert torch.equal(a.embed, b.embed)


def test_cached_toy_model_trains_and_writes_on_a_miss(tmp_path):
    path = str(tmp_path / "sub" / "toy.npz")
    kw = dict(steps=2, batch=BATCH, seq_len=SEQ, seed=5)
    params, lm, loss = toymodel.cached_toy_model(path, cfg=TINY_LLAMA,
                                                 device="cpu", **kw)
    assert os.path.exists(path) and np.isfinite(loss)
    again, lm2, loss2 = toymodel.cached_toy_model(path, cfg=TINY_LLAMA,
                                                  device="cpu")
    assert loss2 == np.float32(loss) and np.array_equal(lm.trans, lm2.trans)
    a, b = _leaves(params_to_numpy(params)), _leaves(params_to_numpy(again))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    # JAX reads it (and its BigramLM has the same seed)
    jparams, jlm, jloss = jtoy.cached_toy_model(path, cfg=J_TINY)
    assert jloss == loss2 and np.array_equal(jlm.trans, lm.trans)
    tokens = lm.sample(2, 16, seed=0).numpy()
    jl, _ = jforward(jparams, J_TINY, jnp.asarray(tokens))
    tl, _ = forward(again, TINY_LLAMA, torch.as_tensor(tokens))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("n,seed", [(16, 0), (16, 1199), (4, 10_001),
                                    (4, 20_002)])
def test_bigram_samples_equal_jax(n, seed):
    lm = toymodel.BigramLM(TOY_CFG.vocab_size, seed=0)
    jlm = jtoy.BigramLM(TOY_CFG.vocab_size, seed=0)
    got = lm.sample(n, 256, seed)
    assert got.dtype == torch.int32 and got.shape == (n, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlm.sample(
        n, 256, seed)))
