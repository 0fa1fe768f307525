"""The induction-retrieval language in the port (utils/induction.py)
against the JAX package:

  - every structural check of tests/test_induction.py on the port's six
    samplers (needle placement, distinct keys, masks on the answer tokens
    only, position jumps, difficulty 0 and 1, the blocks of
    sample_blocks_batch), plus sample_long_batch's, on the CPU generator;
  - the draws differ from jax.random's, so the samplers are held to JAX
    by their marginals over many rows: the mean of each drawn quantity
    (jump, mask count, start of the copy, source block, key) within 6
    standard errors of JAX's mean over as many rows, and the same ranges;
  - a tensor ``difficulty`` gives the float's draws;
  - build_retrieval_prompt and build_copy_prompt equal JAX's bit for bit;
  - rope_cos_sin at positions up to 131072 + 511 (IND_CFG's theta 1e7)
    within 1e-6 of JAX's; masked_loss and its gradient within 1e-5
    (relative to the largest entry) of JAX's on the same numpy batch,
    whose positions jump by 131072; the robust fine-tune's noisy loss and
    its gradient likewise with the same numpy probes, chunked attention
    and remat on (JAX's loss is the closure of
    kvquant_tpu/utils/induction.py:441-455, restated here); one stage-1
    step from the same weights and batch gives JAX's loss and gradients,
    and the port's Adam on JAX's gradients gives optax's parameters
    (within 1e-5 absolute, 1% of the lr);
  - the training loops run both stages and the fine-tune at a tiny width,
    and cached_induction_model loads a checkpoint JAX also reads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kvquant_tpu.models import init_params as jinit
from kvquant_tpu.models.llama import forward as jforward
from kvquant_tpu.models.llama import rope_cos_sin as jrope
from kvquant_tpu.utils import induction as J
from kvquant_tpu.utils import toymodel as jtoy

from kvquant_tpu_torch.models import params_from_numpy, params_to_numpy
from kvquant_tpu_torch.models.llama import rope_cos_sin, trainable
from kvquant_tpu_torch.utils import induction as I
from kvquant_tpu_torch.utils import toymodel

torch.set_num_threads(1)

SMALL = dataclasses.replace(I.IND_CFG, n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, d_head=16, d_ff=128)
J_SMALL = dataclasses.replace(J.IND_CFG, n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=2, d_head=16, d_ff=128)


def _np(*xs):
    return tuple(np.array(x) for x in xs)


def _gen(seed):
    return I.generator(seed, "cpu")


def test_constants_and_config_match_jax():
    for name in ("HAY", "KEY0", "NKEYS", "QUERY", "VL", "N_NEEDLES", "W",
                 "QW", "SEG_LEN", "SEG_MIN"):
        assert getattr(I, name) == getattr(J, name), name
    assert dataclasses.asdict(I.IND_CFG) == dataclasses.asdict(J.IND_CFG)
    assert I.CKPT == J.CKPT


# ---------------------------------------------------------------------------
# structure (tests/test_induction.py on the port's samplers)
# ---------------------------------------------------------------------------


def test_sample_batch_structure():
    B, T, MJ = 8, 256, 4096
    toks, pos, mask = _np(*I.sample_batch(_gen(0), B, T, MJ))
    region = T - I.QW
    assert toks.shape == pos.shape == mask.shape == (B, T)
    assert toks.dtype == pos.dtype == np.int32 and mask.dtype == bool
    assert (toks[:, region] == I.QUERY).all()
    qkey = toks[:, region + 1]
    assert ((qkey >= I.KEY0) & (qkey < I.KEY0 + I.NKEYS)).all()
    for b in range(B):
        (where,) = np.nonzero(toks[b, :region] == qkey[b])
        assert len(where) == 1  # keys are distinct per sequence
        s = where[0]
        assert toks[b, s - 1] == I.QUERY  # needle repeats the marker
        np.testing.assert_array_equal(
            toks[b, s + 1:s + 1 + I.VL],
            toks[b, region + 2:region + 2 + I.VL])
        keys = toks[b, :region][(toks[b, :region] >= I.KEY0)
                                & (toks[b, :region] < I.KEY0 + I.NKEYS)]
        assert len(keys) == len(set(keys)) == I.N_NEEDLES
    assert (np.diff(pos, axis=1) >= 1).all()
    assert (pos[:, region] - region < MJ).all()
    assert (pos[:, :region] == np.arange(region)).all()
    assert (mask.sum(1) == I.VL).all()
    assert mask[:, region + 2:region + 2 + I.VL].all()


def test_sample_repeat_batch_structure():
    B, T = 4, 128
    toks, pos, mask = _np(*I.sample_repeat_batch(_gen(1), B, T, 999))
    R = T // 2
    np.testing.assert_array_equal(toks[:, :R], toks[:, R:])
    assert (toks <= I.QUERY).all() and (toks >= 0).all()
    assert (mask.sum(1) == R - 1).all() and not mask[:, :R + 1].any()
    assert (np.diff(pos, axis=1) >= 1).all()
    assert (pos[:, R] - R < 999).all()


def test_sample_mixed_batch_shapes():
    toks, pos, mask = I.sample_mixed_batch(_gen(2), 6, 64, 10)
    assert toks.shape == pos.shape == mask.shape == (6, 64)
    assert toks.dtype == pos.dtype == torch.int32
    assert mask.dtype == torch.bool


def _copy_structure(toks, pos, mask, lo_src, hi_src, s2_min, seg_max):
    """The masked run continues a segment that occurs verbatim in
    [lo_src, hi_src); returns the (s2, Lw) of every row."""
    out = []
    for b in range(toks.shape[0]):
        nm = int(mask[b].sum())
        assert I.SEG_MIN - 1 <= nm <= seg_max - 1
        lo = int(np.argmax(mask[b]))
        s2, Lw = lo - 1, nm + 1
        assert s2 >= s2_min and s2 + Lw <= toks.shape[1]
        assert mask[b, lo:lo + nm].all()
        seg = toks[b, s2:s2 + Lw]
        assert any((toks[b, s:s + Lw] == seg).all()
                   for s in range(lo_src, hi_src - Lw + 1))
        out.append((s2, Lw))
    return out


@pytest.mark.parametrize("d", [0.0, 0.5, 1.0])
def test_sample_copy_batch_structure(d):
    B, T = 4, 256
    R = T // 2
    toks, pos, mask = _np(*I.sample_copy_batch(_gen(0), B, T, 1000, d))
    assert toks.shape == pos.shape == mask.shape == (B, T)
    rows = _copy_structure(toks, pos, mask, 0, R, R, R)
    for b, (s2, Lw) in enumerate(rows):
        assert (np.diff(pos[b, :R]) == 1).all()
        assert (np.diff(pos[b, R:]) == 1).all()
        assert pos[b, R] >= R
        if d == 0.0:  # the full repeat
            assert (s2, Lw) == (R, R)
            np.testing.assert_array_equal(toks[b, :R], toks[b, R:])
    assert (toks < I.HAY).all()


@pytest.mark.parametrize("d", [0.0, 1.0])
def test_sample_blocks_batch_structure(d):
    B, T = 4, 1024
    H0 = 6 * 128
    toks, pos, mask = _np(*I.sample_blocks_batch(_gen(2), B, T, d))
    rows = _copy_structure(toks, pos, mask, 0, H0, H0, 128)
    for b, (s2, Lw) in enumerate(rows):
        dp = np.diff(pos[b])
        assert (dp >= 1).all()
        jump_at = np.nonzero(dp > 1)[0] + 1
        assert all(j % 128 == 0 and j <= H0 for j in jump_at)
        if d == 0.0:  # the last history block, a whole block, at H0
            assert (s2, Lw) == (H0, 128)
            np.testing.assert_array_equal(toks[b, H0 - 128:H0],
                                          toks[b, H0:H0 + 128])


def test_sample_long_batch_structure():
    B, T, qz = 2, 2048, 256
    toks, pos, mask = _np(*I.sample_long_batch(_gen(3), B, T, qz=qz))
    rows = _copy_structure(toks, pos, mask, 0, T - qz, T - qz, 128)
    for b in range(B):
        assert (np.diff(pos[b, :T - qz]) == 1).all()
        assert (np.diff(pos[b, T - qz:]) == 1).all()
        assert 0 <= pos[b, T - qz] - (T - qz) < 131072
    assert len(rows) == B


def test_tensor_difficulty_gives_the_float_draws():
    for f in (lambda g, d: I.sample_copy_batch(g, 4, 256, 1000, d),
              lambda g, d: I.sample_blocks_batch(g, 4, 1024, d)):
        a = f(_gen(9), 0.37)
        b = f(_gen(9), torch.tensor(0.37))
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# marginals against JAX's draws
# ---------------------------------------------------------------------------


def _stats_close(mine, theirs, what):
    mine, theirs = np.asarray(mine, np.float64), np.asarray(theirs,
                                                            np.float64)
    se = np.sqrt(mine.var() / mine.size + theirs.var() / theirs.size)
    assert abs(mine.mean() - theirs.mean()) <= 6 * se + 1e-9, (
        what, mine.mean(), theirs.mean(), se)


def _copy_stats(toks, pos, mask, R):
    """(mask count, first masked index, jump) per row."""
    return (mask.sum(1), mask.argmax(1), pos[:, R] - R)


N_ROWS = 2048


@pytest.mark.parametrize("d", [0.0, 0.3, 1.0])
def test_sample_copy_batch_marginals_match_jax(d):
    T, MJ = 128, 4096
    R = T // 2
    mine = _copy_stats(*_np(*I.sample_copy_batch(_gen(5), N_ROWS, T, MJ, d)),
                       R)
    theirs = _copy_stats(*_np(*J.sample_copy_batch(
        jax.random.PRNGKey(5), N_ROWS, T, MJ, d)), R)
    for what, a, b in zip(("mask count", "copy start", "jump"), mine,
                          theirs):
        assert a.min() >= 0 and a.max() <= max(b.max(), MJ)
        if b.std() == 0:
            assert (a == b[0]).all(), what
        else:
            _stats_close(a, b, what)
    assert (mine[2] < MJ).all() and mine[2].max() > MJ // 2


def test_sample_blocks_batch_marginals_match_jax():
    T = 1024
    H0 = 768
    mine = _np(*I.sample_blocks_batch(_gen(6), 512, T, 0.6))
    theirs = _np(*J.sample_blocks_batch(jax.random.PRNGKey(6), 512, T, 0.6))
    for (toks, pos, mask), tag in ((mine, "port"), (theirs, "jax")):
        assert (pos[:, -1] - (T - 1) < 6 * 16384).all(), tag
    for what, f in (
            ("mask count", lambda x: x[2].sum(1)),
            ("copy start", lambda x: x[2].argmax(1)),
            ("total jump", lambda x: x[1][:, -1] - (T - 1)),
            ("jumped blocks", lambda x: (np.diff(x[1][:, :H0 + 1], axis=1)
                                         > 1).sum(1))):
        _stats_close(f(mine), f(theirs), what)


def test_sample_batch_and_long_batch_marginals_match_jax():
    T, MJ = 64, 100_000
    region = T - I.QW
    mine = _np(*I.sample_batch(_gen(7), N_ROWS, T, MJ))
    theirs = _np(*J.sample_batch(jax.random.PRNGKey(7), N_ROWS, T, MJ))
    for what, f in (("query key", lambda x: x[0][:, region + 1]),
                    ("value", lambda x: x[0][:, region + 2]),
                    ("jump", lambda x: x[1][:, region] - region),
                    ("needle 0 offset", lambda x: np.argmax(
                        x[0][:, :region // I.N_NEEDLES] == I.QUERY,
                        axis=1))):
        _stats_close(f(mine), f(theirs), what)
    keys = mine[0][:, region + 1]
    assert set(np.unique(keys)) == set(range(I.KEY0, I.KEY0 + I.NKEYS))
    T = 1024
    mine = _np(*I.sample_long_batch(_gen(8), 256, T, qz=256))
    theirs = _np(*J.sample_long_batch(jax.random.PRNGKey(8), 256, T,
                                      qz=256))
    for what, f in (("mask count", lambda x: x[2].sum(1)),
                    ("copy start", lambda x: x[2].argmax(1)),
                    ("jump", lambda x: x[1][:, -1] - (T - 1))):
        _stats_close(f(mine), f(theirs), what)


# ---------------------------------------------------------------------------
# eval prompts: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ctx,depth,seed", [(2048, 0.0, 3), (2048, 0.5, 3),
                                            (4096, 1.0, 11), (300, 0.25, 0)])
def test_prompt_builders_equal_jax(ctx, depth, seed):
    for mine, theirs in ((I.build_retrieval_prompt(ctx, depth, seed),
                          J.build_retrieval_prompt(ctx, depth, seed)),
                         (I.build_copy_prompt(ctx, depth, seed),
                          J.build_copy_prompt(ctx, depth, seed)),
                         (I.build_copy_prompt(ctx, depth, seed, prefix=8,
                                              answer=4),
                          J.build_copy_prompt(ctx, depth, seed, prefix=8,
                                              answer=4))):
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# losses, gradients and a step against JAX
# ---------------------------------------------------------------------------


def _jumped_batch(B=2, T=64, seed=0):
    """A numpy copy batch whose positions jump by 131072 at T/2."""
    toks, pos, mask = _np(*J.sample_copy_batch(jax.random.PRNGKey(seed), B,
                                               T, 8, 0.5))
    R = T // 2
    idx = np.arange(T)
    pos = np.where(idx >= R, idx + 131072, idx).astype(np.int32)
    return toks, np.repeat(pos[None], B, axis=0), mask


def test_rope_at_long_positions_matches_jax():
    p = np.arange(131072, 131072 + 512, dtype=np.int32)[None]
    p = np.concatenate([np.arange(512, dtype=np.int32)[None], p], axis=1)
    jc, js = jrope(jnp.asarray(p), J.IND_CFG)
    tc, ts = rope_cos_sin(torch.as_tensor(p), I.IND_CFG)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-6)


@pytest.fixture(scope="module")
def small():
    jp = jinit(jax.random.PRNGKey(0), J_SMALL, dtype=jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _grad_close(tparams, jgrad, tol=1e-5):
    tg = toymodel._flatten(params_to_numpy(_grads(tparams)))
    jg = toymodel._flatten(jax.tree.map(np.asarray, jgrad))
    assert tg.keys() == jg.keys()
    for k in jg:
        scale = max(float(np.abs(jg[k]).max()), 1e-12)
        assert float(np.abs(tg[k] - jg[k]).max()) <= tol * scale, k


def _grads(tparams):
    """A Llama-shaped view of ``tparams``' gradients."""
    from kvquant_tpu_torch.models.llama import Llama

    g = lambda p: p.grad.detach()  # noqa: E731
    return Llama(tparams.cfg, g(tparams.embed), g(tparams.final_norm),
                 {k: g(v) for k, v in tparams.layers.items()},
                 None if tparams.lm_head is None else g(tparams.lm_head))


def test_masked_loss_and_grad_match_jax_across_a_131072_jump(small):
    jp, tree = small
    toks, pos, mask = _jumped_batch()
    jl, jg = jax.value_and_grad(J.masked_loss)(
        jp, J_SMALL, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(mask))
    tp = trainable(params_from_numpy(tree, SMALL, device="cpu"))
    tl = I.masked_loss(tp, SMALL, torch.as_tensor(toks),
                       torch.as_tensor(pos), torch.as_tensor(mask))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _grad_close(tp, jg)


def _jax_noisy_loss(params, cfg, toks, pos, mask, probes, chunk, remat):
    # kvquant_tpu/utils/induction.py:441-455 with the probes given
    logits, _ = jforward(params, cfg, toks, positions=pos, kv_probes=probes,
                         attn_chunk=chunk, remat=remat)
    logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
    tgt = toks[:, 1:]
    nll = -jnp.take_along_axis(logp, tgt[..., None], -1)[..., 0]
    m = mask[:, 1:].astype(jnp.float32)
    return (nll * m).sum() / jnp.maximum(m.sum(), 1.0)


def test_noisy_loss_and_grad_match_jax_chunked_with_remat(small):
    jp, tree = small
    B, T = 2, 128
    toks, pos, mask = _jumped_batch(B, T, seed=1)
    rng = np.random.default_rng(0)
    shape = (SMALL.n_layers, B, T, SMALL.kv_hidden)
    probes = {n: (rng.standard_normal(shape) * s).astype(np.float32)
              for n, s in (("k", 0.08), ("v", 0.05))}
    jl, jg = jax.value_and_grad(_jax_noisy_loss)(
        jp, J_SMALL, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(mask),
        {k: jnp.asarray(v) for k, v in probes.items()}, 32, True)
    tp = trainable(params_from_numpy(tree, SMALL, device="cpu"))
    tl = I.noisy_loss(tp, SMALL, torch.as_tensor(toks), torch.as_tensor(pos),
                      torch.as_tensor(mask),
                      {k: torch.as_tensor(v) for k, v in probes.items()},
                      chunk=32, remat=True)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _grad_close(tp, jg)
    # the noise moved the loss
    clean = I.masked_loss(tp, SMALL, torch.as_tensor(toks),
                          torch.as_tensor(pos), torch.as_tensor(mask))
    assert float(clean.detach()) != float(tl.detach())


def test_one_stage1_step_matches_jax(small):
    """One stage-1 step in two checks that do not hang on the host's
    rounding: the port's loss and gradients against JAX's (``train_step``
    keeps the gradients of the weights it started from), then the port's
    Adam applied to JAX's own gradients against optax's parameters. Adam's
    first update is lr * g / (|g| + eps): where |g| is near eps (1e-8) an
    ulp of gradient rounding moves the update by percents of the lr, so
    the parameters after the port's own gradients would test the rounding
    of such elements, not the port."""
    jp, tree = small
    toks, pos, mask = _np(*J.sample_mixed_batch(jax.random.PRNGKey(1000), 4,
                                                128, 131072, 0.0))
    opt = optax.adam(1e-3)
    state = opt.init(jp)
    jl, g = jax.value_and_grad(J.masked_loss)(
        jp, J_SMALL, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(mask))
    upd, state = opt.update(g, state)
    jnew = jax.tree.map(np.asarray, optax.apply_updates(jp, upd))
    tp = trainable(params_from_numpy(tree, SMALL, device="cpu"))
    tl = toymodel.train_step(toymodel.adam(tp, 1e-3), I.masked_loss(
        tp, SMALL, torch.as_tensor(toks), torch.as_tensor(pos),
        torch.as_tensor(mask)))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _grad_close(tp, g)

    tp = trainable(params_from_numpy(tree, SMALL, device="cpu"))
    jgrad = params_from_numpy(jax.tree.map(np.asarray, g), SMALL,
                              device="cpu")
    opt_t = toymodel.adam(tp, 1e-3)
    for (name, p), (gname, gp) in zip(tp.named_parameters(),
                                      jgrad.named_parameters()):
        assert name == gname
        p.grad = gp.detach().to(torch.float32).clone()
    opt_t.step()
    a = toymodel._flatten(jnew)
    b = toymodel._flatten(params_to_numpy(tp))
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5, err_msg=k)


def test_kv_stds_are_population_stds(small):
    _, tree = small
    tp = params_from_numpy(tree, SMALL, device="cpu")
    kstd, vstd = I.kv_stds(tp, SMALL)
    toks, pos, _ = I.sample_copy_batch(_gen(0), 4, 512, 1000, 1.0)
    _, aux = jforward(jtoy._unflatten(toymodel._flatten(tree)), J_SMALL,
                      jnp.asarray(toks.numpy()),
                      positions=jnp.asarray(pos.numpy()), capture_kv=True)
    np.testing.assert_allclose(kstd.numpy(), np.asarray(
        aux["k_acts"]).std(axis=(1, 2, 3)), rtol=1e-5)
    np.testing.assert_allclose(vstd.numpy(), np.asarray(
        aux["v_acts"]).std(axis=(1, 2, 3)), rtol=1e-5)


# ---------------------------------------------------------------------------
# the loops and the cached checkpoint
# ---------------------------------------------------------------------------


def test_training_loops_run_both_stages_and_the_finetune():
    lines = []
    params, loss = I.train_induction_model(SMALL, steps=8, batch=4,
                                           seq_len=512, segment=4,
                                           device="cpu", log=lines.append)
    assert np.isfinite(loss)
    assert [ln.split(":")[0].rsplit(" d=", 1)[0] for ln in lines] == [
        "[induction] stage1 step 4", "[induction] stage1 step 8",
        "[induction] stage2 step 4", "[induction] stage2 step 5"]
    assert not any(p.requires_grad for p in params.parameters())
    before = params.embed.clone()
    params = I.finetune_retrieval_robust(params, SMALL, steps=1,
                                         long_T=1024, log=lines.append)
    assert lines[-1].startswith("[induction] robust step 1: long ")
    assert not torch.equal(before, params.embed)
    assert not any(p.requires_grad for p in params.parameters())


def test_cached_induction_model_loads_what_jax_reads(tmp_path):
    path = str(tmp_path / "ind.npz")
    tree = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(3), J.IND_CFG,
                                          dtype=jnp.float32))
    toymodel.save_toy_checkpoint(path, tree, 0.5, 0)
    params, loss = I.cached_induction_model(path, device="cpu")
    jparams, jloss = J.cached_induction_model(path)
    assert loss == jloss == 0.5
    a = toymodel._flatten(params_to_numpy(params))
    b = toymodel._flatten(jax.tree.map(np.asarray, jparams))
    assert all(np.array_equal(a[k], b[k]) for k in b)
