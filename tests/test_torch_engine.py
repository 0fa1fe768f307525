"""Port of the deployed engine (kvquant_tpu_torch/engine.py) against the JAX
engine on the same weights, quantizers and tokens, fp32 dots:

  - 30-token decode_step trajectories (sink-only steps, the first live
    block, block crossings) on the speed storage modes: logits within
    atol 3e-4 / rtol 1e-4 for the port's kernel="flash_serial" and its
    eager kernel="xla"; the caches afterwards agree once unpacked (codes
    within one level in at most 0.1% of the elements: fp32 RoPE / matmul
    rounding can move a value across a midpoint);
  - prefill + greedy generate on the committed toy checkpoint: identical
    tokens for 32 steps;
  - deployed_ppl on the toy checkpoint within 1e-3 relative;
  - the reference-faithful scheme (nuq3 bit planes, pre-RoPE K, slot
    outliers) through kernel="flash" (K1): 30-token decode trajectories
    (logits as above), quantized chunked prefill at chunk 128 (k_planes
    bitwise, against JAX and against the port's own xla path; logits
    within the trajectory tolerance of tests/test_flash_decode.py:244-249)
    and, on the toy checkpoint with its committed 3-bit k-means quantizers
    at head_group 4, greedy generate token-identical for 32 steps with
    either prefill and deployed_ppl within 1e-3 relative.

The random-model trajectories fit uniform codebooks (stored as bit planes
and decoded through the LUT like any other). A per-token V range is set by
the token's own extremes, so those elements sit exactly at |x_norm| = 1,
the outlier threshold, and XLA's and torch's matmuls round them apart by
an ulp: a k-means codebook, whose end entries are not +-1, then turns the
flipped membership into a residual of ~0.15 and the trajectories drift
apart (the JAX package's flash-vs-xla tests loosen their tolerance for the
same reason); with end entries at +-1 the residual there is ~0.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kvquant_tpu import engine as jeng
from kvquant_tpu.cache import (DeployConfig as JDeployConfig,
                               create_cache as jcreate,
                               deployed_from_quantizers as jdeployed)
from kvquant_tpu.models import TINY_LLAMA as J_TINY, TINY_GQA as J_GQA
from kvquant_tpu.models import init_params as jinit
from kvquant_tpu.ops.deployed import _stored_codes as jstored
from kvquant_tpu.quant.artifacts import save_quantizers
from kvquant_tpu.quant.calibration import (collect_kv_activations,
                                           fit_quantizers)

from kvquant_tpu_torch import engine
from kvquant_tpu_torch.cache import (DeployConfig, create_cache,
                                     deployed_from_quantizers)
from kvquant_tpu_torch.models import TINY_LLAMA, TINY_GQA, params_from_numpy
from kvquant_tpu_torch.ops.deployed import _stored_codes
from kvquant_tpu_torch.quant.artifacts import load_quantizers
from kvquant_tpu_torch.utils.toymodel import TOY_CFG, load_toy_checkpoint

torch.set_num_threads(1)

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts")
SPEED = dict(k_outliers="channels", n_kc=2, cap_per_side=0)
MODES = {
    "int4x2-speed": ("int4x2", 2, SPEED),
    "int4-speed": ("int4", 4, SPEED),
    "int4-slots": ("int4", 3, dict(k_outliers="slots", cap_per_side=2)),
}


def _cfgs(codes, bits, cfg, kernel, **kw):
    d = dict(bits=bits, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
             max_len=69, sink=5, kernel=kernel, dot_bf16=False, codes=codes,
             head_group=2, post_rope_k=True, **kw)
    return JDeployConfig.create(**d), DeployConfig.create(**d)


def _setup(jcfg, tcfg, bits, tmp_path):
    """Random fp32 model and uniform quantizers fitted by the JAX package,
    handed to the port through numpy and an npz artifact."""
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    cal = jax.random.randint(jax.random.PRNGKey(7), (2, 40), 0,
                             jcfg.vocab_size)
    k_acts, v_acts = collect_kv_activations(params, jcfg, [cal])
    qs = fit_quantizers(k_acts, v_acts, bits=bits, sparsity_threshold=0.99,
                        cap_outliers=True, first_few_fp16=5, sample_seqlen=40,
                        kmeans_iters=10, mode="uniform")
    path = str(tmp_path / "q.npz")
    save_quantizers(path, qs)
    tq = deployed_from_quantizers(load_quantizers(path), tcfg.n_kv_heads,
                                  tcfg.d_head, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    return (params, jdeployed(qs, jcfg.n_kv_heads, jcfg.d_head)), (tparams, tq)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("which", ["mha", "gqa"])
def test_decode_trajectory_matches_jax(which, mode, tmp_path):
    jcfg, tcfg = (J_TINY, TINY_LLAMA) if which == "mha" else (J_GQA, TINY_GQA)
    codes, bits, kw = MODES[mode]
    (jp, jq), (tp, tq) = _setup(jcfg, tcfg, bits, tmp_path)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (1, 30),
                                               dtype=np.int32)
    for kernel in ("flash_serial", "xla"):
        jd, td = _cfgs(codes, bits, jcfg, kernel, **kw)
        jc = jcreate(jd, jcfg.n_layers, 1)
        step = jax.jit(lambda c, tok, pos: jeng.decode_step(
            jp, jcfg, jd, jq, c, tok, pos))
        tc = create_cache(td, tcfg.n_layers, 1, device="cpu")
        jl, tl = [], []
        for t in range(tokens.shape[1]):
            jc, lg = step(jc, jnp.asarray(tokens[:, t]), jnp.int32(t))
            jl.append(np.asarray(lg))
            tc, lg = engine.decode_step(tp, tcfg, td, tq, tc,
                                        torch.as_tensor(tokens[:, t]), t)
            tl.append(lg.numpy())
        np.testing.assert_allclose(np.stack(tl), np.stack(jl), atol=3e-4,
                                   rtol=1e-4, err_msg=kernel)
        for name in ("k_planes", "v_planes"):
            got = _stored_codes(getattr(tc, name), td).numpy()
            want = np.asarray(jstored(getattr(jc, name), jd))
            diff = np.abs(got - want)
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (name, kernel)
        for name in ("v_scale", "v_offset", "k_sink", "v_sink"):
            np.testing.assert_allclose(getattr(tc, name).numpy(),
                                       np.asarray(getattr(jc, name)),
                                       atol=1e-4, rtol=1e-4, err_msg=name)
        assert tc.length.tolist() == np.asarray(jc.length).tolist()


def test_uniform_and_per_sample_append_agree(tmp_path):
    """The batch-wide (int pos) and per-sample (list pos) append branches
    write the same cache and give the same logits."""
    (_, _), (tp, tq) = _setup(J_GQA, TINY_GQA, 4, tmp_path)
    _, td = _cfgs("int4", 4, TINY_GQA, "flash_serial", **SPEED)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, TINY_GQA.vocab_size, (2, 12), dtype=np.int32))
    caches = []
    for as_list in (False, True):
        c = create_cache(td, TINY_GQA.n_layers, 2, device="cpu")
        logits = []
        for t in range(tokens.shape[1]):
            c, lg = engine.decode_step(tp, TINY_GQA, td, tq, c, tokens[:, t],
                                       [t, t] if as_list else t)
            logits.append(lg)
        caches.append((c, torch.stack(logits)))
    (a, la), (b, lb) = caches
    torch.testing.assert_close(la, lb, atol=0, rtol=0)
    for name, arr in a.arrays().items():
        assert torch.equal(arr, getattr(b, name)), name


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The committed toy checkpoint with int4 uniform quantizers fitted by
    the JAX package (speed config: post-RoPE int4, channels, hg 4)."""
    from kvquant_tpu.utils.toymodel import BigramLM, TOY_CFG as J_TOY

    tree, _, seed = load_toy_checkpoint(os.path.join(ART, "toy_model.npz"))
    jp = jax.tree.map(jnp.asarray, tree)
    lm = BigramLM(J_TOY.vocab_size, seed=seed)
    cal = lm.sample(2, 64, seed=20_002)
    k_acts, v_acts = collect_kv_activations(jp, J_TOY, [cal], rope_k=True)
    qs = fit_quantizers(k_acts, v_acts,
                        bits=4, sparsity_threshold=0.99, cap_outliers=True,
                        first_few_fp16=5, sample_seqlen=64, kmeans_iters=10,
                        mode="uniform")
    path = str(tmp_path_factory.mktemp("q") / "q.npz")
    save_quantizers(path, qs)
    d = dict(bits=4, n_kv_heads=4, d_head=32, max_len=69, sink=5,
             head_group=4, codes="int4", kernel="flash_serial",
             post_rope_k=True, k_outliers="channels", n_kc=4, cap_per_side=0,
             dot_bf16=False)
    return dict(
        jax=(jp, J_TOY, JDeployConfig.create(**d),
             jdeployed(qs, 4, 32)),
        torch=(params_from_numpy(tree, TOY_CFG, device="cpu"), TOY_CFG,
               DeployConfig.create(**d),
               deployed_from_quantizers(load_quantizers(path), 4, 32,
                                        device="cpu")),
        lm=lm,
    )


def test_toy_prefill_greedy_generate_matches_jax(toy):
    prompt = np.array(toy["lm"].sample(1, 16, seed=31))
    want, _ = jeng.generate(*toy["jax"], jnp.asarray(prompt),
                            jeng.GenerateConfig(max_new_tokens=32))
    got, cache = engine.generate(*toy["torch"], torch.as_tensor(prompt),
                                 engine.GenerateConfig(max_new_tokens=32),
                                 device="cpu")
    assert got.tolist() == np.asarray(want).tolist()
    assert cache.length.tolist() == [16 + 32]


def test_toy_deployed_ppl_matches_jax(toy):
    toks = np.array(toy["lm"].sample(1, 40, seed=10_001))
    want = jeng.deployed_ppl(*toy["jax"], jnp.asarray(toks))
    got = engine.deployed_ppl(*toy["torch"], torch.as_tensor(toks),
                              device="cpu")
    assert abs(got / want - 1) < 1e-3, (got, want)


def test_temperature_sampling_is_seeded():
    logits = torch.randn((3, 50), generator=torch.Generator().manual_seed(0))
    g = engine.GenerateConfig(max_new_tokens=1, temperature=0.8, top_p=0.9)
    draws = [engine._sample(logits, g, torch.Generator().manual_seed(5))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    greedy = engine._sample(logits, engine.GenerateConfig(max_new_tokens=1))
    assert torch.equal(greedy, logits.argmax(-1).to(torch.int32))


@pytest.mark.parametrize("kernel", ["flash", "pallas"])
def test_unported_kernels_raise(kernel, toy):
    """Under kernel="flash" the head-paired int4x2 path of K1 is not ported
    (NotImplementedError naming ROADMAP), for decode and chunked prefill;
    kernel="pallas" refuses the storage its two-pass kernels do not read
    (here int4 containers with post-RoPE keys and channel outliers), as the
    JAX package asserts."""
    params, cfg, dcfg, dq = toy["torch"]
    d = dataclasses.replace(dcfg, kernel=kernel)
    err, match = AssertionError, "two-pass kernels"
    if kernel == "flash":
        d = dataclasses.replace(d, codes="int4x2", bits=2)
        err, match = NotImplementedError, "ROADMAP"
    with pytest.raises(err, match=match):
        engine.deployed_ppl(params, cfg, d, dq, torch.zeros((1, 8),
                            dtype=torch.int32), device="cpu")
    with pytest.raises(err, match=match):
        engine.generate(params, cfg, d, dq, torch.zeros((1, 8),
                        dtype=torch.int32), engine.GenerateConfig(4),
                        prefill_mode="quantized", device="cpu")


# ---------------------------------------------------------------------------
# the reference-faithful scheme through K1 (kernel="flash")
# ---------------------------------------------------------------------------

FAITHFUL = dict(codes="nuq", post_rope_k=False, k_outliers="slots",
                cap_per_side=2)


def _faithful(jcfg, max_len=69, hg=2):
    d = dict(bits=3, n_kv_heads=jcfg.n_kv_heads, d_head=jcfg.d_head,
             max_len=max_len, sink=5, kernel="flash", dot_bf16=False,
             head_group=hg, **FAITHFUL)
    return JDeployConfig.create(**d), DeployConfig.create(**d)


@pytest.mark.parametrize("which", ["mha", "gqa"])
def test_flash_trajectory_matches_jax(which, tmp_path):
    jcfg, tcfg = (J_TINY, TINY_LLAMA) if which == "mha" else (J_GQA, TINY_GQA)
    (jp, jq), (tp, tq) = _setup(jcfg, tcfg, 3, tmp_path)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (1, 30),
                                               dtype=np.int32)
    jd, td = _faithful(jcfg)
    jc = jcreate(jd, jcfg.n_layers, 1)
    step = jax.jit(lambda c, tok, pos: jeng.decode_step(
        jp, jcfg, jd, jq, c, tok, pos))
    tc = create_cache(td, tcfg.n_layers, 1, device="cpu")
    jl, tl = [], []
    for t in range(tokens.shape[1]):
        jc, lg = step(jc, jnp.asarray(tokens[:, t]), jnp.int32(t))
        jl.append(np.asarray(lg))
        tc, lg = engine.decode_step(tp, tcfg, td, tq, tc,
                                    torch.as_tensor(tokens[:, t]), t)
        tl.append(lg.numpy())
    np.testing.assert_allclose(np.stack(tl), np.stack(jl), atol=3e-4,
                               rtol=1e-4)
    for name in ("k_planes", "v_planes"):
        got = _stored_codes(getattr(tc, name), td).numpy()
        want = np.asarray(jstored(getattr(jc, name), jd))
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
    assert tc.length.tolist() == np.asarray(jc.length).tolist()


def test_prefill_quantized_matches_jax(tmp_path):
    """Chunked prefill at chunk 128 (a first chunk with the sink rows, then
    a later one) through K1, B=2, GQA."""
    (jp, jq), (tp, tq) = _setup(J_GQA, TINY_GQA, 3, tmp_path)
    tokens = np.random.default_rng(11).integers(0, J_GQA.vocab_size, (2, 200),
                                                dtype=np.int32)
    jd, td = _faithful(J_GQA, max_len=300)
    xc, _ = engine.prefill_quantized(
        tp, TINY_GQA, dataclasses.replace(td, kernel="xla"), tq,
        create_cache(td, TINY_GQA.n_layers, 2, device="cpu"),
        torch.as_tensor(tokens), chunk=128)
    jc, jlog = jeng.prefill_quantized(jp, J_GQA, jd, jq,
                                      jcreate(jd, J_GQA.n_layers, 2),
                                      jnp.asarray(tokens), chunk=128)
    tc, tlog = engine.prefill_quantized(
        tp, TINY_GQA, td, tq, create_cache(td, TINY_GQA.n_layers, 2,
                                           device="cpu"),
        torch.as_tensor(tokens), chunk=128)
    np.testing.assert_array_equal(tc.k_planes.numpy(),
                                  np.asarray(jc.k_planes))
    assert torch.equal(tc.k_planes, xc.k_planes)
    assert tc.length.tolist() == np.asarray(jc.length).tolist() == [200, 200]
    diff = np.abs(tlog.numpy() - np.asarray(jlog))
    assert np.quantile(diff, 0.5) < 5e-3 and diff.max() < 0.25, (
        np.quantile(diff, 0.5), diff.max())


@pytest.fixture(scope="module")
def toy_nuq():
    """The committed toy checkpoint with its committed 3-bit quantizers:
    nuq3, pre-RoPE K, slots cap 2, head_group 4, kernel "flash"."""
    from kvquant_tpu.quant.artifacts import load_quantizers as jload
    from kvquant_tpu.utils.toymodel import BigramLM, TOY_CFG as J_TOY

    tree, _, seed = load_toy_checkpoint(os.path.join(ART, "toy_model.npz"))
    path = os.path.join(ART, "toy_quantizers_3bit.npz")
    jd, td = _faithful(J_TOY, hg=4)
    return dict(
        jax=(jax.tree.map(jnp.asarray, tree), J_TOY, jd,
             jdeployed(jload(path), 4, 32)),
        torch=(params_from_numpy(tree, TOY_CFG, device="cpu"), TOY_CFG, td,
               deployed_from_quantizers(load_quantizers(path), 4, 32,
                                        device="cpu")),
        lm=BigramLM(J_TOY.vocab_size, seed=seed),
    )


@pytest.mark.parametrize("prefill_mode", ["fp16", "quantized"])
def test_toy_nuq3_flash_generate_matches_jax(toy_nuq, prefill_mode):
    prompt = np.array(toy_nuq["lm"].sample(1, 16, seed=31))
    want, _ = jeng.generate(*toy_nuq["jax"], jnp.asarray(prompt),
                            jeng.GenerateConfig(max_new_tokens=32),
                            prefill_mode=prefill_mode)
    got, cache = engine.generate(*toy_nuq["torch"], torch.as_tensor(prompt),
                                 engine.GenerateConfig(max_new_tokens=32),
                                 prefill_mode=prefill_mode, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()
    assert cache.length.tolist() == [16 + 32]


def test_toy_nuq3_flash_deployed_ppl_matches_jax(toy_nuq):
    toks = np.array(toy_nuq["lm"].sample(1, 40, seed=10_001))
    want = jeng.deployed_ppl(*toy_nuq["jax"], jnp.asarray(toks))
    got = engine.deployed_ppl(*toy_nuq["torch"], torch.as_tensor(toks),
                              device="cpu")
    assert abs(got / want - 1) < 1e-3, (got, want)


# ---------------------------------------------------------------------------
# the two-pass path (kernel="pallas": K3 qk_fused + K4 pv_fused)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 2])
def test_pallas_decode_attention_matches_jax_xla(bits):
    """decode_attention with kernel="pallas" for 12 steps at B=2 against
    the JAX package's kernel="xla" oracle (tests/test_pallas_kernels.py:
    TestDecodePallasVsXla): NormalFloat codebooks, pre-RoPE K, slots cap 2,
    sink 5, RoPE scaling 2, fp32 dots. Outputs within atol 1e-4 (rtol 1e-3,
    the JAX test's); the caches afterwards bitwise, except the sink keys,
    which hold roped keys (torch.pow and jnp.power may round the RoPE
    frequencies differently in the last ulp: rtol 1e-6)."""
    from kvquant_tpu.cache import DeployedQuant as JDeployedQuant
    from kvquant_tpu.models.config import ModelConfig as JModelConfig
    from kvquant_tpu.ops import deployed as jdep
    from kvquant_tpu.quant.nuq import nf_signposts
    from kvquant_tpu_torch.cache import DeployedQuant
    from kvquant_tpu_torch.models.config import ModelConfig
    from kvquant_tpu_torch.ops import deployed as tdep

    Hkv, Dh, G = 2, 16, 2
    mk = dict(vocab_size=64, d_model=64, n_layers=1, n_heads=Hkv * G,
              n_kv_heads=Hkv, d_head=Dh, d_ff=64, max_seq_len=512,
              rope_scaling=2.0)
    jm, tm = JModelConfig(**mk), ModelConfig(**mk)
    rng = np.random.default_rng(5)
    C = Hkv * Dh
    u = (np.abs(rng.normal(size=C)) * 2 + 1).astype(np.float32)
    lut = np.sort(nf_signposts(bits)).astype(np.float32)
    dq = dict(k_range=(u * 0.95).reshape(Hkv, Dh),
              k_offset=(u * 0.05).reshape(Hkv, Dh), k_lower=-u * 0.9,
              k_upper=u, k_lut_enc=lut, k_lut_dec=lut, v_lut_enc=lut,
              v_lut_dec=lut, k_ressc=np.zeros(C, np.float32))
    jq = JDeployedQuant(**{k: jnp.asarray(v) for k, v in dq.items()})
    tq = DeployedQuant(**{k: torch.as_tensor(v) for k, v in dq.items()})
    kw = dict(bits=bits, n_kv_heads=Hkv, d_head=Dh, max_len=133, sink=5,
              dot_bf16=False)
    jd = JDeployConfig.create(kernel="xla", **kw)
    td = DeployConfig.create(kernel="pallas", **kw)

    Bn, T = 2, 12
    q = rng.normal(size=(Bn, T, Hkv * G, Dh)).astype(np.float32)
    k = (rng.normal(size=(Bn, T, C)) * 2).astype(np.float32)
    v = rng.normal(size=(Bn, T, C)).astype(np.float32)
    jc = jcreate(jd, 1, Bn).layer(0)
    tc = create_cache(td, 1, Bn, device="cpu").layer(0)
    for t in range(T):
        jc, jo = jdep.decode_attention(jc, jq, jd, jm, jnp.asarray(q[:, t]),
                                       jnp.asarray(k[:, t]),
                                       jnp.asarray(v[:, t]), jnp.int32(t))
        tc, to = tdep.decode_attention(tc, tq, td, tm,
                                       torch.as_tensor(q[:, t]),
                                       torch.as_tensor(k[:, t]),
                                       torch.as_tensor(v[:, t]), t)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4,
                                   rtol=1e-3, err_msg=f"step {t}")
    for name in ("k_planes", "v_planes", "v_scale", "v_offset", "v_sink",
                 "length"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)
    np.testing.assert_array_equal(tc.kv_out.numpy().view(np.int32),
                                  np.asarray(jc.kv_out).view(np.int32))
    np.testing.assert_allclose(tc.k_sink.numpy(), np.asarray(jc.k_sink),
                               rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def toy_pallas(toy_nuq):
    """The toy checkpoint and its committed 3-bit quantizers (hg 4) under
    kernel="pallas" on both sides."""
    return {side: (*toy_nuq[side][:2],
                   dataclasses.replace(toy_nuq[side][2], kernel="pallas"),
                   toy_nuq[side][3])
            for side in ("jax", "torch")} | {"lm": toy_nuq["lm"]}


@pytest.mark.parametrize("prefill_mode", ["fp16", "quantized"])
def test_toy_nuq3_pallas_generate_matches_jax(toy_pallas, prefill_mode):
    prompt = np.array(toy_pallas["lm"].sample(1, 16, seed=31))
    want, _ = jeng.generate(*toy_pallas["jax"], jnp.asarray(prompt),
                            jeng.GenerateConfig(max_new_tokens=32),
                            prefill_mode=prefill_mode)
    got, cache = engine.generate(*toy_pallas["torch"],
                                 torch.as_tensor(prompt),
                                 engine.GenerateConfig(max_new_tokens=32),
                                 prefill_mode=prefill_mode, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()
    assert cache.length.tolist() == [16 + 32]


def test_toy_nuq3_pallas_deployed_ppl_matches_jax(toy_pallas):
    toks = np.array(toy_pallas["lm"].sample(1, 40, seed=10_001))
    want = jeng.deployed_ppl(*toy_pallas["jax"], jnp.asarray(toks))
    got = engine.deployed_ppl(*toy_pallas["torch"], torch.as_tensor(toks),
                              device="cpu")
    assert abs(got / want - 1) < 1e-3, (got, want)
