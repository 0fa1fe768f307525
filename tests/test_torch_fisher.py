"""Fisher information in the port (fisher/fisher.py, cli/fisher.py,
models/llama.forward(kv_probes=, remat=), make_kv_probes, get_forward)
against the JAX package, on TINY_LLAMA and TINY_GQA weights carried across
with params_from_numpy:

  - fisher_info over 2 batches of (2, 32) tokens: with fp32 params within
    rtol 2e-4 / atol 1e-5 * max|jax| of jax.grad's squared gradients
    (observed: worst |diff| / (atol + rtol |jax|) 0.018-0.037); with bf16
    params, closer to JAX's (relative Frobenius) than JAX's own bf16
    Fisher is to its fp32 Fisher (the bound and the observed errors are in
    the test);
  - clm_loss equals JAX's (fp32: rtol 1e-6; bf16: rtol 1e-3), and the
    zero probes leave it unchanged (bitwise with fp32 params; with bf16
    params the fp32 probes promote k / v, as in tests/test_model.py:113-119,
    and the loss moves within rtol 1e-3);
  - remat=True gives the remat=False gradients (layer checkpoints, and the
    chunked attention's per-chunk checkpoints under attn_chunk), within
    1e-6 relative (measured: equal);
  - get_forward returns the Llama forward and refuses other configs;
  - an npz from JAX's fisher_info, fed to the port's cli.calibrate
    --fisher, gives JAX's fit_quantizers result on the same arrays:
    thresholds equal, the weighted Lloyd loop from JAX's seeds equal within
    1e-6, the CLI's own codebooks (other k-means++ draws) within 25% of
    JAX's weighted inertia (the test says why not within the unweighted
    fits' 0.15 per entry / 10%); the
    port's cli.fisher npz loads in JAX's cli.calibrate, which fits exactly
    what JAX's fit_quantizers fits with those arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvquant_tpu.fisher import clm_loss as jclm, fisher_info as jfisher
from kvquant_tpu.models import TINY_GQA as J_GQA, TINY_LLAMA as J_TINY
from kvquant_tpu.models import init_params as jinit
from kvquant_tpu.models import make_kv_probes as jprobes
from kvquant_tpu.quant import calibration as jcal

from kvquant_tpu_torch.fisher import clm_loss, fisher_info
from kvquant_tpu_torch.fisher.fisher import _fisher_step
from kvquant_tpu_torch.models import (TINY_GQA, TINY_LLAMA, ModelConfig,
                                      forward, get_forward, make_kv_probes,
                                      params_from_numpy)

torch.set_num_threads(1)

CFGS = {"mha": (J_TINY, TINY_LLAMA), "gqa": (J_GQA, TINY_GQA)}


def _models(which, bf16):
    jcfg, tcfg = CFGS[which]
    jp = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    if bf16:
        jp = jax.tree_util.tree_map_with_path(
            lambda path, a: a if "ln_" in str(path) or "final_norm" in str(
                path) else a.astype(jnp.bfloat16), jp)
    tp = params_from_numpy(tree, tcfg, device="cpu",
                           dtype=torch.bfloat16 if bf16 else None)
    return (jp, jcfg), (tp, tcfg)


def _batches(vocab, n=2, shape=(2, 32), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, shape, dtype=np.int32) for _ in range(n)]


@pytest.mark.parametrize("which", list(CFGS))
def test_fisher_info_fp32_matches_jax_grad(which):
    (jp, jcfg), (tp, tcfg) = _models(which, bf16=False)
    batches = _batches(jcfg.vocab_size)
    jk, jv = jfisher(jp, jcfg, [jnp.asarray(b) for b in batches])
    tk, tv = fisher_info(tp, tcfg, [torch.as_tensor(b) for b in batches])
    assert tk.shape == (jcfg.n_layers, 2 * 2 * 32, jcfg.kv_hidden)
    assert tk.dtype == tv.dtype == torch.float32
    for got, want in ((tk, jk), (tv, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                                   atol=1e-5 * np.abs(want).max())
        assert (want > 0).mean() > 0.5


@pytest.mark.parametrize("which", list(CFGS))
def test_fisher_info_bf16_matches_jax_grad(which):
    """bf16 squared gradients carry bf16's rounding: JAX's own bf16 Fisher
    lies 1.9-2.7% (relative Frobenius) from its fp32 Fisher here. The port
    must lie closer to JAX's bf16 Fisher than that, and no farther from
    the fp32 Fisher than 1.2x JAX's distance (observed: port vs JAX
    1.5-2.4%, port vs fp32 1.8-2.6%)."""
    (jp, jcfg), (tp, tcfg) = _models(which, bf16=True)
    (jp32, _), _ = _models(which, bf16=False)
    batches = _batches(jcfg.vocab_size)
    jb = [jnp.asarray(b) for b in batches]
    want = jfisher(jp, jcfg, jb)
    exact = jfisher(jp32, jcfg, jb)
    got = fisher_info(tp, tcfg, [torch.as_tensor(b) for b in batches])

    def err(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    for g, w, x in zip(got, want, exact):
        g = g.numpy()
        assert err(g, w) < err(w, x), (err(g, w), err(w, x))
        assert err(g, x) < 1.2 * err(w, x), (err(g, x), err(w, x))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("which", list(CFGS))
def test_clm_loss_and_neutral_probes(which, bf16):
    (jp, jcfg), (tp, tcfg) = _models(which, bf16)
    tokens = _batches(jcfg.vocab_size, n=1, shape=(2, 64), seed=5)[0]
    want = float(jclm(jp, jcfg, jnp.asarray(tokens)))
    want_probed = float(jclm(jp, jcfg, jnp.asarray(tokens),
                             kv_probes=jprobes(jcfg, 2, 64)))
    with torch.no_grad():
        base = float(clm_loss(tp, tcfg, torch.as_tensor(tokens)))
        probed = float(clm_loss(tp, tcfg, torch.as_tensor(tokens),
                                kv_probes=make_kv_probes(tcfg, 2, 64,
                                                         device="cpu")))
    rtol = 1e-3 if bf16 else 1e-6
    np.testing.assert_allclose(base, want, rtol=rtol)
    np.testing.assert_allclose(probed, want_probed, rtol=rtol)
    if bf16:
        np.testing.assert_allclose(probed, base, rtol=1e-3)
    else:
        assert probed == base


def test_make_kv_probes_shape():
    p = make_kv_probes(TINY_GQA, 3, 17, device="cpu")
    assert set(p) == {"k", "v"}
    for t in p.values():
        assert t.shape == (2, 3, 17, TINY_GQA.kv_hidden)
        assert t.dtype == torch.float32 and not t.any()


@pytest.mark.parametrize("which", list(CFGS))
def test_remat_gives_the_same_gradients(which):
    _, (tp, tcfg) = _models(which, bf16=False)
    tokens = torch.as_tensor(_batches(tcfg.vocab_size, n=1)[0])
    fk, fv = _fisher_step(tp, tcfg, tokens)
    rk, rv = _fisher_step(tp, tcfg, tokens, remat=True)
    for a, b in ((rk, fk), (rv, fv)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()))

    # the chunked attention's per-chunk checkpoints (attn_chunk forces it)
    def grads(remat):
        probes = make_kv_probes(tcfg, 2, 32, device="cpu")
        for p in probes.values():
            p.requires_grad_(True)
        logits, _ = forward(tp, tcfg, tokens, kv_probes=probes,
                            attn_chunk=8, remat=remat)
        return torch.autograd.grad(logits.square().mean(),
                                   (probes["k"], probes["v"]))

    for a, b in zip(grads(True), grads(False)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()))


def test_get_forward():
    assert get_forward(TINY_LLAMA) is forward

    @dataclasses.dataclass(frozen=True)
    class OtherConfig(ModelConfig):
        n_experts: int = 4

    with pytest.raises(NotImplementedError, match="item 11"):
        get_forward(OtherConfig())


# ---------------------------------------------------------------------------
# the npz across packages, through the CLIs
# ---------------------------------------------------------------------------

SMALL = ["--toy-layers", "2", "--toy-dmodel", "64", "--toy-heads", "4",
         "--toy-kv-heads", "2", "--toy-vocab", "128", "--dtype", "float32",
         "--nsamples", "2", "--seqlen", "48"]
FIT = dict(bits=3, sparsity_threshold=0.99, cap_outliers=True,
           first_few_fp16=5, sample_seqlen=48, kmeans_iters=50)


def _port_cli_model():
    """The port CLIs' random-init model for SMALL, its calibration windows
    and its activations, as numpy."""
    import argparse

    from kvquant_tpu_torch.cli import common
    from kvquant_tpu_torch.quant.calibration import collect_kv_activations

    ap = argparse.ArgumentParser()
    common.add_model_args(ap)
    common.add_data_args(ap)
    args = ap.parse_args(SMALL + ["--device", "cpu"])
    params, cfg = common.load_model(args)
    train, _ = common.load_data(args, cfg)
    k, v = collect_kv_activations(params, cfg, [torch.as_tensor(train)])
    return params, cfg, train, k.numpy(), v.numpy()


def _inertia(points, weights, lut):
    c = np.sort(lut)
    mids = (c[1:] + c[:-1]) * 0.5
    return float(np.sum(weights * (points - c[np.searchsorted(mids, points)])
                        ** 2))


def test_jax_fisher_npz_in_port_calibrate(tmp_path):
    """The port's k-means draws its k-means++ seeds from a torch generator,
    JAX from jax.random. Under Fisher weights (heavy-tailed: a few tokens
    carry most of the weight) the two seeds settle in optima farther apart
    than the unweighted fits of tests/test_torch_calibration.py: measured
    up to 0.36 per codebook entry and a weighted inertia 0.81-1.15x JAX's.
    So the fit itself is held exactly: the port's Lloyd loop, started from
    JAX's seeds with the npz's weights, gives JAX's codebook within 1e-6
    (measured 0); the CLI's own codebooks must reach a weighted inertia
    within 25% of JAX's either way, and its thresholds equal JAX's."""
    from kvquant_tpu.models.config import ModelConfig as JModelConfig
    from kvquant_tpu.quant.kmeans import weighted_kmeans_1d as jkmeans

    from kvquant_tpu_torch.cli import calibrate
    from kvquant_tpu_torch.quant.kmeans import _lloyd

    params, cfg, train, k, v = _port_cli_model()
    # JAX's fisher_info over the port CLI's weights and windows
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    tree = {"embed": params.embed, "final_norm": params.final_norm,
            "lm_head": params.lm_head, "layers": dict(params.layers)}
    jp = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree)
    fk, fv = jfisher(jp, jcfg, [jnp.asarray(train[i:i + 1])
                                for i in range(len(train))])
    fk, fv = np.array(fk, np.float32), np.array(fv, np.float32)
    path = str(tmp_path / "f.npz")
    np.savez(path, fisher_k=fk, fisher_v=fv, seqlen=np.int32(48))

    got = calibrate.main(SMALL + ["--device", "cpu", "--abits", "3",
                                  "--fisher", path, "--output",
                                  str(tmp_path / "q.npz")])
    want = jcal.fit_quantizers(jnp.asarray(k), jnp.asarray(v), fisher_k=fk,
                               fisher_v=fv, **FIT)
    for li, (g, w) in enumerate(zip(got.layers, want.layers)):
        np.testing.assert_array_equal(g.k.upper, w.k.upper)
        np.testing.assert_array_equal(g.k.lower, w.k.lower)
        for kind, x, f in (("k", k[li], fk[li]), ("v", v[li], fv[li])):
            gl, wl = getattr(g, kind).lut, getattr(w, kind).lut
            # the fitted points: range-normalized, outliers / sink masked
            q = jcal.fit_channel_quantizer(
                jnp.asarray(x), 3, axis=0 if kind == "k" else 1,
                cap_outliers=kind == "k", first_few_fp16=5, sample_seqlen=48,
                mode="uniform")
            ax = 0 if kind == "k" else 1
            zp = np.expand_dims((q["upper"] + q["lower"]) * 0.5, ax)
            hr = np.expand_dims((q["upper"] - q["lower"]) * 0.5, ax)
            xn = (x - zp) / hr
            keep = (np.abs(xn) <= 1) & (np.arange(len(x)) % 48 >= 5)[:, None]
            wts = np.where(keep, f, 0.0).astype(np.float32)
            seeds, _ = jkmeans(jnp.asarray(xn.reshape(-1)),
                               jnp.asarray(wts.reshape(-1)), k=8, iters=0,
                               seed=0)
            lut, _ = _lloyd(torch.as_tensor(xn.reshape(-1)),
                            torch.as_tensor(wts.reshape(-1)),
                            torch.as_tensor(np.array(seeds)), 50)
            np.testing.assert_allclose(lut.numpy(), wl, atol=1e-6)
            gi = _inertia(xn[keep], f[keep], gl)
            wi = _inertia(xn[keep], f[keep], wl)
            assert abs(gi / wi - 1) < 0.25, (li, kind, gi, wi)


def test_port_fisher_npz_in_jax_calibrate(tmp_path, capsys):
    from kvquant_tpu.cli import calibrate as jcalibrate
    from kvquant_tpu.cli import common as jcommon
    from kvquant_tpu.quant.artifacts import load_quantizers as jload

    from kvquant_tpu_torch.cli import fisher as fisher_cli

    path = str(tmp_path / "f.npz")
    fk, fv = fisher_cli.main(SMALL + ["--device", "cpu", "--output", path])
    assert f"saved fisher info (2, 96, 32) -> {path}" in \
        capsys.readouterr().out
    with np.load(path) as z:
        assert sorted(z.files) == ["fisher_k", "fisher_v", "seqlen"]
        assert z["fisher_k"].dtype == z["fisher_v"].dtype == np.float32
        assert z["seqlen"].dtype == np.int32 and int(z["seqlen"]) == 48
        np.testing.assert_array_equal(z["fisher_k"], fk.numpy())
        zk, zv = z["fisher_k"], z["fisher_v"]
    assert np.isfinite(zk).all() and (zk >= 0).all() and zk.any()

    out = str(tmp_path / "q.npz")
    jcalibrate.main(SMALL + ["--abits", "3", "--fisher", path,
                             "--output", out])
    got = jload(out)
    # JAX's own fit with those arrays, on the JAX CLI's model and windows
    import argparse

    ap = argparse.ArgumentParser()
    jcommon.add_model_args(ap)
    jcommon.add_data_args(ap)
    args = ap.parse_args(SMALL)
    jp, jcfg = jcommon.load_model(args)
    train, _ = jcommon.load_data(args, jcfg)
    k, v = jcal.collect_kv_activations(jp, jcfg, [jnp.asarray(train)])
    want = jcal.fit_quantizers(k, v, fisher_k=zk, fisher_v=zv,
                               seed=0, **FIT)
    for g, w in zip(got.layers, want.layers):
        for kind in ("k", "v"):
            np.testing.assert_array_equal(getattr(g, kind).lut,
                                          getattr(w, kind).lut)
