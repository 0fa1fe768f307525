"""Calibration in the port (quant/calibration.py, quant/kmeans.py,
quant/artifacts.py, data.py, utils/toymodel.BigramLM) against the JAX
package:

  - collect_kv_activations (pre-RoPE and roped keys) on a random TINY model:
    atol 1e-5 (fp32 matmuls in other orders);
  - fit_channel_quantizer in the uniform and NormalFloat modes, per channel
    (capped thresholds, sink tokens, Q-Norm, Fisher weights) and per token,
    on the same activations: thresholds equal (the same fp32 medians and
    quantiles), codebooks equal to 2 ulp (a uniform grid entry may round an
    ulp apart), ressc and the Q-Norm affine within 1e-5 relative (means
    summed in other orders);
  - the Lloyd loop of weighted_kmeans_1d started from JAX's seeded centers
    equals JAX's within 1e-6 (centers and relative inertia);
  - a whole nuq fit (the port's own seeding, 50 Lloyd iterations):
    thresholds equal; each 3-bit codebook within 0.15 of JAX's entry by
    entry (60% of the grid's mean spacing, 0.25) and its inertia on the
    fitted points within 10% of JAX's either way (k-means++ from other
    draws settles in nearby local optima; measured up to 0.13 and 5.3%);
  - artifacts written by either package load in the other, field for field;
  - the data loaders and the bigram language give JAX's windows and samples.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kvquant_tpu import data as jdata
from kvquant_tpu.models import TINY_GQA as J_GQA, init_params as jinit
from kvquant_tpu.quant import artifacts as jart
from kvquant_tpu.quant import calibration as jcal
from kvquant_tpu.quant.kmeans import weighted_kmeans_1d as jkmeans
from kvquant_tpu.utils.toymodel import BigramLM as JBigram

from kvquant_tpu_torch import data as tdata
from kvquant_tpu_torch.models import TINY_GQA, params_from_numpy
from kvquant_tpu_torch.quant import artifacts as tart
from kvquant_tpu_torch.quant import calibration as tcal
from kvquant_tpu_torch.quant import kmeans as tkm
from kvquant_tpu_torch.utils.toymodel import BigramLM

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def acts():
    """TINY_GQA activations of both packages on the same two windows."""
    params = jinit(jax.random.PRNGKey(0), J_GQA, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), TINY_GQA,
                                device="cpu")
    cal = np.random.default_rng(7).integers(0, J_GQA.vocab_size, (2, 48),
                                            dtype=np.int32)
    out = {}
    for rope_k in (False, True):
        jk, jv = jcal.collect_kv_activations(params, J_GQA,
                                             [jnp.asarray(cal)], rope_k=rope_k)
        tk, tv = tcal.collect_kv_activations(tparams, TINY_GQA,
                                             [torch.as_tensor(cal)],
                                             rope_k=rope_k)
        out[rope_k] = (np.array(jk), np.array(jv), tk.numpy(), tv.numpy())
    return out


@pytest.mark.parametrize("rope_k", [False, True], ids=["pre", "roped"])
def test_collect_kv_activations(acts, rope_k):
    jk, jv, tk, tv = acts[rope_k]
    assert tk.shape == jk.shape == (J_GQA.n_layers, 96, J_GQA.kv_hidden)
    np.testing.assert_allclose(tk, jk, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=1e-5)


def _same_fit(got, want):
    for name in ("upper", "lower"):
        np.testing.assert_array_equal(got[name], np.asarray(want[name]),
                                      err_msg=name)
    # NormalFloat tables are equal; a uniform grid entry may sit an ulp
    # apart (XLA's CPU division rounds some of jnp.linspace's steps
    # otherwise than IEEE division)
    np.testing.assert_allclose(got["lut"], np.asarray(want["lut"]), rtol=0,
                               atol=2.5e-7)
    if "ressc" in want:
        np.testing.assert_allclose(got["ressc"], np.asarray(want["ressc"]),
                                   rtol=1e-5, atol=1e-7)
    for name in ("normscale", "normoffset"):
        if want[name] is None:
            assert got[name] is None
        else:
            assert abs(got[name] - want[name]) <= 1e-5 * max(
                1.0, abs(want[name])), (name, got[name], want[name])


FITS = {
    "k-uniform-cap-sink": dict(axis=0, mode="uniform", cap_outliers=True,
                               first_few_fp16=5, sample_seqlen=48),
    "k-nf-qnorm": dict(axis=0, mode="nf", cap_outliers=True, qnorm=True,
                       first_few_fp16=5, sample_seqlen=48),
    "k-uniform-fisher": dict(axis=0, mode="uniform", fisher=True),
    "k-uniform-dense": dict(axis=0, mode="uniform", include_sparse=False),
    "v-uniform-qnorm": dict(axis=1, mode="uniform", qnorm=True,
                            first_few_fp16=5, sample_seqlen=48),
    "v-nf": dict(axis=1, mode="nf"),
}


@pytest.mark.parametrize("bits", [2, 3])
@pytest.mark.parametrize("fit", list(FITS))
def test_fit_channel_quantizer(acts, fit, bits):
    jk, jv, tk, tv = acts[False]
    kw = dict(FITS[fit])
    x = jk[1] if kw["axis"] == 0 else jv[1]
    if kw.pop("fisher", False):
        kw["fisher"] = np.random.default_rng(3).random(x.shape).astype(
            np.float32)
    want = jcal.fit_channel_quantizer(jnp.asarray(x), bits, **{
        k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    got = tcal.fit_channel_quantizer(torch.as_tensor(x), bits, **{
        k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    _same_fit(got, want)


@pytest.mark.parametrize("k", [4, 8, 16])
def test_lloyd_from_jax_seeds(k):
    rng = np.random.default_rng(k)
    x = np.concatenate([rng.standard_normal(3000) * 0.4,
                        rng.uniform(-1, 1, 1000)]).astype(np.float32)
    w = rng.random(x.shape).astype(np.float32)
    w[rng.random(x.shape) < 0.1] = 0.0  # masked points
    seeds, _ = jkmeans(jnp.asarray(x), jnp.asarray(w), k=k, iters=0, seed=0)
    want, wi = jkmeans(jnp.asarray(x), jnp.asarray(w), k=k, iters=12, seed=0)
    got, gi = tkm._lloyd(torch.as_tensor(x), torch.as_tensor(w),
                         torch.as_tensor(np.asarray(seeds)), 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert abs(float(gi) / float(wi) - 1) < 1e-6, (float(gi), float(wi))


def _inertia(points, weights, lut):
    c = np.sort(lut)
    mids = (c[1:] + c[:-1]) * 0.5
    return float(np.sum(weights * (points - c[np.searchsorted(mids, points)])
                        ** 2))


def test_nuq_fit_within_kmeans_tolerance(acts):
    jk, jv, tk, tv = acts[False]
    kw = dict(bits=3, sparsity_threshold=0.99, cap_outliers=True,
              first_few_fp16=5, sample_seqlen=48, kmeans_iters=50)
    want = jcal.fit_quantizers(jnp.asarray(jk), jnp.asarray(jv), **kw)
    got = tcal.fit_quantizers(torch.as_tensor(jk), torch.as_tensor(jv), **kw)
    for li, (g, w) in enumerate(zip(got.layers, want.layers)):
        np.testing.assert_array_equal(g.k.upper, w.k.upper)
        np.testing.assert_array_equal(g.k.lower, w.k.lower)
        for kind, x in (("k", jk[li]), ("v", jv[li])):
            gl, wl = getattr(g, kind).lut, getattr(w, kind).lut
            assert np.abs(gl - wl).max() < 0.15, (li, kind, gl, wl)
            # the fitted points: range-normalized, outliers / sink masked
            q = jcal.fit_channel_quantizer(
                jnp.asarray(x), 3, axis=0 if kind == "k" else 1,
                cap_outliers=kind == "k", first_few_fp16=5, sample_seqlen=48,
                mode="uniform")
            up, lo = q["upper"], q["lower"]
            ax = 0 if kind == "k" else 1
            zp = np.expand_dims((up + lo) * 0.5, ax)
            hr = np.expand_dims((up - lo) * 0.5, ax)
            xn = (x - zp) / hr
            keep = (np.abs(xn) <= 1) & (np.arange(len(x)) % 48 >= 5)[:, None]
            gi = _inertia(xn[keep], np.ones(keep.sum()), gl)
            wi = _inertia(xn[keep], np.ones(keep.sum()), wl)
            assert abs(gi / wi - 1) < 0.1, (li, kind, gi, wi)


def test_artifacts_load_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    C, L = 32, 2

    def qset(mod):
        return mod.QuantizerSet(
            layers=[mod.LayerQuantizers(
                k=mod.KQuantizer(upper=rng.random(C).astype(np.float32),
                                 lower=-rng.random(C).astype(np.float32),
                                 lut=np.linspace(-1, 1, 4, dtype=np.float32),
                                 normscale=1.25 if i else None,
                                 normoffset=-0.5 if i else None,
                                 ressc=rng.random(C).astype(np.float32)),
                v=mod.VQuantizer(lut=np.linspace(-1, 1, 4, dtype=np.float32),
                                 upper=rng.random(3).astype(np.float32),
                                 lower=None))
                for i in range(L)],
            bits=2, sparsity_threshold=0.99, cap_outliers=True,
            first_few_fp16=5, meta={"post_rope_k": True, "model": "toy"})

    for writer, reader in ((tart, jart), (jart, tart)):
        qs = qset(writer)
        path = str(tmp_path / f"{writer.__name__}.npz")
        writer.save_quantizers(path, qs)
        back = reader.load_quantizers(path)
        for attr in ("bits", "sparsity_threshold", "cap_outliers",
                     "first_few_fp16", "meta"):
            assert getattr(back, attr) == getattr(qs, attr), attr
        for a, b in zip(back.layers, qs.layers):
            for kind in ("k", "v"):
                qa, qb = getattr(a, kind), getattr(b, kind)
                for f in qa.__dataclass_fields__:
                    va, vb = getattr(qa, f), getattr(qb, f)
                    if vb is None:
                        assert va is None, (kind, f)
                    else:
                        np.testing.assert_array_equal(va, vb, err_msg=f)


def test_port_fit_artifact_loads_in_jax(acts, tmp_path):
    """A uniform 2-bit fit by the port, written and read back by JAX, equals
    JAX's own fit of the same activations."""
    jk, jv, _, _ = acts[True]
    kw = dict(bits=2, sparsity_threshold=0.99, cap_outliers=True,
              first_few_fp16=5, sample_seqlen=48, mode="uniform",
              meta={"post_rope_k": True})
    path = str(tmp_path / "q.npz")
    tart.save_quantizers(path, tcal.fit_quantizers(torch.as_tensor(jk),
                                                   torch.as_tensor(jv), **kw))
    got = jart.load_quantizers(path)
    want = jcal.fit_quantizers(jnp.asarray(jk), jnp.asarray(jv), **kw)
    assert got.meta == want.meta == {"post_rope_k": True}
    for g, w in zip(got.layers, want.layers):
        for kind in ("k", "v"):
            for f in ("upper", "lower", "lut"):
                np.testing.assert_allclose(getattr(getattr(g, kind), f),
                                           getattr(getattr(w, kind), f),
                                           rtol=0, atol=2.5e-7)
        np.testing.assert_allclose(g.k.ressc, w.k.ressc, rtol=1e-5, atol=1e-7)


def test_data_and_bigram_match_jax():
    np.testing.assert_array_equal(tdata.synthetic_stream(500, 4000, 3),
                                  jdata.synthetic_stream(500, 4000, 3))
    for got, want in zip(tdata.get_loaders("synthetic", nsamples=3,
                                           seqlen=64, vocab_size=300,
                                           eval_tokens=1024),
                         jdata.get_loaders("synthetic", nsamples=3,
                                           seqlen=64, vocab_size=300,
                                           eval_tokens=1024)):
        np.testing.assert_array_equal(got, want)
    lm, jlm = BigramLM(64, seed=2), JBigram(64, seed=2)
    s = lm.sample(3, 20, seed=5)
    assert s.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), np.asarray(jlm.sample(3, 20, 5)))
    assert lm.entropy == jlm.entropy and lm.ideal_ppl == jlm.ideal_ppl
