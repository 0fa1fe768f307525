"""The simulated-quantization oracle of the port (quant/nuq.py,
quant/outliers.py, models/llama.py simquant_*, forward(simquant=),
evals/ppl.py) against the JAX package on the same numpy inputs:

  - nearest_values, nf_signposts, dynamic_minmax (medians of odd and even
    counts), quant_zp and quant_lut: equal to JAX's (atol 1e-6: the same
    fp32 operations; division and rounding are exact in both);
  - the outlier masks: static, dynamic (percentiles of even counts),
    capped per token / per head / per-token range, with ties (repeated
    values, +0.0 and -0.0) and a cap above the outlier count, and the sink
    mask: identical;
  - simquant_k / simquant_v over slots / channels x pre / post RoPE x topk /
    percentile V x Q-Norm on and off: atol 1e-6;
  - forward(simquant=) logits and perplexity on a random TINY model:
    within 1e-5 relative (fp32 matmuls sum in other orders).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kvquant_tpu.models import TINY_LLAMA as J_TINY, TINY_GQA as J_GQA
from kvquant_tpu.models import init_params as jinit, forward as jforward
from kvquant_tpu.models import llama as jllama
from kvquant_tpu.evals import perplexity as jperplexity
from kvquant_tpu.quant import nuq as jnuq, outliers as jout
from kvquant_tpu.quant.artifacts import (KQuantizer as JK, VQuantizer as JV,
                                         LayerQuantizers as JLQ,
                                         QuantizerSet as JQS)

from kvquant_tpu_torch.evals import perplexity
from kvquant_tpu_torch.models import TINY_LLAMA, TINY_GQA, params_from_numpy
from kvquant_tpu_torch.models import llama as tllama
from kvquant_tpu_torch.quant import nuq as tnuq, outliers as tout
from kvquant_tpu_torch.quant.artifacts import (KQuantizer, VQuantizer,
                                               LayerQuantizers, QuantizerSet)

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _x(shape, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 2
    if ties:
        # repeated values, and +0.0 / -0.0 side by side in every row
        x[..., 1::4] = x[..., 0::4][..., : x[..., 1::4].shape[-1]]
        x[..., 2] = 0.0
        x[..., 3] = -0.0
    return x


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_codebook_primitives(bits):
    np.testing.assert_array_equal(tnuq.nf_signposts(bits),
                                  jnuq.nf_signposts(bits))
    lut = np.sort(np.random.default_rng(bits).uniform(-1, 1, 2 ** bits)
                  ).astype(np.float32)
    x = _x((64, 40), seed=bits) / 2
    _eq(tnuq.nearest_values(_t(x), _t(lut)),
        jnuq.nearest_values(jnp.asarray(x), jnp.asarray(lut)), atol=0)


@pytest.mark.parametrize("shape,axis", [((31, 12), 0), ((32, 12), 0),
                                        ((6, 33), -1), ((6, 32), -1)],
                         ids=["odd-tokens", "even-tokens", "odd-channels",
                              "even-channels"])
def test_dynamic_minmax_median(shape, axis):
    x = _x(shape, seed=1)
    mask = np.random.default_rng(2).random(shape) < 0.2
    got = tnuq.dynamic_minmax(_t(x), axis, _t(mask))
    want = jnuq.dynamic_minmax(jnp.asarray(x), axis, jnp.asarray(mask))
    for g, w in zip(got, want):
        _eq(g, w, atol=0)
    _eq(tnuq.median(_t(x), axis, keepdim=True),
        jnp.median(jnp.asarray(x), axis=axis, keepdims=True), atol=0)
    for q in (0.005, 0.5, 0.995, 1.0):
        _eq(tnuq.quantile(_t(x), q, axis),
            jnp.quantile(jnp.asarray(x), q, axis=axis), atol=0)


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("clamp", [False, True])
def test_quant_zp(dynamic, clamp):
    x = _x((20, 16), seed=3)
    mask = np.random.default_rng(4).random(x.shape) < 0.1
    lo, hi = x.min(0) * 0.8, x.max(0) * 0.8
    kw = dict(axis=-1 if dynamic else 0, outlier_mask=mask, dynamic=dynamic,
              clamp=clamp)
    if not dynamic:
        kw.update(minval=lo, maxval=hi)
    got = tnuq.quant_zp(_t(x), 3, **{k: _t(v) if isinstance(v, np.ndarray)
                                     else v for k, v in kw.items()})
    want = jnuq.quant_zp(jnp.asarray(x), 3, **{
        k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    _eq(got, want)


@pytest.mark.parametrize("dynamic,norm,sink", [(False, False, 0),
                                               (False, True, 5),
                                               (True, False, 3),
                                               (True, True, 0)])
def test_quant_lut(dynamic, norm, sink):
    x = _x((2, 20, 16), seed=5)
    lut = np.sort(np.random.default_rng(6).uniform(-1, 1, 8)).astype(
        np.float32)
    mask = np.random.default_rng(7).random(x.shape) < 0.1
    kw = dict(axis=-1 if dynamic else 0, outlier_mask=mask, dynamic=dynamic,
              sink=sink, token_axis=-2)
    if not dynamic:
        kw.update(minval=x.min((0, 1)) * 0.9, maxval=x.max((0, 1)) * 0.9)
    if norm:
        kw.update(normscale=np.float32(1.1), normoffset=np.float32(-0.02))
    got = tnuq.quant_lut(_t(x), _t(lut), **{
        k: _t(v) if isinstance(v, (np.ndarray, np.floating)) else v
        for k, v in kw.items()})
    want = jnuq.quant_lut(jnp.asarray(x), jnp.asarray(lut), **{
        k: jnp.asarray(v) if isinstance(v, (np.ndarray, np.floating)) else v
        for k, v in kw.items()})
    _eq(got, want)


@pytest.mark.parametrize("cap", [2, 16], ids=["cap2", "cap-above-count"])
@pytest.mark.parametrize("ties", [False, True], ids=["plain", "ties"])
def test_outlier_masks(cap, ties):
    B, T, H, D = 2, 9, 2, 16
    x = _x((B, T, H * D), seed=8, ties=ties)
    lower = np.full(H * D, -1.5, np.float32)
    upper = np.full(H * D, 1.7, np.float32)
    tx, jx = _t(x), jnp.asarray(x)
    np.testing.assert_array_equal(
        tout.static_outlier_mask(tx, _t(lower), _t(upper), axis=0),
        jout.static_outlier_mask(jx, lower, upper, axis=0))
    for thresh in (0.9, 0.99):  # percentiles of an even count (32)
        np.testing.assert_array_equal(
            tout.dynamic_outlier_mask(tx, thresh, axis=-1),
            jout.dynamic_outlier_mask(jx, thresh, axis=-1))
    np.testing.assert_array_equal(
        tout.capped_outlier_mask_headwise(tx, lower, upper, cap, H),
        jout.capped_outlier_mask_headwise(jx, lower, upper, cap, H))
    mn, mx = x.min(-1, keepdims=True) * 0.6, x.max(-1, keepdims=True) * 0.6
    np.testing.assert_array_equal(
        tout.headwise_range_outlier_mask(tx, _t(mn), _t(mx), cap, H),
        jout.headwise_range_outlier_mask(jx, jnp.asarray(mn),
                                         jnp.asarray(mx), cap, H))
    gm, gr = tout.capped_outlier_mask(tx, lower, upper, cap, axis=0)
    wm, wr = jout.capped_outlier_mask(jx, lower, upper, cap, axis=0)
    np.testing.assert_array_equal(gm, wm)
    _eq(gr, wr)
    for sink in (0, 3):
        np.testing.assert_array_equal(
            tout.apply_sink_mask(gm, sink, token_axis=-2),
            jout.apply_sink_mask(wm, sink, token_axis=-2))


def _quantizers(L, C, bits, qnorm, seed=0):
    """A random QuantizerSet for both packages (numpy arrays)."""
    out = {}
    for side, (K, V, LQ, QS) in (("jax", (JK, JV, JLQ, JQS)),
                                 ("torch", (KQuantizer, VQuantizer,
                                            LayerQuantizers, QuantizerSet))):
        r = np.random.default_rng(seed)
        layers = []
        for _ in range(L):
            u = (np.abs(r.normal(size=C)) + 0.3).astype(np.float32)
            # end entries at +-1: an element at the outlier threshold, whose
            # membership an ulp of matmul rounding may flip, then costs ~0
            # either way (ROADMAP queue 3)
            lut, vlut = (np.sort(np.concatenate([
                [-1.0, 1.0], r.uniform(-1, 1, 2 ** bits - 2)])).astype(
                    np.float32) for _ in range(2))
            ns = (1.1, -0.03) if qnorm else (None, None)
            layers.append(LQ(
                k=K(upper=u, lower=(-u * 0.8).astype(np.float32), lut=lut,
                    normscale=ns[0], normoffset=ns[1],
                    ressc=r.random(C).astype(np.float32)),
                v=V(lut=vlut, normscale=ns[0], normoffset=ns[1])))
        out[side] = QS(layers=layers, bits=bits, sparsity_threshold=0.99,
                       cap_outliers=True, first_few_fp16=5)
    return out


SQ_CASES = {
    "slots-pre-topk": ("slots", False, "topk", False, 2),
    "slots-post-topk-qnorm": ("slots", True, "topk", True, 2),
    "slots-pre-percentile": ("slots", False, "percentile", False, 2),
    "channels-post-topk": ("channels", True, "topk", False, 0),
    "channels-pre-topk-qnorm": ("channels", False, "topk", True, 2),
    "channels-post-percentile": ("channels", True, "percentile", False, 0),
    "slots-pre-topk-uncapped": ("slots", False, "topk", False, 0),
}


@pytest.mark.parametrize("case", list(SQ_CASES))
def test_simquant_k_v(case):
    k_out, post, v_mode, qnorm, cap = SQ_CASES[case]
    Hkv, D = 4, 16
    qs = _quantizers(2, Hkv * D, 3, qnorm)
    kw = dict(v_mode=v_mode, n_kv_heads=Hkv, cap_per_side=cap, head_group=2,
              post_rope_k=post, k_outliers=k_out, n_kc=3)
    jsq = jllama.simquant_from_quantizers(qs["jax"], **kw)
    tsq = tllama.simquant_from_quantizers(qs["torch"], device="cpu", **kw)
    assert tsq.config == tllama.SimQuantConfig(**jsq.config.__dict__)
    x = _x((2, 12, Hkv * D), seed=9)
    for li in range(2):
        ja = jax.tree.map(lambda a: a[li], jsq.arrays)
        ta = tsq.arrays.layer(li)
        _eq(tllama.simquant_k(_t(x), ta, tsq.config),
            jllama.simquant_k(jnp.asarray(x), ja, jsq.config))
        _eq(tllama.simquant_v(_t(x), ta, tsq.config),
            jllama.simquant_v(jnp.asarray(x), ja, jsq.config))


@pytest.mark.parametrize("post", [False, True], ids=["pre", "post"])
@pytest.mark.parametrize("which", ["mha", "gqa"])
def test_forward_and_perplexity_with_simquant(which, post):
    jcfg, tcfg = (J_TINY, TINY_LLAMA) if which == "mha" else (J_GQA, TINY_GQA)
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    qs = _quantizers(jcfg.n_layers, jcfg.kv_hidden, 3, False, seed=1)
    kw = dict(v_mode="topk", n_kv_heads=jcfg.n_kv_heads, head_group=2,
              post_rope_k=post, k_outliers="channels" if post else "slots",
              n_kc=2, cap_per_side=0 if post else 2)
    jsq = jllama.simquant_from_quantizers(qs["jax"], **kw)
    tsq = tllama.simquant_from_quantizers(qs["torch"], device="cpu", **kw)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (3, 24),
                                             dtype=np.int32)
    want, _ = jforward(params, jcfg, jnp.asarray(toks), simquant=jsq)
    got, _ = tllama.forward(tparams, tcfg, torch.as_tensor(toks),
                            simquant=tsq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    for sq_j, sq_t in ((None, None), (jsq, tsq)):
        pw = jperplexity(params, jcfg, jnp.asarray(toks), simquant=sq_j)
        pg = perplexity(tparams, tcfg, toks, simquant=sq_t)
        assert abs(pg / pw - 1) < 1e-5, (pg, pw)
