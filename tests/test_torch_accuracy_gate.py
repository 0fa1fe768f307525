"""The accuracy gate of tests/test_accuracy_gate.py inside the port, on the
committed trained toy checkpoint (artifacts/toy_model.npz) and its committed
quantizers, plus the 2-bit exact-density speed config of
benchmarks/ppl_table.py:259-291 (uniform 2-bit on roped activations,
static-channel K outliers, no V slots, head_group 4, int4x2 through K1):

  - the model learned (ppl near the bigram floor);
  - the nuq4/3/2 envelope of the simulated ppl over fp16 (the JAX gate's
    limits), and the int4x2 speed config's below +1.5 (measured +0.67 on
    the CPU);
  - deployed ppl == simulated ppl of the same scheme within 0.02 in log
    (the reference's --check oracle) for nuq3 hg 4, int4 uniform, Q-Norm
    2-bit and the int4x2 speed config, deployed on the CPU through the
    port's engine (kernel plain versions);
  - every simulated ppl of the port within 1e-4 relative of the JAX
    package's on the same quantizers (fp32 forward in other summation
    orders; measured ~1e-6).

The port fits its own quantizers where the JAX gate fits (calibration.
fit_quantizers); a uniform fit equals JAX's up to an ulp of its grid, a
k-means fit (the Q-Norm case) does not, so that case also scores JAX's fit
through both packages for the 1e-4 comparison.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kvquant_tpu.evals import perplexity as jperplexity
from kvquant_tpu.models import simquant_from_quantizers as jsimquant
from kvquant_tpu.quant import calibration as jcal
from kvquant_tpu.quant.artifacts import (load_quantizers as jload,
                                         save_quantizers as jsave)
from kvquant_tpu.utils.toymodel import TOY_CFG as J_TOY, load_toy_checkpoint

from kvquant_tpu_torch import engine
from kvquant_tpu_torch.cache import DeployConfig, deployed_from_quantizers
from kvquant_tpu_torch.evals import perplexity
from kvquant_tpu_torch.models import simquant_from_quantizers
from kvquant_tpu_torch.quant.artifacts import load_quantizers
from kvquant_tpu_torch.quant.calibration import (collect_kv_activations,
                                                 fit_quantizers)
from kvquant_tpu_torch.utils.toymodel import TOY_CFG, cached_toy_model

torch.set_num_threads(1)

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts")
C = TOY_CFG


@pytest.fixture(scope="module")
def setup():
    params, lm, _ = cached_toy_model(os.path.join(ART, "toy_model.npz"),
                                     device="cpu")
    tree, _, _ = load_toy_checkpoint(os.path.join(ART, "toy_model.npz"))
    return dict(params=params, lm=lm, eval=lm.sample(4, 256, seed=10_001),
                cal=lm.sample(4, 256, seed=20_002), jparams=tree)


def _sim_pair(setup, qs_port, qs_jax, windows, **kw):
    """(port, JAX) simulated ppl of the same scheme."""
    got = perplexity(setup["params"], C, windows, simquant=(
        simquant_from_quantizers(qs_port, v_mode="topk",
                                 n_kv_heads=C.n_kv_heads, device="cpu",
                                 **kw)))
    want = jperplexity(setup["jparams"], J_TOY, jnp.asarray(windows.numpy()),
                       simquant=jsimquant(qs_jax, v_mode="topk",
                                          n_kv_heads=C.n_kv_heads, **kw))
    assert abs(got / want - 1) < 1e-4, (got, want)
    return got


def _deployed(setup, qs, windows, **dkw):
    dcfg = DeployConfig.create(bits=qs.bits, n_kv_heads=C.n_kv_heads,
                               d_head=C.d_head, max_len=261, sink=5,
                               head_group=4, **dkw)
    dq = deployed_from_quantizers(qs, C.n_kv_heads, C.d_head, device="cpu")
    return engine.deployed_ppl(setup["params"], C, dcfg, dq, windows,
                               device="cpu")


def test_model_actually_learned(setup):
    ppl = perplexity(setup["params"], C, setup["eval"])
    want = jperplexity(setup["jparams"], J_TOY,
                       jnp.asarray(setup["eval"].numpy()))
    assert abs(ppl / want - 1) < 1e-4, (ppl, want)
    assert ppl < setup["lm"].ideal_ppl * 1.5, (ppl, setup["lm"].ideal_ppl)


def test_quantized_ppl_envelope(setup):
    fp16 = perplexity(setup["params"], C, setup["eval"])
    deltas = {}
    for bits, limit in ((4, 0.1), (3, 0.2), (2, 0.6)):
        path = os.path.join(ART, f"toy_quantizers_{bits}bit.npz")
        ppl = _sim_pair(setup, load_quantizers(path), jload(path),
                        setup["eval"])
        deltas[bits] = ppl - fp16
        assert -0.05 < ppl - fp16 < limit, (bits, ppl, fp16)
    assert deltas[4] <= deltas[2] + 0.05, deltas


def test_deployed_matches_simulated_oracle(setup):
    path = os.path.join(ART, "toy_quantizers_3bit.npz")
    ev = setup["eval"][:2]
    sim = _sim_pair(setup, load_quantizers(path), jload(path), ev,
                    head_group=4)
    dep = _deployed(setup, load_quantizers(path), ev)
    assert abs(np.log(dep) - np.log(sim)) < 0.02, (dep, sim)


def _fits(setup, rope_k=False, **kw):
    """The port's and the JAX package's fit of the same calibration set."""
    k, v = collect_kv_activations(setup["params"], C, [setup["cal"]],
                                  rope_k=rope_k)
    common = dict(sparsity_threshold=0.99, cap_outliers=True,
                  first_few_fp16=5, sample_seqlen=256, **kw)
    return (fit_quantizers(k, v, **common),
            jcal.fit_quantizers(jnp.asarray(k.numpy()),
                                jnp.asarray(v.numpy()), **common))


def test_int4_uniform_envelope_and_oracle(setup):
    ev = setup["eval"][:2]
    qs, jqs = _fits(setup, bits=4, mode="uniform")
    fp16 = perplexity(setup["params"], C, ev)
    sim = _sim_pair(setup, qs, jqs, ev, head_group=4)
    assert -0.05 < sim - fp16 < 0.1, (sim, fp16)
    dep = _deployed(setup, qs, ev, codes="int4", kernel="flash")
    assert abs(np.log(dep) - np.log(sim)) < 0.02, (dep, sim)


def test_qnorm_envelope_and_oracle(setup, tmp_path):
    ev = setup["eval"][:2]
    qs, jqs = _fits(setup, bits=2, kmeans_iters=10, qnorm=True)
    ns = [lq.k.normscale for lq in qs.layers]
    assert all(s is not None for s in ns)
    assert any(abs(s - 1.0) > 1e-4 for s in ns), ns
    dq = deployed_from_quantizers(qs, C.n_kv_heads, C.d_head, device="cpu")
    assert float((dq.k_lut_enc - dq.k_lut_dec).abs().max()) > 1e-5

    fp16 = perplexity(setup["params"], C, ev)
    sim = perplexity(setup["params"], C, ev, simquant=simquant_from_quantizers(
        qs, v_mode="topk", n_kv_heads=C.n_kv_heads, head_group=4,
        device="cpu"))
    assert -0.05 < sim - fp16 < 4.0, (sim, fp16)
    dep = _deployed(setup, qs, ev, kernel="flash")
    assert abs(np.log(dep) - np.log(sim)) < 0.02, (dep, sim)
    # JAX's own k-means fit, scored by both packages
    path = str(tmp_path / "jax_qnorm.npz")
    jsave(path, jqs)
    _sim_pair(setup, load_quantizers(path), jqs, ev, head_group=4)


def test_int4x2_speed_config_oracle(setup):
    """The 2-bit exact-density speed config: uniform 2-bit fitted on roped
    activations, post-RoPE K, 4 static K channels per head group of 4, no
    V slots, deployed through the int4x2 container and K1."""
    ev = setup["eval"][:2]
    qs, jqs = _fits(setup, rope_k=True, bits=2, mode="uniform")
    qs.meta["post_rope_k"] = jqs.meta["post_rope_k"] = True
    fp16 = perplexity(setup["params"], C, ev)
    sim = _sim_pair(setup, qs, jqs, ev, head_group=4, k_outliers="channels",
                    cap_per_side=0)
    assert -0.05 < sim - fp16 < 1.5, (sim, fp16)
    dep = _deployed(setup, qs, ev, codes="int4x2", post_rope_k=True,
                    k_outliers="channels", kernel="flash", cap_per_side=0)
    assert abs(np.log(dep) - np.log(sim)) < 0.02, (dep, sim)


def test_qnorm_first_difference_pinned(setup, tmp_path):
    """Where test_qnorm_envelope_and_oracle's two scores part: layer 0's
    keys. JAX's Q-Norm fit scores the port's calibration activations, so
    its thresholds are values of the port's own layer-0 keys, which depend
    on the token alone and recur in the eval windows: at window 0, token
    8, channel 71 the port's key equals k_upper (2.344048) and stays an
    inlier, clamped to the codebook's end (1.3803622), while JAX's forward
    computes that key some ulps above (RMSNorm's reduction, XLA's rsqrt
    and the matmul each round in another order) and keeps it as an
    outlier (2.3440487). The quantizers themselves agree: fed the same
    captured activations, the port's and JAX's simulated K / V of layer 0
    are equal elementwise to an ulp, for either package's activations."""
    import jax

    from kvquant_tpu.models import llama as jl
    from kvquant_tpu_torch.models import llama as pl

    ev = setup["eval"][:1]
    _, jqs = _fits(setup, bits=2, kmeans_iters=10, qnorm=True)
    path = str(tmp_path / "jax_qnorm.npz")
    jsave(path, jqs)
    kw = dict(v_mode="topk", n_kv_heads=C.n_kv_heads, head_group=4)
    psq = simquant_from_quantizers(load_quantizers(path), device="cpu", **kw)
    jsq = jsimquant(jqs, **kw)

    _, paux = pl.forward(setup["params"], C, ev, simquant=psq,
                         capture_kv=True)
    _, jaux = jax.jit(lambda p, t, a: jl.forward(
        p, J_TOY, t, simquant=jl.SimQuantParams(arrays=a, config=jsq.config),
        capture_kv=True))(setup["jparams"], jnp.asarray(ev.numpy()),
                          jsq.arrays)
    pk, pv = (paux[k][0].numpy() for k in ("k_acts", "v_acts"))
    jk, jv = (np.asarray(jaux[k][0]) for k in ("k_acts", "v_acts"))
    # the activations entering layer 0's quantizers: a few ulps apart
    np.testing.assert_allclose(pk, jk, rtol=0, atol=1e-5)
    upper = psq.arrays.layer(0).k_upper.numpy()
    assert abs(pk[0, 8, 71] - upper[71]) <= 4e-7 * abs(upper[71])

    parr = psq.arrays.layer(0)
    jarr = jax.tree.map(lambda a: a[0], jsq.arrays)
    jk_fn = jax.jit(lambda x, a: jl.simquant_k(x, a, jsq.config))
    jv_fn = jax.jit(lambda x, a: jl.simquant_v(x, a, jsq.config))
    for k_in, v_in in ((pk, pv), (jk, jv)):
        got_k = pl.simquant_k(torch.tensor(k_in), parr, psq.config).numpy()
        got_v = pl.simquant_v(torch.tensor(v_in), parr, psq.config).numpy()
        np.testing.assert_allclose(got_k, np.asarray(jk_fn(k_in, jarr)),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_v, np.asarray(jv_fn(v_in, jarr)),
                                   rtol=0, atol=1e-6)
