"""The port's MoE family (kvquant_tpu_torch/models/moe.py) against the JAX
package's (kvquant_tpu/models/moe.py) on the same numpy inputs, at TINY_MOE
(dense experts, 4 / 2 heads) and at a G 6 MoE of three layers (12 / 2
heads, sparse dispatch, LayerNorm, DBRX's RoPE theta):

  - ``moe_ffn`` dense and sparse: fp32 within 1e-5 of the output's scale,
    bf16 weights within 2e-2 of it;
  - capacity dispatch at capacity_factor 1 and 2.5 with a router that
    sends every token to one expert, so tokens are dropped: the same
    capacity (2.5 rounds half to even, to 2), the same kept pairs, the
    same output;
  - router ties at the k-th logit pick the lower expert, as jax.lax.top_k
    does (torch.topk promises no order);
  - ``forward`` logits and captured K / V, with and without ``simquant``
    (quantizers fitted by the JAX package): within 1e-5 relative;
  - calibration through ``get_forward``: captured activations within
    1e-5, thresholds equal; perplexity and ``deployed_ppl`` within 1e-3
    relative; Fisher information within rtol 2e-4, remat equal;
  - the fp16-KV baseline: decode logits equal to JAX's (whose MoE decode
    exists); its ``prefill`` runs the MoE forward, where JAX's calls the
    Llama forward and fails (a reference fault, not copied);
  - the K2 / K5 plans at G 3 and 6 (the decode instances take 1/2/4/8
    query rows per kv head): the next instance up, and the padded launch
    equals the plain version at the real rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvquant_tpu import baseline_fp16 as jbase
from kvquant_tpu import engine as jeng
from kvquant_tpu.cache import (DeployConfig as JDeployConfig,
                               deployed_from_quantizers as jdeployed)
from kvquant_tpu.evals import perplexity as jperplexity
from kvquant_tpu.models import moe as jmoe
from kvquant_tpu.models import simquant_from_quantizers as jsimquant
from kvquant_tpu.quant.artifacts import save_quantizers
from kvquant_tpu.quant.calibration import (collect_kv_activations as jcollect,
                                           fit_quantizers as jfit)

from kvquant_tpu_torch import baseline_fp16 as tbase
from kvquant_tpu_torch import engine
from kvquant_tpu_torch.cache import DeployConfig, deployed_from_quantizers
from kvquant_tpu_torch.evals import perplexity
from kvquant_tpu_torch.models import get_forward, moe, simquant_from_quantizers
from kvquant_tpu_torch.quant.artifacts import load_quantizers
from kvquant_tpu_torch.quant.calibration import (collect_kv_activations,
                                                 fit_quantizers)

torch.set_num_threads(1)

G6 = dict(vocab_size=256, d_model=96, n_layers=3, n_heads=12, n_kv_heads=2,
          d_head=8, d_ff=64, max_seq_len=512, n_experts=4, top_k=2,
          ffn_mode="sparse", norm_type="layernorm", rope_theta=500000.0)
MODELS = {"tiny": (jmoe.TINY_MOE, moe.TINY_MOE),
          "g6": (jmoe.MoEConfig(**G6), moe.MoEConfig(**G6))}


def _models(which, dtype=np.float32, seed=0):
    """(JAX params, port params, JAX cfg, port cfg): the JAX init, carried
    across as numpy."""
    jcfg, tcfg = MODELS[which]
    jp = jmoe.init_params(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    tp = moe.params_from_numpy(tree, tcfg, device="cpu")
    return jp, tp, jcfg, tcfg


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]), tp.layer(0))


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def test_get_forward_and_surface():
    assert get_forward(moe.TINY_MOE) is moe.forward
    _, tp, _, cfg = _models("g6")
    assert tp.layer(1)["w_qkv"].shape == (96, (12 + 4) * 8)
    assert tp.layers["w_gate"].shape == (3, 4, 96, 64)
    assert tp.head().shape == (96, 256)
    assert set(tp.layers) == set(moe.LAYER_KEYS)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_moe_ffn_matches_jax(mode, dtype):
    jp, tp, jcfg, tcfg = _models("tiny", seed=3)
    jl, tl = _layer0(jp, tp)
    h = np.random.default_rng(4).standard_normal((2, 16, 64)).astype(
        np.float32)
    jc = dataclasses.replace(jcfg, ffn_mode=mode)
    tc = dataclasses.replace(tcfg, ffn_mode=mode)
    if dtype == "bf16":
        jl = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jl)
        tl = {k: v.to(torch.bfloat16) for k, v in tl.items()}
        want = jmoe.moe_ffn(jnp.asarray(h, jnp.bfloat16), jl, jc)
        got = moe.moe_ffn(torch.as_tensor(h).to(torch.bfloat16), tl, tc)
        assert got.dtype == torch.bfloat16
        _close(got.float(), np.asarray(want.astype(jnp.float32)), 2e-2)
    else:
        want = jmoe.moe_ffn(jnp.asarray(h), jl, jc)
        got = moe.moe_ffn(torch.as_tensor(h), tl, tc)
        _close(got, want, 1e-5)


@pytest.mark.parametrize("cf", [1.0, 2.5])
def test_capacity_drops_match_jax(cf):
    """E 8, top 2, N 32: C = ceil(32 * 2 / 8) * max(1, round(cf)), 8 at
    cf 1 and 16 at cf 2.5. A router column that dominates sends all 32
    tokens to expert 0, so 16-24 of them lose it."""
    jcfg = dataclasses.replace(jmoe.TINY_MOE, n_experts=8, top_k=2,
                               ffn_mode="sparse", capacity_factor=cf)
    tcfg = dataclasses.replace(moe.TINY_MOE, n_experts=8, top_k=2,
                               ffn_mode="sparse", capacity_factor=cf)
    jp = jmoe.init_params(jax.random.PRNGKey(5), jcfg, dtype=jnp.float32)
    tree = jax.tree.map(np.array, jp)
    tree["layers"]["w_router"][0][:, 0] += 0.1
    tp = moe.params_from_numpy(tree, tcfg, device="cpu")
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"])
    tl = tp.layer(0)
    h = np.abs(np.random.default_rng(6).standard_normal((1, 32, 64))
               ).astype(np.float32)
    C = moe.capacity(32, tcfg)
    assert C == {1.0: 8, 2.5: 16}[cf]
    _, w = moe._router_weights(torch.as_tensor(h).reshape(32, 64), tl, tcfg)
    keep = moe.dispatch(w, C)
    assert int((w > 0).sum()) == 64 and int(keep[:, 0].sum()) == C
    assert int(keep.sum()) < 64  # pairs were dropped
    _, jw = jmoe._router_weights(jnp.asarray(h), jl, jcfg)
    np.testing.assert_array_equal(np.asarray(jw).reshape(32, 8) > 0,
                                  w.numpy() > 0)
    _close(moe.moe_ffn(torch.as_tensor(h), tl, tcfg),
           jmoe.moe_ffn(jnp.asarray(h), jl, jcfg), 1e-5)


def test_router_ties_pick_the_lower_expert():
    """Experts 1, 2 and 3 share a router column, so every token's logits
    tie at the k-th place (top 2 of 4 with expert 0's column lower): the
    lower index wins, as in jax.lax.top_k."""
    jp, tp, jcfg, tcfg = _models("tiny", seed=7)
    tree = jax.tree.map(np.array, jp)
    r = tree["layers"]["w_router"][0]
    r[:, 2] = r[:, 3] = r[:, 1]
    r[:, 0] = -r[:, 1]
    tp = moe.params_from_numpy(tree, tcfg, device="cpu")
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"])
    h = np.abs(np.random.default_rng(8).standard_normal((1, 8, 64))
               ).astype(np.float32)
    h[..., :] *= np.sign(h @ r[:, 1])[..., None]  # column 1 scores > 0
    _, w = moe._router_weights(torch.as_tensor(h), tp.layer(0), tcfg)
    _, jw = jmoe._router_weights(jnp.asarray(h), jl, jcfg)
    np.testing.assert_array_equal((w > 0).numpy(), np.asarray(jw) > 0)
    assert (w[0, :, 1:3] > 0).all() and not (w[0, :, 3] > 0).any()
    for mode in ("dense", "sparse"):
        _close(moe.moe_ffn(torch.as_tensor(h), tp.layer(0),
                           dataclasses.replace(tcfg, ffn_mode=mode)),
               jmoe.moe_ffn(jnp.asarray(h), jl,
                            dataclasses.replace(jcfg, ffn_mode=mode)), 1e-5)


@pytest.fixture(scope="module", params=list(MODELS))
def fitted(request, tmp_path_factory):
    """A model of each shape with 3-bit uniform quantizers fitted by the
    JAX package on its own activations (handed to the port as an npz)."""
    jp, tp, jcfg, tcfg = _models(request.param)
    cal = np.random.default_rng(9).integers(0, 256, (2, 48), dtype=np.int32)
    qs = jfit(*jcollect(jp, jcfg, [jnp.asarray(cal)]), bits=3,
              cap_outliers=True, first_few_fp16=5, sample_seqlen=48,
              kmeans_iters=8, mode="uniform")
    path = str(tmp_path_factory.mktemp("q") / "q.npz")
    save_quantizers(path, qs)
    return dict(jax=(jp, jcfg, qs), torch=(tp, tcfg, load_quantizers(path)),
                cal=cal, which=request.param)


def test_forward_and_simquant_match_jax(fitted):
    jp, jcfg, jqs = fitted["jax"]
    tp, tcfg, tqs = fitted["torch"]
    toks = np.random.default_rng(10).integers(0, 256, (2, 40),
                                              dtype=np.int32)
    jl, jaux = jmoe.forward(jp, jcfg, jnp.asarray(toks), capture_kv=True)
    tl, taux = moe.forward(tp, tcfg, torch.as_tensor(toks), capture_kv=True)
    _close(tl, jl, 1e-5)
    for name in ("k_acts", "v_acts"):
        _close(taux[name], jaux[name], 1e-5)
    Hkv = jcfg.n_kv_heads
    jsq = jsimquant(jqs, n_kv_heads=Hkv, head_group=2)
    tsq = simquant_from_quantizers(tqs, n_kv_heads=Hkv, head_group=2,
                                   device="cpu")
    jl, _ = jmoe.forward(jp, jcfg, jnp.asarray(toks), simquant=jsq)
    tl, _ = moe.forward(tp, tcfg, torch.as_tensor(toks), simquant=tsq)
    _close(tl, jl, 1e-5)
    want = jperplexity(jp, jcfg, jnp.asarray(toks[:1]), simquant=jsq)
    got = perplexity(tp, tcfg, toks[:1], simquant=tsq)
    assert abs(got / want - 1) < 1e-5, (got, want)


def test_calibration_and_deployed_ppl_match_jax(fitted):
    jp, jcfg, jqs = fitted["jax"]
    tp, tcfg, _ = fitted["torch"]
    cal = fitted["cal"]
    jk, jv = jcollect(jp, jcfg, [jnp.asarray(cal)])
    tk, tv = collect_kv_activations(tp, tcfg, [cal])
    _close(tk, jk, 1e-5)
    _close(tv, jv, 1e-5)
    tqs = fit_quantizers(tk, tv, bits=3, cap_outliers=True,
                         first_few_fp16=5, sample_seqlen=48, kmeans_iters=8,
                         mode="uniform")
    for a, b in zip(tqs.layers, jqs.layers):
        np.testing.assert_allclose(a.k.upper, b.k.upper, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(a.k.lower, b.k.lower, rtol=1e-5,
                                   atol=1e-6)
    d = dict(bits=3, n_kv_heads=jcfg.n_kv_heads, d_head=jcfg.d_head,
             max_len=40, sink=5, head_group=2, dot_bf16=False)
    toks = np.random.default_rng(11).integers(0, 256, (1, 40),
                                              dtype=np.int32)
    want = jeng.deployed_ppl(jp, jcfg, JDeployConfig.create(**d),
                             jdeployed(jqs, jcfg.n_kv_heads, jcfg.d_head),
                             jnp.asarray(toks))
    got = engine.deployed_ppl(
        tp, tcfg, DeployConfig.create(**d),
        deployed_from_quantizers(fitted["torch"][2], tcfg.n_kv_heads,
                                 tcfg.d_head, device="cpu"),
        torch.as_tensor(toks), device="cpu")
    assert abs(got / want - 1) < 1e-3, (got, want)


@pytest.mark.parametrize("which", list(MODELS))
def test_fisher_info_matches_jax(which):
    """Fisher information through ``get_forward`` (fp32, 2 batches of
    (2, 24)): within rtol 2e-4 (tests/test_torch_fisher.py's bound), with
    and without remat."""
    from kvquant_tpu.fisher import fisher_info as jfisher
    from kvquant_tpu_torch.fisher import fisher_info
    from kvquant_tpu_torch.fisher.fisher import _fisher_step

    jp, tp, jcfg, tcfg = _models(which, seed=14)
    rng = np.random.default_rng(15)
    batches = [rng.integers(0, 256, (2, 24), dtype=np.int32)
               for _ in range(2)]
    jk, jv = jfisher(jp, jcfg, [jnp.asarray(b) for b in batches])
    tk, tv = fisher_info(tp, tcfg, batches)
    for got, want in ((tk, jk), (tv, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                                   atol=1e-5 * np.abs(want).max())
    rk, rv = _fisher_step(tp, tcfg, torch.as_tensor(batches[0]), remat=True)
    torch.testing.assert_close(rk, tk[:, :48].reshape(rk.shape), rtol=1e-6,
                               atol=1e-6 * float(rk.abs().max()))


@pytest.mark.parametrize("which", list(MODELS))
def test_fp16_baseline_matches_jax(which):
    """fp32 weights and cache, B=2: the port's prefill of 12 tokens then 6
    decode steps against JAX's decode_step over all 18 tokens (JAX's
    prefill runs the Llama forward and fails on MoE parameters): logits
    within atol / rtol 1e-4, the caches within 1e-5."""
    jp, tp, jcfg, tcfg = _models(which, seed=12)
    toks = np.random.default_rng(13).integers(0, 256, (2, 18),
                                              dtype=np.int32)
    jc = jbase.create_fp16_cache(jcfg, 20, 2, dtype=jnp.float32)
    with pytest.raises(KeyError):
        jbase.prefill(jp, jcfg, jc, jnp.asarray(toks[:, :12]))
    tc = tbase.create_fp16_cache(tcfg, 20, 2, dtype=torch.float32,
                                 device="cpu")
    tc, tl = tbase.prefill(tp, tcfg, tc, torch.as_tensor(toks[:, :12]))
    for pos in range(18):
        jc, jl = jbase.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, pos]),
                                   pos)
        if pos == 11:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-4, rtol=1e-4)
        if pos >= 12:
            tc, tl = tbase.decode_step(tp, tcfg, tc,
                                       torch.as_tensor(toks[:, pos]), pos)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                       rtol=1e-4, err_msg=f"pos {pos}")
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# K2 / K5 at head ratios without a decode instance
# ---------------------------------------------------------------------------

SMS = 132  # H100 SXM


def _speed(Hkv=8, hg=8):
    return DeployConfig.create(
        bits=4, n_kv_heads=Hkv, d_head=128, max_len=4096 + 5, sink=5,
        kernel="flash_serial", head_group=hg, codes="int4", post_rope_k=True,
        k_outliers="channels", n_kc=16, cap_per_side=0)


@pytest.mark.parametrize("G,rows", [(3, 4), (6, 8), (5, 8), (7, 8), (8, 8)])
@pytest.mark.parametrize("body", ["fs_mma", "fs_partial"])
def test_k2_plans_odd_head_ratios_at_the_padded_instance(G, rows, body):
    """fs_partial plans G at the padded instance of ``rows``; fs_mma plans
    the G rows themselves (one launch, a merge block per row), and its
    padded route, forced for timing, the padded instance."""
    from kvquant_tpu_torch.ops.kernels import common, flash_serial as fs

    d = _speed()
    assert common.decode_rows(G) == rows
    plan = fs.fs_plan(d, 1, 8, G, 128, d.cache_tokens, sms=SMS, body=body)
    padded = fs.fs_plan(d, 1, 8, rows, 128, d.cache_tokens, sms=SMS,
                        body=body)
    if body == "fs_partial":
        assert plan == padded and plan.rows == rows
        return
    assert plan.rows == G
    assert plan.smem == fs.mma_smem_bytes(G, 128, 16, 0, 0)
    forced = fs.fs_plan(d, 1, 8, G, 128, d.cache_tokens, sms=SMS,
                        body=fs.PADDED)
    assert forced == padded and forced.rows == rows
    assert forced.smem == fs.mma_smem_bytes(rows, 128, 16, 0, 0)


@pytest.mark.parametrize("G,rows,launches", [(3, 4, 1), (6, 8, 1),
                                             (12, 8, 2), (16, 8, 2)])
@pytest.mark.parametrize("codes", ["nuq", "int4x2"])
def test_k5_plans_odd_head_ratios_at_the_padded_instance(G, rows, launches,
                                                         codes):
    """With bf16 dots G 3 / 6 run fd_gqa at G rows in one launch and G 12 /
    16 two launches of 8 rows there; with fp32 dots the padded fd_decode
    instance."""
    from kvquant_tpu_torch.ops.kernels import flash_decode as fd
    from kvquant_tpu_torch.ops.kernels import paged_decode as pdk

    kw = (dict(bits=3, codes="nuq", k_outliers="slots", cap_per_side=2)
          if codes == "nuq" else
          dict(bits=2, codes="int4x2", post_rope_k=True,
               k_outliers="channels", n_kc=4, cap_per_side=0))
    n_rows = codes == "nuq" or kw["k_outliers"] == "channels"
    for dot_bf16 in (True, False):
        d = DeployConfig.create(n_kv_heads=8, d_head=128, max_len=8192,
                                sink=5, kernel="flash", head_group=4,
                                dot_bf16=dot_bf16, **kw)
        plan = pdk.paged_plan(d, 4, 8, G, 128, d.n_slots, 8192, SMS)
        R = G if dot_bf16 and G in fd.GQA_ROWS else rows
        kind = "gqa" if dot_bf16 and R in fd.GQA_ROWS else "decode"
        assert (plan.body, plan.rows, plan.launches) == (
            kind, R, 1 if R == G else launches)
        if plan.body == "gqa":
            gp = fd.gqa_plan(d, 128, d.n_slots, plan.rows)
            assert plan.n_split == fd.gqa_splits(gp, 4, 8, 8192, SMS)
            assert (plan.hb, plan.stages) == (gp.hb, gp.stages)
        else:
            assert plan.n_split == fd.decode_splits(
                d, 4, 8, rows, 128, d.n_slots, n_rows,
                d.n_kc if codes != "nuq" else 0, 8192, SMS)
        assert fd.is_decode(plan.rows, 1, dot_bf16)



def test_k2_k5_g0_raises():
    from kvquant_tpu_torch.ops.kernels import flash_serial as fs
    from kvquant_tpu_torch.ops.kernels import paged_decode as pdk

    d = _speed()
    with pytest.raises(ValueError, match="query rows per kv head"):
        fs.fs_plan(d, 1, 8, 0, 128, d.cache_tokens, sms=SMS)
    with pytest.raises(ValueError, match="query rows per kv head"):
        pdk.paged_plan(dataclasses.replace(d, kernel="flash"), 1, 8, 0, 128,
                       d.n_slots, 4096, SMS)


@pytest.mark.parametrize("G", [3, 6, 12])
def test_padded_launch_equals_plain_at_the_real_rows(G):
    """What the card's wrappers do around a launch (``padded_launches``),
    with the plain version standing in for the kernel: the G real rows of
    the padded call equal the plain version at G."""
    from kvquant_tpu_torch.ops.kernels import common, flash_serial as fs
    from kvquant_tpu_torch.models.config import ModelConfig

    Hkv, D, S, Tc = 2, 32, 5, 256
    d = DeployConfig.create(
        bits=4, n_kv_heads=Hkv, d_head=D, max_len=Tc + S, sink=S,
        kernel="flash_serial", head_group=2, codes="int4", post_rope_k=True,
        k_outliers="channels", n_kc=2, cap_per_side=0, dot_bf16=False)
    mcfg = ModelConfig(n_heads=Hkv * G, n_kv_heads=Hkv, d_head=D)
    g = torch.Generator().manual_seed(G)
    L, B = 1, 2
    ops = dict(
        k_planes=torch.randint(0, 256, (L, B, Hkv, Tc, D // 2), generator=g,
                               dtype=torch.uint8),
        v_planes=torch.randint(0, 256, (L, B, Hkv, Tc, D // 2), generator=g,
                               dtype=torch.uint8),
        kv_out=torch.randn((L, B, 1, d.n_slots, Tc), generator=g) * 0.1,
        k_range=torch.rand((L, Hkv, D), generator=g) + 0.5,
        k_offset=torch.randn((L, Hkv, D), generator=g) * 0.1,
        v_scale=torch.rand((L, B, Tc), generator=g) + 0.5,
        v_offset=torch.randn((L, B, Tc), generator=g) * 0.1,
        k_sink=torch.randn((L, B, Hkv, S, D), generator=g),
        v_sink=torch.randn((L, B, Hkv, S, D), generator=g),
        k_lut=torch.linspace(-1, 1, 16).repeat(L, 1),
        v_lut=torch.linspace(-1, 1, 16).repeat(L, 1))
    ressc = torch.rand((L, Hkv * D), generator=g)
    pos = torch.tensor([S + 100, S + 250], dtype=torch.int32)

    def plain(q):
        return fs.flash_serial_decode_ref(q, *ops.values(), 0, pos, d, mcfg,
                                          k_ressc=ressc)

    q = torch.randn((B, Hkv, G, D), generator=g)
    rows = []
    got = common.padded_launches(q, lambda x: rows.append(x.shape[2])
                                 or plain(x))
    assert rows == [common.decode_rows(G)] * (-(-G // common.decode_rows(G)))
    torch.testing.assert_close(got, plain(q), atol=1e-6, rtol=1e-6)
