"""Decode steps of 3-8 query rows per kv head, the rows the tensor-core
decode bodies take on the card (fd_gqa for K1 / K5 in
kvquant_tpu_torch/csrc/flash_decode.cu, qk_gqa for K3 in csrc/attention.cu).
On the CPU the wrappers run their plain versions, which the CUDA bodies are
held against on the card; here those plain versions are held against the
JAX package's kernels (interpret mode) on the same numpy inputs, at TINY
widths with two kv heads:

  (a) K1 (``flash_decode.flash_attention``) at Tq = 1 and G 3 / 6 / 7: nuq3
      bit planes with pre-RoPE keys and slot outliers, int4x2 with
      post-RoPE keys and static K channels, sink 5, B = 2 at unequal
      positions (one with a sliding window), both dot modes;
  (b) K5 (``paged_decode.paged_flash_decode``) at the same G over permuted
      pages, against JAX's ``paged_flash_decode`` (int4x2: against JAX's
      contiguous ``flash_attention`` over each slot's live pages, as
      tests/test_torch_paged.py holds it);
  (c) K3 (``attention.qk_fused``) at R 6 against JAX's ``qk_fused``;
  (d) the routing the card takes: ``flash_decode.body`` / ``is_decode`` /
      ``gqa_plan`` / ``gqa_splits`` / ``decode_splits``,
      ``attention.qk_plan`` and ``paged_decode.paged_plan`` at G / R 3-8
      in both dot modes, and the old routes a caller may force for timing.

Tolerances are those of tests/test_torch_flash_decode.py and
tests/test_torch_attention.py: fp32 dots atol = rtol = 1e-5 for K1 / K5
(atol 2e-4, rtol 1e-4 for K3), bf16 dot operands 2e-2 for K1 / K5 (the two
sides round the probabilities at different points) and 1e-2 * max|JAX| for
K3.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kvquant_tpu import paged as jpaged
from kvquant_tpu.cache import (DeployConfig as JDeployConfig,
                               DeployedQuant as JDeployedQuant)
from kvquant_tpu.models.config import ModelConfig as JModelConfig
from kvquant_tpu.ops import packing as jpk
from kvquant_tpu.ops.pallas import qk_fused as jax_qk
from kvquant_tpu.ops.pallas.flash_decode import flash_attention as jax_fa

from kvquant_tpu_torch import paged
from kvquant_tpu_torch.cache import DeployConfig, DeployedQuant
from kvquant_tpu_torch.models.config import ModelConfig
from kvquant_tpu_torch.ops import packing as tpk
from kvquant_tpu_torch.ops.kernels import attention as at
from kvquant_tpu_torch.ops.kernels import common
from kvquant_tpu_torch.ops.kernels import flash_decode as fd
from kvquant_tpu_torch.ops.kernels import paged_decode as pdk

torch.set_num_threads(1)

L, B, Hkv, D, HG = 2, 2, 2, 16, 2
Tc = 512
PAGE, NP, MP = 256, 6, 3
SMS = 132  # H100 SXM
ROWS = [3, 6, 7]
# (codes, bits, post_rope_k, k_outliers)
SCHEMES = {"nuq3-pre-slots": ("nuq", 3, False, "slots"),
           "int4x2-post-channels": ("int4x2", 2, True, "channels")}


def _words(rng, shape):
    """Encoded slot words at random in-group (head, dim) indices."""
    vals = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    idx = (rng.integers(0, HG, shape) << 7) | rng.integers(0, D, shape)
    bits = vals.view(np.uint32)
    return ((bits & np.uint32(0xFFFFFE00)) | idx.astype(np.uint32)).view(
        np.float32)


def _cfgs(scheme, G, dot_bf16, max_len, window=None):
    codes, bits, post, k_out = SCHEMES[scheme]
    kw = dict(bits=bits, n_kv_heads=Hkv, d_head=D, max_len=max_len, sink=5,
              kernel="flash", dot_bf16=dot_bf16, head_group=HG, codes=codes,
              post_rope_k=post, k_outliers=k_out, n_kc=3,
              cap_per_side=0 if k_out == "channels" else 2)
    mk = dict(vocab_size=64, d_model=Hkv * G * D, n_layers=L,
              n_heads=Hkv * G, n_kv_heads=Hkv, d_head=D, d_ff=32,
              max_seq_len=max_len + 64, sliding_window=window)
    return (JDeployConfig.create(**kw), DeployConfig.create(**kw),
            JModelConfig(**mk), ModelConfig(**mk))


def _codes(rng, td, lead, tokens):
    """K and V code arrays (JAX, port) of one scheme: bit planes (random
    words are valid planes) or the head-paired int4x2 container."""
    out = []
    for _ in range(2):
        if td.codes == "nuq":
            a = rng.integers(-2 ** 31, 2 ** 31,
                             (*lead, Hkv, td.bits, tokens // 32, D),
                             dtype=np.int64).astype(np.int32)
            out.append((jnp.asarray(a), torch.as_tensor(a)))
        else:
            c = rng.integers(0, 4, (*lead, tokens, Hkv, D))  # heads at -2
            out.append((jnp.moveaxis(jpk.pair_codes_int4x2(jnp.asarray(c)),
                                     -2, -3),
                        torch.movedim(tpk.pair_codes_int4x2(
                            torch.as_tensor(c)), -2, -3).contiguous()))
    return out


def _kv_out(rng, td, lead, tokens):
    NG, J = Hkv // HG, td.n_slots
    if td.k_outliers == "channels":
        return (rng.standard_normal((*lead, NG, J, tokens)) * 0.1).astype(
            np.float32)
    return _words(rng, (*lead, NG, J, tokens))


def _luts(rng, td):
    K = 2 ** td.bits
    if td.codes == "nuq":
        return [np.sort(rng.uniform(-1, 1, (L, K)), axis=1).astype(np.float32)
                for _ in range(2)]
    return [np.stack([np.linspace(-1, 1, K, dtype=np.float32)] * L),
            np.stack([np.linspace(-0.9, 1.1, K, dtype=np.float32)] * L)]


def _k1(scheme, G, dot_bf16, window=None, seed=0):
    jd, td, jm, tm = _cfgs(scheme, G, dot_bf16, Tc + 5, window)
    rng = np.random.default_rng(seed)
    (jk, tk), (jv, tv) = _codes(rng, td, (L, B), Tc)
    k_lut, v_lut = _luts(rng, td)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    arrays = dict(
        kv_out=_kv_out(rng, td, (L, B), Tc),
        k_range=(rng.random((L, Hkv, D)) + 0.5).astype(np.float32),
        k_offset=f32(L, Hkv, D) * 0.1,
        v_scale=(rng.random((L, B, Tc)) + 0.5).astype(np.float32),
        v_offset=f32(L, B, Tc) * 0.1,
        k_sink=f32(L, B, Hkv, 5, D), v_sink=f32(L, B, Hkv, 5, D),
        k_lut=k_lut, v_lut=v_lut)
    q = f32(B, Hkv, G, D)
    ressc = rng.random((L, Hkv * D)).astype(np.float32)
    pos = np.array([5 + 200, 5 + Tc - 3], np.int32)
    names = list(arrays)
    want = jax_fa(jnp.asarray(q), jk, jv,
                  *(jnp.asarray(arrays[n]) for n in names), jnp.int32(1),
                  jnp.asarray(pos), jd, jm, Tq=1, block_tokens=256,
                  k_ressc=jnp.asarray(ressc))
    got = fd.flash_attention(torch.as_tensor(q), tk, tv,
                             *(torch.as_tensor(arrays[n]) for n in names), 1,
                             torch.as_tensor(pos), td, tm, Tq=1,
                             k_ressc=torch.as_tensor(ressc))
    return np.asarray(want), got.numpy()


def _tol(dot_bf16):
    return 2e-2 if dot_bf16 else 1e-5


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("G", ROWS)
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_k1_rows_match_jax_kernel(scheme, G, dot_bf16):
    want, got = _k1(scheme, G, dot_bf16, seed=G)
    tol = _tol(dot_bf16)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
def test_k1_rows_with_a_window_match_jax_kernel(dot_bf16):
    want, got = _k1("nuq3-pre-slots", 6, dot_bf16, window=64, seed=11)
    tol = _tol(dot_bf16)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _k5(scheme, G, dot_bf16, seed=0):
    jd, td, jm, tm = _cfgs(scheme, G, dot_bf16, MP * PAGE + 5)
    jd = dataclasses.replace(jd, page_tokens=PAGE)
    td = dataclasses.replace(td, page_tokens=PAGE)
    rng = np.random.default_rng(seed)
    (jk, tk), (jv, tv) = _codes(rng, td, (L, NP), PAGE)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    rest = dict(kv_out=_kv_out(rng, td, (L, NP), PAGE),
                v_scale=(rng.random((L, NP, PAGE)) + 0.5).astype(np.float32),
                v_offset=f32(L, NP, PAGE) * 0.1,
                k_sink=f32(L, B, Hkv, 5, D), v_sink=f32(L, B, Hkv, 5, D))
    jpool = jpaged.PagedPool(k_planes=jk, v_planes=jv,
                             **{n: jnp.asarray(a) for n, a in rest.items()})
    tpool = paged.PagedPool(k_planes=tk, v_planes=tv,
                            **{n: torch.as_tensor(a) for n, a in rest.items()})
    k_lut, v_lut = _luts(rng, td)
    C = Hkv * D
    dq = dict(k_range=(rng.random((L, Hkv, D)) + 0.5).astype(np.float32),
              k_offset=f32(L, Hkv, D) * 0.1,
              k_lower=np.zeros((L, C), np.float32),
              k_upper=np.zeros((L, C), np.float32),
              k_lut_enc=k_lut, k_lut_dec=k_lut, v_lut_enc=v_lut,
              v_lut_dec=v_lut, k_ressc=rng.random((L, C)).astype(np.float32))
    jq = JDeployedQuant(**{k: jnp.asarray(v) for k, v in dq.items()})
    tq = DeployedQuant(**{k: torch.as_tensor(v) for k, v in dq.items()})
    # slot 0 inside its first page, slot 1 deep in its third; pages permuted,
    # table entries past the last live page never read
    table = np.array([[4, 10 ** 6, 10 ** 6], [1, 5, 2]], np.int32)
    pos = np.array([5 + 10, 5 + 2 * PAGE + 200], np.int32)
    q = f32(B, Hkv, G, D)
    got = pdk.paged_flash_decode(torch.as_tensor(q), tpool,
                                 torch.as_tensor(table), tq, 1,
                                 torch.as_tensor(pos), td, tm)
    if td.codes != "int4x2":
        want = jpaged.paged_flash_decode(jnp.asarray(q), jpool,
                                         jnp.asarray(table), jq,
                                         jnp.int32(1), jnp.asarray(pos), jd,
                                         jm)
        return np.asarray(want), got.numpy()
    # JAX's paged kernel fails on its head-paired path (its scratch is
    # sized for Q rows, not the 2Q a pair stacks; tests/test_torch_paged.py
    # holds int4x2 the same way): the paged result against JAX's
    # contiguous flash_attention over each slot's live pages in order
    tt = torch.as_tensor(table)
    g = pdk.gather_layer(tpool, pdk.live_pages(tt, torch.as_tensor(pos), td),
                         1, td)
    jint4 = lambda t: jnp.asarray(  # noqa: E731
        tpk.unpack_nibbles(t[None]).numpy(), jnp.int4)
    one = lambda t: jnp.asarray(t[1][None].numpy())  # noqa: E731
    want = jax_fa(jnp.asarray(q), jint4(g["k_planes"]), jint4(g["v_planes"]),
                  jnp.asarray(g["kv_out"][None].numpy()), one(tq.k_range),
                  one(tq.k_offset), jnp.asarray(g["v_scale"][None].numpy()),
                  jnp.asarray(g["v_offset"][None].numpy()), one(tpool.k_sink),
                  one(tpool.v_sink), one(tq.k_lut_dec), one(tq.v_lut_dec),
                  jnp.int32(0), jnp.asarray(pos), jd, jm, block_tokens=PAGE,
                  k_ressc=one(tq.k_ressc))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("G", ROWS)
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_k5_rows_match_jax_kernel(scheme, G, dot_bf16):
    want, got = _k5(scheme, G, dot_bf16, seed=20 + G)
    tol = _tol(dot_bf16)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
def test_k3_six_rows_match_jax_kernel(dot_bf16):
    """qk_fused_ref at R 6 (a DBRX decode step's rows) against JAX's
    qk_fused, nuq3 with pre-RoPE keys and slots cap 2 at head group 2."""
    R, tc = 6, 256
    kw = dict(bits=3, n_kv_heads=Hkv, d_head=D, max_len=tc + 5, sink=5,
              head_group=HG, cap_per_side=2, dot_bf16=dot_bf16,
              kernel="pallas")
    jd, td = JDeployConfig.create(**kw), DeployConfig.create(**kw)
    mk = dict(vocab_size=64, d_model=Hkv * R * D, n_layers=1,
              n_heads=Hkv * R, n_kv_heads=Hkv, d_head=D, d_ff=64,
              max_seq_len=512, rope_scaling=2.0)
    jm, tm = JModelConfig(**mk), ModelConfig(**mk)
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 8, (B, Hkv, tc, D)).astype(np.int32)
    planes = np.stack([np.asarray(jpk.pack_codes(jnp.asarray(c), 3))
                       for c in codes])
    shape = (B, Hkv // HG, td.n_slots, tc)
    vals = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    idx = (rng.integers(0, HG, shape) << 7) | rng.integers(0, D, shape)
    words = np.asarray(jpk.encode_outlier_words(jnp.asarray(vals),
                                                jnp.asarray(idx))).copy()
    words[rng.random(shape) < 0.2] = 0.0  # zero padding
    lut = np.sort(rng.uniform(-1, 1, 8)).astype(np.float32)
    k_range = (rng.random((Hkv, D)) + 0.5).astype(np.float32)
    k_offset = (rng.standard_normal((Hkv, D)) * 0.1).astype(np.float32)
    q = rng.standard_normal((B, Hkv, R, D)).astype(np.float32)
    want = np.stack([np.asarray(jax_qk(
        jnp.asarray(q[b]), jnp.asarray(planes[b]), jnp.asarray(words[b]),
        jnp.asarray(k_range), jnp.asarray(k_offset), jnp.asarray(lut), jd,
        jm)) for b in range(B)])
    got = at.qk_fused(torch.as_tensor(q), torch.as_tensor(planes),
                      torch.as_tensor(words), torch.as_tensor(k_range),
                      torch.as_tensor(k_offset), torch.as_tensor(lut), td,
                      tm).numpy()
    if dot_bf16:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# (d) the routing of 3-8 rows per kv head on the card
# ---------------------------------------------------------------------------

def _dbrx_like(codes="nuq", dot_bf16=True, hg=4, Hkv_=8, D_=128):
    """DBRX's attention at one layer (8 kv heads, D 128): the faithful nuq3
    scheme (pre-RoPE, slots cap 2, head group 4) or int4x2 with 4 static K
    channels."""
    kw = (dict(bits=3, codes="nuq", k_outliers="slots", cap_per_side=2)
          if codes == "nuq" else
          dict(bits=2, codes="int4x2", post_rope_k=True,
               k_outliers="channels", n_kc=4, cap_per_side=0))
    return DeployConfig.create(n_kv_heads=Hkv_, d_head=D_, max_len=32776,
                               sink=5, kernel="flash", head_group=hg,
                               dot_bf16=dot_bf16, **kw)


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 7, 8])
def test_k1_body_by_rows_and_dot_mode(G, dot_bf16):
    """bf16 dots: 1 / 2 rows on fd_decode, 3-8 on fd_gqa (GQA_ROWS); fp32
    dots: 1 / 2 / 4 / 8 on fd_decode, 3 / 5 / 6 / 7 on the SIMT chunk body
    at Tq = 1 (fd_partial)."""
    d = _dbrx_like(dot_bf16=dot_bf16)
    kind = fd.body(d, G, 1)
    if dot_bf16 and G in fd.GQA_ROWS:
        assert kind == "gqa"
    elif G in (1, 2, 4, 8):
        assert kind == "decode"
    else:
        assert kind == "simt"
    assert fd.GQA_ROWS == (3, 4, 5, 6, 7, 8)
    assert fd.is_decode(G, 1, dot_bf16) == (kind in ("decode", "gqa"))
    if kind in ("decode", "gqa"):
        with pytest.raises(ValueError, match="decode step"):
            fd.chunk_plan(d, 128, d.n_slots, G, 1)


@pytest.mark.parametrize("codes", ["nuq", "int4x2"])
@pytest.mark.parametrize("G", [3, 4, 5, 6, 7, 8])
def test_gqa_plan_shape_and_splits(G, codes):
    """fd_gqa's block: decode_plan's heads (whole int4x2 pairs) at one block
    an SM (GQA_BLOCKS_PER_SM), 2-4 ring stages, shared memory within
    DECODE_SMEM_MAX and a block an SM; the splits fill the card once and
    never exceed the capacity's tiles; the bf16 route's plan is this one
    for K1 (run_kernel) and K5 (paged_plan)."""
    d = _dbrx_like(codes)
    J = d.n_slots
    plan = fd.gqa_plan(d, 128, J, G)
    live = fd.kernel_limits(d, 128, J)
    hb, stages, tile = fd.decode_plan(d, 128, J, any(live))
    assert (plan.hb, plan.tile) == (hb, tile)
    assert codes != "int4x2" or plan.hb % 2 == 0
    assert 2 <= plan.stages <= stages <= 4
    assert plan.smem <= fd.DECODE_SMEM_MAX
    assert plan.per_sm == fd.GQA_BLOCKS_PER_SM == 1
    assert (plan.smem + 1024) * plan.per_sm <= fd.SMEM_PER_SM
    assert plan.smem == fd._gqa_smem(d, 128, J, G, any(live), live, plan.hb,
                                     plan.stages)
    for B_, Tc_ in ((1, 34816), (4, 8192), (3, 256)):
        ns = fd.gqa_splits(plan, B_, 8, Tc_, SMS)
        assert 1 <= ns <= Tc_ // plan.tile
        assert ns * (B_ * 8 // plan.hb) <= max(SMS, B_ * 8 // plan.hb)
    p5 = pdk.paged_plan(dataclasses.replace(d, page_tokens=1024), 4, 8, G,
                        128, J, 8192, SMS)
    assert (p5.body, p5.rows, p5.launches) == ("gqa", G, 1)
    assert (p5.hb, p5.stages, p5.tile) == (plan.hb, plan.stages, plan.tile)
    assert p5.n_split == fd.gqa_splits(plan, 4, 8, 8192, SMS)


@pytest.mark.parametrize("G", [3, 5, 6, 7])
def test_fp32_dots_keep_their_routes(G):
    """fp32 dots: K1 at 3-8 rows keeps the SIMT chunk body, K5 pads to the
    fd_decode instance with decode_splits, K3 keeps qk_decode."""
    d = _dbrx_like(dot_bf16=False)
    assert fd.body(d, G, 1) == "simt"
    plan = fd.chunk_plan(d, 128, d.n_slots, G, 1)
    assert plan.body == "simt" and plan.n_rt == 1
    p5 = pdk.paged_plan(dataclasses.replace(d, page_tokens=1024), 4, 8, G,
                        128, d.n_slots, 8192, SMS)
    R = common.decode_rows(G)
    assert (p5.body, p5.rows, p5.launches) == ("decode", R, 1)
    assert p5.n_split == fd.decode_splits(d, 4, 8, R, 128, d.n_slots, True,
                                          0, 8192, SMS)
    dp = dataclasses.replace(d, kernel="pallas")
    q = at.qk_plan(dp, G, 128, 34816, 1, 8, dp.n_slots, SMS)
    assert (q.body, q.rows) == ("decode", R)


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 5, 6, 7, 8])
def test_k3_plan_at_decode_rows(R, dot_bf16):
    """K3 at R rows: qk_gqa with bf16 dots at QK_GQA_ROWS (R rows, the
    decode ring's heads and stages, two blocks an SM), else qk_decode's
    instance; K4 runs pv_gqa at PV_GQA_ROWS with bf16 dots, else
    pv_decode; the shared memory mirrors csrc qk_gqa_smem."""
    d = dataclasses.replace(_dbrx_like(dot_bf16=dot_bf16), kernel="pallas")
    J, Tc_ = d.n_slots, 34816
    plan = at.qk_plan(d, R, 128, Tc_, 1, 8, J, SMS)
    dec = at.qk_plan(d, R, 128, Tc_, 1, 8, J, SMS, "decode")
    assert dec.body == "decode" and dec.rows == common.decode_rows(R)
    if dot_bf16 and R in at.QK_GQA_ROWS:
        assert at.QK_GQA_ROWS == (3, 4, 5, 6, 7, 8)
        assert (plan.body, plan.rows, plan.n_rt) == ("gqa", R, 1)
        assert (plan.hc, plan.stages) == (dec.hc, dec.stages)
        stage = at._stage_bytes(3, 128, plan.hc, 4 * (plan.hc // 4), False)
        assert plan.smem == (128 + plan.stages * stage + 4 * plan.hc * 10
                             * 128 + at.DECODE_WARPS * at.GQA_X_BYTES)
        assert plan.smem <= at.SMEM_MAX and plan.per_sm == 2
    else:
        assert plan == dec
    assert 1 <= plan.n_split <= Tc_ // at.DECODE_TILE
    assert at.pv_plan(d, R, 128, Tc_, 1, 8, J, SMS).body == (
        "gqa" if dot_bf16 and R in at.PV_GQA_ROWS else "decode")


def test_forced_routes_for_timing():
    """The old routes stay reachable by ``body=`` (timing only); a body
    that cannot run the call raises."""
    d, d32 = _dbrx_like(), _dbrx_like(dot_bf16=False)
    assert fd.body(d, 6, 1, "mma") == "mma"
    assert fd.body(d, 8, 1, "decode") == "decode"
    assert fd.body(d32, 6, 1, "simt") == "simt"
    for bad, dc, G in (("decode", d, 6), ("gqa", d32, 6), ("gqa", d, 2),
                       ("mma", d32, 6), ("chunk", d, 6)):
        with pytest.raises(ValueError, match="body"):
            fd.body(dc, G, 1, bad)
    dp = dataclasses.replace(d, kernel="pallas")
    assert at.body(dp, 6, "qk", "decode") == "decode"
    for bad, kernel, R in (("gqa", "pv", 2), ("gqa", "qk", 2),
                           ("decode", "qk", 9)):
        with pytest.raises(ValueError, match="body"):
            at.body(dp, R, kernel, bad)


def test_gqa_launch_counters_are_snapshotted():
    """The launches on the tensor-core decode bodies are counters of their
    own (K1_gqa, K3_gqa, K5_gqa): graphs record and replay them, and
    launch_counts keeps one count per wrapper."""
    from kvquant_tpu_torch.ops import kernels as tk

    snap = tk.snapshot()
    assert {"K1_gqa", "K3_gqa", "K5_gqa"} <= set(snap)
    assert set(tk.launch_counts()) == {"K1", "K2", "K3", "K4", "K5",
                                       "moe_experts"}
    before = fd.flash_attention.gqa_launches
    try:
        _, delta = tk.counted(lambda: setattr(
            fd.flash_attention, "gqa_launches",
            fd.flash_attention.gqa_launches + 2))
        assert delta == {"K1_gqa": 2}
        assert fd.flash_attention.gqa_launches == before
        tk.add_launches(delta)
        assert fd.flash_attention.gqa_launches == before + 2
    finally:
        fd.flash_attention.gqa_launches = before
