"""Port of the bit-plane ("nuq") storage and the eager datapath around it
(kvquant_tpu_torch/ops/{packing,deployed}.py) against the JAX package on
the same numpy inputs:

  - pack_codes / unpack_codes / set_token_codes* bitwise, bits 2/3/4, token
    counts and positions that cross 128-token groups;
  - the caches after prefill_pack, decode_attention (kernel="xla") and
    append_token_flash (scalar and per-sample positions) bitwise, for nuq3
    bit planes and for int4 / int8 containers with PRE-RoPE keys, head
    groups 1/2/4, sink 0/5; the xla decode attention within 1e-5;
  - block_attention's xla branch (a first chunk with the sink rows, then a
    later chunk): caches bitwise, outputs within 1e-5.

The sink rows hold roped keys; torch.pow and jnp.power may round the RoPE
frequencies differently in the last ulp, so they compare at rtol 1e-6; the
slot residuals of post-RoPE storage (roped inputs) compare at the word's
value granularity, rtol 2**-13, their indices exactly. The
JAX functions run eagerly (op by op), so neither side fuses a multiply-add.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kvquant_tpu import cache as jcache
from kvquant_tpu.models.config import TINY_LLAMA as J_TINY
from kvquant_tpu.ops import deployed as jdep, packing as jpk

from kvquant_tpu_torch import cache as tcache
from kvquant_tpu_torch.models.config import TINY_LLAMA
from kvquant_tpu_torch.ops import deployed as tdep, packing as tpk

torch.set_num_threads(1)

FIELDS = ("k_planes", "v_planes", "kv_out", "v_scale", "v_offset", "k_sink",
          "v_sink")


def _eq(got, want, name=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=name)


# ---------------------------------------------------------------------------
# bit-plane packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_bit_planes_bitwise(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2 ** bits, (2, 3, 384, 16)).astype(np.int32)
    jp = np.asarray(jpk.pack_codes(jnp.asarray(codes), bits))
    tp = tpk.pack_codes(torch.as_tensor(codes), bits)
    assert tp.dtype == torch.int32
    _eq(tp, jp)
    _eq(tpk.unpack_codes(tp, bits), codes)
    _eq(tpk.unpack_codes(tp, bits), jpk.unpack_codes(jnp.asarray(jp), bits))

    # single-token writes, crossing group boundaries
    L, B, H, D = 2, 2, 3, 16
    planes = rng.integers(-2 ** 31, 2 ** 31, (L, B, H, bits, 12, D),
                          dtype=np.int64).astype(np.int32)
    jl = jnp.asarray(planes)
    tl = torch.as_tensor(planes.copy())
    for i, pos in enumerate((0, 127, 128, 255, 300, 383)):
        c = rng.integers(0, 2 ** bits, (B, H, D)).astype(np.int32)
        li = i % L
        if i % 3 == 0:
            jl = jpk.set_token_codes_at_layer_uniform(
                jl, jnp.asarray(c), li, pos)
            tpk.set_token_codes_at_layer_uniform(tl, torch.as_tensor(c), li,
                                                 pos)
        elif i % 3 == 1:
            b = i % B
            jl = jl.at[:, b].set(jpk.set_token_codes_at_layer(
                jl[:, b], jnp.asarray(c[b]), li, pos))
            tpk.set_token_codes_at_layer(tl[:, b], torch.as_tensor(c[b]), li,
                                         pos)
        else:
            jl = jpk.set_token_codes(jl, jnp.asarray(c), pos,
                                     pred=jnp.bool_(False))
            tpk.set_token_codes(tl, torch.as_tensor(c), pos, pred=False)
            jl = jpk.set_token_codes(jl, jnp.asarray(c), pos)
            tpk.set_token_codes(tl, torch.as_tensor(c), pos)
        _eq(tl, jl, f"pos {pos}")


# ---------------------------------------------------------------------------
# caches and the xla attention
# ---------------------------------------------------------------------------


def _quantizers(codes, bits, seed=0):
    """Random per-channel K ranges and codebooks for TINY_LLAMA widths
    (affine for the integer containers)."""
    rng = np.random.default_rng(seed)
    L, Hkv, D = 2, TINY_LLAMA.n_kv_heads, TINY_LLAMA.d_head
    C = Hkv * D
    up = (np.abs(rng.standard_normal((L, C))) * 2 + 1).astype(np.float32)
    lo = (-up * 0.9).astype(np.float32)
    K = 2 ** bits
    if codes == "nuq":
        kl = np.sort(rng.uniform(-1, 1, (L, K)), axis=1).astype(np.float32)
        vl = np.sort(rng.uniform(-1, 1, (L, K)), axis=1).astype(np.float32)
    else:
        kl = np.stack([np.linspace(-1, 1, K, dtype=np.float32)] * L)
        vl = kl.copy()
    dq = dict(k_range=((up - lo) / 2).reshape(L, Hkv, D),
              k_offset=((up + lo) / 2).reshape(L, Hkv, D), k_lower=lo,
              k_upper=up, k_lut_enc=kl, k_lut_dec=kl * np.float32(1.01),
              v_lut_enc=vl, v_lut_dec=vl,
              k_ressc=rng.random((L, C)).astype(np.float32))
    return (jcache.DeployedQuant(**{k: jnp.asarray(v) for k, v in dq.items()}),
            tcache.DeployedQuant(**{k: torch.as_tensor(v)
                                    for k, v in dq.items()}))


def _compare_caches(tc, jc, td, jd):
    """Layer caches (KVCache) or stacked arrays (dict) bitwise; code
    containers as unsigned codes (torch holds int4 as nibble pairs)."""
    get = (lambda c, f: c[f]) if isinstance(tc, dict) else getattr
    for f in FIELDS:
        got, want = get(tc, f), get(jc, f)
        if f in ("k_planes", "v_planes") and td.codes != "nuq":
            got, want = tdep._stored_codes(got, td), jdep._stored_codes(
                want, jd)
        if f == "k_sink":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7, err_msg=f)
        elif f == "kv_out" and td.post_rope_k:
            # post-RoPE storage quantizes roped keys: a last-ulp difference
            # of a key can move its slot residual across one step of the
            # word's 14-bit mantissa (2**-14 relative)
            gv, gi = tpk.decode_outlier_words(got)
            wv, wi = jpk.decode_outlier_words(want)
            _eq(gi, wi, f)
            np.testing.assert_allclose(gv.numpy(), np.asarray(wv),
                                       rtol=2 ** -13, atol=0, err_msg=f)
        elif f == "kv_out":  # words compare as bit patterns
            _eq(got.numpy().view(np.int32), np.asarray(want).view(np.int32),
                f)
        else:
            _eq(got, want, f)


@pytest.mark.parametrize("sink", [0, 5])
@pytest.mark.parametrize("hg", [1, 2, 4])
@pytest.mark.parametrize("codes,bits", [("nuq", 3), ("int4", 4), ("int8", 8)])
def test_caches_and_xla_decode_match_jax(codes, bits, hg, sink):
    """nuq3 bit planes, and int4 / int8 with PRE-RoPE keys (post_rope_k
    False), slots cap 2: prefill_pack, one decode_attention step at
    per-sample positions and append_token_flash, against JAX."""
    jq, tq = _quantizers(codes, bits)
    kw = dict(bits=bits, n_kv_heads=4, d_head=16, max_len=300, sink=sink,
              head_group=hg, codes=codes, post_rope_k=False,
              k_outliers="slots", cap_per_side=2, dot_bf16=False)
    jd, td = jcache.DeployConfig.create(**kw), tcache.DeployConfig.create(**kw)
    rng = np.random.default_rng(hg * 10 + sink)
    B, T0, C, H = 2, 40, 64, TINY_LLAMA.n_heads
    k = (rng.standard_normal((B, T0, C)) * 1.5).astype(np.float32)
    v = rng.standard_normal((B, T0, C)).astype(np.float32)
    li = 1

    jc = jcache.create_cache(jd, 2, B)
    tc = tcache.create_cache(td, 2, B, device="cpu")
    jl = jdep.prefill_pack(jc.layer(li), jq.layer(li), jd, J_TINY,
                           jnp.asarray(k), jnp.asarray(v))
    tl = tdep.prefill_pack(tc.layer(li), tq.layer(li), td, TINY_LLAMA,
                           torch.as_tensor(k), torch.as_tensor(v))
    _compare_caches(tl, jl, td, jd)

    # one decode step per sample: one past the prompt, one still in the sink
    q = rng.standard_normal((B, H, 16)).astype(np.float32)
    kn = rng.standard_normal((B, C)).astype(np.float32)
    vn = rng.standard_normal((B, C)).astype(np.float32)
    pos = [T0, 3]
    jl, jo = jdep.decode_attention(jl, jq.layer(li), jd, J_TINY,
                                   jnp.asarray(q), jnp.asarray(kn),
                                   jnp.asarray(vn), jnp.asarray(pos))
    tl, to = tdep.decode_attention(tl, tq.layer(li), td, TINY_LLAMA,
                                   torch.as_tensor(q), torch.as_tensor(kn),
                                   torch.as_tensor(vn), pos)
    _compare_caches(tl, jl, td, jd)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)

    # row-level appends into the stacked arrays: uniform and per-sample
    jarrs = {f: getattr(jc, f).at[li].set(getattr(jl, f)) for f in FIELDS}
    tarrs = tc.arrays()
    for p in (T0 + 1, [T0 + 2, 4]):
        jarrs = jdep.append_token_flash(
            jarrs, jq.layer(li), jd, J_TINY, jnp.asarray(kn),
            jnp.asarray(vn), jnp.asarray(p, jnp.int32), jnp.int32(li))
        tdep.append_token_flash(tarrs, tq.layer(li), td, TINY_LLAMA,
                                torch.as_tensor(kn), torch.as_tensor(vn), p,
                                li)
        _compare_caches(tarrs, jarrs, td, jd)


@pytest.mark.parametrize("post", [False, True], ids=["pre", "post"])
def test_block_attention_xla_matches_jax(post):
    """Two chunks of quantized prefill through block_attention's xla branch
    (nuq3, slots cap 2, hg 2, sink 5): the first carries the sink rows."""
    jq, tq = _quantizers("nuq", 3, seed=4)
    kw = dict(bits=3, n_kv_heads=4, d_head=16, max_len=300, sink=5,
              head_group=2, codes="nuq", post_rope_k=post,
              k_outliers="slots", cap_per_side=2, dot_bf16=False)
    jd, td = jcache.DeployConfig.create(**kw), tcache.DeployConfig.create(**kw)
    rng = np.random.default_rng(8)
    B, C, H = 2, 64, TINY_LLAMA.n_heads
    jl = jcache.create_cache(jd, 2, B).layer(0)
    tl = tcache.create_cache(td, 2, B, device="cpu").layer(0)
    for tq_all, pos0, fill in ((133, 5, True), (128, 133, False)):
        q = rng.standard_normal((B, tq_all, H, 16)).astype(np.float32)
        k = (rng.standard_normal((B, tq_all, C)) * 1.5).astype(np.float32)
        v = rng.standard_normal((B, tq_all, C)).astype(np.float32)
        jl, jo = jdep.block_attention(jl, jq.layer(0), jd, J_TINY,
                                      jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), pos0, sink_fill=fill)
        tl, to = tdep.block_attention(tl, tq.layer(0), td, TINY_LLAMA,
                                      torch.as_tensor(q), torch.as_tensor(k),
                                      torch.as_tensor(v), pos0,
                                      sink_fill=fill)
        _compare_caches(tl, jl, td, jd)
        assert tl.length.tolist() == np.asarray(jl.length).tolist()
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                                   rtol=1e-5)
