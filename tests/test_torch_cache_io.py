"""The port's cache checkpointing and reset (cache_io.py, cache.reset_cache)
and its packing against the JAX package, on TINY_GQA weights and
quantizers fitted by JAX (uniform codebooks), for every storage mode
(nuq3 bit planes, int4, int8, int4x2 2-bit):

  - a cache the port prefilled, written by the port, loads in JAX's
    load_cache equal to JAX's own prefill of the same tokens (int4x2 by
    value: JAX returns those codes as int8, the reference fault at
    kvquant_tpu/cache_io.py:46-48 that the port does not copy), and a
    JAX-written file loads in the port equal to the port's cache, nibble
    containers included: codes and lengths exactly, fp32 values within
    2.5e-4 relative and slot indices exactly where a slot holds a residual
    (the two prefills' fp32 matmuls round apart by ulps; measured up to
    one ulp of a 14-bit slot word);
  - a cache that crosses to the other package and back is bit for bit
    the one that left;
  - a decode_step from a restored cache gives logits identical to one
    from the original, in the port (its own file and JAX's) and in JAX
    (its cache carried through the port; not for int4x2, whose JAX
    restore is the fault above); the mirror of tests/test_aux.py:76-157;
  - reset_cache zeroes every array in place, length included, keeping
    shapes and dtypes, as JAX's reset_cache;
  - the port's bit-plane packing and outlier words equal the host C++
    packer kvquant_tpu.native bit for bit (tests/test_native.py:14-47).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvquant_tpu import cache_io as jio
from kvquant_tpu import engine as jeng
from kvquant_tpu import native
from kvquant_tpu.cache import (DeployConfig as JDeployConfig,
                               create_cache as jcreate,
                               deployed_from_quantizers as jdeployed,
                               reset_cache as jreset)
from kvquant_tpu.models import TINY_GQA as J_GQA, init_params as jinit
from kvquant_tpu.quant.artifacts import save_quantizers
from kvquant_tpu.quant.calibration import (collect_kv_activations,
                                           fit_quantizers)

from kvquant_tpu_torch import cache_io, engine
from kvquant_tpu_torch.cache import (DeployConfig, KVCache, create_cache,
                                     deployed_from_quantizers, reset_cache)
from kvquant_tpu_torch.models import TINY_GQA, params_from_numpy
from kvquant_tpu_torch.ops import packing
from kvquant_tpu_torch.quant.artifacts import load_quantizers

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(KVCache)]
MODES = {
    "nuq": dict(bits=3, codes="nuq", k_outliers="slots", cap_per_side=2),
    "int4": dict(bits=4, codes="int4", k_outliers="slots", cap_per_side=2),
    "int8": dict(bits=4, codes="int8", k_outliers="slots", cap_per_side=2),
    "int4x2": dict(bits=2, codes="int4x2", k_outliers="channels", n_kc=2,
                   cap_per_side=0, post_rope_k=True),
}


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    params = jinit(jax.random.PRNGKey(0), J_GQA, dtype=jnp.float32)
    cal = jax.random.randint(jax.random.PRNGKey(7), (2, 40), 0,
                             J_GQA.vocab_size)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), TINY_GQA,
                                device="cpu")
    qsets = {}
    for bits in (2, 3, 4):
        for post in (False, True):
            k, v = collect_kv_activations(params, J_GQA, [cal], rope_k=post)
            qs = fit_quantizers(k, v, bits=bits, sparsity_threshold=0.99,
                                cap_outliers=True, first_few_fp16=5,
                                sample_seqlen=40, mode="uniform")
            path = str(tmp_path_factory.mktemp("q") / "q.npz")
            save_quantizers(path, qs)
            qsets[bits, post] = (
                jdeployed(qs, J_GQA.n_kv_heads, J_GQA.d_head),
                deployed_from_quantizers(load_quantizers(path),
                                         TINY_GQA.n_kv_heads,
                                         TINY_GQA.d_head, device="cpu"))
    return params, tparams, qsets


def _prefilled(model, mode):
    """(JAX cache, JAX dcfg, JAX quant), (port cache, dcfg, quant) after a
    prefill of the same 2 x 20 tokens."""
    params, tparams, qsets = model
    kw = dict(MODES[mode])
    jq, tq = qsets[kw["bits"], kw.get("post_rope_k", False)]
    d = dict(n_kv_heads=J_GQA.n_kv_heads, d_head=J_GQA.d_head, max_len=37,
             sink=5, head_group=2, kernel="xla", dot_bf16=False, **kw)
    jd, td = JDeployConfig.create(**d), DeployConfig.create(**d)
    tokens = np.random.default_rng(3).integers(0, J_GQA.vocab_size, (2, 20),
                                               dtype=np.int32)
    jc, _ = jeng.prefill(params, J_GQA, jd, jq,
                         jcreate(jd, J_GQA.n_layers, 2), jnp.asarray(tokens))
    tc, _ = engine.prefill(tparams, TINY_GQA, td, tq,
                           create_cache(td, TINY_GQA.n_layers, 2,
                                        device="cpu"),
                           torch.as_tensor(tokens))
    return (jc, jd, jq), (tc, td, tq), tokens


def _jax_view(name, a, dcfg):
    """A port array as the JAX package holds it (nibbles unpacked)."""
    if name in ("k_planes", "v_planes") and dcfg.codes in ("int4", "int4x2"):
        a = packing.unpack_nibbles(a)
    return a.numpy()


def _same_cache(got, want, dcfg):
    """Two packages' caches of the same tokens, as numpy by field: codes
    and lengths equal; fp32 values within 2.5e-4 relative (the prefill's
    fp32 matmuls round apart by ulps; an encoded slot word keeps 14
    mantissa bits); slot indices equal wherever the slot holds more than
    1e-4 of the largest residual (a slot whose residual is ~0 may name
    another dim: measured 3 of 8192 slots, |value| 6e-8)."""
    for name in FIELDS:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape, name
        if name == "kv_out":
            dense = dcfg.n_kc if dcfg.k_outliers == "channels" else 0
            np.testing.assert_allclose(g[..., :dense, :], w[..., :dense, :],
                                       rtol=2.5e-4, atol=1e-6)
            if dense == g.shape[-2]:
                continue  # no slot words (channels, cap 0)
            gv, gi = packing.decode_outlier_words(
                torch.tensor(g[..., dense:, :]))
            wv, wi = packing.decode_outlier_words(
                torch.tensor(w[..., dense:, :]))
            live = torch.maximum(gv.abs(), wv.abs()) > 1e-4 * wv.abs().max()
            assert torch.equal(gi[live], wi[live])
            np.testing.assert_allclose(gv.numpy(), wv.numpy(), rtol=2.5e-4,
                                       atol=1e-6)
        elif g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=2.5e-4, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.astype(np.int32),
                                          w.astype(np.int32), err_msg=name)


def _jax_arrays(c):
    return {n: np.asarray(getattr(c, n).astype(jnp.int32)
                          if str(getattr(c, n).dtype) == "int4"
                          else getattr(c, n)) for n in FIELDS}


@pytest.mark.parametrize("mode", list(MODES))
def test_port_file_loads_in_jax(model, mode, tmp_path):
    """The port's file in JAX: JAX's own cache of the same tokens; written
    back by JAX, the port reads its original cache bit for bit; JAX
    resumes from the port's file as from its own cache."""
    (jc, jd, jq), (tc, td, _), tokens = _prefilled(model, mode)
    path = str(tmp_path / "port.npz")
    cache_io.save_cache(path, tc, td)
    back, jd2 = jio.load_cache(path)
    assert jd2 == jd
    _same_cache(_jax_arrays(back), _jax_arrays(jc), jd)
    if mode == "int4":
        assert str(back.k_planes.dtype) == "int4"
    jio.save_cache(path, back, jd)
    again, _ = cache_io.load_cache(path, device="cpu")
    for name in FIELDS:
        assert torch.equal(getattr(again, name), getattr(tc, name)), name
    if mode != "int4x2":
        # JAX resumes from its cache carried through the port (its file,
        # read and written by the port) as from the cache itself; its
        # load_cache returns int4x2 codes as int8, the fault above
        cache_io.save_cache(path, cache_io.load_cache(
            _write_jax(tmp_path, jc, jd), device="cpu")[0], td)
        through_port, _ = jio.load_cache(path)
        params = model[0]
        tok = jnp.asarray(tokens[:, -1])
        _, l1 = jeng.decode_step(params, J_GQA, jd, jq, jc, tok,
                                 jnp.int32(20))
        _, l2 = jeng.decode_step(params, J_GQA, jd, jq, through_port, tok,
                                 jnp.int32(20))
        np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))


def _write_jax(tmp_path, jc, jd):
    path = str(tmp_path / "jax.npz")
    jio.save_cache(path, jc, jd)
    return path


@pytest.mark.parametrize("mode", list(MODES))
def test_jax_file_loads_in_port(model, mode, tmp_path):
    """JAX's file in the port: the port's own cache of the same tokens, in
    the port's containers; written back by the port, JAX reads its
    original cache bit for bit."""
    (jc, jd, _), (tc, td, _), _ = _prefilled(model, mode)
    back, td2 = cache_io.load_cache(_write_jax(tmp_path, jc, jd),
                                    device="cpu")
    assert td2 == td
    for name in FIELDS:
        got, want = getattr(back, name), getattr(tc, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
    _same_cache({n: _jax_view(n, getattr(back, n), td) for n in FIELDS},
                {n: _jax_view(n, getattr(tc, n), td) for n in FIELDS}, td)
    path = str(tmp_path / "port.npz")
    cache_io.save_cache(path, back, td)
    again, _ = jio.load_cache(path)
    for name, want in _jax_arrays(jc).items():
        np.testing.assert_array_equal(_jax_arrays(again)[name], want,
                                      err_msg=name)


@pytest.mark.parametrize("kernel", ["xla", "flash"])
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_from_restored_cache(model, mode, kernel, tmp_path):
    """The port resumes from its own file, and from JAX's, with the logits
    it gets from the cache it wrote or read."""
    (jc, jd, _), (tc, td, tq), tokens = _prefilled(model, mode)
    td = dataclasses.replace(td, kernel=kernel)
    tparams = model[1]
    tok = torch.as_tensor(tokens[:, -1])
    from_jax, _ = cache_io.load_cache(_write_jax(tmp_path, jc, jd),
                                      device="cpu")
    for cache in (tc, from_jax):
        path = str(tmp_path / "c.npz")
        cache_io.save_cache(path, cache, td)
        back, td2 = cache_io.load_cache(path, device="cpu")
        assert td2 == td
        _, want = engine.decode_step(tparams, TINY_GQA, td, tq, cache, tok,
                                     20)
        _, got = engine.decode_step(tparams, TINY_GQA, td, tq, back, tok, 20)
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", list(MODES))
def test_reset_cache_matches_jax(model, mode, tmp_path):
    (jc, jd, _), (tc, td, _), _ = _prefilled(model, mode)
    shapes = {n: (getattr(tc, n).shape, getattr(tc, n).dtype)
              for n in FIELDS}
    assert tc.length.tolist() == [20, 20]
    ptrs = {n: getattr(tc, n).data_ptr() for n in FIELDS}
    assert reset_cache(tc) is tc
    jz = jreset(jc)
    for name in FIELDS:
        a = getattr(tc, name)
        assert (a.shape, a.dtype) == shapes[name], name
        assert a.data_ptr() == ptrs[name], name  # in place
        assert not a.any(), name
        np.testing.assert_array_equal(
            _jax_view(name, a, td),
            np.asarray(getattr(jz, name)).astype(_jax_view(name, a, td).dtype))


# ---------------------------------------------------------------------------
# the port's packing against the host C++ packer
# ---------------------------------------------------------------------------


def test_native_packer_builds():
    assert native.have_native()


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_pack_matches_native(bits):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 2 ** bits, size=(3, 256, 16)).astype(np.int32)
    want = native.pack_codes(codes, bits)
    got = packing.pack_codes(torch.as_tensor(codes), bits).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_unpack_matches_native(bits):
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 2 ** bits, size=(2, 128, 8)).astype(np.int32)
    planes = native.pack_codes(codes, bits)
    got = packing.unpack_codes(torch.as_tensor(planes), bits).numpy()
    np.testing.assert_array_equal(got, native.unpack_codes(planes, bits))
    np.testing.assert_array_equal(got, codes)


def test_outlier_words_match_native():
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(4, 8, 64)).astype(np.float32)
    idx = rng.integers(0, 512, size=(4, 8, 64)).astype(np.int32)
    want = native.encode_outliers(vals, idx)
    got = packing.encode_outlier_words(torch.as_tensor(vals),
                                       torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    v2, i2 = packing.decode_outlier_words(torch.as_tensor(want))
    nv, ni = native.decode_outliers(want)
    np.testing.assert_array_equal(i2.numpy(), ni)
    np.testing.assert_array_equal(v2.numpy().view(np.uint32),
                                  nv.view(np.uint32))
