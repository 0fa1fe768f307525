"""The port's prefill chunk at a device ``pos0`` and the fp16-KV baseline's
step at device positions (kvquant_tpu_torch/ops/{packing,deployed}.py,
engine.py, serve.py, paged.py, baseline_fp16.py): the bodies that
engine.ChunkGraph and baseline_fp16.DecodeGraph capture on a card, against
their host-int forms and the JAX package on the same numpy inputs:

  (a) the block writes (packing.write_block through ops.deployed.
      _place_codes) and ops.deployed.block_attention through every route
      ("xla", "flash" / "flash_serial" on K1's plain version, "pallas" on
      K3 / K4's): codes nuq 2/3/4, int4, int8, int4x2 x pre / post-RoPE K
      x slots / static channels; a 0-d and a (1,) int32 ``pos0`` tensor
      give bitwise the cache and output of the same int ``pos0`` at the
      first chunk (``sink_fill``), a middle chunk and the chunk that ends
      at capacity;
  (b) prefill_quantized over 4 chunks of 128 (JAX's ``rest_chunks`` scan
      carries its cache over three) against kvquant_tpu.engine.
      prefill_quantized through "flash", "pallas" and "xla" on both sides
      (JAX's Pallas kernels in interpret mode): k_planes bitwise and the
      lengths as tests/test_torch_engine.py compares them, the last-token
      logits within its tolerance; and the chunk loop as ChunkGraph runs
      it (chunks 1... from one static token buffer at a 0-d position
      tensor) == prefill_quantized bitwise;
  (c) prefill_chunk at a device ``pos0`` (the sink chunk and a later one)
      makes no host read, on every route: a TorchDispatchMode that fails on
      aten._local_scalar_dense, Tensor.tolist / numpy / cpu patched to
      raise; the kernels' plain versions, which never run on the card's
      path, are exempt (tests/test_torch_decode_graph.py's guard);
  (d) serve.Server and paged.PagedServer, whose chunked admission runs in
      one held admission cache (reset as each admission starts): tokens
      == the JAX servers' and the port's isolated quantized generation
      over requests that reuse the cache, a long prompt before short
      ones; the held cache after the last admission == a fresh
      prefill_quantized of its prompt, bitwise (the paged server's length
      aside, which it leaves at the last chunk's end, as JAX's does);
  (e) baseline_fp16.decode_step at 0-d and (1,) position tensors ==
      the int form bitwise, == kvquant_tpu.baseline_fp16.decode_step within
      the baseline tests' tolerance (atol / rtol 1e-4 logits, 1e-5
      caches), for the Llama and the MoE family, and no host read;
      decode_stepper off the card is the eager step; the warm-up's row
      keeper puts the cache back bitwise;
  (f) ChunkGraph and baseline_fp16.DecodeGraph refuse a CPU cache and
      tp > 1; the MoE family is refused only for the CPU cache.

A CUDA graph's capture and replay run only on a card (chip_smoke.py
phases 30 and 31).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kvquant_tpu import baseline_fp16 as jbase
from kvquant_tpu import engine as jeng, paged as jpaged, serve as jserve
from kvquant_tpu.cache import (DeployConfig as JDeployConfig,
                               create_cache as jcreate,
                               deployed_from_quantizers as jdeployed)
from kvquant_tpu.models import init_params as jinit, moe as jmoe
from kvquant_tpu.models.config import TINY_LLAMA as J_TINY, TINY_GQA as J_GQA
from kvquant_tpu.quant.artifacts import save_quantizers
from kvquant_tpu.quant.calibration import (collect_kv_activations,
                                           fit_quantizers)

from kvquant_tpu_torch import baseline_fp16 as tbase
from kvquant_tpu_torch import cache as tcache, engine, paged, serve
from kvquant_tpu_torch.models import moe, params_from_numpy
from kvquant_tpu_torch.models.config import TINY_LLAMA, TINY_GQA
from kvquant_tpu_torch.ops import deployed as tdep
from kvquant_tpu_torch.ops.kernels import attention as at
from kvquant_tpu_torch.ops.kernels import flash_decode as fd
from kvquant_tpu_torch.ops.kernels import flash_serial as fs
from kvquant_tpu_torch.quant.artifacts import load_quantizers

torch.set_num_threads(1)

FIELDS = ("k_planes", "v_planes", "kv_out", "v_scale", "v_offset", "k_sink",
          "v_sink", "length")
CODES = {"nuq2": ("nuq", 2), "nuq3": ("nuq", 3), "nuq4": ("nuq", 4),
         "int4": ("int4", 4), "int8": ("int8", 8), "int4x2": ("int4x2", 2)}
OUTLIERS = {"slots": dict(k_outliers="slots", cap_per_side=2),
            "channels": dict(k_outliers="channels", n_kc=3, cap_per_side=2)}
S, MAX_LEN = 5, 300  # capacity 512 packed tokens
CHUNK = 128


def _bitwise(a, b, tag, fields=FIELDS):
    """Two caches (KVCache or name -> tensor) bitwise, fp32 as bit
    patterns."""
    for f in fields:
        x = a[f] if isinstance(a, dict) else getattr(a, f)
        y = b[f] if isinstance(b, dict) else getattr(b, f)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{tag}: {f}"


def _quantizers(mcfg, codes, bits, seed=0):
    """Random per-channel K ranges, codebooks (affine for the integer
    containers) and K residual scores."""
    rng = np.random.default_rng(seed)
    L, C = mcfg.n_layers, mcfg.n_kv_heads * mcfg.d_head
    up = (np.abs(rng.standard_normal((L, C))) * 2 + 1).astype(np.float32)
    lo = (-up * 0.9).astype(np.float32)
    K = 2 ** bits
    if codes == "nuq":
        kl = np.sort(rng.uniform(-1, 1, (L, K)), axis=1).astype(np.float32)
        vl = np.sort(rng.uniform(-1, 1, (L, K)), axis=1).astype(np.float32)
    else:
        kl = np.stack([np.linspace(-1, 1, K, dtype=np.float32)] * L)
        vl = kl.copy()
    Hkv, D = mcfg.n_kv_heads, mcfg.d_head
    dq = dict(k_range=((up - lo) / 2).reshape(L, Hkv, D),
              k_offset=((up + lo) / 2).reshape(L, Hkv, D), k_lower=lo,
              k_upper=up, k_lut_enc=kl, k_lut_dec=kl * np.float32(1.01),
              v_lut_enc=vl, v_lut_dec=vl,
              k_ressc=rng.random((L, C)).astype(np.float32))
    return tcache.DeployedQuant(**{k: torch.as_tensor(v)
                                   for k, v in dq.items()})


def _config(codes, bits, post, outliers, kernel="xla", mcfg=TINY_LLAMA,
            hg=2):
    return tcache.DeployConfig.create(
        bits=bits, n_kv_heads=mcfg.n_kv_heads, d_head=mcfg.d_head,
        max_len=MAX_LEN, sink=S, head_group=hg, codes=codes,
        post_rope_k=post, dot_bf16=False, kernel=kernel, **OUTLIERS[outliers])


def _tensor_forms(pos0):
    """The same position as an int, a 0-d and a (1,) int32 tensor."""
    return (pos0, torch.tensor(pos0, dtype=torch.int32),
            torch.tensor([pos0], dtype=torch.int32))


# ---------------------------------------------------------------------------
# (a) block writes and block_attention at a device pos0
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("code", list(CODES))
def test_block_writes_at_device_offset(code):
    """_place_codes (place_planes / place_codes_int / place_codes_int4x2 ->
    write_block) and write_block along the token axis of kv_out and the V
    range: a tensor offset writes what the int offset writes, at the
    first block, a middle one and the one that ends at capacity."""
    codes, bits = CODES[code]
    td = _config(codes, bits, False, "slots")
    Tc, Hkv, D = td.cache_tokens, td.n_kv_heads, td.d_head
    rng = np.random.default_rng(1)
    base = tcache.create_cache(td, 1, 2, device="cpu").layer(0)
    for f in ("k_planes", "kv_out", "v_scale"):
        a = getattr(base, f)
        a.copy_(torch.as_tensor(rng.integers(-100, 100, a.shape)).to(a.dtype))
    for p0 in (0, CHUNK, Tc - CHUNK):
        c = torch.as_tensor(rng.integers(0, 2 ** bits, (2, CHUNK, Hkv, D))
                            .astype(np.int32))
        w = torch.as_tensor(rng.standard_normal(
            (2, td.n_groups, td.n_slots, CHUNK)).astype(np.float32))
        sc = torch.as_tensor(rng.standard_normal((2, CHUNK))
                             .astype(np.float32))
        outs = []
        for p in _tensor_forms(p0):
            lay = {f: getattr(base, f).clone()
                   for f in ("k_planes", "kv_out", "v_scale")}
            tdep._place_codes(lay["k_planes"], c, p, td)
            tdep.write_block(lay["kv_out"], w, p, axis=-1)
            tdep.write_block(lay["v_scale"], sc, p, axis=1)
            outs.append(lay)
        assert torch.equal(tdep._stored_codes(outs[0]["k_planes"], td)
                           [..., p0:p0 + CHUNK, :], c.movedim(-3, -2))
        for o in outs[1:]:
            for f in o:
                assert torch.equal(o[f], outs[0][f]), (code, p0, f)


ROUTES = [(code, post, out, route) for code in CODES
          for post in (False, True) for out in OUTLIERS
          for route in ("xla", "flash", "pallas")
          if route != "pallas" or (CODES[code][0] == "nuq" and not post
                                   and out == "slots")]


@pytest.mark.parametrize("code,post,outliers,route", ROUTES)
def test_block_attention_at_device_pos0(code, post, outliers, route):
    """Three chunks of 128 into layer 1 of a 2-layer cache, the first with
    the sink rows, the last ending at capacity: the cache (every array and
    the length) and the output bitwise equal for an int, a 0-d and a (1,)
    tensor pos0."""
    codes, bits = CODES[code]
    mcfg = TINY_LLAMA
    tq = _quantizers(mcfg, codes, bits, seed=2)
    td = _config(codes, bits, post, outliers, route, mcfg)
    Tc, C = td.cache_tokens, mcfg.n_kv_heads * mcfg.d_head
    rng = np.random.default_rng(3 + post)
    caches = [tcache.create_cache(td, 2, 2, device="cpu") for _ in range(3)]
    for pos0, sink_fill in ((S, True), (S + CHUNK, False),
                            (S + Tc - CHUNK, False)):
        T = CHUNK + (S if sink_fill else 0)
        q = torch.as_tensor(rng.standard_normal(
            (2, T, mcfg.n_heads, mcfg.d_head)).astype(np.float32))
        k = torch.as_tensor((rng.standard_normal((2, T, C)) * 1.5)
                            .astype(np.float32))
        v = torch.as_tensor(rng.standard_normal((2, T, C)).astype(np.float32))
        outs = []
        for cache, p in zip(caches, _tensor_forms(pos0)):
            _, o = tdep.block_attention(cache.layer(1), tq.layer(1), td,
                                        mcfg, q, k, v, p, sink_fill=sink_fill)
            outs.append(o)
        tag = f"{code} {route} pos0 {pos0}"
        assert caches[0].length.tolist() == [pos0 + CHUNK] * 2
        assert torch.isfinite(outs[0]).all()
        for cache, o in zip(caches[1:], outs[1:]):
            _bitwise(cache, caches[0], tag)
            assert torch.equal(o.view(torch.int32),
                               outs[0].view(torch.int32)), tag


def test_int_pos0_past_capacity_raises():
    """An int pos0 whose block runs past the capacity fails on the host
    (block_pos0), in block_attention and in prefill_chunk, before
    anything is written."""
    tq = _quantizers(TINY_LLAMA, "nuq", 3)
    td = _config("nuq", 3, False, "slots", "flash")
    Tc, C = td.cache_tokens, TINY_LLAMA.n_kv_heads * TINY_LLAMA.d_head
    cache = tcache.create_cache(td, 2, 1, device="cpu")
    q = torch.zeros((1, CHUNK, TINY_LLAMA.n_heads, TINY_LLAMA.d_head))
    kv = torch.zeros((1, CHUNK, C))
    with pytest.raises(AssertionError, match="exceeds capacity"):
        tdep.block_attention(cache.layer(0), tq.layer(0), td, TINY_LLAMA,
                             q, kv, kv, S + Tc - CHUNK + 128)
    tp = params_from_numpy(jax.tree.map(np.asarray, jinit(
        jax.random.PRNGKey(0), J_TINY, dtype=jnp.float32)), TINY_LLAMA,
        device="cpu")
    with pytest.raises(AssertionError, match="exceeds capacity"):
        engine.prefill_chunk(tp, TINY_LLAMA, td, tq, cache,
                             torch.zeros((1, CHUNK), dtype=torch.int32),
                             S + Tc, False)
    assert int(cache.length[0]) == 0 and not cache.k_planes.any()
    assert tdep.block_pos0(S + Tc - CHUNK, CHUNK, td, "cpu").shape == ()


@pytest.mark.parametrize("code", list(CODES))
def test_cache_in_a_shared_storage(code):
    """create_cache(storage=...): a 1-page cache in the buffer of a 2-page
    one has a fresh cache's shapes and dtypes, zeroed whatever the buffer
    held, and its arrays are views of the buffer; writes through the
    2-page cache laid over the same buffer reach it."""
    codes, bits = CODES[code]
    big = dataclasses.replace(_config(codes, bits, False, "slots"),
                              max_len=S + 512)
    small = dataclasses.replace(big, max_len=S + 256)
    n = tcache.cache_storage_bytes(big, 2, 1)
    assert n >= tcache.cache_storage_bytes(small, 2, 1)
    storage = torch.full((n,), 0xA5, dtype=torch.uint8)
    for td in (small, big):
        c = tcache.create_cache(td, 2, 1, storage=storage)
        fresh = tcache.create_cache(td, 2, 1, device="cpu")
        for name in FIELDS:
            x, y = getattr(c, name), getattr(fresh, name)
            assert (x.shape, x.dtype) == (y.shape, y.dtype), name
            assert torch.equal(x, y), name
            assert x.untyped_storage().data_ptr() == \
                storage.untyped_storage().data_ptr(), name
    c.v_scale.fill_(1.0)
    c.length.fill_(7)
    assert storage.any()
    with pytest.raises(AssertionError):
        tcache.create_cache(big, 2, 1, storage=storage[:n // 2])


# ---------------------------------------------------------------------------
# (b) prefill_quantized over four chunks against JAX's scanned prefill
# ---------------------------------------------------------------------------


def _fit(jcfg, tcfg, bits, tmp_path, seed=0):
    """A random fp32 model and uniform quantizers fitted by the JAX package,
    handed to the port through numpy and an npz artifact."""
    params = jinit(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    cal = jax.random.randint(jax.random.PRNGKey(7), (2, 40), 0,
                             jcfg.vocab_size)
    k_acts, v_acts = collect_kv_activations(params, jcfg, [cal])
    qs = fit_quantizers(k_acts, v_acts, bits=bits, sparsity_threshold=0.99,
                        cap_outliers=True, first_few_fp16=5, sample_seqlen=40,
                        kmeans_iters=10, mode="uniform")
    path = str(tmp_path / "q.npz")
    save_quantizers(path, qs)
    tq = tcache.deployed_from_quantizers(load_quantizers(path),
                                         tcfg.n_kv_heads, tcfg.d_head,
                                         device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    return (params, jdeployed(qs, jcfg.n_kv_heads, jcfg.d_head)), (tparams, tq)


def _faithful(jcfg, kernel, max_len):
    d = dict(bits=3, n_kv_heads=jcfg.n_kv_heads, d_head=jcfg.d_head,
             max_len=max_len, sink=S, kernel=kernel, dot_bf16=False,
             head_group=2, codes="nuq", post_rope_k=False,
             k_outliers="slots", cap_per_side=2)
    return JDeployConfig.create(**d), tcache.DeployConfig.create(**d)


@pytest.fixture(scope="module")
def gqa(tmp_path_factory):
    return _fit(J_GQA, TINY_GQA, 3, tmp_path_factory.mktemp("gqa"))


P_LEN = S + 3 * CHUNK + 60  # 4 chunks, the last partly padding


@pytest.mark.parametrize("kernel", ["flash", "pallas", "xla"])
def test_prefill_quantized_over_four_chunks_matches_jax(gqa, kernel):
    """B=1, TINY_GQA, nuq3 pre-RoPE slots, chunk 128 over a 449-token
    prompt (4 chunks, 512 packed tokens = the capacity): k_planes bitwise
    against JAX's and the port's xla path, the lengths, the last-token
    logits within the tolerance of tests/test_torch_engine.py; the chunk
    loop as ChunkGraph runs it gives prefill_quantized's cache and
    logits bitwise."""
    (jp, jq), (tp, tq) = gqa
    tokens = np.random.default_rng(11).integers(
        0, J_GQA.vocab_size, (1, P_LEN), dtype=np.int32)
    jd, td = _faithful(J_GQA, kernel, max_len=4 * CHUNK + S)
    assert td.cache_tokens == 4 * CHUNK
    jc, jlog = jeng.prefill_quantized(jp, J_GQA, jd, jq,
                                      jcreate(jd, J_GQA.n_layers, 1),
                                      jnp.asarray(tokens), chunk=CHUNK)
    tc, tlog = engine.prefill_quantized(
        tp, TINY_GQA, td, tq,
        tcache.create_cache(td, TINY_GQA.n_layers, 1, device="cpu"),
        torch.as_tensor(tokens), chunk=CHUNK)
    np.testing.assert_array_equal(tc.k_planes.numpy(),
                                  np.asarray(jc.k_planes))
    assert tc.length.tolist() == np.asarray(jc.length).tolist() == [P_LEN]
    diff = np.abs(tlog.numpy() - np.asarray(jlog))
    assert np.quantile(diff, 0.5) < 5e-3 and diff.max() < 0.25, (
        np.quantile(diff, 0.5), diff.max())
    if kernel != "xla":
        xc, _ = engine.prefill_quantized(
            tp, TINY_GQA, dataclasses.replace(td, kernel="xla"), tq,
            tcache.create_cache(td, TINY_GQA.n_layers, 1, device="cpu"),
            torch.as_tensor(tokens), chunk=CHUNK)
        assert torch.equal(tc.k_planes, xc.k_planes)

    # the loop of ChunkGraph: chunk 0 eager at an int, then one static
    # token buffer and a 0-d position tensor for every later chunk
    toks = torch.nn.functional.pad(torch.as_tensor(tokens),
                                   (0, 4 * CHUNK - (P_LEN - S)))
    gc = tcache.create_cache(td, TINY_GQA.n_layers, 1, device="cpu")
    engine.prefill_chunk(tp, TINY_GQA, td, tq, gc, toks[:, :S + CHUNK], S,
                         True)
    buf = torch.zeros((1, CHUNK), dtype=torch.int32)
    pos0 = torch.zeros((), dtype=torch.int32)
    for c in range(1, 4):
        buf.copy_(toks[:, S + c * CHUNK:S + (c + 1) * CHUNK])
        pos0.fill_(S + c * CHUNK)
        _, logits = engine.prefill_chunk(tp, TINY_GQA, td, tq, gc, buf, pos0,
                                         False)
    gc.length.fill_(P_LEN)
    _bitwise(gc, tc, f"{kernel} graph loop")
    last = (P_LEN - 1) - (S + 3 * CHUNK)
    assert torch.equal(logits[:, last], tlog)


# ---------------------------------------------------------------------------
# (c) no host read in a chunk at a device pos0
# ---------------------------------------------------------------------------


class _NoHostRead(torch.utils._python_dispatch.TorchDispatchMode):
    """Fails on aten._local_scalar_dense (a tensor's value read by the
    host) outside the exempt plain kernel versions."""

    exempt = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (func is torch.ops.aten._local_scalar_dense.default
                and not _NoHostRead.exempt):
            raise AssertionError("host read: aten._local_scalar_dense")
        return func(*args, **(kwargs or {}))


def _exempt(fn):
    def run(*a, **kw):
        _NoHostRead.exempt += 1
        try:
            return fn(*a, **kw)
        finally:
            _NoHostRead.exempt -= 1
    return run


def _raise_if_not_exempt(name, orig):
    def run(self, *a, **kw):
        if not _NoHostRead.exempt:
            raise AssertionError(f"host read: Tensor.{name}")
        return orig(self, *a, **kw)
    return run


def _guard(monkeypatch):
    """Exempt the kernels' plain versions; make tolist / numpy / cpu
    raise outside them."""
    for mod, name in ((fd, "flash_attention_ref"),
                      (fs, "flash_serial_decode_ref"),
                      (at, "qk_fused_ref"), (at, "pv_fused_ref")):
        monkeypatch.setattr(mod, name, _exempt(getattr(mod, name)))
    for name in ("tolist", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, _raise_if_not_exempt(
            name, getattr(torch.Tensor, name)))


GUARDED = {  # kernel -> (codes, bits, post-RoPE K, outliers)
    "flash": [("nuq", 3, False, "slots"), ("int4x2", 2, True, "channels")],
    "flash_serial": [("int4", 4, True, "channels")],
    "pallas": [("nuq", 3, False, "slots")],
    "xla": [("nuq", 2, False, "channels"), ("int8", 8, True, "slots")],
}


def _tiny_params(cfg=TINY_LLAMA, jcfg=J_TINY, seed=1):
    return params_from_numpy(jax.tree.map(np.asarray, jinit(
        jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)), cfg,
        device="cpu")


@pytest.mark.parametrize("kernel,case", [(k, c) for k, cs in GUARDED.items()
                                         for c in cs])
def test_prefill_chunk_makes_no_host_read(kernel, case, monkeypatch):
    codes, bits, post, outliers = case
    cfg = TINY_LLAMA
    tq = _quantizers(cfg, codes, bits, seed=1)
    td = _config(codes, bits, post, outliers, kernel, cfg)
    params = _tiny_params()
    cache = tcache.create_cache(td, cfg.n_layers, 2, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, 256, (2, S + 2 * CHUNK), dtype=np.int32))
    _guard(monkeypatch)
    with _NoHostRead():
        for blk, p, sf in ((toks[:, :S + CHUNK], S, True),
                           (toks[:, S + CHUNK:], S + CHUNK, False)):
            _, logits = engine.prefill_chunk(
                params, cfg, td, tq, cache, blk,
                torch.tensor(p, dtype=torch.int32), sf)
        with pytest.raises(AssertionError, match="host read"):
            bool(logits.sum() > 0)  # the guard sees a host read
    assert torch.isfinite(logits).all()
    assert torch.equal(cache.length, torch.full((2,), S + 2 * CHUNK,
                                                dtype=torch.int32))


# ---------------------------------------------------------------------------
# (d) the servers' held, reset admission cache
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """TINY_LLAMA with uniform 3-bit quantizers (the codebooks of the
    paged and serve tests)."""
    return _fit(J_TINY, TINY_LLAMA, 3, tmp_path_factory.mktemp("tiny"))


def _requests(mod, spec, seed):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, 256, n)
                        .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(spec)]


def _generate(tp, tq, td, req):
    out, _ = engine.generate(
        tp, TINY_LLAMA, td, tq, torch.as_tensor(req.prompt)[None],
        engine.GenerateConfig(max_new_tokens=req.max_new_tokens),
        prefill_mode="quantized", device="cpu")
    return out[0].tolist()


def _fresh_prefill(tp, tq, td, prompt):
    c = tcache.create_cache(td, TINY_LLAMA.n_layers, 1, device="cpu")
    return engine.prefill_quantized(tp, TINY_LLAMA, td, tq, c,
                                    torch.as_tensor(prompt)[None],
                                    chunk=CHUNK)[0]


def test_server_admission_cache_matches_jax(tiny):
    """serve.Server, 1 slot, chunked admission of 128: four requests
    admitted one after another into the one held cache, the longest
    first; tokens == JAX's Server and the isolated quantized generation;
    the held cache after the last == a fresh prefill of its prompt."""
    (jp, jq), (tp, tq) = tiny
    d = dict(bits=3, n_kv_heads=4, d_head=16, max_len=3 * CHUNK + S + 32,
             sink=S, dot_bf16=False, kernel="flash")
    jd, td = JDeployConfig.create(**d), tcache.DeployConfig.create(**d)
    spec = [(3 * CHUNK, 6), (40, 5), (150, 4), (12, 7)]
    out = {}
    for side, mod, args in (("jax", jserve, (jp, J_TINY, jd, jq)),
                            ("torch", serve, (tp, TINY_LLAMA, td, tq))):
        extra = {} if side == "jax" else {"device": "cpu"}
        srv = mod.Server(*args, n_slots=1, admit_mode="chunked",
                         admit_chunk=CHUNK, **extra)
        res = srv.run(_requests(mod, spec, 6))
        out[side] = {rid: c.tokens for rid, c in res.items()}
    assert out["torch"] == out["jax"]
    reqs = _requests(serve, spec, 6)
    for r in reqs:
        assert out["torch"][r.rid] == _generate(tp, tq, td, r), r.rid
    _bitwise(srv._adm.cache, _fresh_prefill(tp, tq, td, reqs[-1].prompt),
             "held admission cache")
    assert not srv._adm.graphed and srv._adm.graphs == {}


def test_paged_admission_caches_match_jax(tiny):
    """paged.PagedServer, 2 slots, chunked admission of 128 into held
    caches keyed by the temporary capacity (1 and 2 pages of 256), taking
    turns in one buffer (2, 1, 1, 2, 1 pages): tokens == JAX's PagedServer
    and the isolated quantized generation, every page returned; both
    caches view the one buffer of MP pages; the 1-page cache after the
    last admission == a fresh prefill of that prompt."""
    (jp, jq), (tp, tq) = tiny
    d = dict(bits=3, n_kv_heads=4, d_head=16, max_len=2 * 256 + S,
             sink=S, kernel="flash", dot_bf16=False, head_group=4,
             codes="nuq", post_rope_k=False, k_outliers="slots",
             cap_per_side=2)
    jd = dataclasses.replace(JDeployConfig.create(**d), page_tokens=256)
    td = dataclasses.replace(tcache.DeployConfig.create(**d), page_tokens=256)
    spec = [(300, 6), (200, 5), (40, 9), (260, 4), (20, 6)]
    out = {}
    for side, mod, args in (("jax", jpaged, (jp, J_TINY, jd, jq)),
                            ("torch", paged, (tp, TINY_LLAMA, td, tq))):
        extra = {} if side == "jax" else {"device": "cpu"}
        srv = mod.PagedServer(*args, n_pages=4, n_slots=2,
                              max_pages_per_slot=2, admit_mode="chunked",
                              admit_chunk=CHUNK, burst=4, **extra)
        res = srv.run(_requests(serve, spec, 8), max_steps=300)
        assert sorted(srv.free) == [0, 1, 2, 3]
        out[side] = {rid: c.tokens for rid, c in res.items()}
    assert out["torch"] == out["jax"]
    reqs = _requests(serve, spec, 8)
    for r in reqs:
        td_r = dataclasses.replace(td, max_len=S + srv._pages_needed(r) * 256)
        assert out["torch"][r.rid] == _generate(tp, tq, td_r, r), r.rid
    assert sorted(srv._adm_caches) == [256, 512]
    # both capacities' caches view the one buffer of MP pages
    mem = srv._adm_memory
    assert mem.storage.numel() == tcache.cache_storage_bytes(
        td, TINY_LLAMA.n_layers, 1)
    for h in srv._adm_caches.values():
        assert h.memory is mem
        for name in FIELDS:
            assert getattr(h.cache, name).untyped_storage().data_ptr() \
                == mem.storage.untyped_storage().data_ptr(), name
    # the last admission, reqs[4], ran in the 1-page cache
    held = srv._adm_caches[256].cache
    td1 = dataclasses.replace(td, max_len=S + 256)
    _bitwise(held, _fresh_prefill(tp, tq, td1, reqs[4].prompt),
             "held 1-page cache", FIELDS[:-1])
    # the paged admission leaves the last chunk's end as the length, as
    # JAX's does (the pages carry no length)
    assert held.length.tolist() == [S + CHUNK]


# ---------------------------------------------------------------------------
# (e) the fp16-KV baseline's step at device positions
# ---------------------------------------------------------------------------


G6 = dict(vocab_size=256, d_model=96, n_layers=3, n_heads=12, n_kv_heads=2,
          d_head=8, d_ff=64, max_seq_len=512, n_experts=4, top_k=2,
          norm_type="layernorm", rope_theta=500000.0)
FAMILIES = {"llama": (J_GQA, TINY_GQA),
            "moe": (jmoe.MoEConfig(**G6), moe.MoEConfig(**G6))}


def _family(which, seed=3):
    jcfg, tcfg = FAMILIES[which]
    if which == "moe":
        jp = jmoe.init_params(jax.random.PRNGKey(seed), jcfg,
                              dtype=jnp.float32)
        tp = moe.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    else:
        jp = jinit(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
    return jp, tp, jcfg, tcfg


@pytest.mark.parametrize("which", list(FAMILIES))
def test_baseline_step_at_device_positions(which):
    """fp32 weights and cache, B=2, 8 steps from position 0 (JAX's
    prefill fails on MoE parameters, so both sides decode every token):
    the (1,) and 0-d position tensors give the int form's logits and
    cache bitwise; JAX's decode_step within atol / rtol 1e-4 (logits) and
    1e-5 (caches)."""
    jp, tp, jcfg, tcfg = _family(which)
    toks = np.random.default_rng(4).integers(0, 256, (2, 8), dtype=np.int32)
    jc = jbase.create_fp16_cache(jcfg, 12, 2, dtype=jnp.float32)
    tcs = [tbase.create_fp16_cache(tcfg, 12, 2, dtype=torch.float32,
                                   device="cpu") for _ in range(3)]
    for pos in range(8):
        jc, jl = jbase.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, pos]),
                                   pos)
        logits = []
        for tc, p in zip(tcs, _tensor_forms(pos)):
            _, tl = tbase.decode_step(tp, tcfg, tc,
                                      torch.as_tensor(toks[:, pos]), p)
            logits.append(tl)
        for tl in logits[1:]:
            assert torch.equal(tl.view(torch.int32),
                               logits[0].view(torch.int32)), pos
        np.testing.assert_allclose(logits[0].numpy(), np.asarray(jl),
                                   atol=1e-4, rtol=1e-4, err_msg=f"pos {pos}")
    for tc in tcs[1:]:
        for name in ("k", "v", "length"):
            assert torch.equal(getattr(tc, name), getattr(tcs[0], name))
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(tcs[0], name).numpy(),
                                   np.asarray(getattr(jc, name)), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    assert tcs[0].length.tolist() == np.asarray(jc.length).tolist() == [8, 8]


@pytest.mark.parametrize("which", list(FAMILIES))
def test_baseline_step_makes_no_host_read(which, monkeypatch):
    """The baseline's step at a (1,) position tensor reads nothing back to
    the host (the dense MoE expert mix included); the stepper off the card
    is that step."""
    _, tp, _, tcfg = _family(which)
    tc = tbase.create_fp16_cache(tcfg, 40, 2, device="cpu")
    tok = torch.tensor([3, 9], dtype=torch.int32)
    step = tbase.decode_stepper(tp, tcfg, tc)
    assert not isinstance(step, tbase.DecodeGraph)
    _guard(monkeypatch)
    with _NoHostRead():
        for p in (0, 17, 39):
            logits = step(tok, torch.tensor([p], dtype=torch.int32))
        with pytest.raises(AssertionError, match="host read"):
            bool(logits.sum() > 0)
    assert torch.isfinite(logits).all()
    assert torch.equal(tc.length, torch.tensor([40, 40], dtype=torch.int32))


def test_baseline_row_keeper_puts_the_warmup_back():
    """A step at position 0, the baseline graph's warm-up, leaves a filled
    cache bitwise as it found it once first_row_keeper puts back what it
    wrote."""
    _, tp, _, tcfg = _family("llama")
    tc = tbase.create_fp16_cache(tcfg, 16, 2, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, 256, (2, 10), dtype=np.int32))
    tbase.prefill(tp, tcfg, tc, toks)
    before = {n: getattr(tc, n).clone() for n in ("k", "v", "length")}
    restore = tbase.first_row_keeper(tc)
    tbase.decode_step(tp, tcfg, tc, toks[:, 0], torch.zeros(
        (1,), dtype=torch.int32))
    assert not torch.equal(tc.length, before["length"])
    restore()
    for n, a in before.items():
        assert torch.equal(getattr(tc, n), a), n


# ---------------------------------------------------------------------------
# (f) what the graphs refuse
# ---------------------------------------------------------------------------


def _tp2():
    from kvquant_tpu_torch.parallel import shardings

    kw = {f.name: getattr(TINY_LLAMA, f.name)
          for f in dataclasses.fields(TINY_LLAMA)}
    return shardings._local_class(type(TINY_LLAMA))(
        **kw, tp_group=object(), tp_rank=0, tp_size=2)


def test_chunk_graph_refuses_cpu_tp_and_moe():
    tq = _quantizers(TINY_LLAMA, "nuq", 3)
    td = _config("nuq", 3, False, "slots", "flash")
    cache = tcache.create_cache(td, 2, 1, device="cpu")
    blk = torch.zeros((1, CHUNK), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs a card"):
        engine.ChunkGraph(None, TINY_LLAMA, td, tq, cache, blk, S + CHUNK,
                          False)
    with pytest.raises(ValueError, match="tensor parallelism"):
        engine.ChunkGraph(None, _tp2(), td, tq, cache, blk, S + CHUNK, False)
    # the MoE family captures; off the card it is refused for the card
    with pytest.raises(ValueError, match="needs a card"):
        engine.ChunkGraph(None, moe.TINY_MOE, td, tq, cache, blk, S + CHUNK,
                          False)
    assert not engine.chunk_graphable(cache, TINY_LLAMA)
    assert not engine.chunk_graphable(cache, moe.TINY_MOE)
    held = serve.AdmissionCache(None, TINY_LLAMA, td, tq, "cpu")
    assert not held.graphed


def test_baseline_graph_refuses_cpu_tp_and_moe():
    cache = tbase.create_fp16_cache(TINY_LLAMA, 16, 1, device="cpu")
    with pytest.raises(ValueError, match="needs a card"):
        tbase.DecodeGraph(None, TINY_LLAMA, cache)
    with pytest.raises(ValueError, match="tensor parallelism"):
        tbase.DecodeGraph(None, _tp2(), cache)
    with pytest.raises(ValueError, match="needs a card"):
        tbase.DecodeGraph(None, moe.TINY_MOE, cache)
