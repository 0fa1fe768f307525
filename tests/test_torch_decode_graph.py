"""The port's decode step at device positions (kvquant_tpu_torch/ops/
{packing,deployed}.py, engine.py) and the bookkeeping of its CUDA graph,
against the JAX package on the same numpy inputs:

  - append_token_flash and decode_attention with (B,) position tensors
    against the host-int row writes (packing.set_token_codes /
    set_token_rows at host positions, bitwise) and against JAX's functions
    (caches as tests/test_torch_nuq.py compares them, the xla attention
    within 1e-5): codes nuq 2/3/4, int4, int8, int4x2 x pre / post-RoPE K
    x slot / static-channel outliers x B 1 (positions 0, S-1, S, mid,
    capacity end) and B 3 (per-sample positions that straddle the sink),
    over a prefilled cache, so that a predicated row keeps a live value;
  - decode_step trajectories at device positions through the four kernels
    against JAX's generate (greedy tokens) and deployed_ppl on the same
    storage (TINY_LLAMA, TINY_GQA);
  - no host read in any path's step: decode_step under a TorchDispatchMode
    that fails on aten._local_scalar_dense (``.item()``, ``int()``,
    ``bool()``), with Tensor.tolist / numpy / cpu patched to raise; the
    kernels' plain versions, which never run on the card's path, are
    exempt;
  - DecodeGraph refuses the CPU and tp > 1, and takes the MoE family
    (``graph_unsupported`` is None for it); the launch
    counters' record-and-add logic (ops.kernels.counted / add_launches)
    with a stub capture, since a replay cannot run here;
  - a step at position S, DecodeGraph's warm-up, leaves the cache bitwise
    as it found it once ``ops.deployed.first_row_keeper`` puts back what
    it wrote;
  - the static K channels (cache.static_channels) == k_channel_index ==
    JAX's k_channel_onehot, ties included; a step builder
    (engine.decode_stepper) computes them once and its steps sort no more.

A CUDA graph's capture and replay run only on a card (chip_smoke.py phase
28).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kvquant_tpu import cache as jcache
from kvquant_tpu import engine as jeng
from kvquant_tpu.models import init_params as jinit
from kvquant_tpu.models.config import TINY_LLAMA as J_TINY, TINY_GQA as J_GQA
from kvquant_tpu.ops import deployed as jdep, packing as jpk

from kvquant_tpu_torch import cache as tcache, engine
from kvquant_tpu_torch.models import params_from_numpy
from kvquant_tpu_torch.models.config import TINY_LLAMA, TINY_GQA
from kvquant_tpu_torch.ops import deployed as tdep, packing as tpk
from kvquant_tpu_torch.ops import kernels as tkernels
from kvquant_tpu_torch.ops.kernels import attention as at
from kvquant_tpu_torch.ops.kernels import flash_decode as fd
from kvquant_tpu_torch.ops.kernels import flash_serial as fs
from kvquant_tpu_torch.ops.kernels import moe_experts as mx

torch.set_num_threads(1)

FIELDS = ("k_planes", "v_planes", "kv_out", "v_scale", "v_offset", "k_sink",
          "v_sink")
CODES = {"nuq2": ("nuq", 2), "nuq3": ("nuq", 3), "nuq4": ("nuq", 4),
         "int4": ("int4", 4), "int8": ("int8", 8), "int4x2": ("int4x2", 2)}
OUTLIERS = {"slots": dict(k_outliers="slots", cap_per_side=2),
            "channels": dict(k_outliers="channels", n_kc=3, cap_per_side=2)}
S, MAX_LEN = 5, 300  # capacity 512 packed tokens
T0 = 40  # prefilled tokens


def _eq(got, want, name=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=name)


def _quantizers(mcfg, codes, bits, seed=0, v_ends=False):
    """Random per-channel K ranges, codebooks (affine for the integer
    containers) and K residual scores, for both packages. ``v_ends``: the
    nuq V codebook's ends sit at -1 and 1, where each token's own V range
    puts its extremes (ROADMAP queue 3)."""
    rng = np.random.default_rng(seed)
    L, C = mcfg.n_layers, mcfg.n_kv_heads * mcfg.d_head
    up = (np.abs(rng.standard_normal((L, C))) * 2 + 1).astype(np.float32)
    lo = (-up * 0.9).astype(np.float32)
    K = 2 ** bits
    if codes == "nuq":
        kl = np.sort(rng.uniform(-1, 1, (L, K)), axis=1).astype(np.float32)
        vl = np.sort(rng.uniform(-1, 1, (L, K)), axis=1).astype(np.float32)
        if v_ends:
            vl[:, 0], vl[:, -1] = -1.0, 1.0
    else:
        kl = np.stack([np.linspace(-1, 1, K, dtype=np.float32)] * L)
        vl = kl.copy()
    Hkv, D = mcfg.n_kv_heads, mcfg.d_head
    dq = dict(k_range=((up - lo) / 2).reshape(L, Hkv, D),
              k_offset=((up + lo) / 2).reshape(L, Hkv, D), k_lower=lo,
              k_upper=up, k_lut_enc=kl, k_lut_dec=kl * np.float32(1.01),
              v_lut_enc=vl, v_lut_dec=vl,
              k_ressc=rng.random((L, C)).astype(np.float32))
    return (jcache.DeployedQuant(**{k: jnp.asarray(v) for k, v in dq.items()}),
            tcache.DeployedQuant(**{k: torch.as_tensor(v)
                                    for k, v in dq.items()}))


def _configs(codes, bits, post, outliers, kernel="xla", mcfg=TINY_LLAMA,
             hg=2):
    kw = dict(bits=bits, n_kv_heads=mcfg.n_kv_heads, d_head=mcfg.d_head,
              max_len=MAX_LEN, sink=S, head_group=hg, codes=codes,
              post_rope_k=post, dot_bf16=False, kernel=kernel,
              **OUTLIERS[outliers])
    return jcache.DeployConfig.create(**kw), tcache.DeployConfig.create(**kw)


def _compare_jax(tc: dict, jc: dict, td, jd, tag):
    """Stacked arrays against JAX's: bitwise, code containers as unsigned
    codes, except where the keys are roped (torch.pow and jnp.power may
    round a RoPE frequency apart by an ulp, 4.8e-7 at keys of magnitude up
    to 8 whatever the element's own size): the sink keys and post-RoPE
    static-channel residuals within 1e-6, post-RoPE K slot words at the
    word's value granularity (rtol 2**-13), their indices exactly."""
    spk = td.slots_per_kind
    for f in FIELDS:
        got, want = tc[f], np.asarray(jc[f])
        if f in ("k_planes", "v_planes") and td.codes != "nuq":
            got, want = tdep._stored_codes(got, td), np.asarray(
                jdep._stored_codes(jc[f], jd))
        if f == "k_sink":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{tag} {f}")
        elif f == "kv_out":
            got, want = got.numpy(), want
            _eq(got[..., spk:, :].view(np.int32),
                want[..., spk:, :].view(np.int32), f"{tag} V rows")
            gk, wk = got[..., :spk, :], want[..., :spk, :]
            if not td.post_rope_k:
                _eq(gk.view(np.int32), wk.view(np.int32), f"{tag} K rows")
            elif td.k_outliers == "channels":
                np.testing.assert_allclose(gk, wk, rtol=1e-6, atol=1e-6,
                                           err_msg=f"{tag} K rows")
            else:
                gv, gi = tpk.decode_outlier_words(torch.as_tensor(gk))
                wv, wi = jpk.decode_outlier_words(jnp.asarray(wk))
                _eq(gi, wi, f"{tag} K slot indices")
                np.testing.assert_allclose(gv.numpy(), np.asarray(wv),
                                           rtol=2 ** -13, atol=0,
                                           err_msg=f"{tag} K slot values")
        else:
            _eq(got, want, f"{tag} {f}")


def _bitwise(a: dict, b: dict, tag):
    for f in FIELDS:
        x, y = a[f], b[f]
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{tag} {f}"


def _host_int_append(arrs, lq, td, mcfg, k, v, pl, li):
    """The row writes at host integer positions (one per sample, through
    packing's host-int paths), of the values the port quantizes."""
    B = k.shape[0]
    cos, sin = tdep.rope_cos_sin(torch.tensor(pl, dtype=torch.int32), mcfg)
    ck, cv, kw, vw, vs, vo, kr, vh = tdep._quantize_token(lq, td, mcfg, k, v,
                                                          cos, sin)
    spk, Tc = td.slots_per_kind, td.cache_tokens
    for b in range(B):
        ok = pl[b] >= S
        p = min(max(pl[b] - S, 0), Tc - 1)
        for name, codes in (("k_planes", ck), ("v_planes", cv)):
            if td.codes == "nuq":
                tpk.set_token_codes(arrs[name][li, b], codes[b], p, ok)
            else:
                tpk.set_token_rows(arrs[name][li, b],
                                   tdep._encode_rows(codes[b], td), p, ok)
        if ok:
            arrs["kv_out"][li, b, :, :spk, p] = kw[b]
            if vw is not None:
                arrs["kv_out"][li, b, :, spk:spk + vw.shape[-1], p] = vw[b]
            arrs["v_scale"][li, b, p] = vs[b]
            arrs["v_offset"][li, b, p] = vo[b]
        else:
            arrs["k_sink"][li, b, :, pl[b]] = kr[b]
            arrs["v_sink"][li, b, :, pl[b]] = vh[b]


def _positions(B):
    if B == 1:
        return [[0], [S - 1], [S], [S + 200], [S + 511]]
    return [[S - 1, S, S + 150], [0, S + 511, S + 37]]


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("outliers", list(OUTLIERS))
@pytest.mark.parametrize("post", [False, True], ids=["pre", "post"])
@pytest.mark.parametrize("code", list(CODES))
def test_device_position_writes(code, post, outliers, B):
    codes, bits = CODES[code]
    jq, tq = _quantizers(TINY_LLAMA, codes, bits)
    jd, td = _configs(codes, bits, post, outliers)
    rng = np.random.default_rng(B * 7 + post)
    C, H, D, li = 64, TINY_LLAMA.n_heads, TINY_LLAMA.d_head, 1
    k = (rng.standard_normal((B, T0, C)) * 1.5).astype(np.float32)
    v = rng.standard_normal((B, T0, C)).astype(np.float32)
    jc = jcache.create_cache(jd, 2, B)
    tc = tcache.create_cache(td, 2, B, device="cpu")
    jl = jdep.prefill_pack(jc.layer(li), jq.layer(li), jd, J_TINY,
                           jnp.asarray(k), jnp.asarray(v))
    tdep.prefill_pack(tc.layer(li), tq.layer(li), td, TINY_LLAMA,
                      torch.as_tensor(k), torch.as_tensor(v))
    jbase = {f: getattr(jc, f).at[li].set(getattr(jl, f)) for f in FIELDS}
    tbase = tc.arrays()
    _compare_jax(tbase, jbase, td, jd, "prefill")

    for pl in _positions(B):
        tag = f"pos {pl}"
        kn = (rng.standard_normal((B, C)) * 1.5).astype(np.float32)
        vn = rng.standard_normal((B, C)).astype(np.float32)
        q = rng.standard_normal((B, H, D)).astype(np.float32)
        kt, vt = torch.as_tensor(kn), torch.as_tensor(vn)
        pos = torch.tensor(pl, dtype=torch.int32)

        dev = {f: a.clone() for f, a in tbase.items()}
        tdep.append_token_flash(dev, tq.layer(li), td, TINY_LLAMA, kt, vt,
                                pos, li)
        host = {f: a.clone() for f, a in tbase.items()}
        _host_int_append(host, tq.layer(li), td, TINY_LLAMA, kt, vt, pl, li)
        _bitwise(dev, host, f"{tag} device vs host-int")
        jarrs = jdep.append_token_flash(
            dict(jbase), jq.layer(li), jd, J_TINY, jnp.asarray(kn),
            jnp.asarray(vn), jnp.asarray(pl, jnp.int32), jnp.int32(li))
        _compare_jax(dev, jarrs, td, jd, f"{tag} append_token_flash")

        # decode_attention on the layer views: the same rows, then attention
        layer = tcache.KVCache(length=torch.zeros(B, dtype=torch.int32),
                               **{f: a.clone() for f, a in tbase.items()})
        _, out = tdep.decode_attention(layer.layer(li), tq.layer(li), td,
                                       TINY_LLAMA, torch.as_tensor(q), kt,
                                       vt, pos)
        _bitwise(layer.arrays(), dev, f"{tag} decode_attention vs append")
        assert layer.length.tolist() == [p + 1 for p in pl]
        jlay = jcache.KVCache(length=jnp.zeros(B, jnp.int32),
                              **{f: jbase[f][li] for f in FIELDS})
        jlay, jout = jdep.decode_attention(
            jlay, jq.layer(li), jd, J_TINY, jnp.asarray(q), jnp.asarray(kn),
            jnp.asarray(vn), jnp.asarray(pl, jnp.int32))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=1e-5, err_msg=tag)


def test_uniform_position_tensor_equals_int():
    """A () position tensor, an int and B equal ints write the same rows."""
    jq, tq = _quantizers(TINY_LLAMA, "nuq", 3)
    _, td = _configs("nuq", 3, False, "slots")
    rng = np.random.default_rng(3)
    kt = torch.as_tensor(rng.standard_normal((2, 64)).astype(np.float32))
    vt = torch.as_tensor(rng.standard_normal((2, 64)).astype(np.float32))
    outs = []
    for pos in (133, torch.tensor(133, dtype=torch.int32), [133, 133]):
        arrs = tcache.create_cache(td, 2, 2, device="cpu").arrays()
        tdep.append_token_flash(arrs, tq.layer(0), td, TINY_LLAMA, kt, vt,
                                pos, 0)
        outs.append(arrs)
    _bitwise(outs[0], outs[1], "() tensor")
    _bitwise(outs[0], outs[2], "list")


# ---------------------------------------------------------------------------
# decode_step trajectories at device positions against JAX
# ---------------------------------------------------------------------------


STORAGES = {  # name -> (codes, bits, post-RoPE K, outliers), the port's kernels
    "nuq3": (("nuq", 3, False, "slots"), ("flash", "pallas", "xla")),
    "int4": (("int4", 4, True, "channels"), ("flash_serial", "xla")),
}
B_TRAJ, PROMPT, STEPS = 2, 12, 10


def _model(which, storage, kernel, v_ends=False):
    jcfg, tcfg = (J_TINY, TINY_LLAMA) if which == "mha" else (J_GQA, TINY_GQA)
    codes, bits, post, outliers = STORAGES[storage][0]
    jq, tq = _quantizers(tcfg, codes, bits, seed=5, v_ends=v_ends)
    jd, td = _configs(codes, bits, post, outliers, kernel, tcfg)
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    return (params, jcfg, jd, jq), (tparams, tcfg, td, tq)


PPL_TOKS = np.random.default_rng(4).integers(0, 256, (1, 24), np.int32)


@functools.lru_cache(maxsize=None)
def _jax_reference(which, storage, v_ends=False):
    """JAX's greedy generate tokens and deployed_ppl through its xla
    datapath, its oracle (JAX's flash path departs from its own xla path
    at TINY_GQA's d_head 8 by 0.02 in the first step's logits)."""
    jm, _ = _model(which, storage, "xla", v_ends)
    prompt = np.random.default_rng(2).integers(0, 256, (B_TRAJ, PROMPT),
                                               np.int32)
    toks, _ = jeng.generate(*jm, jnp.asarray(prompt),
                            jeng.GenerateConfig(max_new_tokens=STEPS))
    return prompt, np.asarray(toks), jeng.deployed_ppl(
        *jm, jnp.asarray(PPL_TOKS))


@functools.lru_cache(maxsize=None)
def _port_ppl(which, storage, kernel, v_ends=False):
    _, (params, cfg, td, tq) = _model(which, storage, kernel, v_ends)
    return engine.deployed_ppl(params, cfg, td, tq, torch.as_tensor(PPL_TOKS),
                               device="cpu")


@pytest.mark.parametrize("storage,kernel", [(s, k) for s, (_, ks)
                                            in STORAGES.items() for k in ks])
@pytest.mark.parametrize("which", ["mha", "gqa"])
def test_trajectory_at_device_positions_matches_jax(which, storage, kernel):
    """Prefill of 12 tokens, then 10 greedy steps driven through
    decode_step with (B,) int32 position tensors == JAX's generate; the
    port's deployed_ppl within 1e-5 of its other paths' on the same
    random codebooks, and within 1e-3 of JAX's on codebooks whose V ends
    sit at -1 and 1. (With random V ends, an ulp of matmul rounding that
    moves a token's extreme across the outlier threshold |x_norm| = 1
    changes its residual by ~0.15, and JAX's own paths part by 0.02 in
    logits: ROADMAP queue 3.)"""
    prompt, want, _ = _jax_reference(which, storage)
    _, (params, cfg, td, tq) = _model(which, storage, kernel)
    B, P = prompt.shape
    cache = tcache.create_cache(td, cfg.n_layers, B, device="cpu")
    cache, logits = engine.prefill(params, cfg, td, tq, cache,
                                   torch.as_tensor(prompt))
    got = []
    for i in range(STEPS):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        got.append(tok.numpy())
        pos = torch.full((B,), P + i, dtype=torch.int32)
        cache, logits = engine.decode_step(params, cfg, td, tq, cache, tok,
                                           pos)
    np.testing.assert_array_equal(np.stack(got, axis=1), want)
    assert cache.length.tolist() == [P + STEPS] * B
    tppl = _port_ppl(which, storage, kernel)
    for other in STORAGES[storage][1]:
        oppl = _port_ppl(which, storage, other)
        assert abs(tppl - oppl) <= 1e-5 * oppl, (kernel, tppl, other, oppl)
    jppl = _jax_reference(which, storage, v_ends=True)[2]
    tppl = _port_ppl(which, storage, kernel, v_ends=True)
    assert abs(tppl - jppl) <= 1e-3 * jppl, (tppl, jppl)


# ---------------------------------------------------------------------------
# no host read in a decode step
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


GUARDED = {  # kernel -> (codes, bits, post-RoPE K, outliers)
    "flash": [("nuq", 3, False, "slots"), ("int4x2", 2, True, "channels")],
    "flash_serial": [("int4", 4, True, "channels"),
                     ("int8", 8, True, "slots")],
    "pallas": [("nuq", 3, False, "slots")],
    "xla": [("nuq", 2, False, "channels"), ("int4", 4, True, "slots")],
}


@pytest.mark.parametrize("kernel,case", [(k, c) for k, cs in GUARDED.items()
                                         for c in cs])
def test_decode_step_makes_no_host_read(kernel, case, monkeypatch):
    codes, bits, post, outliers = case
    cfg = TINY_LLAMA
    _, tq = _quantizers(cfg, codes, bits, seed=1)
    _, td = _configs(codes, bits, post, outliers, kernel, cfg)
    params = params_from_numpy(jax.tree.map(
        np.asarray, jinit(jax.random.PRNGKey(1), J_TINY,
                          dtype=jnp.float32)), cfg, device="cpu")
    B = 3
    cache = tcache.create_cache(td, cfg.n_layers, B, device="cpu")
    tok = torch.tensor([3, 7, 11], dtype=torch.int32)
    # the first step checks the codebooks once (a host read per
    # DeployedQuant, outside the step that a graph captures)
    engine.decode_step(params, cfg, td, tq, cache, tok,
                       torch.tensor([0, 1, 2], dtype=torch.int32))
    for mod, name in ((fd, "flash_attention_ref"),
                      (fs, "flash_serial_decode_ref"),
                      (at, "qk_fused_ref"), (at, "pv_fused_ref")):
        monkeypatch.setattr(mod, name, _exempt(getattr(mod, name)))
    for name in ("tolist", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, _raise_if_not_exempt(
            name, getattr(torch.Tensor, name)))
    with _NoHostRead():
        for pl in ([S - 1, S, S + 200], [S + 1, S + 1, S + 1]):
            _, logits = engine.decode_step(
                params, cfg, td, tq, cache, tok,
                torch.tensor(pl, dtype=torch.int32))
        with pytest.raises(AssertionError, match="host read"):
            bool(logits.sum() > 0)  # the guard sees a host read
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# DecodeGraph: what it refuses; the launch counters under replay
# ---------------------------------------------------------------------------


def test_decode_graph_refuses_cpu_tp_and_moe():
    from kvquant_tpu_torch.models import moe
    from kvquant_tpu_torch.parallel import shardings

    _, tq = _quantizers(TINY_LLAMA, "nuq", 3)
    _, td = _configs("nuq", 3, False, "slots", "flash")
    cache = tcache.create_cache(td, 2, 1, device="cpu")
    with pytest.raises(ValueError, match="needs a card"):
        engine.DecodeGraph(None, TINY_LLAMA, td, tq, cache)
    kw = {f.name: getattr(TINY_LLAMA, f.name)
          for f in dataclasses.fields(TINY_LLAMA)}
    tp2 = shardings._local_class(type(TINY_LLAMA))(
        **kw, tp_group=object(), tp_rank=0, tp_size=2)
    assert "tensor parallelism" in engine.graph_unsupported(tp2)
    with pytest.raises(ValueError, match="tensor parallelism"):
        engine.DecodeGraph(None, tp2, td, tq, cache)
    # the MoE family captures (its dispatch reads nothing back); off the
    # card it is refused for the card alone
    for cfg in (TINY_LLAMA, moe.TINY_MOE):
        assert engine.graph_unsupported(cfg) is None
    with pytest.raises(ValueError, match="needs a card"):
        engine.DecodeGraph(None, moe.TINY_MOE, td, tq, cache)
    # the CPU path steps through decode_step
    step = engine.decode_stepper(None, TINY_LLAMA, td, tq, cache)
    assert not isinstance(step, engine.DecodeGraph)


def test_launch_counters_record_and_replay(monkeypatch):
    """``counted`` returns a stub capture's counter increase and sets the
    counters back; ``add_launches`` adds it once per replay, K2's
    per-body counts and K1's chunk count included."""
    monkeypatch.setattr(fd.flash_attention, "launches", 5)
    monkeypatch.setattr(fd.flash_attention, "chunk_launches", 1)
    monkeypatch.setattr(fs.flash_serial_decode, "launches", 2)
    monkeypatch.setattr(fs.flash_serial_decode, "route_launches",
                        {"fs_mma": 2, "fs_partial": 0})
    monkeypatch.setattr(at.qk_fused, "launches", 0)
    monkeypatch.setattr(at.pv_fused, "launches", 0)
    monkeypatch.setattr(mx.moe_experts, "launches", 0)

    def stub_capture():  # what the wrappers count while a graph captures
        fd.flash_attention.launches += 3
        fs.flash_serial_decode.launches += 2
        fs.flash_serial_decode.route_launches["fs_mma"] += 2
        at.qk_fused.launches += 1
        at.pv_fused.launches += 1
        mx.moe_experts.launches += 2
        return "logits"

    before = tkernels.snapshot()
    out, delta = tkernels.counted(stub_capture)
    assert out == "logits"
    assert delta == {"K1": 3, "K2": 2, "K2:fs_mma": 2, "K3": 1, "K4": 1,
                     "moe_experts": 2}
    assert tkernels.snapshot() == before  # a capture launches nothing
    for _ in range(4):  # four replays
        tkernels.add_launches(delta)
    assert tkernels.launch_counts() == {"K1": 17, "K2": 10, "K3": 4,
                                        "K4": 4, "K5": before["K5"],
                                        "moe_experts": 8}
    assert fs.flash_serial_decode.route_launches == {"fs_mma": 10,
                                                     "fs_partial": 0}
    assert fd.flash_attention.chunk_launches == 1

    def failing():
        fd.flash_attention.launches += 1
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        tkernels.counted(failing)
    assert fd.flash_attention.launches == 17  # set back after a failure


# ---------------------------------------------------------------------------
# the graph's warm-up over the cache itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,case", [(k, c) for k, cs in GUARDED.items()
                                         for c in cs])
def test_warmup_rows_put_back(kernel, case):
    """A decode step at position S, the warm-up step of DecodeGraph, writes
    nothing that ``first_row_keeper`` does not put back: after it the
    cache equals, bitwise, the prefilled cache it started from."""
    codes, bits, post, outliers = case
    cfg = TINY_LLAMA
    _, tq = _quantizers(cfg, codes, bits, seed=2)
    _, td = _configs(codes, bits, post, outliers, kernel, cfg)
    params = params_from_numpy(jax.tree.map(
        np.asarray, jinit(jax.random.PRNGKey(2), J_TINY,
                          dtype=jnp.float32)), cfg, device="cpu")
    B = 2
    cache = tcache.create_cache(td, cfg.n_layers, B, device="cpu")
    prompt = torch.as_tensor(np.random.default_rng(6).integers(
        0, 256, (B, T0), np.int32))
    engine.prefill(params, cfg, td, tq, cache, prompt)
    before = tcache.KVCache(**{f.name: getattr(cache, f.name).clone()
                               for f in dataclasses.fields(cache)})
    restore = tdep.first_row_keeper(cache)
    engine.decode_step(params, cfg, td, tq, cache,
                       torch.tensor([9, 4], dtype=torch.int32),
                       torch.full((B,), S, dtype=torch.int32))
    assert cache.length.tolist() == [S + 1] * B
    written = [f for f in FIELDS if not torch.equal(getattr(cache, f),
                                                    getattr(before, f))]
    assert {"k_planes", "v_planes", "v_scale"} <= set(written)
    restore()
    _bitwise(cache.arrays(), before.arrays(), f"{kernel} {case}")
    assert torch.equal(cache.length, before.length)


# ---------------------------------------------------------------------------
# the static K channels, computed once by the step builder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hg,n_kc", [(1, 3), (2, 4), (4, 16)])
def test_channel_index_kept_once(hg, n_kc):
    rng = np.random.default_rng(hg)
    L, Hkv, D = 3, 4, 16
    ressc = rng.random((L, Hkv * D)).astype(np.float32)
    ressc[0] = 0.0  # all tied: the lower index first, as lax.top_k
    ressc[1, ::5] = ressc[1, 1]  # partial ties
    kw = dict(bits=3, n_kv_heads=Hkv, d_head=D, max_len=300,
              head_group=hg, k_outliers="channels", n_kc=n_kc)
    jd, td = jcache.DeployConfig.create(**kw), tcache.DeployConfig.create(**kw)
    zeros = np.zeros((L, Hkv * D), np.float32)
    dq = tcache.DeployedQuant(
        k_range=torch.ones(L, Hkv, D), k_offset=torch.zeros(L, Hkv, D),
        k_lower=torch.as_tensor(zeros), k_upper=torch.as_tensor(zeros),
        k_lut_enc=torch.zeros(L, 8), k_lut_dec=torch.zeros(L, 8),
        v_lut_enc=torch.zeros(L, 8), v_lut_dec=torch.zeros(L, 8),
        k_ressc=torch.as_tensor(ressc))
    idx = tcache.static_channels(dq, td)
    want = np.argmax(np.asarray(jcache.k_channel_onehot(
        jnp.asarray(ressc), jd)), axis=-1)
    _eq(idx, want)
    _eq(idx, tcache.k_channel_index(torch.as_tensor(ressc), td))
    assert tcache.static_channels(
        dq, dataclasses.replace(td, k_outliers="slots")) is None
    for li in range(L):  # a layer's slice is that layer's selection
        _eq(idx[li], tcache.k_channel_index(dq.layer(li).k_ressc, td))


@pytest.mark.parametrize("kernel", ["flash", "flash_serial", "xla"])
def test_step_builder_sorts_once(kernel, monkeypatch):
    """``decode_stepper`` computes the static K channels once; its steps
    sort no more, and give what a step that computes them gives."""
    codes, bits, post = ("int4", 4, True) if kernel == "flash_serial" \
        else ("nuq", 3, False)
    cfg = TINY_LLAMA
    _, tq = _quantizers(cfg, codes, bits, seed=3)
    _, td = _configs(codes, bits, post, "channels", kernel, cfg)
    params = params_from_numpy(jax.tree.map(
        np.asarray, jinit(jax.random.PRNGKey(3), J_TINY,
                          dtype=jnp.float32)), cfg, device="cpu")
    caches = [tcache.create_cache(td, cfg.n_layers, 1, device="cpu")
              for _ in range(2)]
    tok = torch.tensor([5], dtype=torch.int32)
    _, want = engine.decode_step(params, cfg, td, tq, caches[0], tok, 0)
    step = engine.decode_stepper(params, cfg, td, tq, caches[1])
    sorts = []
    for mod in (tcache, tdep, fd, fs):
        monkeypatch.setattr(mod, "k_channel_index",
                            lambda *a: sorts.append(a))
    got = step(tok, 0)
    assert not sorts
    _eq(got, want)
    _bitwise(caches[1].arrays(), caches[0].arrays(), kernel)
