"""The exact-density 2-bit container (codes="int4x2", two 2-bit codes per
nibble via head pairing) through the port's K1 (ops/kernels/flash_decode.py)
and the engine, against the JAX package (tests/test_int4x2.py's cases):

  - K1's plain version against JAX flash_attention (interpret mode) on
    random operands: pre/post-RoPE x channels / slots / no sparse x sink
    0/5 x head_group 2/4, decode at B=2 and unequal positions, a first and
    a later prefill chunk, a sliding window; the head_group % 2 refusal;
  - one decode step from the same warm cache (MHA / GQA x pre / post):
    kernel "flash" against JAX's "flash" and against the port's "xla";
  - the 2-bit speed config (post-RoPE, static K channels, no V slots) over
    a 40-step kernel="flash" trajectory against JAX's;
  - quantized chunked prefill through K1 against JAX's.

Tolerances: K1 grid atol = rtol = 1e-5 with fp32 dots (the sides sum in
different orders), 2e-2 with bf16 dots (the TPU kernel rounds q . k_step
and multiplies exact integer codes, the port rounds the dequantized key);
the single step atol 2e-4 / rtol 1e-4 and the trajectory median 5e-3 / max
0.25 / argmax 95%, JAX's own bounds for flash against xla
(tests/test_int4x2.py:112,125-128); quantized prefill logits atol 2e-3 /
rtol 1e-3 and the packed codes equal (tests/test_int4x2.py:142-148).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kvquant_tpu import engine as jeng
from kvquant_tpu.cache import (DeployConfig as JDeployConfig,
                               create_cache as jcreate,
                               deployed_from_quantizers as jdeployed)
from kvquant_tpu.models import TINY_LLAMA as J_TINY, TINY_GQA as J_GQA
from kvquant_tpu.models import init_params as jinit
from kvquant_tpu.models.config import ModelConfig as JModelConfig
from kvquant_tpu.ops import packing as jpk
from kvquant_tpu.ops.pallas.flash_decode import flash_attention as jax_fa
from kvquant_tpu.quant.artifacts import save_quantizers
from kvquant_tpu.quant.calibration import (collect_kv_activations,
                                           fit_quantizers)

from kvquant_tpu_torch import engine
from kvquant_tpu_torch.cache import (DeployConfig, KVCache, create_cache,
                                     deployed_from_quantizers)
from kvquant_tpu_torch.models import TINY_LLAMA, TINY_GQA, params_from_numpy
from kvquant_tpu_torch.models.config import ModelConfig
from kvquant_tpu_torch.ops import packing as tpk
from kvquant_tpu_torch.ops.kernels import flash_decode as fd
from kvquant_tpu_torch.quant.artifacts import load_quantizers

torch.set_num_threads(1)

L, B, Hkv, G, D = 2, 2, 4, 2, 16
Tc = 512


def _words(rng, shape, hg):
    """Encoded outlier slot words at random in-group (head, dim)."""
    vals = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    idx = (rng.integers(0, hg, shape) << 7) | rng.integers(0, D, shape)
    bits = vals.view(np.uint32)
    return ((bits & np.uint32(0xFFFFFE00)) | idx.astype(np.uint32)).view(
        np.float32)


def paired(codes):
    """Unsigned 2-bit codes (..., H, T, D) -> the JAX int4 container and the
    port's uint8 one, both (..., H/2, T, ·)."""
    c = np.swapaxes(codes, -3, -2)  # head axis -2 for the pairing
    j = jnp.moveaxis(jpk.pair_codes_int4x2(jnp.asarray(c)), -2, -3)
    t = torch.movedim(tpk.pair_codes_int4x2(torch.as_tensor(c)), -2, -3)
    return j, t.contiguous()


def jax_to_port_container(arr):
    """A JAX int4 container (..., D) -> the port's nibble pairs (..., D/2)."""
    return tpk.pack_nibbles(torch.as_tensor(np.array(arr.astype(jnp.int8))))


def _case(post, k_out, hg, sink, Tq=1, pos=(3, 300), window=None,
          dot_bf16=False, seed=0):
    kw = dict(bits=2, n_kv_heads=Hkv, d_head=D, max_len=Tc + sink, sink=sink,
              kernel="flash", dot_bf16=dot_bf16, head_group=hg,
              codes="int4x2", post_rope_k=post,
              k_outliers="channels" if k_out == "channels" else "slots",
              n_kc=3, include_sparse=k_out != "none",
              cap_per_side=2 if k_out == "slots" else 0)
    jd, td = JDeployConfig.create(**kw), DeployConfig.create(**kw)
    mk = dict(vocab_size=64, d_model=Hkv * G * D, n_layers=L,
              n_heads=Hkv * G, n_kv_heads=Hkv, d_head=D, d_ff=32,
              max_seq_len=Tc + 64, sliding_window=window)
    jm, tm = JModelConfig(**mk), ModelConfig(**mk)

    rng = np.random.default_rng(seed)
    jk, tk = paired(rng.integers(0, 4, (L, B, Hkv, Tc, D)))
    jv, tv = paired(rng.integers(0, 4, (L, B, Hkv, Tc, D)))
    NG, J, spk = Hkv // hg, td.n_slots, td.slots_per_kind
    if k_out == "channels":
        kv_out = (rng.standard_normal((L, B, NG, J, Tc)) * 0.1).astype(
            np.float32)
    else:
        kv_out = _words(rng, (L, B, NG, J, Tc), hg)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    arrays = dict(
        kv_out=kv_out,
        k_range=(rng.random((L, Hkv, D)) + 0.5).astype(np.float32),
        k_offset=f32(L, Hkv, D) * 0.1,
        v_scale=(rng.random((L, B, Tc)) + 0.5).astype(np.float32),
        v_offset=f32(L, B, Tc) * 0.1,
        k_sink=f32(L, B, Hkv, sink, D), v_sink=f32(L, B, Hkv, sink, D),
        k_lut=np.stack([np.linspace(-1, 1, 4, dtype=np.float32)] * L),
        v_lut=np.stack([np.linspace(-0.9, 1.1, 4, dtype=np.float32)] * L),
    )
    q = f32(B, Hkv, G * Tq, D)
    ressc = rng.random((L, Hkv * D)).astype(np.float32)
    pos = np.array(pos, np.int32)
    names = list(arrays)
    want = jax_fa(jnp.asarray(q), jk, jv,
                  *(jnp.asarray(arrays[n]) for n in names), jnp.int32(1),
                  jnp.asarray(pos), jd, jm, Tq=Tq, block_tokens=256,
                  k_ressc=jnp.asarray(ressc))
    got = fd.flash_attention(torch.as_tensor(q), tk, tv,
                             *(torch.as_tensor(arrays[n]) for n in names), 1,
                             torch.as_tensor(pos), td, tm, Tq=Tq,
                             k_ressc=torch.as_tensor(ressc))
    return np.asarray(want), got.numpy()


# (post_rope_k, k_outliers, head_group, sink, Tq, pos, window)
K1_CASES = {
    "pre-slots-hg4-sink5": (False, "slots", 4, 5, 1, (3, 300), None),
    "post-slots-hg4-sink0": (True, "slots", 4, 0, 1, (0, 511), None),
    "pre-channels-hg2-sink0": (False, "channels", 2, 0, 1, (3, 300), None),
    "post-channels-hg4-sink5": (True, "channels", 4, 5, 1, (40, 457), None),
    "pre-none-hg2-sink5": (False, "none", 2, 5, 1, (3, 300), None),
    "post-none-hg2-sink0": (True, "none", 2, 0, 1, (130, 300), None),
    "pre-window": (False, "slots", 4, 5, 1, (300, 457), 64),
    "post-first-chunk": (True, "channels", 2, 5, 133, (0, 0), None),
    "pre-first-chunk": (False, "slots", 4, 5, 133, (0, 0), None),
    "post-later-chunk": (True, "slots", 2, 5, 128, (133, 261), None),
    "pre-later-chunk": (False, "channels", 4, 0, 128, (128, 256), None),
    "post-chunk-window": (True, "channels", 2, 5, 128, (261, 261), 100),
}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_plain_matches_jax_kernel(case):
    want, got = _case(*K1_CASES[case])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("post,Tq,pos", [(True, 1, (3, 300)),
                                         (False, 128, (133, 261))],
                         ids=["post-decode", "pre-chunk"])
def test_k1_plain_matches_jax_kernel_bf16_dots(post, Tq, pos):
    want, got = _case(post, "channels", 4, 5, Tq=Tq, pos=pos, dot_bf16=True)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_k1_refuses_odd_head_group():
    """The kernel pairs kv heads within a head group (JAX asserts the same,
    flash_decode.py:911); on the CPU nothing launches."""
    d = DeployConfig.create(bits=2, n_kv_heads=Hkv, d_head=D, max_len=261,
                            sink=5, kernel="flash", head_group=1,
                            codes="int4x2", post_rope_k=True)
    m = ModelConfig(vocab_size=64, d_model=Hkv * G * D, n_layers=L,
                    n_heads=Hkv * G, n_kv_heads=Hkv, d_head=D, d_ff=32,
                    max_seq_len=512)
    z = torch.zeros((B, Hkv, G, D))
    with pytest.raises(AssertionError, match="pairs heads"):
        fd.flash_decode(z, None, None, None, None, None, None, None, None,
                        None, None, None, 0, torch.zeros(B, dtype=torch.int32),
                        d, m)
    assert fd.flash_attention.launches == 0


# ---------------------------------------------------------------------------
# the engine: decode steps and quantized prefill through K1
# ---------------------------------------------------------------------------


def _setup(jcfg, tcfg, tmp_path):
    """Random fp32 model and uniform 2-bit quantizers fitted by the JAX
    package (tests/test_int4x2.py:_setup), handed to the port as an npz."""
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    cal = jax.random.randint(jax.random.PRNGKey(7), (2, 40), 0,
                             jcfg.vocab_size)
    k_acts, v_acts = collect_kv_activations(params, jcfg, [cal])
    qs = fit_quantizers(k_acts, v_acts, bits=2, sparsity_threshold=0.99,
                        cap_outliers=True, first_few_fp16=5, sample_seqlen=40,
                        kmeans_iters=10, mode="uniform")
    path = str(tmp_path / "q.npz")
    save_quantizers(path, qs)
    tq = deployed_from_quantizers(load_quantizers(path), tcfg.n_kv_heads,
                                  tcfg.d_head, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    return (params, jdeployed(qs, jcfg.n_kv_heads, jcfg.d_head)), (tparams, tq)


def _cfgs(jcfg, kernel, max_len=69, **kw):
    d = dict(bits=2, n_kv_heads=jcfg.n_kv_heads, d_head=jcfg.d_head,
             max_len=max_len, sink=5, kernel=kernel, dot_bf16=False,
             codes="int4x2", head_group=2, **kw)
    return JDeployConfig.create(**d), DeployConfig.create(**d)


def _jax_decode(params, cfg, dcfg, dq, tokens):
    cache = jcreate(dcfg, cfg.n_layers, 1)
    step = jax.jit(lambda c, tok, pos: jeng.decode_step(params, cfg, dcfg, dq,
                                                        c, tok, pos))
    outs = []
    for t in range(tokens.shape[1]):
        cache, logits = step(cache, jnp.asarray(tokens[:, t]), jnp.int32(t))
        outs.append(np.asarray(logits))
    return cache, np.stack(outs, axis=1)


def _port_decode(params, cfg, dcfg, dq, tokens, cache=None, t0=0):
    cache = cache or create_cache(dcfg, cfg.n_layers, 1, device="cpu")
    outs = []
    for t in range(tokens.shape[1]):
        cache, logits = engine.decode_step(params, cfg, dcfg, dq, cache,
                                           torch.as_tensor(tokens[:, t]),
                                           t0 + t)
        outs.append(logits.numpy())
    return cache, np.stack(outs, axis=1)


def _port_cache(jc) -> KVCache:
    """The port's copy of a JAX cache: the same codes, slots and ranges."""
    arr = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    return KVCache(k_planes=jax_to_port_container(jc.k_planes),
                   v_planes=jax_to_port_container(jc.v_planes),
                   kv_out=arr(jc.kv_out), v_scale=arr(jc.v_scale),
                   v_offset=arr(jc.v_offset), k_sink=arr(jc.k_sink),
                   v_sink=arr(jc.v_sink), length=arr(jc.length))


@pytest.mark.parametrize("which", ["mha", "gqa"])
@pytest.mark.parametrize("post", [False, True], ids=["prerope", "postrope"])
def test_single_step_from_warm_cache(which, post, tmp_path):
    """A 20-token cache written by JAX's xla path, copied into the port;
    one more token through kernel "flash" on both sides, and through the
    port's "xla"."""
    jcfg, tcfg = (J_TINY, TINY_LLAMA) if which == "mha" else (J_GQA, TINY_GQA)
    (jp, jq), (tp, tq) = _setup(jcfg, tcfg, tmp_path)
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(5), (1, 21), 0,
                                           jcfg.vocab_size))
    jx, _ = _cfgs(jcfg, "xla", post_rope_k=post)
    jc, _ = _jax_decode(jp, jcfg, jx, jq, tokens[:, :20])
    jf, tf = _cfgs(jcfg, "flash", post_rope_k=post)
    _, want = jeng.decode_step(jp, jcfg, jf, jq, jc, jnp.asarray(tokens[:, 20]),
                               jnp.int32(20))
    outs = {}
    for kernel in ("flash", "xla"):
        _, outs[kernel] = engine.decode_step(
            tp, tcfg, dataclasses.replace(tf, kernel=kernel), tq,
            _port_cache(jc), torch.as_tensor(tokens[:, 20]), 20)
    np.testing.assert_allclose(outs["flash"].numpy(), np.asarray(want),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(outs["flash"].numpy(), outs["xla"].numpy(),
                               atol=2e-4, rtol=1e-4)


def test_speed_config_trajectory(tmp_path):
    """The 2-bit speed config (post-RoPE K, static-channel K outliers, no V
    slots) over 40 kernel="flash" steps, against JAX's flash trajectory and
    the port's xla one, with JAX's flash-vs-xla bounds."""
    (jp, jq), (tp, tq) = _setup(J_TINY, TINY_LLAMA, tmp_path)
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, 40), 0,
                                           J_TINY.vocab_size))
    speed = dict(post_rope_k=True, k_outliers="channels", n_kc=2,
                 cap_per_side=0)
    jf, tf = _cfgs(J_TINY, "flash", **speed)
    _, want = _jax_decode(jp, J_TINY, jf, jq, tokens)
    _, got = _port_decode(tp, TINY_LLAMA, tf, tq, tokens)
    _, xla = _port_decode(tp, TINY_LLAMA,
                          dataclasses.replace(tf, kernel="xla"), tq, tokens)
    for other in (want, xla):
        diff = np.abs(got - other)
        assert np.quantile(diff, 0.5) < 5e-3, np.quantile(diff, 0.5)
        assert diff.max() < 0.25, diff.max()
        assert np.mean(np.argmax(got, -1) == np.argmax(other, -1)) > 0.95


def test_quantized_prefill_matches_jax(tmp_path):
    """150 tokens in chunks of 128 through K1 (a first chunk with the sink
    rows, then a later one), pre-RoPE slots, against JAX's kernel="flash"
    prefill: logits and the packed codes."""
    (jp, jq), (tp, tq) = _setup(J_TINY, TINY_LLAMA, tmp_path)
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(3), (1, 150), 0,
                                           J_TINY.vocab_size))
    jd, td = _cfgs(J_TINY, "flash", max_len=200)
    jc, jlog = jeng.prefill_quantized(jp, J_TINY, jd, jq,
                                      jcreate(jd, J_TINY.n_layers, 1),
                                      jnp.asarray(tokens), chunk=128)
    tc, tlog = engine.prefill_quantized(
        tp, TINY_LLAMA, td, tq, create_cache(td, TINY_LLAMA.n_layers, 1,
                                             device="cpu"),
        torch.as_tensor(tokens), chunk=128)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-3,
                               rtol=1e-3)
    n = 150 - td.sink
    for name in ("k_planes", "v_planes"):
        np.testing.assert_array_equal(
            getattr(tc, name).numpy()[..., :n, :],
            jax_to_port_container(getattr(jc, name)).numpy()[..., :n, :],
            err_msg=name)
    assert tc.length.tolist() == np.asarray(jc.length).tolist() == [150]
