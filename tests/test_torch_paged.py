"""Port of the paged KV cache and server (kvquant_tpu_torch/paged.py and the
plain version of the paged kernel K5, ops/kernels/paged_decode.py) against
the JAX package (kvquant_tpu/paged.py, its Pallas kernel run in interpret
mode on the CPU as tests/test_paged.py runs it), on the same numpy inputs,
P = 256:

  (a) paged_flash_decode_ref against JAX paged_flash_decode on random pool
      operands: nuq3 and int4 x pre/post-RoPE x slots/channels x sink 0/5,
      B = 3 at unequal positions, permuted pages, junk trailing table ids;
      int4x2 (the head-paired 2-bit container) with pre-RoPE keys the
      same way, with post-RoPE keys against JAX's contiguous
      flash_attention over the same tokens (JAX's paged kernel fails on
      its paired path: its scratch is sized for Q rows, not a pair's 2Q);
  (b) K5's plain version equals K1's plain version on the same tokens laid
      out contiguously (JAX's own ground truth, tests/test_paged.py:48);
  (c) paged_append_token and write_pages_from_cache bitwise equal to JAX's,
      with sink positions, a page-boundary crossing and an inactive slot
      aliasing another slot's pages: nuq3 and int4, then the int8 (3-bit),
      int4x2 and 2-bit int4 containers, each x pre / post-RoPE x slots /
      channels;
  (d) paged_decode_step logits against JAX over 6 steps that cross a page
      boundary, from a 258-token prefill copied into permuted pages;
  (e) the port's PagedServer (sync; chunked; bursts against per-step with
      EOS inside a burst; int4x2 pre / post-RoPE) token-identical to the
      port's isolated generate, with every page returned;
  (f) on the committed toy checkpoint, PagedServer tokens equal JAX
      engine.generate's (kernel="xla");
  (g) the step at device positions: paged_append_token with the table,
      positions and active mask as tensors bitwise equal to JAX's (nuq3,
      int4, int4x2 x sink 0 / 5; a sink-row slot, an inactive slot at an
      active slot's very page row and one a row further); paged_decode_step
      reads nothing back to the host, K5's plain version included; the
      greedy step (paged.PagedStep, the body PagedGraph captures on a
      card) with every slot inactive, its warm-up, leaves a live pool
      bitwise unchanged; PagedGraph refuses a CPU pool; PagedServer with
      bursts of 8 gives the JAX PagedServer's tokens, an EOS inside a
      burst included.

Tolerances: (a) atol = rtol = 1e-5 with fp32 dots, as
tests/test_torch_flash_decode.py (the sides sum in different orders);
with bf16 dot operands the sides round at different points (the TPU kernel
the probabilities against its running maximum and the slot corrections as
separate dots), 2e-2. (d) atol 3e-4 / rtol 1e-4, the decode-trajectory
tolerance of tests/test_torch_engine.py (fp32 matmul rounding), with
uniform codebooks (ROADMAP queue 3 explains why). (b), (c), (e), (f), (g):
exact.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kvquant_tpu import engine as jeng, paged as jpaged
from kvquant_tpu.cache import (DeployConfig as JDeployConfig,
                               DeployedQuant as JDeployedQuant,
                               create_cache as jcreate,
                               deployed_from_quantizers as jdeployed)
from kvquant_tpu.models import TINY_LLAMA as J_TINY, init_params as jinit
from kvquant_tpu.models.config import ModelConfig as JModelConfig
from kvquant_tpu.ops import packing as jpk
from kvquant_tpu.quant.artifacts import save_quantizers
from kvquant_tpu.quant.calibration import (collect_kv_activations,
                                           fit_quantizers)

from kvquant_tpu_torch import engine, paged
from kvquant_tpu_torch.cache import (DeployConfig, DeployedQuant,
                                     create_cache, deployed_from_quantizers,
                                     static_channels)
from kvquant_tpu_torch.models import TINY_LLAMA, params_from_numpy
from kvquant_tpu_torch.models.config import ModelConfig
from kvquant_tpu_torch.ops import packing as tpk
from kvquant_tpu_torch.ops.kernels import flash_decode as fd
from kvquant_tpu_torch.ops.kernels import paged_decode as pdk
from kvquant_tpu_torch.quant.artifacts import load_quantizers
from kvquant_tpu_torch.serve import Request

torch.set_num_threads(1)

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts")
PAGE = 256
L, Hkv, G, D = 2, 4, 2, 16
NP, MP = 6, 3
JUNK = 10 ** 6  # trailing table ids past the last live page: never read
# slot 0 inside page 0, slot 1 just past a page boundary, slot 2 deep in
# its last live page; pages permuted across the pool
TABLE = [[4, JUNK, JUNK], [1, 5, JUNK], [3, 0, 2]]
POS = [5 + 10, 5 + 256 + 3, 5 + 2 * 256 + 200]
BITS = {"nuq3": ("nuq", 3), "int4": ("int4", 4)}
INT4X2 = {"int4x2": ("int4x2", 2)}  # the head-paired 2-bit container


def _words(rng, shape, hg):
    vals = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    idx = (rng.integers(0, hg, shape) << 7) | rng.integers(0, D, shape)
    bits = vals.view(np.uint32)
    return ((bits & np.uint32(0xFFFFFE00)) | idx.astype(np.uint32)).view(
        np.float32)


def _configs(mode, post, k_out, sink, dot_bf16=False, hg=None):
    codes, bits = {**BITS, **INT4X2}[mode]
    hg = hg or (4 if k_out == "slots" else 2)
    kw = dict(bits=bits, n_kv_heads=Hkv, d_head=D, max_len=MP * PAGE + sink,
              sink=sink, kernel="flash", dot_bf16=dot_bf16, head_group=hg,
              codes=codes, post_rope_k=post, k_outliers=k_out, n_kc=3,
              cap_per_side=0 if k_out == "channels" else 2)
    jd = dataclasses.replace(JDeployConfig.create(**kw), page_tokens=PAGE)
    td = dataclasses.replace(DeployConfig.create(**kw), page_tokens=PAGE)
    mk = dict(vocab_size=64, d_model=Hkv * G * D, n_layers=L,
              n_heads=Hkv * G, n_kv_heads=Hkv, d_head=D, d_ff=32,
              max_seq_len=1024)
    return jd, td, JModelConfig(**mk), ModelConfig(**mk)


def _random_pool(td, B, rng):
    """Random pool operands as numpy: containers as (JAX, port) pairs."""
    codes, bits = td.codes, td.bits
    if codes == "nuq":
        shape = (L, NP, Hkv, bits, PAGE // 32, D)
        kp, vp = (rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
                  .astype(np.int32) for _ in range(2))
        planes = {"k_planes": (kp, kp), "v_planes": (vp, vp)}
    elif codes == "int4x2":
        planes = {}
        for name in ("k_planes", "v_planes"):
            # head axis -2 for the pairing, then the container's (H/2, P)
            c = rng.integers(0, 4, (L, NP, PAGE, Hkv, D))
            planes[name] = (
                np.moveaxis(np.asarray(jpk.pair_codes_int4x2(
                    jnp.asarray(c))), -2, -3),
                torch.movedim(tpk.pair_codes_int4x2(torch.as_tensor(c)), -2,
                              -3).contiguous().numpy())
    else:
        planes = {}
        for name in ("k_planes", "v_planes"):
            c = rng.integers(0, 2 ** bits, (L, NP, Hkv, PAGE, D))
            planes[name] = (
                np.asarray(jpk.store_codes_int(jnp.asarray(c), bits,
                                               jnp.int4)),
                tpk.store_codes_int(torch.as_tensor(c), bits,
                                    td.code_dtype).numpy())
    NG, J, spk = Hkv // td.head_group, td.n_slots, td.slots_per_kind
    if td.k_outliers == "channels":
        kv_out = (rng.standard_normal((L, NP, NG, J, PAGE)) * 0.1).astype(
            np.float32)
        kv_out[:, :, :, spk:] = _words(rng, (L, NP, NG, J - spk, PAGE),
                                       td.head_group)
    else:
        kv_out = _words(rng, (L, NP, NG, J, PAGE), td.head_group)
    S = td.sink
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    rest = dict(kv_out=kv_out,
                v_scale=(rng.random((L, NP, PAGE)) + 0.5).astype(np.float32),
                v_offset=f32(L, NP, PAGE) * 0.1,
                k_sink=f32(L, B, Hkv, S, D), v_sink=f32(L, B, Hkv, S, D))
    return planes, rest


def _random_dq(td, rng):
    K = 2 ** td.bits
    if td.codes == "nuq":
        luts = [np.sort(rng.uniform(-1, 1, (L, K)), axis=1).astype(np.float32)
                for _ in range(2)]
    else:
        luts = [np.stack([np.linspace(-1, 1, K, dtype=np.float32)] * L),
                np.stack([np.linspace(-0.9, 1.1, K, dtype=np.float32)] * L)]
    C = Hkv * D
    return dict(
        k_range=(rng.random((L, Hkv, D)) + 0.5).astype(np.float32),
        k_offset=(rng.standard_normal((L, Hkv, D)) * 0.1).astype(np.float32),
        k_lower=np.zeros((L, C), np.float32),
        k_upper=np.zeros((L, C), np.float32),
        k_lut_enc=luts[0], k_lut_dec=luts[0], v_lut_enc=luts[1],
        v_lut_dec=luts[1],
        k_ressc=rng.random((L, C)).astype(np.float32))


def _both(td, B, seed):
    rng = np.random.default_rng(seed)
    planes, rest = _random_pool(td, B, rng)
    dq = _random_dq(td, rng)
    jpool = jpaged.PagedPool(
        **{n: jnp.asarray(j) for n, (j, _) in planes.items()},
        **{n: jnp.asarray(a) for n, a in rest.items()})
    tpool = paged.PagedPool(
        **{n: torch.as_tensor(t) for n, (_, t) in planes.items()},
        **{n: torch.as_tensor(a) for n, a in rest.items()})
    jq = JDeployedQuant(**{k: jnp.asarray(v) for k, v in dq.items()})
    tq = DeployedQuant(**{k: torch.as_tensor(v) for k, v in dq.items()})
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    return (jpool, jq), (tpool, tq), q


def _k5(mode, post, k_out, sink, dot_bf16=False, seed=0):
    jd, td, jm, tm = _configs(mode, post, k_out, sink, dot_bf16)
    (jpool, jq), (tpool, tq), q = _both(td, 3, seed)
    table, pos = np.array(TABLE, np.int32), np.array(POS, np.int32)
    want = jpaged.paged_flash_decode(jnp.asarray(q), jpool,
                                     jnp.asarray(table), jq, jnp.int32(1),
                                     jnp.asarray(pos), jd, jm)
    got = pdk.paged_flash_decode(torch.as_tensor(q), tpool,
                                 torch.as_tensor(table), tq, 1,
                                 torch.as_tensor(pos), td, tm)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("sink", [0, 5])
@pytest.mark.parametrize("k_out", ["slots", "channels"])
@pytest.mark.parametrize("post", [False, True], ids=["pre", "post"])
@pytest.mark.parametrize("mode", list(BITS))
def test_plain_matches_jax_kernel(mode, post, k_out, sink):
    want, got = _k5(mode, post, k_out, sink)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", list(BITS))
def test_plain_matches_jax_kernel_bf16_dots(mode):
    want, got = _k5(mode, False, "slots", 5, dot_bf16=True)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("mode", list(BITS))
def test_paged_equals_contiguous(mode):
    """K5's plain version == K1's plain version over each slot's live pages
    laid out contiguously by hand."""
    _, td, _, tm = _configs(mode, False, "slots", 5)
    _, (pool, dq), q = _both(td, 3, seed=3)
    P = PAGE
    live = [(p - 5) // P + 1 for p in POS]

    def contiguous(a, tok_axis, rows):
        a = a.numpy()
        # dead blocks hold page 0's rows (masked in the attention)
        out = np.concatenate([a[:, :1]] * 3, axis=1).repeat(MP, tok_axis)
        for b in range(3):
            for m in range(live[b]):
                idx = [slice(None)] * (out.ndim - 2)
                idx[tok_axis - 2] = slice(m * rows, (m + 1) * rows)
                out[(slice(None), b, *idx)] = a[:, TABLE[b][m]]
        return torch.as_tensor(out)

    nuq = td.codes == "nuq"
    c = dict(k_planes=contiguous(pool.k_planes, 4 if nuq else 3,
                                 P // 32 if nuq else P),
             v_planes=contiguous(pool.v_planes, 4 if nuq else 3,
                                 P // 32 if nuq else P),
             kv_out=contiguous(pool.kv_out, 4, P),
             v_scale=contiguous(pool.v_scale, 2, P),
             v_offset=contiguous(pool.v_offset, 2, P))
    pos = torch.as_tensor(np.array(POS, np.int32))
    want = fd.flash_attention_ref(
        torch.as_tensor(q), c["k_planes"], c["v_planes"], c["kv_out"],
        dq.k_range, dq.k_offset, c["v_scale"], c["v_offset"], pool.k_sink,
        pool.v_sink, dq.k_lut_dec, dq.v_lut_dec, 1, pos, td, tm,
        k_ressc=dq.k_ressc)
    got = pdk.paged_flash_decode(torch.as_tensor(q), pool,
                                 torch.as_tensor(np.array(TABLE, np.int32)),
                                 dq, 1, pos, td, tm)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("sink", [0, 5])
@pytest.mark.parametrize("k_out", ["slots", "channels"])
def test_int4x2_pre_rope_matches_jax_kernel(k_out, sink):
    """int4x2 with pre-RoPE keys against JAX's paged kernel itself."""
    want, got = _k5("int4x2", False, k_out, sink)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _port_to_jax_int4(t):
    """The port's nibble-pair container (..., D/2) -> JAX's int4 (..., D)."""
    return jnp.asarray(tpk.unpack_nibbles(t).numpy(), jnp.int4)


@pytest.mark.parametrize("sink", [0, 5])
@pytest.mark.parametrize("k_out", ["slots", "channels"])
def test_int4x2_post_rope_matches_jax_contiguous(k_out, sink):
    """int4x2 with post-RoPE keys: JAX's paged kernel fails on its paired
    path (its m / l scratch and mask are sized for Q rows, not the 2Q a
    head pair stacks), so K5's plain version is held against what the paged
    result is defined to be: JAX's contiguous flash_attention over each
    slot's live pages laid out in order (tests/test_paged.py:1-6)."""
    from kvquant_tpu.ops.pallas.flash_decode import flash_attention as jfa

    jd, td, jm, tm = _configs("int4x2", True, k_out, sink)
    _, (pool, dq), q = _both(td, 3, seed=4)
    table = torch.as_tensor(np.array(TABLE, np.int32))
    pos = torch.as_tensor(np.array(POS, np.int32))
    got = pdk.paged_flash_decode(torch.as_tensor(q), pool, table, dq, 1, pos,
                                 td, tm)
    g = pdk.gather_layer(pool, pdk.live_pages(table, pos, td), 1, td)
    one = lambda t: jnp.asarray(t[1][None].numpy())  # noqa: E731
    want = jfa(jnp.asarray(q), _port_to_jax_int4(g["k_planes"][None]),
               _port_to_jax_int4(g["v_planes"][None]),
               jnp.asarray(g["kv_out"][None].numpy()), one(dq.k_range),
               one(dq.k_offset), jnp.asarray(g["v_scale"][None].numpy()),
               jnp.asarray(g["v_offset"][None].numpy()), one(pool.k_sink),
               one(pool.v_sink), one(dq.k_lut_dec), one(dq.v_lut_dec),
               jnp.int32(0), jnp.asarray(pos), jd, jm, block_tokens=PAGE,
               k_ressc=one(dq.k_ressc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_wrapper_refusals():
    """int4x2 under an odd head group raises as JAX's kernel asserts (it
    pairs heads within a group); a page of 200 tokens (not whole 128-token
    groups) raises ValueError; on CPU tensors the wrapper runs the plain
    version and counts no launch."""
    before = pdk.paged_flash_decode.launches
    want, got = _k5("nuq3", False, "slots", 5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert pdk.paged_flash_decode.launches == before == 0
    _, td, _, tm = _configs("nuq3", False, "slots", 5)
    args = (torch.zeros((1, Hkv, G, D)), None, torch.zeros((1, 1),
            dtype=torch.int32), None, 0, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 128"):
        pdk.paged_flash_decode(*args, dataclasses.replace(td, page_tokens=200),
                               tm)
    t2 = DeployConfig.create(bits=2, n_kv_heads=Hkv, d_head=D, max_len=261,
                             sink=5, kernel="flash", head_group=1,
                             codes="int4x2", post_rope_k=True)
    with pytest.raises(AssertionError, match="pairs heads"):
        pdk.paged_flash_decode(*args, dataclasses.replace(t2,
                                                         page_tokens=PAGE),
                               tm)
    assert pdk.paged_flash_decode.launches == 0


# ---------------------------------------------------------------------------
# append, page copies, decode step: the JAX package's model and quantizers
# ---------------------------------------------------------------------------


def _fit_tiny(tmp_path_factory, bits):
    """TINY_LLAMA with uniform ``bits``-bit quantizers fitted by the JAX
    package, handed to the port through numpy and an npz artifact."""
    params = jinit(jax.random.PRNGKey(0), J_TINY, dtype=jnp.float32)
    cal = jax.random.randint(jax.random.PRNGKey(7), (2, 40), 0,
                             J_TINY.vocab_size)
    k_acts, v_acts = collect_kv_activations(params, J_TINY, [cal])
    qs = fit_quantizers(k_acts, v_acts, bits=bits, sparsity_threshold=0.99,
                        cap_outliers=True, first_few_fp16=5, sample_seqlen=40,
                        kmeans_iters=10, mode="uniform")
    path = str(tmp_path_factory.mktemp("q") / "q.npz")
    save_quantizers(path, qs)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), TINY_LLAMA,
                                device="cpu")
    tq = deployed_from_quantizers(load_quantizers(path), 4, 16, device="cpu")
    return (params, jdeployed(qs, 4, 16)), (tparams, tq)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """TINY_LLAMA with 3-bit quantizers (see _fit_tiny)."""
    return _fit_tiny(tmp_path_factory, 3)


@pytest.fixture(scope="module")
def tiny2(tmp_path_factory):
    """TINY_LLAMA with 2-bit quantizers, for the 2-bit containers."""
    return _fit_tiny(tmp_path_factory, 2)


def _tiny_cfgs(codes="nuq", max_len=2 * PAGE + 5, bits=None, post=False,
               k_out="slots"):
    d = dict(bits=bits or (3 if codes == "nuq" else 4), n_kv_heads=4,
             d_head=16, max_len=max_len, sink=5, kernel="flash",
             dot_bf16=False, head_group=4, codes=codes, post_rope_k=post,
             k_outliers=k_out, n_kc=3,
             cap_per_side=2 if k_out == "slots" else 0)
    return (dataclasses.replace(JDeployConfig.create(**d), page_tokens=PAGE),
            dataclasses.replace(DeployConfig.create(**d), page_tokens=PAGE))


def _assert_pools_equal(tpool, jpool, td):
    for name in ("k_planes", "v_planes"):
        got = getattr(tpool, name)
        want = np.asarray(getattr(jpool, name))
        if td.codes != "nuq":  # containers: compare the codes
            got = tpk.load_codes_int(got, td.bits)
            want = np.asarray(jpk.load_codes_int(jnp.asarray(want), td.bits))
        np.testing.assert_array_equal(np.asarray(got), want, name)
    got, want = tpool.kv_out.numpy(), np.asarray(jpool.kv_out)
    if td.post_rope_k and td.k_outliers == "channels":
        # channel residuals of roped keys: the RoPE frequencies may round
        # an ulp apart (below); slot words keep only the top 23 bits
        spk = td.slots_per_kind
        np.testing.assert_allclose(got[:, :, :, :spk], want[:, :, :, :spk],
                                   rtol=1e-6, atol=1e-7)
        got, want = got[:, :, :, spk:], want[:, :, :, spk:]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for name in ("v_scale", "v_offset", "v_sink"):
        np.testing.assert_array_equal(getattr(tpool, name).numpy(),
                                      np.asarray(getattr(jpool, name)), name)
    # roped sink keys: torch.pow and jnp.power may round the RoPE
    # frequencies apart in the last ulp
    np.testing.assert_allclose(tpool.k_sink.numpy(), np.asarray(jpool.k_sink),
                               rtol=1e-6, atol=1e-7)


# (codes, bits, post-RoPE K, K outliers): the two first cases keep their
# ids; the int8 (3-bit), int4x2 and 2-bit int4 containers each x pre /
# post-RoPE x slots / channels
APPEND_CASES = [pytest.param("nuq", 3, False, "slots", id="nuq"),
                pytest.param("int4", 4, False, "slots", id="int4")] + [
    pytest.param(codes, bits, post, k_out,
                 id=f"{codes}-{bits}bit-{'post' if post else 'pre'}-{k_out}")
    for codes, bits in (("int8", 3), ("int4x2", 2), ("int4", 2))
    for post in (False, True) for k_out in ("slots", "channels")]


@pytest.mark.parametrize("codes,bits,post,k_out", APPEND_CASES)
def test_append_and_page_copy_match_jax(tiny, tiny2, codes, bits, post,
                                        k_out):
    (_, jq), (_, tq) = tiny2 if bits == 2 else tiny
    jd, td = _tiny_cfgs(codes, bits=bits, post=post, k_out=k_out)
    rng = np.random.default_rng(4)
    B, C = 3, 64
    jpool = jpaged.create_paged_pool(jd, 2, 4, B)
    tpool = paged.create_paged_pool(td, 2, 4, B, device="cpu")

    # a contiguous 1-sequence cache of 2 pages, copied into pages [3, 1]
    one = create_cache(td, 2, 1, device="cpu")
    for name, arr in one.arrays().items():
        if arr.dtype == torch.int32:
            arr.copy_(torch.as_tensor(rng.integers(
                -2 ** 31, 2 ** 31, arr.shape, dtype=np.int64).astype(
                    np.int32)))
        elif arr.dtype == torch.uint8:
            arr.copy_(torch.as_tensor(rng.integers(0, 256, arr.shape)
                                      .astype(np.uint8)))
        elif arr.dtype == torch.int8:
            arr.copy_(torch.as_tensor(rng.integers(-128, 128, arr.shape)
                                      .astype(np.int8)))
        else:
            arr.copy_(torch.as_tensor(rng.standard_normal(arr.shape)
                                      .astype(np.float32)))
    jarrs = {}
    for name, arr in one.arrays().items():
        if arr.dtype == torch.uint8:  # nibble pairs
            jarrs[name] = jnp.asarray(tpk.unpack_nibbles(arr).numpy()).astype(
                jnp.int4)
        else:
            jarrs[name] = jnp.asarray(arr.numpy())
    jpool = jpaged.write_pages_from_cache(jpool, jarrs,
                                          jnp.asarray([3, 1], jnp.int32), 1,
                                          jd)
    paged.write_pages_from_cache(tpool, one.arrays(), [3, 1], 1, td)
    _assert_pools_equal(tpool, jpool, td)

    # appends: slot 0 in the sink, slot 1 across the page boundary of its
    # table [3, 1], slot 2 INACTIVE with its row aliasing slot 1's pages at
    # the same positions (it must write nothing)
    table = np.array([[0, 2], [3, 1], [3, 1]], np.int32)
    act = np.array([True, True, False])
    jlq = jax.tree.map(lambda a: a[1], jq)
    for i in range(4):
        pos = np.array([2 + i, 5 + 254 + i, 5 + 254 + i], np.int32)
        k = rng.standard_normal((B, C)).astype(np.float32) * 2
        v = rng.standard_normal((B, C)).astype(np.float32)
        jpool = jpaged.paged_append_token(
            jpool, jnp.asarray(table), jlq, jd, J_TINY, jnp.asarray(k),
            jnp.asarray(v), jnp.asarray(pos), jnp.int32(1), jnp.asarray(act))
        paged.paged_append_token(tpool, table, tq.layer(1), td, TINY_LLAMA,
                                 torch.as_tensor(k), torch.as_tensor(v), pos,
                                 1, act)
    _assert_pools_equal(tpool, jpool, td)


def _prefill_pages(side, params, dq, cfg, dcfg, prompts):
    """Prefill each prompt into a 2-page temporary cache and copy it into
    permuted pages: slot 0 -> [3, 1], slot 1 -> [0, 2]."""
    pages = [[3, 1], [0, 2]]
    if side == "jax":
        pool = jpaged.create_paged_pool(dcfg, cfg.n_layers, 4, 2)
        for b, p in enumerate(prompts):
            c, _ = jeng.prefill(params, cfg, dcfg, dq,
                                jcreate(dcfg, cfg.n_layers, 1),
                                jnp.asarray(p)[None])
            arrs = {k: v for k, v in dataclasses.asdict(c).items()
                    if k != "length"}
            pool = jpaged.write_pages_from_cache(
                pool, arrs, jnp.asarray(pages[b], jnp.int32), b, dcfg)
        return pool
    pool = paged.create_paged_pool(dcfg, cfg.n_layers, 4, 2, device="cpu")
    for b, p in enumerate(prompts):
        c, _ = engine.prefill(params, cfg, dcfg, dq,
                              create_cache(dcfg, cfg.n_layers, 1,
                                           device="cpu"),
                              torch.as_tensor(p)[None])
        paged.write_pages_from_cache(pool, c.arrays(), pages[b], b, dcfg)
    return pool


def test_decode_step_matches_jax(tiny):
    """Two slots from 258-token prefills in permuted pages, 6 decode steps
    at positions 258..263 (packed 253..258: across the page boundary)."""
    (jp, jq), (tp, tq) = tiny
    jd, td = _tiny_cfgs()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, 258).astype(np.int32) for _ in range(2)]
    jpool = _prefill_pages("jax", jp, jq, J_TINY, jd, prompts)
    tpool = _prefill_pages("torch", tp, tq, TINY_LLAMA, td, prompts)
    table = np.array([[3, 1], [0, 2]], np.int32)
    act = np.ones(2, bool)
    step = jax.jit(lambda p, tok, pos: jpaged.paged_decode_step(
        jp, J_TINY, jd, jq, p, jnp.asarray(table), tok, pos,
        jnp.asarray(act)))
    toks = rng.integers(0, 256, (6, 2)).astype(np.int32)
    for i in range(6):
        pos = np.full(2, 258 + i, np.int32)
        jpool, jl = step(jpool, jnp.asarray(toks[i]), jnp.asarray(pos))
        _, tl = paged.paged_decode_step(tp, TINY_LLAMA, td, tq, tpool, table,
                                        torch.as_tensor(toks[i]), pos, act)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=3e-4,
                                   rtol=1e-4, err_msg=f"step {i}")


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def _requests(spec, seed, eos=None):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, 256, n).astype(np.int32),
                    max_new_tokens=m, eos_token_id=(eos or {}).get(i))
            for i, (n, m) in enumerate(spec)]


def _isolated(tiny, td, req, prefill_mode):
    tp, tq = tiny[1]
    out, _ = engine.generate(
        tp, TINY_LLAMA, td, tq, torch.as_tensor(req.prompt)[None],
        engine.GenerateConfig(max_new_tokens=req.max_new_tokens),
        prefill_mode=prefill_mode, device="cpu")
    return out[0].tolist()


@pytest.mark.parametrize("admit_mode", ["sync", "chunked"])
def test_server_matches_isolated_generation(tiny, admit_mode):
    """2 slots, 3-4 pages: later requests wait for retirement and reuse
    freed pages; chunked admission streams prompts longer than one chunk
    and matches the quantized prefill."""
    tp, tq = tiny[1]
    _, td = _tiny_cfgs(max_len=2 * PAGE + 5)
    if admit_mode == "sync":
        reqs, n_pages = _requests([(12, 6), (25, 5), (18, 7), (9, 4)], 3), 3
    else:
        reqs, n_pages = _requests([(150, 5), (40, 4), (200, 6)], 4), 4
    srv = paged.PagedServer(tp, TINY_LLAMA, td, tq, n_pages=n_pages,
                            n_slots=2, max_pages_per_slot=2,
                            admit_mode=admit_mode, admit_chunk=128,
                            device="cpu")
    comps = srv.run(list(reqs), max_steps=300)
    mode = "fp16" if admit_mode == "sync" else "quantized"
    for r in reqs:
        assert comps[r.rid].tokens == _isolated(tiny, td, r, mode), r.rid
    assert sorted(srv.free) == list(range(n_pages))


@pytest.mark.parametrize("post", [False, True], ids=["pre", "post"])
def test_int4x2_server_matches_isolated_generation(tiny, post):
    """The head-paired 2-bit container through PagedServer (chunked
    admission through K1, K5 decode steps, page copies): the same tokens as
    the port's isolated quantized-prefill generate. Uniform 2-bit
    quantizers fitted by the port from the tiny model's activations."""
    from kvquant_tpu_torch.quant.calibration import (
        collect_kv_activations as tcollect, fit_quantizers as tfit)

    tp, _ = tiny[1]
    cal = torch.as_tensor(np.random.default_rng(7).integers(
        0, 256, (2, 40), dtype=np.int32))
    k, v = tcollect(tp, TINY_LLAMA, [cal], rope_k=post)
    qs = tfit(k, v, bits=2, sparsity_threshold=0.99, cap_outliers=True,
              first_few_fp16=5, sample_seqlen=40, mode="uniform")
    tq = deployed_from_quantizers(qs, 4, 16, device="cpu")
    td = dataclasses.replace(DeployConfig.create(
        bits=2, n_kv_heads=4, d_head=16, max_len=2 * PAGE + 5, sink=5,
        kernel="flash", dot_bf16=False, head_group=4, codes="int4x2",
        post_rope_k=post, k_outliers="channels" if post else "slots",
        n_kc=2, cap_per_side=0 if post else 2), page_tokens=PAGE)
    reqs = _requests([(150, 5), (40, 4), (200, 6)], 4)
    srv = paged.PagedServer(tp, TINY_LLAMA, td, tq, n_pages=4, n_slots=2,
                            max_pages_per_slot=2, admit_mode="chunked",
                            admit_chunk=128, device="cpu")
    comps = srv.run(list(reqs), max_steps=300)
    for r in reqs:
        out, _ = engine.generate(
            tp, TINY_LLAMA, td, tq, torch.as_tensor(r.prompt)[None],
            engine.GenerateConfig(max_new_tokens=r.max_new_tokens),
            prefill_mode="quantized", device="cpu")
        assert comps[r.rid].tokens == out[0].tolist(), r.rid
    assert sorted(srv.free) == list(range(4))


class _BurstLog(paged.PagedServer):
    """Records, for every burst, H and each request's token count before
    and after it."""

    def _step_burst(self):
        before = {r: len(c.tokens) for r, c in self.completions.items()}
        H = super()._step_burst()
        self.log.append((H, before, {r: len(c.tokens)
                                     for r, c in self.completions.items()}))
        return H


def test_burst_matches_per_step_with_eos_mid_burst(tiny):
    tp, tq = tiny[1]
    _, td = _tiny_cfgs()
    spec = [(30, 12), (55, 9), (20, 16), (41, 7)]

    def run(burst, eos=None):
        srv = _BurstLog(tp, TINY_LLAMA, td, tq, n_pages=4, n_slots=2,
                        max_pages_per_slot=2, admit_mode="chunked",
                        admit_chunk=128, burst=burst, device="cpu")
        srv.log = []
        comps = srv.run(_requests(spec, 5, eos), max_steps=300)
        assert sorted(srv.free) == [0, 1, 2, 3]
        return {rid: c.tokens for rid, c in comps.items()}, srv.log

    free, _ = run(0)
    # request 2 (the longest budget) decodes after the queue empties, in
    # bursts; its EOS is its k-th token (first seen there), k >= 3
    t = free[2]
    k = next(i for i in range(3, len(t)) if t[i] not in t[:i])
    eos = {2: t[k]}
    (per_step, _), (bursty, log) = run(0, eos), run(8, eos)
    assert per_step[2] == t[:k + 1]
    assert bursty == per_step
    # the EOS fell inside a burst: it stopped request 2 before H tokens
    assert any(H > 1 and 2 in before and after[2] - before[2] < H
               and after[2] == k + 1 for H, before, after in log), log


def test_toy_checkpoint_matches_jax_generate():
    """The committed toy checkpoint and 3-bit quantizers (nuq3, hg 4): the
    port's PagedServer (P 256, 2 slots) gives JAX engine.generate's tokens
    (kernel "xla"), fp16 prefill for sync and quantized for chunked
    admission."""
    from kvquant_tpu.quant.artifacts import load_quantizers as jload
    from kvquant_tpu.utils.toymodel import BigramLM, TOY_CFG as J_TOY
    from kvquant_tpu_torch.utils.toymodel import TOY_CFG, load_toy_checkpoint

    tree, _, seed = load_toy_checkpoint(os.path.join(ART, "toy_model.npz"))
    qpath = os.path.join(ART, "toy_quantizers_3bit.npz")
    d = dict(bits=3, n_kv_heads=4, d_head=32, max_len=PAGE + 5, sink=5,
             head_group=4, codes="nuq", dot_bf16=False, cap_per_side=2)
    jd = JDeployConfig.create(kernel="xla", **d)
    td = dataclasses.replace(DeployConfig.create(kernel="flash", **d),
                             page_tokens=PAGE)
    jp = jax.tree.map(jnp.asarray, tree)
    jq = jdeployed(jload(qpath), 4, 32)
    tp = params_from_numpy(tree, TOY_CFG, device="cpu")
    tq = deployed_from_quantizers(load_quantizers(qpath), 4, 32,
                                  device="cpu")
    lm = BigramLM(J_TOY.vocab_size, seed=seed)
    reqs = [Request(rid=i, prompt=np.asarray(lm.sample(1, n, seed=40 + i)[0],
                                             np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate([(16, 10), (30, 6)])]
    for admit_mode, prefill in (("sync", "fp16"), ("chunked", "quantized")):
        srv = paged.PagedServer(tp, TOY_CFG, td, tq, n_pages=2, n_slots=2,
                                max_pages_per_slot=1, admit_mode=admit_mode,
                                burst=4, device="cpu")
        comps = srv.run(list(reqs))
        for r in reqs:
            want, _ = jeng.generate(jp, J_TOY, jd, jq,
                                    jnp.asarray(r.prompt)[None],
                                    jeng.GenerateConfig(r.max_new_tokens),
                                    prefill_mode=prefill)
            assert comps[r.rid].tokens == np.asarray(want)[0].tolist(), \
                (admit_mode, r.rid)
        assert sorted(srv.free) == [0, 1]


def test_pool_bytes_match_jax():
    # (int4: numpy's int4 itemsize is a byte, the port stores nibble pairs)
    for codes in ("nuq", "int8"):
        jd, td = _tiny_cfgs(codes)
        assert paged.paged_pool_bytes(td, 2, 5, 3) == \
            jpaged.paged_pool_bytes(jd, 2, 5, 3)


# ---------------------------------------------------------------------------
# device positions and the server's step graph
# ---------------------------------------------------------------------------


APPEND_DEVICE_CASES = [("nuq", 3), ("int4", 4), ("int4x2", 2)]


@pytest.mark.parametrize("sink", [0, 5])
@pytest.mark.parametrize("codes,bits", APPEND_DEVICE_CASES,
                         ids=[c for c, _ in APPEND_DEVICE_CASES])
def test_append_at_device_positions_matches_jax(tiny, tiny2, codes, bits,
                                                sink):
    """paged_append_token with the table, positions and active mask as
    tensors == JAX's, bitwise over the pool, 4 steps: slot 0 from position
    2 (the sink rows under sink 5), slot 1 across its page boundary, slot 2
    inactive at slot 1's very (page, row), slot 3 inactive one row further
    in slot 1's page (the same bit-plane word). The inactive slots must
    write nothing, whatever the order of the device's scatters."""
    (_, jq), (_, tq) = tiny2 if bits == 2 else tiny
    jd, td = (dataclasses.replace(c, sink=sink)
              for c in _tiny_cfgs(codes, bits=bits))
    rng = np.random.default_rng(11)
    B, C = 4, 64
    jpool = jpaged.create_paged_pool(jd, 2, 4, B)
    tpool = paged.create_paged_pool(td, 2, 4, B, device="cpu")
    table = np.array([[0, 2], [3, 1], [3, 1], [3, 1]], np.int32)
    act = np.array([True, True, False, False])
    jlq = jax.tree.map(lambda a: a[1], jq)
    for i in range(4):
        p1 = sink + 254 + i
        pos = np.array([2 + i, p1, p1, p1 + 1], np.int32)
        k = rng.standard_normal((B, C)).astype(np.float32) * 2
        v = rng.standard_normal((B, C)).astype(np.float32)
        jpool = jpaged.paged_append_token(
            jpool, jnp.asarray(table), jlq, jd, J_TINY, jnp.asarray(k),
            jnp.asarray(v), jnp.asarray(pos), jnp.int32(1), jnp.asarray(act))
        paged.paged_append_token(
            tpool, torch.as_tensor(table), tq.layer(1), td, TINY_LLAMA,
            torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(pos), 1,
            torch.as_tensor(act))
    _assert_pools_equal(tpool, jpool, td)
    # slot 1 wrote its 4 rows (2 in page 3, 2 in page 1), slot 3 none
    assert int(tpool.v_scale[1, [3, 1]].count_nonzero()) == 4


def _filled_pool(td, n_pages, B, seed):
    """A pool of random codes, slot words and values (every row
    live-looking)."""
    rng = np.random.default_rng(seed)
    pool = paged.create_paged_pool(td, TINY_LLAMA.n_layers, n_pages, B,
                                   device="cpu")
    for f in dataclasses.fields(pool):
        a = getattr(pool, f.name)
        if f.name == "kv_out":
            a.copy_(torch.as_tensor(_words(rng, a.shape, td.head_group)))
        elif a.dtype == torch.float32:
            a.copy_(torch.as_tensor(rng.standard_normal(a.shape)
                                    .astype(np.float32)))
        else:
            info = torch.iinfo(a.dtype)
            a.copy_(torch.as_tensor(rng.integers(
                info.min, info.max, a.shape, dtype=np.int64)).to(a.dtype))
    return pool


def _pool_clone(pool):
    return paged.PagedPool(**{f.name: getattr(pool, f.name).clone()
                              for f in dataclasses.fields(pool)})


def _pools_bitwise(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f.name


@pytest.mark.parametrize("codes", ["nuq", "int4x2"])
def test_decode_step_makes_no_host_read(tiny, tiny2, codes, monkeypatch):
    """paged_decode_step with tensor table, positions and active mask reads
    nothing back to the host, K5's plain version included: under a
    TorchDispatchMode that fails on aten._local_scalar_dense, with
    Tensor.tolist / numpy / cpu patched to raise (the guard of
    tests/test_torch_decode_graph.py)."""
    from test_torch_decode_graph import _NoHostRead, _raise_if_not_exempt

    (_, tq), bits = ((tiny2[1], 2) if codes == "int4x2" else (tiny[1], 3))
    tp = tiny[1][0]
    _, td = _tiny_cfgs(codes, bits=bits)
    B = 3
    pool = _filled_pool(td, 4, B, seed=3)
    table = torch.tensor([[3, 1], [0, 2], [3, 1]], dtype=torch.int32)
    tok = torch.tensor([3, 7, 11], dtype=torch.int32)
    act = torch.tensor([True, True, False])
    # the first step checks an intN codebook once (a host read per
    # DeployedQuant, outside the step that a graph captures)
    paged.paged_decode_step(tp, TINY_LLAMA, td, tq, pool, table, tok,
                            torch.tensor([4, 5, 6], dtype=torch.int32), act)
    k_chan = static_channels(tq, td)
    for name in ("tolist", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, _raise_if_not_exempt(
            name, getattr(torch.Tensor, name)))
    with _NoHostRead():
        for pl in ([4, 5 + 300, 5 + 255], [5 + 256, 5 + 2, 5 + 256]):
            _, logits = paged.paged_decode_step(
                tp, TINY_LLAMA, td, tq, pool, table, tok,
                torch.tensor(pl, dtype=torch.int32), act, k_chan=k_chan)
        with pytest.raises(AssertionError, match="host read"):
            bool(logits.sum() > 0)  # the guard sees a host read
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("codes", ["nuq", "int4"])
def test_greedy_step_warmup_writes_nothing(tiny, codes):
    """PagedGraph's warm-up, the greedy body with every slot inactive,
    leaves a live pool bitwise as it was: at the buffers' zeros (the
    warm-up) and at positions and table rows that alias live pages. With
    slots active, the body advances only their token and position."""
    tp, tq = tiny[1]
    _, td = _tiny_cfgs(codes)
    B = 3
    pool = _filled_pool(td, 4, B, seed=4)
    before = _pool_clone(pool)
    st = paged.PagedStep(tp, TINY_LLAMA, td, tq, pool, 2)
    logits = st()
    _pools_bitwise(pool, before)
    assert torch.isfinite(logits).all()
    host = dict(token=np.array([3, 7, 11], np.int32),
                pos=np.array([5 + 300, 5 + 255, 5 + 256], np.int32),
                table=np.array([[3, 1], [3, 1], [0, 2]], np.int32))
    st.load(host["token"], host["pos"], np.zeros(B, bool), host["table"])
    st()
    _pools_bitwise(pool, before)
    assert st.token.tolist() == [3, 7, 11]
    assert st.pos.tolist() == host["pos"].tolist()
    act = np.array([True, False, True])
    st.load(host["token"], host["pos"], act, host["table"])
    logits = st()
    nxt = torch.argmax(logits, -1)
    assert st.token.tolist() == [int(nxt[0]), 7, int(nxt[2])]
    assert st.pos.tolist() == (host["pos"] + act).tolist()


def test_paged_graph_refuses_cpu(tiny):
    tp, tq = tiny[1]
    _, td = _tiny_cfgs()
    pool = paged.create_paged_pool(td, TINY_LLAMA.n_layers, 2, 2,
                                   device="cpu")
    with pytest.raises(ValueError, match="needs a card"):
        paged.PagedGraph(tp, TINY_LLAMA, td, tq, pool, 2)
    srv = paged.PagedServer(tp, TINY_LLAMA, td, tq, n_pages=2, n_slots=2,
                            max_pages_per_slot=1, device="cpu")
    assert type(srv._step) is paged.PagedStep


def test_burst_server_matches_jax_server(tiny):
    """The port's PagedServer with bursts of 8 gives the JAX PagedServer's
    tokens on the same requests (uniform 3-bit codebooks, chunked
    admission of 128, 2 slots over 4 pages), with an EOS that stops a
    request inside a burst; every page comes back."""
    (jp, jq), (tp, tq) = tiny
    jd, td = _tiny_cfgs()
    spec = [(30, 12), (55, 9), (20, 16), (41, 7)]

    def run(side, eos=None):
        if side == "jax":
            srv = jpaged.PagedServer(jp, J_TINY, jd, jq, n_pages=4,
                                     n_slots=2, max_pages_per_slot=2,
                                     admit_mode="chunked", admit_chunk=128,
                                     burst=8)
        else:
            srv = _BurstLog(tp, TINY_LLAMA, td, tq, n_pages=4, n_slots=2,
                            max_pages_per_slot=2, admit_mode="chunked",
                            admit_chunk=128, burst=8, device="cpu")
            srv.log = []
        comps = srv.run(_requests(spec, 5, eos), max_steps=300)
        assert sorted(srv.free) == [0, 1, 2, 3]
        return {rid: c.tokens for rid, c in comps.items()}, srv

    free, _ = run("torch")
    t = free[2]
    k = next(i for i in range(3, len(t)) if t[i] not in t[:i])
    eos = {2: t[k]}
    got, srv = run("torch", eos)
    want, _ = run("jax", eos)
    assert got == want
    assert got[2] == t[:k + 1]
    assert any(H > 1 and 2 in before and after[2] - before[2] < H
               and after[2] == k + 1 for H, before, after in srv.log), srv.log
