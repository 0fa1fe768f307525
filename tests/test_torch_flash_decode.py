"""Port of the one-pass attention kernel K1: the plain PyTorch version
(kvquant_tpu_torch/ops/kernels/flash_decode.py), which the CUDA kernel is
held against on the card, must compute what the JAX Pallas kernel
(kvquant_tpu/ops/pallas/flash_decode.py:flash_attention, run in interpret
mode on the CPU) computes, on the same numpy inputs: bit planes (random
words are valid planes, non-affine codebooks) and integer containers,
pre- and post-RoPE keys, slot and channel outliers, head groups 1/2/4,
sink 0/5, decode rows (Tq = 1) at per-sample positions, prefill blocks
(Tq > 1: a first chunk holding the sink rows, later chunks) and a sliding
window.

Tolerance: atol = rtol = 1e-5 with fp32 dots (dot_bf16=False): the two
sides sum in different orders. With bf16 dot operands the two sides round
at different points (the TPU kernel the probabilities against its running
maximum and the slot corrections as separate dots, the port the roped
keys with their outliers and the probabilities after normalisation), so
those cases allow 2e-2."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kvquant_tpu.cache import DeployConfig as JaxDeployConfig
from kvquant_tpu.models.config import ModelConfig as JaxModelConfig
from kvquant_tpu.ops import packing as jpk
from kvquant_tpu.ops.pallas.flash_decode import flash_attention as jax_fa

from kvquant_tpu_torch.cache import DeployConfig
from kvquant_tpu_torch.models.config import ModelConfig
from kvquant_tpu_torch.ops import packing as tpk
from kvquant_tpu_torch.ops.kernels import flash_decode as fd

torch.set_num_threads(1)

L, B, Hkv, G, D = 2, 2, 4, 2, 16
Tc = 512
BITS = {"nuq2": ("nuq", 2), "nuq3": ("nuq", 3), "nuq4": ("nuq", 4),
        "int4": ("int4", 4), "int8": ("int8", 8)}


def _words(rng, shape, hg):
    """Encoded outlier slot words: random residuals at random in-group
    (head, dim) indices."""
    vals = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    idx = (rng.integers(0, hg, shape) << 7) | rng.integers(0, D, shape)
    bits = vals.view(np.uint32)
    return ((bits & np.uint32(0xFFFFFE00)) | idx.astype(np.uint32)).view(
        np.float32)


def _case(mode, post, k_out, hg, sink, Tq=1, pos=(3, 300), window=None,
          dot_bf16=False, seed=0, G=G):
    codes, bits = BITS[mode]
    kw = dict(bits=bits, n_kv_heads=Hkv, d_head=D, max_len=Tc + sink,
              sink=sink, kernel="flash", dot_bf16=dot_bf16, head_group=hg,
              codes=codes, post_rope_k=post, k_outliers=k_out, n_kc=3,
              cap_per_side=0 if k_out == "channels" else 2)
    jd, td = JaxDeployConfig.create(**kw), DeployConfig.create(**kw)
    mk = dict(vocab_size=64, d_model=Hkv * G * D, n_layers=L,
              n_heads=Hkv * G, n_kv_heads=Hkv, d_head=D, d_ff=32,
              max_seq_len=Tc + 64, sliding_window=window)
    jm, tm = JaxModelConfig(**mk), ModelConfig(**mk)

    rng = np.random.default_rng(seed)
    K = 2 ** bits
    if codes == "nuq":
        shape = (L, B, Hkv, bits, Tc // 32, D)
        kp = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(
            np.int32)
        vp = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(
            np.int32)
        jk, jv, tk, tv = (jnp.asarray(kp), jnp.asarray(vp),
                          torch.as_tensor(kp), torch.as_tensor(vp))
        k_lut = np.sort(rng.uniform(-1, 1, (L, K)), axis=1).astype(np.float32)
        v_lut = np.sort(rng.uniform(-1, 1, (L, K)), axis=1).astype(np.float32)
    else:
        ck = rng.integers(0, K, (L, B, Tc, Hkv, D))
        cv = rng.integers(0, K, (L, B, Tc, Hkv, D))
        dt = jnp.int4 if codes == "int4" else jnp.int8

        def jcont(c):
            return jnp.moveaxis(jpk.store_codes_int(jnp.asarray(c), bits, dt),
                                -3, -2)

        def tcont(c):
            return torch.movedim(tpk.store_codes_int(
                torch.as_tensor(c), bits, td.code_dtype), -2, -3).contiguous()

        jk, jv, tk, tv = jcont(ck), jcont(cv), tcont(ck), tcont(cv)
        k_lut = np.stack([np.linspace(-1, 1, K, dtype=np.float32)] * L)
        v_lut = np.stack([np.linspace(-0.9, 1.1, K, dtype=np.float32)] * L)

    NG, J, spk = Hkv // hg, td.n_slots, td.slots_per_kind
    if k_out == "channels":
        kv_out = (rng.standard_normal((L, B, NG, J, Tc)) * 0.1).astype(
            np.float32)
        kv_out[:, :, :, spk:] = _words(rng, (L, B, NG, J - spk, Tc), hg)
    else:
        kv_out = _words(rng, (L, B, NG, J, Tc), hg)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrays = dict(
        kv_out=kv_out,
        k_range=(rng.random((L, Hkv, D)) + 0.5).astype(np.float32),
        k_offset=f32(L, Hkv, D) * 0.1,
        v_scale=(rng.random((L, B, Tc)) + 0.5).astype(np.float32),
        v_offset=f32(L, B, Tc) * 0.1,
        k_sink=f32(L, B, Hkv, sink, D), v_sink=f32(L, B, Hkv, sink, D),
        k_lut=k_lut, v_lut=v_lut,
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


# (post_rope_k, k_outliers, head_group, sink)
VARIANTS = {"pre-slots-hg4-sink5": (False, "slots", 4, 5),
            "post-channels-hg2-sink0": (True, "channels", 2, 0)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", list(BITS))
def test_decode_plain_matches_jax_kernel(mode, variant):
    want, got = _case(mode, *VARIANTS[variant])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode,post,k_out,hg,sink,Tq,pos,window", [
    ("nuq3", False, "channels", 1, 5, 1, (3, 300), None),
    ("nuq3", True, "slots", 2, 0, 1, (0, 511), None),
    ("nuq3", False, "slots", 4, 5, 1, (300, 457), 64),
    # first prefill chunk: the sink rows are query rows at positions 0..4
    ("nuq3", False, "slots", 4, 5, 133, (0, 0), None),
    ("nuq3", False, "slots", 4, 5, 128, (133, 261), None),
    ("nuq2", False, "slots", 2, 0, 128, (0, 128), None),
    ("int8", True, "channels", 2, 0, 128, (128, 256), None),
    ("nuq4", False, "slots", 4, 5, 128, (261, 261), 100),
], ids=["hg1-channels", "post-slots", "window", "first-chunk",
        "later-chunk", "nuq2-chunk", "int8-post-chunk", "chunk-window"])
def test_plain_matches_jax_kernel(mode, post, k_out, hg, sink, Tq, pos,
                                  window):
    want, got = _case(mode, post, k_out, hg, sink, Tq=Tq, pos=pos,
                      window=window)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode,post,k_out,hg,pos", [
    ("nuq3", False, "slots", 4, (0, 0)),
    ("nuq3", False, "slots", 4, (261, 389)),
    ("int4", True, "channels", 2, (0, 0)),
    ("int8", False, "slots", 2, (133, 250)),
], ids=["nuq3-first", "nuq3-later", "int4-post-channels-first",
        "int8-later"])
@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
def test_chunk_g4_rows_match_jax_kernel(mode, post, k_out, hg, pos,
                                        dot_bf16):
    """Chunks of Tq = 256 + sink rows per query head at G = 4 (Q = 1044
    g-major rows, the layout the chunk body's row blocks cut across g
    boundaries), a first chunk whose sink rows see no packed token and
    later ones at unequal positions; both dot modes."""
    want, got = _case(mode, post, k_out, hg, 5, Tq=261, pos=pos,
                      dot_bf16=dot_bf16, G=4)
    tol = 2e-2 if dot_bf16 else 1e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("Tq,pos", [(1, (3, 300)), (128, (133, 261))],
                         ids=["decode", "chunk"])
def test_plain_matches_jax_kernel_bf16_dots(Tq, pos):
    want, got = _case("nuq3", False, "slots", 4, 5, Tq=Tq, pos=pos,
                      dot_bf16=True)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_wrapper_checks():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; the launch path refuses a capacity off the 128-token granule
    before touching the card; int4x2 under an odd head group is refused as
    JAX's kernel asserts (it pairs kv heads within a group; the int4x2
    parity cases are tests/test_torch_int4x2.py)."""
    before = fd.flash_attention.launches
    want, got = _case("nuq3", False, "slots", 4, 5)
    assert fd.flash_attention.launches == before == 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    td = DeployConfig.create(bits=3, n_kv_heads=Hkv, d_head=D, max_len=205,
                             sink=5, kernel="flash", head_group=2)
    tm = ModelConfig(vocab_size=64, d_model=Hkv * G * D, n_layers=L,
                     n_heads=Hkv * G, n_kv_heads=Hkv, d_head=D, d_ff=32,
                     max_seq_len=256)
    tc = 200
    planes = torch.zeros((L, B, Hkv, 3, 8, D), dtype=torch.int32)
    f = lambda *s: torch.zeros(s)
    with pytest.raises(ValueError, match="multiple of 128"):
        fd._launch(f(B, Hkv, G, D), planes, planes,
                   f(L, B, Hkv // 2, td.n_slots, tc), f(L, Hkv, D),
                   f(L, Hkv, D), f(L, B, tc), f(L, B, tc),
                   f(L, B, Hkv, 5, D), f(L, B, Hkv, 5, D), f(L, 8), f(L, 8),
                   1, torch.zeros(B, dtype=torch.int32), td, tm, 1, None)
    assert fd.flash_attention.launches == 0

    t2 = DeployConfig.create(bits=2, n_kv_heads=Hkv, d_head=D, max_len=261,
                             sink=5, kernel="flash", head_group=1,
                             codes="int4x2", post_rope_k=True)
    with pytest.raises(AssertionError, match="pairs heads"):
        fd.flash_decode(f(B, Hkv, G, D), planes, planes, None, None, None,
                        None, None, None, None, None, None, 0,
                        torch.zeros(B, dtype=torch.int32), t2, tm)
