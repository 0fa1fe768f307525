"""Port of the serial decode kernel: the plain PyTorch version
(kvquant_tpu_torch/ops/kernels/flash_serial.py), which the CUDA kernel is
held against on the card, must compute what the JAX Pallas kernel
(kvquant_tpu/ops/pallas/flash_serial.py, run in interpret mode on the CPU)
computes, on the same numpy inputs.

Tolerance: atol = rtol = 1e-5 with fp32 dots (dot_bf16=False): the two
sides sum in different orders. With bf16 dot operands the two sides round
the probabilities at different points (the TPU kernel against its running
maximum, the port after normalisation), so those cases allow 2e-2."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kvquant_tpu.cache import DeployConfig as JaxDeployConfig
from kvquant_tpu.models.config import ModelConfig as JaxModelConfig
from kvquant_tpu.ops import packing as jpk
from kvquant_tpu.ops.pallas.flash_serial import flash_serial_decode as jax_fs

from kvquant_tpu_torch.cache import DeployConfig
from kvquant_tpu_torch.models.config import ModelConfig
from kvquant_tpu_torch.ops import packing as tpk
from kvquant_tpu_torch.ops.kernels import flash_serial as fs

torch.set_num_threads(1)

L, B, Hkv, G, D = 2, 2, 4, 2, 16
Tc = 512


def _words(rng, shape, hg):
    """Encoded outlier slot words: random residuals at random in-group
    (head, dim) indices."""
    vals = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    idx = (rng.integers(0, hg, shape) << 7) | rng.integers(0, D, shape)
    bits = vals.view(np.uint32)
    return ((bits & np.uint32(0xFFFFFE00)) | idx.astype(np.uint32)).view(
        np.float32)


def _case(codes, k_out, hg, sink, window=None, dot_bf16=False, seed=0):
    bits = {"int4": 4, "int8": 8, "int4x2": 2}[codes]
    cap = 0 if k_out == "channels" else 2
    kw = dict(bits=bits, n_kv_heads=Hkv, d_head=D, max_len=Tc + sink,
              sink=sink, kernel="flash_serial", dot_bf16=dot_bf16,
              head_group=hg, codes=codes, post_rope_k=True, k_outliers=k_out,
              n_kc=3, cap_per_side=cap)
    jd, td = JaxDeployConfig.create(**kw), DeployConfig.create(**kw)
    mk = dict(vocab_size=64, d_model=Hkv * G * D, n_layers=L,
              n_heads=Hkv * G, n_kv_heads=Hkv, d_head=D, d_ff=32,
              max_seq_len=Tc + 64, sliding_window=window)
    jm, tm = JaxModelConfig(**mk), ModelConfig(**mk)

    rng = np.random.default_rng(seed)
    codes_k = rng.integers(0, 2 ** bits, (L, B, Tc, Hkv, D))
    codes_v = rng.integers(0, 2 ** bits, (L, B, Tc, Hkv, D))

    def jcont(c):
        if codes == "int4x2":
            return jnp.moveaxis(jpk.pair_codes_int4x2(jnp.asarray(c)), -3, -2)
        dt = jnp.int4 if codes == "int4" else jnp.int8
        return jnp.moveaxis(jpk.store_codes_int(jnp.asarray(c), bits, dt),
                            -3, -2)

    def tcont(c):
        c = torch.as_tensor(c)
        if codes == "int4x2":
            return torch.movedim(tpk.pair_codes_int4x2(c), -3, -2).contiguous()
        return torch.movedim(tpk.store_codes_int(c, bits, td.code_dtype),
                             -2, -3).contiguous()

    NG, J, spk = Hkv // hg, td.n_slots, td.slots_per_kind
    if k_out == "channels":
        kv_out = (rng.standard_normal((L, B, NG, J, Tc)) * 0.1).astype(
            np.float32)
        kv_out[:, :, :, spk:] = _words(rng, (L, B, NG, J - spk, Tc), hg)
    else:
        kv_out = _words(rng, (L, B, NG, J, Tc), hg)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrays = dict(
        q_rot=f32(B, Hkv, G, D),
        kv_out=kv_out,
        k_range=(rng.random((L, Hkv, D)) + 0.5).astype(np.float32),
        k_offset=f32(L, Hkv, D) * 0.1,
        v_scale=(rng.random((L, B, Tc)) + 0.5).astype(np.float32),
        v_offset=f32(L, B, Tc) * 0.1,
        k_sink=f32(L, B, Hkv, sink, D),
        v_sink=f32(L, B, Hkv, sink, D),
        k_lut=np.stack([np.linspace(-1, 1, 2 ** bits, dtype=np.float32)] * L),
        v_lut=np.stack([np.linspace(-0.9, 1.1, 2 ** bits,
                                    dtype=np.float32)] * L),
    )
    ressc = rng.random((L, Hkv * D)).astype(np.float32)
    # row 0 inside the sink prefix (or at the very start), row 1 past the
    # first 256-token block
    pos = np.array([3, 300] if window is None else [300, 457], np.int32)

    tail = ["kv_out", "k_range", "k_offset", "v_scale", "v_offset",
            "k_sink", "v_sink", "k_lut", "v_lut"]
    jargs = [jnp.asarray(arrays["q_rot"]), jcont(codes_k), jcont(codes_v),
             *(jnp.asarray(arrays[n]) for n in tail)]
    targs = [torch.as_tensor(arrays["q_rot"]), tcont(codes_k),
             tcont(codes_v), *(torch.as_tensor(arrays[n]) for n in tail)]
    want = jax_fs(*jargs, jnp.int32(1), jnp.asarray(pos), jd, jm,
                  block_tokens=256, k_ressc=jnp.asarray(ressc))
    got = fs.flash_serial_decode(*targs, 1, torch.as_tensor(pos), td, tm,
                                 k_ressc=torch.as_tensor(ressc))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("sink", [0, 5])
@pytest.mark.parametrize("hg", [2, Hkv], ids=["hg2", "hgall"])
@pytest.mark.parametrize("k_out", ["channels", "slots"])
@pytest.mark.parametrize("codes", ["int4", "int8", "int4x2"])
def test_plain_matches_jax_kernel(codes, k_out, hg, sink):
    want, got = _case(codes, k_out, hg, sink)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("codes", ["int4", "int4x2"])
def test_plain_matches_jax_kernel_window(codes):
    want, got = _case(codes, "channels", 2, 5, window=64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k_out", ["channels", "slots"])
def test_plain_matches_jax_kernel_bf16_dots(k_out):
    want, got = _case("int4", k_out, 2, 5, dot_bf16=True)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_kernel_rejects_capacity_off_tile():
    """The kernel copies whole 128-token tiles, so the launch path refuses
    a capacity that is not a multiple of the tile before touching the
    card."""
    td = DeployConfig.create(bits=4, n_kv_heads=Hkv, d_head=D, max_len=205,
                             sink=5, kernel="flash_serial", head_group=2,
                             codes="int4", post_rope_k=True,
                             k_outliers="channels", n_kc=3, cap_per_side=0)
    tm = ModelConfig(vocab_size=64, d_model=Hkv * G * D, n_layers=L,
                     n_heads=Hkv * G, n_kv_heads=Hkv, d_head=D, d_ff=32,
                     max_seq_len=256)
    tc = 200
    planes = torch.zeros((L, B, Hkv, tc, td.code_cols), dtype=torch.uint8)
    f = lambda *s: torch.zeros(s)
    with pytest.raises(ValueError, match="multiple of 128"):
        fs._launch(f(B, Hkv, G, D), planes, planes,
                   f(L, B, Hkv // 2, td.n_slots, tc), f(L, Hkv, D),
                   f(L, Hkv, D), f(L, B, tc), f(L, B, tc),
                   f(L, B, Hkv, 5, D), f(L, B, Hkv, 5, D), f(L, 16), f(L, 16),
                   1, torch.zeros(B, dtype=torch.int32), td, tm,
                   torch.zeros((Hkv // 2, 3), dtype=torch.int32))
    assert fs.flash_serial_decode.launches == 0


def test_wrapper_on_cpu_runs_plain_version_uncounted():
    before = fs.flash_serial_decode.launches
    want, got = _case("int4", "channels", Hkv, 5)
    assert fs.flash_serial_decode.launches == before == 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
