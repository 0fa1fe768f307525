"""Port of the two-pass attention kernels K3 / K4: the plain PyTorch
versions (kvquant_tpu_torch/ops/kernels/attention.py: qk_fused_ref,
pv_fused_ref), which the CUDA kernels are held against on the card, must
compute what the JAX Pallas kernels (kvquant_tpu/ops/pallas/attention.py:
qk_fused, pv_fused, run in interpret mode on the CPU) compute, on the same
numpy inputs: random codes packed by the JAX ``pack_codes``, slot words from
the JAX ``encode_outlier_words`` (some zero-padded, heads-in-group below the
head group), bits 2/3/4, head groups 1/2/4, with and without slots, R = G
(decode) and R = G*Tq_all (a prefill block), B = 2 (the JAX kernels run once
per batch row, as the JAX callers vmap them).

Tolerances: fp32 dots atol 2e-4, rtol 1e-4 (the JAX package's own,
tests/test_pallas_kernels.py); bf16 dot operands 1e-2 * max|JAX| (the two
sides may round an operand on either side of a bf16 step when their fp32
rotations differ in the last ulp).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kvquant_tpu.cache import DeployConfig as JDeployConfig
from kvquant_tpu.models.config import ModelConfig as JModelConfig
from kvquant_tpu.ops import packing as jpk
from kvquant_tpu.ops.pallas import qk_fused as jax_qk, pv_fused as jax_pv

from kvquant_tpu_torch.cache import DeployConfig
from kvquant_tpu_torch.models.config import ModelConfig
from kvquant_tpu_torch.ops.kernels import attention as at

torch.set_num_threads(1)

B, HKV, D, G, TC = 2, 4, 16, 2, 256


def _mk(D=D):
    return dict(vocab_size=64, d_model=HKV * G * D, n_layers=1,
                n_heads=HKV * G, n_kv_heads=HKV, d_head=D, d_ff=64,
                max_seq_len=512, rope_scaling=2.0)


def _cfgs(bits, hg, cap=2, include_sparse=True, dot_bf16=False, D=D):
    kw = dict(bits=bits, n_kv_heads=HKV, d_head=D, max_len=TC + 5, sink=5,
              head_group=hg, cap_per_side=cap, include_sparse=include_sparse,
              dot_bf16=dot_bf16, kernel="pallas")
    return JDeployConfig.create(**kw), DeployConfig.create(**kw)


def _inputs(bits, hg, n_slots, R, seed, D=D):
    """Packed planes (B, Hkv, bits, TC/32, D), slot words (B, NG, n_slots,
    TC) and the dense operands, as numpy."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2 ** bits, (B, HKV, TC, D)).astype(np.int32)
    planes = np.stack([np.asarray(jpk.pack_codes(jnp.asarray(c), bits))
                       for c in codes])
    shape = (B, HKV // hg, n_slots, TC)
    vals = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    vals[rng.random(shape) < 0.2] = 0.0  # non-genuine slots keep index bits
    idx = (rng.integers(0, hg, shape) << 7) | rng.integers(0, D, shape)
    words = np.asarray(jpk.encode_outlier_words(jnp.asarray(vals),
                                                jnp.asarray(idx)))
    words = words.copy()
    words[rng.random(shape) < 0.2] = 0.0  # zero padding
    return dict(
        planes=planes, words=words,
        lut=np.sort(rng.uniform(-1, 1, 2 ** bits)).astype(np.float32),
        k_range=(rng.random((HKV, D)) + 0.5).astype(np.float32),
        k_offset=(rng.standard_normal((HKV, D)) * 0.1).astype(np.float32),
        q=rng.standard_normal((B, HKV, R, D)).astype(np.float32),
        probs=rng.dirichlet(np.ones(TC), (B, HKV, R)).astype(np.float32),
        v_scale=(rng.random((B, TC)) + 0.1).astype(np.float32),
        v_offset=(rng.standard_normal((B, TC)) * 0.1).astype(np.float32),
    )


def _qk(jd, td, x, words):
    d = x["q"].shape[-1]
    jm, tm = JModelConfig(**_mk(d)), ModelConfig(**_mk(d))
    want = np.stack([np.asarray(jax_qk(
        jnp.asarray(x["q"][b]), jnp.asarray(x["planes"][b]),
        None if words is None else jnp.asarray(words[b]),
        jnp.asarray(x["k_range"]), jnp.asarray(x["k_offset"]),
        jnp.asarray(x["lut"]), jd, jm)) for b in range(B)])
    got = at.qk_fused(torch.as_tensor(x["q"]), torch.as_tensor(x["planes"]),
                      None if words is None else torch.as_tensor(words),
                      torch.as_tensor(x["k_range"]),
                      torch.as_tensor(x["k_offset"]),
                      torch.as_tensor(x["lut"]), td, tm)
    return want, got.numpy()


def _pv(jd, td, x, words):
    want = np.stack([np.asarray(jax_pv(
        jnp.asarray(x["probs"][b]), jnp.asarray(x["planes"][b]),
        jnp.asarray(x["v_scale"][b]), jnp.asarray(x["v_offset"][b]),
        None if words is None else jnp.asarray(words[b]),
        jnp.asarray(x["lut"]), jd)) for b in range(B)])
    got = at.pv_fused(torch.as_tensor(x["probs"]),
                      torch.as_tensor(x["planes"]),
                      torch.as_tensor(x["v_scale"]),
                      torch.as_tensor(x["v_offset"]),
                      None if words is None else torch.as_tensor(words),
                      torch.as_tensor(x["lut"]), td)
    return want, got.numpy()


KERNELS = {"qk": _qk, "pv": _pv}


@pytest.mark.parametrize("hg", [1, 2, 4])
@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_decode_rows_match_jax_kernel(kernel, bits, hg):
    """R = G rows (a decode step), slots cap 2 (4 K and 4 V rows)."""
    jd, td = _cfgs(bits, hg)
    x = _inputs(bits, hg, td.n_slots, G, seed=bits * 10 + hg)
    want, got = KERNELS[kernel](jd, td, x, x["words"])
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("slots", ["slots", "cap0", "no-sparse", "none"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_block_rows_match_jax_kernel(kernel, slots):
    """R = G*Tq_all rows (a prefill block of 37 query rows at G = 2), with
    slots, with cap 0 (one all-zero row), with include_sparse off, and with
    no kv_out at all."""
    cap = 0 if slots == "cap0" else 2
    jd, td = _cfgs(3, 2, cap=cap, include_sparse=slots != "no-sparse")
    x = _inputs(3, 2, td.n_slots, G * 37, seed=7)
    words = None if slots == "none" else x["words"]
    if slots == "cap0":
        words = np.zeros_like(words)
    want, got = KERNELS[kernel](jd, td, x, words)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("R", [G, G * 37], ids=["decode", "block"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_bf16_dots_match_jax_kernel(kernel, R):
    jd, td = _cfgs(3, 4, dot_bf16=True)
    x = _inputs(3, 4, td.n_slots, R, seed=11)
    want, got = KERNELS[kernel](jd, td, x, x["words"])
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_wrappers_on_cpu_count_no_launch_and_refuse_wide_head_groups():
    """CPU tensors take the plain versions (no launch counted); slots with
    head_group > 4 (the word's head field has 2 bits) raise ValueError in
    both wrappers, as do storage modes the kernels do not read (integer
    containers, channel outliers, post-RoPE keys)."""
    before = (at.qk_fused.launches, at.pv_fused.launches)
    jd, td = _cfgs(3, 2)
    x = _inputs(3, 2, td.n_slots, G, seed=3)
    _qk(jd, td, x, x["words"])
    _pv(jd, td, x, x["words"])
    assert (at.qk_fused.launches, at.pv_fused.launches) == before == (0, 0)

    t8 = DeployConfig(bits=3, n_kv_heads=8, d_head=D, max_len=TC + 5,
                      cap_per_side=2, head_group=8, kernel="pallas")
    words = torch.zeros((B, 1, t8.n_slots, TC))
    planes = torch.zeros((B, 8, 3, TC // 32, D), dtype=torch.int32)
    tm = ModelConfig(**_mk())
    with pytest.raises(ValueError, match="head_group <= 4"):
        at.qk_fused(torch.zeros((B, 8, 1, D)), planes, words,
                    torch.ones((8, D)), torch.zeros((8, D)), torch.zeros(8),
                    t8, tm)
    with pytest.raises(ValueError, match="head_group <= 4"):
        at.pv_fused(torch.zeros((B, 8, 1, TC)), planes, torch.ones((B, TC)),
                    torch.zeros((B, TC)), words, torch.zeros(8), t8)
    # without slots a wide head group is fine
    at.pv_fused(torch.zeros((B, 8, 1, TC)), planes, torch.ones((B, TC)),
                torch.zeros((B, TC)), words, torch.zeros(8),
                dataclasses.replace(t8, include_sparse=False))
    for bad in (dict(codes="int4", bits=4), dict(k_outliers="channels"),
                dict(post_rope_k=True)):
        d = dataclasses.replace(td, **bad)
        with pytest.raises(ValueError):
            at.pv_fused(torch.as_tensor(x["probs"]),
                        torch.as_tensor(x["planes"]),
                        torch.as_tensor(x["v_scale"]),
                        torch.as_tensor(x["v_offset"]),
                        torch.as_tensor(x["words"]),
                        torch.as_tensor(x["lut"]), d)


def test_launch_path_refuses_before_touching_the_card():
    """The CUDA launch path checks shapes before it builds or launches:
    a capacity off the 128-token granule, a head width the kernels do not
    take."""
    jd, td = _cfgs(3, 2)
    tm = ModelConfig(**_mk())
    x = _inputs(3, 2, td.n_slots, G, seed=5)
    planes = torch.as_tensor(x["planes"])[..., :3, :]  # 96 tokens
    with pytest.raises(ValueError, match="multiple of 128"):
        at._qk_launch(torch.as_tensor(x["q"]), planes,
                      torch.as_tensor(x["words"])[..., :96],
                      torch.as_tensor(x["k_range"]),
                      torch.as_tensor(x["k_offset"]),
                      torch.as_tensor(x["lut"]), td, tm)
    with pytest.raises(ValueError, match="d_head 16"):
        at._pv_launch(torch.as_tensor(x["probs"]),
                      torch.as_tensor(x["planes"]),
                      torch.as_tensor(x["v_scale"]),
                      torch.as_tensor(x["v_offset"]),
                      torch.as_tensor(x["words"]), torch.zeros(4), td)
    assert at.qk_fused.launches == at.pv_fused.launches == 0


def _colliding_words(pattern, hg, n_slots, seed, D=D):
    """Slot words (B, NG, n_slots, TC) where a design that keeps the slots
    in registers goes wrong: every slot of a token at one head and dim
    ("dim"); at a dim and its RoPE partner, d and d + D/2 alternating
    ("partner"); at dims D..127 ("beyond": nothing at the dim, but K3's
    rotation adds -v * sin at d - D/2 for d < 3D/2)."""
    rng = np.random.default_rng(seed)
    shape = (B, HKV // hg, n_slots, TC)
    head0 = rng.integers(0, hg, (B, HKV // hg, 1, TC))
    d0 = rng.integers(0, D, (B, HKV // hg, 1, TC))
    j = np.arange(n_slots)[None, None, :, None]
    if pattern == "dim":
        heads, dims = np.broadcast_to(head0, shape), np.broadcast_to(d0, shape)
    elif pattern == "partner":
        heads, dims = np.broadcast_to(head0, shape), (d0 + (j % 2) * (D // 2)) % D
    else:
        heads, dims = rng.integers(0, hg, shape), rng.integers(D, 128, shape)
    vals = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    vals[rng.random(shape) < 0.2] = 0.0
    idx = (heads << 7) | dims
    return np.asarray(jpk.encode_outlier_words(jnp.asarray(vals),
                                               jnp.asarray(idx)))


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
@pytest.mark.parametrize("pattern", ["dim", "partner", "beyond"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_colliding_slots_match_jax_kernel(kernel, pattern, R, dot_bf16):
    """Slot words that collide at one dim, at a dim and its RoPE partner,
    or lie at dims >= D, at R = 1/2/4/8 rows (the decode instances' row
    counts), head group 2, cap 2, in both dot modes: the plain version the
    kernels are held to on the card equals the JAX kernel."""
    jd, td = _cfgs(3, 2, dot_bf16=dot_bf16)
    x = _inputs(3, 2, td.n_slots, R, seed=R * 7 + len(pattern))
    words = _colliding_words(pattern, 2, td.n_slots, seed=R + 3)
    want, got = KERNELS[kernel](jd, td, x, words)
    if dot_bf16:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_slot_dims_beyond_the_head_match_jax_kernel(kernel, d, dot_bf16):
    """Slot words at dims D..127, which the quantizer never writes, at the
    widths of the card's edge grid: the JAX kernel's one-hot rotation adds
    -v * sin at d - D/2 for d < 3D/2 and nothing at d, and pv_fused drops
    them. The plain versions do the same (the port's K3 once dropped them
    too: ROADMAP queue 3)."""
    jd, td = _cfgs(3, 2, dot_bf16=dot_bf16, D=d)
    x = _inputs(3, 2, td.n_slots, 2, seed=d + dot_bf16, D=d)
    words = _colliding_words("beyond", 2, td.n_slots, seed=d, D=d)
    want, got = KERNELS[kernel](jd, td, x, words)
    if dot_bf16:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
