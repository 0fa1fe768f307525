"""The port's host packer (kvquant_tpu_torch/native, its C++ library
kvquant_tpu_torch/csrc/packing.cpp) against the JAX package, bit for bit,
on the same seeded numpy inputs (the mirror of tests/test_native.py):

  - pack_codes equals JAX's ops.packing.pack_codes and kvquant_tpu.native
    for bits 2 / 3 / 4, T 128 / 256 / 1024 and leading shapes (), (3,),
    (2, 1, 4); unpack_codes round trips and equals JAX's unpack_codes;
  - the outlier words equal JAX's encode_outlier_words and
    kvquant_tpu.native on their bit patterns, indices 0-511, values with
    +-0.0, negatives, denormals and the low 9 mantissa bits set;
  - each C++ function equals its numpy *_ref version and the port's torch
    ops/packing on the CPU;
  - there is no fallback: with the host compiler missing or failing, the
    functions raise and have_native() is False.

The library is built here with g++ into kvquant_tpu_torch/_build/."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvquant_tpu import native as jnative
from kvquant_tpu.ops import packing as jpacking
from kvquant_tpu_torch import native
from kvquant_tpu_torch.ops import packing
from kvquant_tpu_torch.ops.kernels import build

SHAPES = [(bits, T, lead) for bits in (2, 3, 4) for T in (128, 256, 1024)
          for lead in ((), (3,), (2, 1, 4))]


def _codes(bits, T, lead, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** bits, size=(*lead, T, 8)).astype(np.int32)


def test_library_builds_into_the_ignored_build_dir():
    assert native.have_native()
    lib = build.library_path("packing")
    assert os.path.dirname(lib) == build.BUILD_DIR
    assert build.BUILD_DIR == os.path.join(
        os.path.dirname(os.path.dirname(native.__file__)), "_build")
    assert os.path.exists(lib)
    assert build.source_path("packing") == os.path.join(build.CSRC_DIR,
                                                        "packing.cpp")
    # nothing is written beside the package's modules
    assert not [f for f in os.listdir(os.path.dirname(native.__file__))
                if f.endswith(".so")]


@pytest.mark.parametrize("bits,T,lead", SHAPES)
def test_pack_matches_jax(bits, T, lead):
    codes = _codes(bits, T, lead, seed=T + bits)
    got = native.pack_codes(codes, bits)
    assert got.shape == (*lead, bits, T // 32, 8) and got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.asarray(jpacking.pack_codes(jnp.asarray(codes), bits)))
    np.testing.assert_array_equal(got, jnative.pack_codes(codes, bits))
    np.testing.assert_array_equal(got, native.pack_codes_ref(codes, bits))
    np.testing.assert_array_equal(
        got, packing.pack_codes(torch.as_tensor(codes), bits).numpy())


@pytest.mark.parametrize("bits,T,lead", SHAPES)
def test_unpack_round_trips_and_matches_jax(bits, T, lead):
    codes = _codes(bits, T, lead, seed=7 * T + bits)
    planes = native.pack_codes(codes, bits)
    got = native.unpack_codes(planes, bits)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, codes)
    np.testing.assert_array_equal(
        got, np.asarray(jpacking.unpack_codes(jnp.asarray(planes), bits)))
    np.testing.assert_array_equal(got, jnative.unpack_codes(planes, bits))
    np.testing.assert_array_equal(got, native.unpack_codes_ref(planes, bits))
    np.testing.assert_array_equal(
        got, packing.unpack_codes(torch.as_tensor(planes), bits).numpy())


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_unpack_of_any_words(bits):
    """Every int32 word is a valid plane: bit 31 and negative words too."""
    rng = np.random.default_rng(bits)
    planes = rng.integers(-2 ** 31, 2 ** 31, size=(2, bits, 16, 8),
                          dtype=np.int64).astype(np.int32)
    got = native.unpack_codes(planes, bits)
    np.testing.assert_array_equal(
        got, np.asarray(jpacking.unpack_codes(jnp.asarray(planes), bits)))
    np.testing.assert_array_equal(got, native.unpack_codes_ref(planes, bits))
    np.testing.assert_array_equal(native.pack_codes(got, bits), planes)


def _outlier_inputs():
    rng = np.random.default_rng(2)
    idx = np.arange(512, dtype=np.int32).reshape(2, 4, 64)
    vals = rng.normal(size=idx.shape).astype(np.float32)
    flat = vals.reshape(-1)
    flat[:6] = [0.0, -0.0, -1.5, 1e-40, -1e-40, 3.0e38]
    # low 9 mantissa bits set: the encoding must clear them
    u = flat[6:64].view(np.uint32)
    u |= np.uint32(0x1FF)
    return vals, idx


def test_outlier_words_match_jax():
    vals, idx = _outlier_inputs()
    words = native.encode_outliers(vals, idx)
    assert words.shape == vals.shape and words.dtype == np.float32
    bits = words.view(np.uint32)
    want = np.asarray(jpacking.encode_outlier_words(jnp.asarray(vals),
                                                    jnp.asarray(idx)))
    np.testing.assert_array_equal(bits, want.view(np.uint32))
    np.testing.assert_array_equal(
        bits, jnative.encode_outliers(vals, idx).view(np.uint32))
    np.testing.assert_array_equal(
        bits, native.encode_outliers_ref(vals, idx).view(np.uint32))
    np.testing.assert_array_equal(
        bits, packing.encode_outlier_words(
            torch.as_tensor(vals), torch.as_tensor(idx)).numpy().view(
                np.uint32))
    assert (bits[0, 0, :2] >> 9 == [0, 1 << 22]).all()  # +0.0 / -0.0 kept

    v, i = native.decode_outliers(words)
    assert v.dtype == np.float32 and i.dtype == np.int32
    np.testing.assert_array_equal(i, idx)
    np.testing.assert_array_equal(v.view(np.uint32),
                                  vals.view(np.uint32) & ~np.uint32(0x1FF))
    jv, ji = jpacking.decode_outlier_words(jnp.asarray(words))
    nv, ni = jnative.decode_outliers(words)
    rv, ri = native.decode_outliers_ref(words)
    tv, ti = packing.decode_outlier_words(torch.as_tensor(words))
    for wv, wi in ((np.asarray(jv), np.asarray(ji)), (nv, ni), (rv, ri),
                   (tv.numpy(), ti.numpy())):
        np.testing.assert_array_equal(v.view(np.uint32), wv.view(np.uint32))
        np.testing.assert_array_equal(i, wi)


def test_layout_asserts():
    with pytest.raises(AssertionError):
        native.pack_codes(np.zeros((2, 96, 8), np.int32), 3)
    with pytest.raises(AssertionError):
        native.unpack_codes(np.zeros((2, 3, 8, 8), np.int32), 2)
    with pytest.raises(AssertionError):
        native.encode_outliers(np.zeros(4, np.float32), np.zeros(3, np.int32))


def _fresh_build(monkeypatch, tmp_path, cxx):
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_loaded", {})


def test_no_fallback_without_a_compiler(monkeypatch, tmp_path):
    missing = str(tmp_path / "no_such_dir" / "g++")
    _fresh_build(monkeypatch, tmp_path, missing)
    codes = _codes(3, 128, (), seed=0)
    for call in (lambda: native.pack_codes(codes, 3),
                 lambda: native.unpack_codes(np.zeros((3, 4, 8), np.int32), 3),
                 lambda: native.encode_outliers(np.zeros(2, np.float32),
                                                np.zeros(2, np.int32)),
                 lambda: native.decode_outliers(np.zeros(2, np.float32))):
        with pytest.raises(RuntimeError, match="no_such_dir"):
            call()
    assert not native.have_native()
    assert not os.path.exists(tmp_path / "build")


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "cxx"
    fake.write_text("#!/bin/sh\necho 'no luck here' >&2\nexit 3\n")
    fake.chmod(0o755)
    _fresh_build(monkeypatch, tmp_path, str(fake))
    with pytest.raises(RuntimeError, match="(?s)cxx failed for packing.cpp "
                                           r"\(3\).*no luck here"):
        native.pack_codes(_codes(2, 128, (), seed=0), 2)
    assert not native.have_native()
    assert os.listdir(tmp_path / "build") == []  # no half-written library
