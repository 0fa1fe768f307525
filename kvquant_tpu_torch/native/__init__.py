"""Host-side runtime of the cache format: bit planes and outlier words off
the device (port of kvquant_tpu/native/__init__.py).

The four conversions run in the port's own C++ library,
``kvquant_tpu_torch/csrc/packing.cpp``, built on first use with the host
compiler (``$CXX``, else ``g++``) by ``ops/kernels/build.py`` into
``kvquant_tpu_torch/_build/`` and loaded with ctypes. They take and return
numpy arrays, for cache import / export and tooling, and they are a second
encoding of the layout that ``ops/packing.py`` and the cache written on the
card are held to.

There is no fallback: when the library cannot be built, each function
raises the build's RuntimeError, which names the compiler.
``have_native()`` probes for the library. The ``*_ref`` functions are
plain numpy versions of the same layout, for the tests.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops.kernels import build
from ..ops.packing import GROUP, OUTLIER_IDX_MASK as IDX_MASK, WPG


def _lib() -> ctypes.CDLL:
    lib = build.load("packing")
    if not getattr(lib, "_kvq_typed", False):
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.kvq_pack_codes.argtypes = [p_i32, p_i32, i64, i64, i64, i32]
        lib.kvq_unpack_codes.argtypes = [p_i32, p_i32, i64, i64, i64, i32]
        lib.kvq_encode_outliers.argtypes = [p_f32, p_i32, p_f32, i64]
        lib.kvq_decode_outliers.argtypes = [p_f32, p_f32, p_i32, i64]
        for fn in (lib.kvq_pack_codes, lib.kvq_unpack_codes,
                   lib.kvq_encode_outliers, lib.kvq_decode_outliers):
            fn.restype = None
        lib._kvq_typed = True
    return lib


def have_native() -> bool:
    """True when the C++ library builds and loads."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _codes_in(codes):
    codes = np.ascontiguousarray(codes, np.int32)
    *lead, T, D = codes.shape
    assert T % GROUP == 0, f"token axis must be a multiple of {GROUP}, got {T}"
    return codes, lead, int(np.prod(lead, dtype=np.int64)), T, D


def _planes_in(planes, bits):
    planes = np.ascontiguousarray(planes, np.int32)
    *lead, b_dim, TW, D = planes.shape
    assert b_dim == bits, f"planes hold {b_dim} bits, not {bits}"
    assert TW % WPG == 0, f"word rows must be a multiple of {WPG}, got {TW}"
    return planes, lead, int(np.prod(lead, dtype=np.int64)), 32 * TW, D


def pack_codes(codes: np.ndarray, bits: int) -> np.ndarray:
    """codes (..., T, D) in [0, 2**bits), T % 128 == 0 -> planes
    (..., bits, T//32, D) int32, the layout of ops.packing.pack_codes."""
    codes, lead, n, T, D = _codes_in(codes)
    out = np.empty((n, bits, T // 32, D), np.int32)
    _lib().kvq_pack_codes(codes.reshape(n, T, D), out, n, T, D, bits)
    return out.reshape(*lead, bits, T // 32, D)


def unpack_codes(planes: np.ndarray, bits: int) -> np.ndarray:
    """planes (..., bits, TW, D) int32 -> codes (..., 32*TW, D) int32."""
    planes, lead, n, T, D = _planes_in(planes, bits)
    out = np.empty((n, T, D), np.int32)
    _lib().kvq_unpack_codes(planes.reshape(n, bits, T // 32, D), out, n, T,
                            D, bits)
    return out.reshape(*lead, T, D)


def encode_outliers(vals: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """(vals fp32, idx = head_in_group << 7 | dim) -> fp32 outlier words."""
    vals = np.ascontiguousarray(vals, np.float32)
    idx = np.ascontiguousarray(idx, np.int32)
    assert vals.shape == idx.shape, (vals.shape, idx.shape)
    out = np.empty(vals.shape, np.float32)
    _lib().kvq_encode_outliers(vals.reshape(-1), idx.reshape(-1),
                               out.reshape(-1), vals.size)
    return out


def decode_outliers(words: np.ndarray):
    """fp32 outlier words -> (vals fp32, idx int32)."""
    words = np.ascontiguousarray(words, np.float32)
    vals = np.empty(words.shape, np.float32)
    idx = np.empty(words.shape, np.int32)
    _lib().kvq_decode_outliers(words.reshape(-1), vals.reshape(-1),
                               idx.reshape(-1), words.size)
    return vals, idx


# ---------------------------------------------------------------------------
# plain numpy versions of the same layout (the tests' reference)
# ---------------------------------------------------------------------------


def pack_codes_ref(codes: np.ndarray, bits: int) -> np.ndarray:
    codes, lead, n, T, D = _codes_in(codes)
    # token t = g*128 + j*4 + w sits at bit j of word row g*4 + w
    c = codes.reshape(n, T // GROUP, GROUP // WPG, WPG, D).astype(np.uint32)
    out = np.zeros((n, bits, T // GROUP, WPG, D), np.uint32)
    for b in range(bits):
        for j in range(GROUP // WPG):
            out[:, b] |= ((c[:, :, j] >> np.uint32(b)) & np.uint32(1)) \
                << np.uint32(j)
    return out.view(np.int32).reshape(*lead, bits, T // 32, D)


def unpack_codes_ref(planes: np.ndarray, bits: int) -> np.ndarray:
    planes, lead, n, T, D = _planes_in(planes, bits)
    w = planes.view(np.uint32).reshape(n, bits, T // GROUP, WPG, D)
    out = np.zeros((n, T // GROUP, GROUP // WPG, WPG, D), np.uint32)
    for b in range(bits):
        for j in range(GROUP // WPG):
            out[:, :, j] |= ((w[:, b] >> np.uint32(j)) & np.uint32(1)) \
                << np.uint32(b)
    return out.view(np.int32).reshape(*lead, T, D)


def encode_outliers_ref(vals: np.ndarray, idx: np.ndarray) -> np.ndarray:
    u = np.ascontiguousarray(vals, np.float32).view(np.uint32)
    i = np.asarray(idx).astype(np.uint32)
    return ((u & ~np.uint32(IDX_MASK)) | (i & np.uint32(IDX_MASK))).view(
        np.float32)


def decode_outliers_ref(words: np.ndarray):
    u = np.ascontiguousarray(words, np.float32).view(np.uint32)
    return (u & ~np.uint32(IDX_MASK)).view(np.float32), \
        (u & np.uint32(IDX_MASK)).astype(np.int32)
