"""Integer code containers and outlier words (port of the integer-container
half of kvquant_tpu/ops/packing.py:174-335; the bit-plane half belongs to
the "nuq" storage of the general flash kernel, a later slice).

torch has no int4 dtype. The JAX package's int4 arrays become uint8 nibble
pairs along d_head: byte j of a row holds dims 2j (low nibble) and 2j+1
(high nibble), each a 4-bit two's-complement value. int8 containers stay
int8. The write helpers update their target in place (the JAX functions
return a new array) and take host-side positions and predicates.
"""

from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# nibble pairs
# ---------------------------------------------------------------------------


def pack_nibbles(s: torch.Tensor) -> torch.Tensor:
    """Signed values in [-8, 7], (..., D) -> uint8 (..., D/2)."""
    s = s.to(torch.int32)
    lo = s[..., 0::2] & 0xF
    hi = s[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_nibbles(u: torch.Tensor) -> torch.Tensor:
    """uint8 (..., D/2) -> signed int32 values (..., D)."""
    x = u.to(torch.int32)
    lo = ((x & 0xF) ^ 8) - 8
    hi = ((x >> 4) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*u.shape[:-1], -1)


# ---------------------------------------------------------------------------
# int4 / int8 containers (DeployConfig.codes "int4"/"int8")
# ---------------------------------------------------------------------------


def store_codes_int(codes: torch.Tensor, bits: int, dtype) -> torch.Tensor:
    """Unsigned codes (..., D) in [0, 2**bits) -> container rows: uint8
    nibble pairs (..., D/2) for ``dtype`` uint8, else int8 (..., D)."""
    s = codes.to(torch.int32) - (1 << (bits - 1))
    if dtype == torch.uint8:
        return pack_nibbles(s)
    return s.to(dtype)


def load_codes_int(arr: torch.Tensor, bits: int) -> torch.Tensor:
    """Container rows -> unsigned int32 codes (..., D)."""
    s = unpack_nibbles(arr) if arr.dtype == torch.uint8 else arr.to(torch.int32)
    return s + (1 << (bits - 1))


def place_codes_int(arr, codes, p0: int, bits: int):
    """Write an aligned token block in place: arr (..., H, Tc, Dc), codes
    (..., T, H, D) int32 unsigned, block start ``p0``. Returns ``arr``."""
    c = torch.movedim(codes, -3, -2)  # (..., H, T, D)
    T = c.shape[-2]
    arr[..., p0:p0 + T, :] = store_codes_int(c, bits, arr.dtype)
    return arr


# ---------------------------------------------------------------------------
# int4x2: two 2-bit codes per nibble via head pairing
# (value c_even + 4*c_odd - 8 for kv heads 2j, 2j+1)
# ---------------------------------------------------------------------------


def pair_codes_int4x2(codes: torch.Tensor) -> torch.Tensor:
    """Unsigned 2-bit codes (..., H, D) (head axis -2) -> (..., H//2, D/2)
    uint8 nibble pairs of c_even + 4*c_odd - 8."""
    c = codes.to(torch.int32)
    return pack_nibbles(c[..., 0::2, :] + 4 * c[..., 1::2, :] - 8)


def unpair_codes_int4x2(arr: torch.Tensor) -> torch.Tensor:
    """(..., H//2, Tc, D/2) uint8 (head axis -3) -> (..., H, Tc, D) int32
    unsigned codes, heads re-interleaved."""
    x = unpack_nibbles(arr) + 8  # c_even + 4*c_odd in [0, 16)
    st = torch.stack([x & 3, x >> 2], dim=-3)  # (..., H//2, 2, Tc, D)
    return st.reshape(*arr.shape[:-3], -1, *st.shape[-2:])


def place_codes_int4x2(arr, codes, p0: int):
    """Write an aligned token block of paired codes in place: arr
    (..., H//2, Tc, D/2) uint8, codes (..., T, H, D) int32 unsigned."""
    c = torch.movedim(pair_codes_int4x2(codes), -3, -2)  # (..., H//2, T, D/2)
    T = c.shape[-2]
    arr[..., p0:p0 + T, :] = c
    return arr


# ---------------------------------------------------------------------------
# row writes
# ---------------------------------------------------------------------------


def set_token_rows(arr, rows, pos: int, pred: bool = True):
    """Write one token's encoded container rows at position ``pos`` (clipped
    to the capacity) in place, unless ``pred`` is False.

    arr: (..., Tc, Dc); rows: (..., Dc) in the container dtype."""
    if pred:
        pos = min(max(int(pos), 0), arr.shape[-2] - 1)
        arr[..., pos, :] = rows.to(arr.dtype)
    return arr


def set_token_rows_at_layer(arr, rows, li: int, pos: int, pred: bool = True):
    """Write one token's encoded rows into layer ``li`` of the stacked
    array in place: arr (L, H', Tc, Dc); rows (H', Dc)."""
    set_token_rows(arr[li], rows, pos, pred)
    return arr


# ---------------------------------------------------------------------------
# outlier word encoding: ONE fp32 word per slot, the residual value with its
# low 9 mantissa bits replaced by the ``head_in_group << 7 | dim`` index
# ---------------------------------------------------------------------------

OUTLIER_DIM_MASK = 0x7F     # low 7 bits: dim within the head
OUTLIER_IDX_MASK = 0x1FF    # full 9-bit (head_in_group, dim) field
_VALUE_MASK = -512          # ~0x1FF as int32 (0xFFFFFE00)


def encode_outlier_words(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(vals fp32, idx int = head_in_group << 7 | dim) -> fp32 words. The
    bit patterns are reinterpreted (``view``), never converted: a zero
    value leaves a denormal holding only the index bits."""
    bits = vals.to(torch.float32).contiguous().view(torch.int32)
    word = (bits & _VALUE_MASK) | (idx.to(torch.int32) & OUTLIER_IDX_MASK)
    return word.view(torch.float32)


def decode_outlier_words(words: torch.Tensor):
    """fp32 words -> (vals fp32, idx int32 = head_in_group << 7 | dim)."""
    u = words.contiguous().view(torch.int32)
    return (u & _VALUE_MASK).view(torch.float32), u & OUTLIER_IDX_MASK
