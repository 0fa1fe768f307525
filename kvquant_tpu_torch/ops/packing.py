"""Code containers and outlier words (port of kvquant_tpu/ops/packing.py).

Bit planes ("nuq" storage): (..., bits, TW, D) int32, head_dim last, the
planes packed along the TOKEN axis in 128-token groups: token t of group
g = t // 128 lives in word row ``g*4 + t % 4`` at bit ``(t % 128) // 4``.
One int32 word row per plane holds 32 tokens. The words are the JAX
package's bit for bit; torch has no uint32 shifts, so the bit arithmetic
runs on int64 and wraps back to int32.

torch has no int4 dtype. The JAX package's int4 arrays become uint8 nibble
pairs along d_head: byte j of a row holds dims 2j (low nibble) and 2j+1
(high nibble), each a 4-bit two's-complement value. int8 containers stay
int8. The write helpers update their target in place (the JAX functions
return a new array). ``set_token_codes`` / ``set_token_rows`` take a host
position and predicate; ``set_token_bits`` / ``write_rows`` take (B,)
tensors of both on the target's device (JAX's ``_write_row_b``): the
decode step's writes, which read nothing back to the host. The block
writes of a prefill chunk (``place_planes``, ``place_codes_int``,
``place_codes_int4x2``, ``write_block``) take their start as a host int or
as an int tensor on the device (JAX's ``dynamic_update_slice``).
"""

from __future__ import annotations

import torch

GROUP = 128  # tokens per packing group
WPG = 4  # int32 words per group and plane


# ---------------------------------------------------------------------------
# bit planes (DeployConfig.codes "nuq")
# ---------------------------------------------------------------------------


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bit pattern."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def token_word_bit(pos):
    """Word row index and bit position of packed token ``pos``: host ints
    for an int, tensors of its dtype for a tensor of positions."""
    if isinstance(pos, torch.Tensor):
        r = pos % GROUP
        return (pos - r) // (GROUP // WPG) + r % WPG, r // WPG
    g, r = divmod(int(pos), GROUP)
    return g * WPG + r % WPG, r // WPG


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """codes (..., T, D) in [0, 2**bits) with T % 128 == 0 -> planes
    (..., bits, T//32, D) int32."""
    *lead, T, D = codes.shape
    assert T % GROUP == 0, f"token axis must be a multiple of {GROUP}, got {T}"
    # (..., g, j, w, D): token t = g*128 + j*4 + w
    c = codes.to(torch.int64).reshape(*lead, T // GROUP, GROUP // WPG, WPG, D)
    weights = (1 << torch.arange(GROUP // WPG, dtype=torch.int64,
                                 device=codes.device))[:, None, None]
    planes = [((((c >> b) & 1) * weights).sum(dim=-3)).reshape(*lead, T // 32, D)
              for b in range(bits)]
    return _to_int32(torch.stack(planes, dim=-3))


def unpack_codes(planes: torch.Tensor, bits: int) -> torch.Tensor:
    """planes (..., bits, TW, D) int32 -> codes (..., 32*TW, D) int32."""
    *lead, b_dim, TW, D = planes.shape
    assert b_dim == bits and TW % WPG == 0
    words = (planes.to(torch.int64) & 0xFFFFFFFF).reshape(
        *lead, bits, TW // WPG, 1, WPG, D)
    shifts = torch.arange(GROUP // WPG, dtype=torch.int64,
                          device=planes.device).reshape(-1, 1, 1)
    bitvals = (words >> shifts) & 1  # (..., bits, g, j, w, D)
    codes = sum(bitvals.select(-5, b) << b for b in range(bits))
    return codes.reshape(*lead, 32 * TW, D).to(torch.int32)


def set_token_codes(planes: torch.Tensor, codes: torch.Tensor, pos: int,
                    pred: bool = True) -> torch.Tensor:
    """Write one token's codes at packed position ``pos`` in place: clear
    then set its bit in its word row of every plane, unless ``pred`` is
    False. planes (..., bits, TW, D) int32; codes (..., D). The form at
    position tensors is ``set_token_bits``."""
    if not pred:
        return planes
    bits = planes.shape[-3]
    w, j = token_word_bit(pos)
    assert 0 <= w < planes.shape[-2], (pos, planes.shape)
    row = planes[..., w, :].to(torch.int64) & 0xFFFFFFFF  # (..., bits, D)
    shifts = torch.arange(bits, dtype=torch.int64,
                          device=planes.device)[:, None]
    bitvals = ((codes.to(torch.int64)[..., None, :] >> shifts) & 1) << j
    planes[..., w, :] = _to_int32((row & ~(1 << j)) | bitvals)
    return planes


def set_token_bits(planes, codes, word, bit, pred):
    """``set_token_codes`` at tensor positions given as their word rows and
    bits ((B,) int64, ``token_word_bit``), in place: sample b's word row
    of planes (B, ..., bits, TW, D) is gathered, its bit set from codes
    (B, ..., D) where pred[b], and scattered back. int32 throughout: the
    bit operations give the same 32-bit words as the host path's int64."""
    B = planes.shape[0]
    lead = (B,) + (1,) * (planes.dim() - 1)
    index = word.view(lead).expand(*planes.shape[:-2], 1, planes.shape[-1])
    old = torch.gather(planes, -2, index)  # (B, ..., bits, 1, D)
    planes.scatter_(-2, index, torch.where(pred.view(lead),
                                           token_bits(old, codes, bit), old))
    return planes


def token_bits(old, codes, bit):
    """Word rows ``old`` (B, ..., bits, 1, D) int32 with sample b's bit
    ``bit[b]`` of every plane set from its codes (B, ..., D)."""
    bits = old.shape[-3]
    j = bit.to(torch.int32).view((old.shape[0],) + (1,) * (old.dim() - 1))
    shifts = torch.arange(bits, dtype=torch.int32, device=old.device)[:, None]
    bitvals = (codes.to(torch.int32)[..., None, :] >> shifts) & 1
    return (old & ~(torch.ones_like(j) << j)) | (bitvals[..., None, :] << j)


def set_token_codes_at_layer(planes, codes, li: int, pos: int,
                             pred: bool = True):
    """One sample's token codes into layer ``li`` of the stacked planes, in
    place: planes (L, H, bits, TW, D); codes (H, D)."""
    set_token_codes(planes[li], codes, pos, pred)
    return planes


def set_token_codes_at_layer_uniform(planes, codes, li: int, pos: int,
                                     pred: bool = True):
    """Every sample's token codes at one shared position into layer ``li``,
    in place: planes (L, B, H, bits, TW, D); codes (B, H, D)."""
    set_token_codes(planes[li], codes, pos, pred)
    return planes


def write_block(arr, block, p0, axis: int = -2):
    """Set ``arr``'s rows p0 .. p0 + n - 1 along ``axis`` to ``block`` (n
    rows along that axis) in place: JAX's ``dynamic_update_slice``.
    ``p0`` is a host int (a slice, which must fit) or a 0-d / (1,) int
    tensor on ``arr``'s device (``index_copy_`` at p0 + arange(n), which
    reads nothing back to the host; the caller checks that the block fits).
    Both give the same array."""
    n = block.shape[axis]
    block = block.to(arr.dtype)
    if isinstance(p0, torch.Tensor):
        idx = p0.reshape(()).long() + torch.arange(n, device=arr.device)
        return arr.index_copy_(axis % arr.dim(), idx, block)
    assert 0 <= p0 and p0 + n <= arr.shape[axis], (p0, n, arr.shape)
    arr.narrow(axis, p0, n).copy_(block)
    return arr


def place_planes(planes, codes, p0, bits: int):
    """Write an aligned token block in place: planes (..., H, bits, TW, D),
    codes (..., T, H, D) unsigned, block start ``p0`` (a multiple of 128,
    which the caller checks; a host int or a 0-d / (1,) int tensor on the
    device, ``write_block``). The block pads to whole 128-token groups
    with code 0, as the JAX package's prompt pack does."""
    if not isinstance(p0, torch.Tensor):
        assert p0 % GROUP == 0, p0
    c = torch.movedim(codes, -3, -2)  # (..., H, T, D)
    T = c.shape[-2]
    pad = -T % GROUP
    if pad:
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
    return write_block(planes, pack_codes(c, bits), p0 // 32, axis=-2)


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


def place_codes_int(arr, codes, p0, bits: int):
    """Write an aligned token block in place: arr (..., H, Tc, Dc), codes
    (..., T, H, D) int32 unsigned, block start ``p0`` (a host int or a
    0-d / (1,) int tensor on the device, ``write_block``). Returns
    ``arr``."""
    c = torch.movedim(codes, -3, -2)  # (..., H, T, D)
    return write_block(arr, store_codes_int(c, bits, arr.dtype), p0)


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


def place_codes_int4x2(arr, codes, p0):
    """Write an aligned token block of paired codes in place: arr
    (..., H//2, Tc, D/2) uint8, codes (..., T, H, D) int32 unsigned,
    ``p0`` as in ``place_codes_int``."""
    c = torch.movedim(pair_codes_int4x2(codes), -3, -2)  # (..., H//2, T, D/2)
    return write_block(arr, c, p0)


# ---------------------------------------------------------------------------
# row writes
# ---------------------------------------------------------------------------


def write_rows(arr, rows, idx, pred, axis: int):
    """Per-sample predicated row write along ``axis``, in place (JAX's
    ``_write_row_b``): arr (B, ...); rows (B, ...) arr's shape without
    ``axis``; idx (B,) int64 tensor in [0, arr.shape[axis]); pred (B,)
    bool tensor: sample b's row keeps its old value where pred[b] is
    False. Gathered and scattered on the device; one call serves a uniform
    and per-sample positions."""
    axis = axis % arr.dim()
    B = arr.shape[0]
    lead = (B,) + (1,) * (arr.dim() - 1)
    shape = list(arr.shape)
    shape[axis] = 1
    index = idx.view(lead).expand(shape)
    old = torch.gather(arr, axis, index)
    new = rows.unsqueeze(axis).to(arr.dtype)
    arr.scatter_(axis, index, torch.where(pred.view(lead), new, old))
    return arr


def set_token_rows(arr, rows, pos: int, pred: bool = True):
    """Write one token's encoded container rows at position ``pos`` (clipped
    to the capacity) in place, unless ``pred`` is False.

    arr: (..., Tc, Dc); rows: (..., Dc) in the container dtype. The form at
    position tensors is ``write_rows``."""
    if pred:
        pos = min(max(int(pos), 0), arr.shape[-2] - 1)
        arr[..., pos, :] = rows.to(arr.dtype)
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
