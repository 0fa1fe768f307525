"""Helpers shared by the attention kernel wrappers (flash_serial, K2,
flash_decode, K1, and attention, K3/K4): the affine-codebook fold, the
codes and outlier addends their plain versions multiply, operand checks
and the card's SM count.

``fold_affine`` is the port of kvquant_tpu/ops/pallas/flash_decode.py:
fold_affine for one layer. Both CUDA kernels fold the codebook themselves
from the LUT endpoints with the same fp32 operations; the plain versions
call this function.
"""

from __future__ import annotations

import functools

import torch

from ...cache import DeployConfig
from ..packing import unpack_nibbles, unpair_codes_int4x2

TILE_TOKENS = 128  # the kernels' cache capacity granule
MAX_KC = 64  # static K channels per head group the kernels take (csrc)
MAX_SINK = 64  # sink tokens the merge kernels take (csrc)


def fold_affine(dcfg: DeployConfig, k_lut, v_lut, k_range, k_offset, li: int):
    """Layer ``li``'s affine codebook folded into the dequant constants, so
    a signed container code c_s dequantizes as ``c_s*k_step + k_zero`` (K)
    and ``c_s*(v_scale*vb) + (v_scale*va + v_offset)`` (V). Returns
    (k_step (Hkv, D), k_zero (Hkv, D), va, vb)."""
    K = 2 ** dcfg.bits
    bias = dcfg.code_bias
    kl, vl = k_lut[li], v_lut[li]
    kb = (kl[-1] - kl[0]) / (K - 1)
    ka = kl[0] + bias * kb
    vb = (vl[-1] - vl[0]) / (K - 1)
    va = vl[0] + bias * vb
    return kb * k_range[li], ka * k_range[li] + k_offset[li], va, vb


def signed_codes(planes, dcfg: DeployConfig):
    """Integer container (B, H', Tc, Dc) -> the codes a folded dequant
    multiplies, (B, Hkv, Tc, D) fp32: signed (code - bias) for int4/int8,
    unsigned for int4x2 (bias 0)."""
    if dcfg.codes == "int4x2":
        return unpair_codes_int4x2(planes).to(torch.float32)
    if dcfg.codes == "int4":
        return unpack_nibbles(planes).to(torch.float32)
    return planes.to(torch.float32)


def channel_addend(rows, chan, dcfg: DeployConfig):
    """Dense (B, Hkv, Tc, D) K addend from the static-channel residual rows
    (B, NG, n_kc, Tc) at group-space channels ``chan`` (NG, n_kc)."""
    B, NG, N, Tc = rows.shape
    hg, D = dcfg.head_group, dcfg.d_head
    dense = torch.zeros((B, NG, Tc, hg * D), dtype=torch.float32,
                        device=rows.device)
    dense.scatter_add_(-1, chan.long()[None, :, None, :].expand(B, NG, Tc, N),
                       rows.transpose(-1, -2))
    return dense.reshape(B, NG, Tc, hg, D).transpose(2, 3).reshape(
        B, NG * hg, Tc, D)


def check_operands(kernel: str, expect: dict, dev: torch.device):
    """Raise ValueError unless every ``name: (tensor, shape, dtype)`` lies
    on ``dev`` with that shape and dtype and is contiguous."""
    for name, (t, shape, dt) in expect.items():
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, queries "
                             f"on {dev}")
        if tuple(t.shape) != tuple(shape) or t.dtype != dt:
            raise ValueError(f"{kernel}: {name}: {tuple(t.shape)} {t.dtype}, "
                             f"kernel takes {tuple(shape)} {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())
