"""Decode attention over the paged pool (port of kvquant_tpu/paged.py:
paged_flash_decode, the TPU kernel K5).

K5 is K1 (``flash_decode.flash_attention``) at Tq = 1 whose token blocks
go through a (B, MP) int32 page table into the (L, NP, ...) pool of
``paged.PagedPool``: slot b's logical packed token t lives in page
``table[b, t // P]`` at row ``t % P`` (P = ``dcfg.page_tokens``). The
token-block index is clamped to the slot's last live page before the
lookup (``paged.py:211-216``), so trailing table entries may hold anything.
Sinks stay per slot, (L, B, Hkv, S, D).

  - CPU tensors: the plain version ``paged_flash_decode_ref`` gathers each
    slot's pages into a contiguous (1, B, ...) layer and calls K1's plain
    version, so K1 and K5 share one oracle.
  - CUDA tensors: ``fd_paged_attention`` of ``csrc/flash_decode.cu``, K1's
    decode kernel (``fd_decode``) instantiated with the paged addressing
    policy, or an exception; there is no fallback.

With bf16 dots, 3, 5, 6 or 7 query rows per kv head run the tensor-core
decode body ``fd_gqa`` (``flash_decode.GQA_ROWS``) in one launch; the
SIMT body ``fd_decode`` is instantiated for 1, 2, 4 and 8 rows, and other
head ratios (fp32 dots, or more than 8 rows) are padded with zero queries
to the next instance (``paged_plan``, ``common.padded_launches``).
``paged_flash_decode.launches`` counts kernel launches. Every storage mode
of K1 is taken, int4x2 included (pool code arrays (L, NP, Hkv/2, P, D/2));
a page must hold whole 128-token bit-plane groups, so
``page_tokens % 128 != 0`` raises ValueError.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...cache import DeployConfig, k_channel_index
from ..packing import GROUP
from .common import check_operands, decode_rows, padded_launches
from .flash_decode import (_check_config, _lib, body, decode_plan,
                           decode_splits, flash_attention_ref, gqa_plan,
                           gqa_splits, kernel_limits, run_kernel)


def _check(dcfg: DeployConfig):
    _check_config(dcfg)
    if dcfg.page_tokens % GROUP:
        raise ValueError(f"paged_flash_decode: page_tokens "
                         f"{dcfg.page_tokens} is not a multiple of {GROUP} "
                         f"(a page holds whole bit-plane groups)")


class PagedPlan(NamedTuple):
    """A K5 call of G query rows per kv head on the card: the decode
    ``body`` of each launch ("gqa", fd_gqa, or "decode", fd_decode), its
    ``rows`` (G in one launch on fd_gqa, else ``decode_rows(G)``, zero
    rows padding G),
    ``launches`` of them, and each launch's block shape (heads per block
    ``hb``, ring ``stages``, ``tile`` tokens) and token splits
    ``n_split``."""
    body: str
    rows: int
    launches: int
    hb: int
    stages: int
    tile: int
    n_split: int


def paged_plan(dcfg: DeployConfig, B: int, Hkv: int, G: int, D: int, J: int,
               Tc: int, sms: int) -> PagedPlan:
    """The plan of a K5 call over ``Tc`` = MP * P table tokens per slot,
    as the wrapper launches it (``flash_decode.run_kernel``'s block shape
    and splits: one launch of G rows where ``flash_decode.body`` routes a
    step of G rows to fd_gqa, else launches of the padded rows on the body
    that takes them). Raises ValueError for a configuration the kernel
    does not take."""
    _check(dcfg)
    R = G if G >= 1 and body(dcfg, G, 1) == "gqa" else decode_rows(G)
    if body(dcfg, R, 1) == "gqa":
        plan = gqa_plan(dcfg, D, J, R)
        return PagedPlan("gqa", R, -(-G // R), plan.hb, plan.stages,
                         plan.tile, gqa_splits(plan, B, Hkv, Tc, sms))
    n_kc, n_ks, n_vs = kernel_limits(dcfg, D, J)
    rows = bool(n_kc or n_ks or n_vs)
    hb, stages, tile = decode_plan(dcfg, D, J, rows)
    return PagedPlan("decode", R, -(-G // R), hb, stages, tile,
                     decode_splits(dcfg, B, Hkv, R, D, J, rows, n_kc, Tc,
                                   sms))


def live_pages(page_table, pos, dcfg: DeployConfig):
    """(B, MP) page ids the attention reads: slot b's token-block index t
    clamped to its last live page, ``max((pos[b] - S) // P, 0)``, then
    looked up in its table row (dead blocks repeat the last live page)."""
    MP = page_table.shape[1]
    last = torch.clamp(
        torch.div(pos.to(torch.int64) - dcfg.sink, dcfg.page_tokens,
                  rounding_mode="floor"), min=0)
    t = torch.arange(MP, device=page_table.device)
    idx = torch.minimum(t[None], last[:, None])
    return torch.gather(page_table.to(torch.int64), 1, idx)


def gather_layer(pool, ids, li: int, dcfg: DeployConfig) -> dict:
    """Layer ``li`` of the pages ``ids`` (B, MP) laid out contiguously, as
    K1's (B, ...) cache arrays of capacity MP * P (bit-plane word rows and
    container rows concatenate page after page)."""
    B, MP = ids.shape
    T = MP * dcfg.page_tokens

    def tokens_last(a, tok_axis):  # (B, MP, ...) -> pages next to tokens
        a = torch.movedim(a, 1, tok_axis)
        return a.reshape(*a.shape[:tok_axis], T * a.shape[tok_axis + 1]
                         // dcfg.page_tokens, *a.shape[tok_axis + 2:])

    code_axis = 3 if dcfg.codes == "nuq" else 2  # (B, H, [bits,] MP, ...)
    return dict(
        k_planes=tokens_last(pool.k_planes[li][ids], code_axis),
        v_planes=tokens_last(pool.v_planes[li][ids], code_axis),
        kv_out=tokens_last(pool.kv_out[li][ids], 3),
        v_scale=pool.v_scale[li][ids].reshape(B, T),
        v_offset=pool.v_offset[li][ids].reshape(B, T),
    )


def paged_flash_decode_ref(q_rot, pool, page_table, dq, li, pos,
                           dcfg: DeployConfig, mcfg, k_chan=None):
    """Plain PyTorch version: each slot's live pages gathered into a
    contiguous layer, then K1's plain version at Tq = 1."""
    _check(dcfg)
    li = int(li)
    B = q_rot.shape[0]
    dev = q_rot.device
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev).reshape(-1)
    pos = pos.expand(B)
    ids = live_pages(torch.as_tensor(page_table, device=dev), pos, dcfg)
    g = gather_layer(pool, ids, li, dcfg)
    one = lambda t: t[li][None]  # noqa: E731
    return flash_attention_ref(
        q_rot, g["k_planes"][None], g["v_planes"][None], g["kv_out"][None],
        one(dq.k_range), one(dq.k_offset), g["v_scale"][None],
        g["v_offset"][None], one(pool.k_sink), one(pool.v_sink),
        one(dq.k_lut_dec), one(dq.v_lut_dec), 0, pos, dcfg, mcfg, Tq=1,
        block_tokens=dcfg.page_tokens, k_ressc=one(dq.k_ressc),
        k_chan=None if k_chan is None else one(k_chan))


def paged_flash_decode(q_rot, pool, page_table, dq, li, pos,
                       dcfg: DeployConfig, mcfg, k_chan=None):
    """One decode step's attention over sink + paged packed cache for layer
    ``li`` (the JAX signature): q_rot (B, Hkv, G, D) fp32 roped at each
    slot's position, ``pool`` a ``paged.PagedPool``, ``page_table`` (B, MP)
    int32 (on the card: an int32 tensor there), ``dq`` the full (L, ...)
    quantizer arrays, ``pos`` (B,) positions. ``k_chan`` (L, n_groups,
    n_kc) may carry the static K channels ("channels" mode). Returns
    (B, Hkv, G, D) fp32."""
    _check(dcfg)
    if q_rot.device.type == "cpu":
        return paged_flash_decode_ref(q_rot, pool, page_table, dq, li, pos,
                                      dcfg, mcfg, k_chan=k_chan)
    if q_rot.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device "
                         f"{q_rot.device}")
    li = int(li)
    q_rot = q_rot.contiguous()
    B, Hkv, G, D = q_rot.shape
    dev = q_rot.device
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(pos, dtype=torch.int32).reshape(-1)
    pos = pos.to(device=dev, dtype=torch.int32).expand(B).contiguous()
    L, NP = pool.k_planes.shape[:2]
    P, S, hg, bits = dcfg.page_tokens, dcfg.sink, dcfg.head_group, dcfg.bits
    NG = Hkv // hg
    MP = page_table.shape[1]
    J = pool.kv_out.shape[-2]
    n_kc = kernel_limits(dcfg, D, J)[0]
    k_chan_l = None
    if n_kc:
        k_chan_l = (k_chan[li] if k_chan is not None
                    else k_channel_index(dq.k_ressc[li], dcfg))
        k_chan_l = k_chan_l.to(torch.int32).contiguous()
    if dcfg.codes == "nuq":
        code = ((L, NP, Hkv, bits, P // 32, D), torch.int32)
    else:
        code = ((L, NP, dcfg.code_heads, P, dcfg.code_cols),
                dcfg.code_dtype)
    expect = {
        "q_rot": (q_rot, (B, Hkv, G, D), torch.float32),
        "k_planes": (pool.k_planes, *code),
        "v_planes": (pool.v_planes, *code),
        "kv_out": (pool.kv_out, (L, NP, NG, J, P), torch.float32),
        "k_range": (dq.k_range, (L, Hkv, D), torch.float32),
        "k_offset": (dq.k_offset, (L, Hkv, D), torch.float32),
        "v_scale": (pool.v_scale, (L, NP, P), torch.float32),
        "v_offset": (pool.v_offset, (L, NP, P), torch.float32),
        "k_sink": (pool.k_sink, (L, B, Hkv, S, D), torch.float32),
        "v_sink": (pool.v_sink, (L, B, Hkv, S, D), torch.float32),
        "k_lut": (dq.k_lut_dec, (L, 2 ** bits), torch.float32),
        "v_lut": (dq.v_lut_dec, (L, 2 ** bits), torch.float32),
        "pos": (pos, (B,), torch.int32),
        "page_table": (page_table, (B, MP), torch.int32),
    }
    if n_kc:
        expect["k_chan"] = (k_chan_l, (NG, n_kc), torch.int32)
    check_operands("paged_flash_decode kernel", expect, dev)

    def launch(q):
        kind = body(dcfg, q.shape[2], 1)
        out = run_kernel(
            _lib().fd_paged_attention, q,
            (pool.k_planes, pool.v_planes, pool.kv_out, dq.k_range,
             dq.k_offset, pool.v_scale, pool.v_offset, pool.k_sink,
             pool.v_sink, dq.k_lut_dec, dq.v_lut_dec), pos, k_chan_l, dcfg,
            mcfg, L=L, Tc=MP * P, J=J, Tq=1, li=li,
            paged=(page_table, MP, P, NP), kind=kind)
        paged_flash_decode.launches += 1
        if kind == "gqa":
            paged_flash_decode.gqa_launches += 1
        return out

    if body(dcfg, G, 1) == "gqa":
        return launch(q_rot)
    return padded_launches(q_rot, launch)


paged_flash_decode.launches = 0
paged_flash_decode.gqa_launches = 0  # of them, steps on fd_gqa
