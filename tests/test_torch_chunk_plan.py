"""The host side of K1's chunk bodies (kvquant_tpu_torch/ops/kernels/
flash_decode.py): ``body`` routes each call, ``chunk_plan`` shapes the
blocks of the tensor-core body ``fd_chunk`` and ``chunk_splits`` spreads
them over the card. What the CUDA kernel relies on, checked on the CPU:

  (a) rows per block are a multiple of the body's row tile (bit planes on
      fd_chunk: wgmma's m64; the containers on fd_chunk_sync: mma.sync's
      16) and at most 256; the row blocks cover each of the Q = G * Tq
      rows exactly once and none is empty;
  (b) the dynamic shared memory (the mirror of csrc ``chunk_layout`` /
      ``sync_layout``) is within the card's 227 KB, at the first of
      ``CHUNK_SHAPES`` (piece buffers, ring stages) that fits; fd_chunk's
      swizzled query tile and every piece buffer start on a 1024-byte
      swizzle atom, a buffer holds its bf16 tiles [32][128] and nothing
      else; fd_chunk_sync's tiles have rows of 128 + 8 bf16;
  (c) the registers each body's roles take after setmaxnreg (read from
      csrc) fit one SM's 65,536;
  (d) the splits lie between 1 and the capacity's 128-token tiles;
  (e) fp32 dots route to the SIMT body ``fd_partial``, decode steps to
      ``fd_decode`` (or, with bf16 dots at 3-8 rows, ``fd_gqa``) and never
      to a chunk plan.
"""

import os
import re

import pytest

from kvquant_tpu_torch.cache import DeployConfig
from kvquant_tpu_torch.models.config import LLAMA2_7B
from kvquant_tpu_torch.ops.kernels import build
from kvquant_tpu_torch.ops.kernels import flash_decode as fd

SMEM_PER_BLOCK = 227 * 1024  # H100: the most shared memory a block can use
REGS_PER_SM = 65536  # H100: 32-bit registers of an SM
MODES = [("nuq", 2), ("nuq", 3), ("nuq", 4), ("int4", 4), ("int8", 8),
         ("int4x2", 2)]


def _dcfg(codes, bits, D, post, k_out, dot_bf16=True, hg=4, n_kc=4):
    return DeployConfig.create(
        bits=bits, n_kv_heads=16, d_head=D, max_len=4096, sink=5,
        kernel="flash", head_group=hg, codes=codes, post_rope_k=post,
        k_outliers="channels" if k_out == "channels" else "slots",
        n_kc=n_kc, include_sparse=k_out != "none",
        cap_per_side=2 if k_out == "slots" else 0, dot_bf16=dot_bf16)


def _configs(codes, bits):
    for D in (32, 64, 128):
        for post in (False, True):
            for k_out in ("slots", "channels", "none"):
                yield D, post, k_out, _dcfg(codes, bits, D, post, k_out)


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("codes,bits", MODES)
def test_chunk_plan_invariants(codes, bits, G):
    for D, post, k_out, dcfg in _configs(codes, bits):
        J = dcfg.n_slots
        for Tq in (128, 256, 261, 2048, 2053):
            Q = G * Tq
            assert fd.body(dcfg, Q, Tq) == "mma"
            plan = fd.chunk_plan(dcfg, D, J, Q, Tq)
            case = (codes, bits, D, post, k_out, G, Tq, plan)
            assert plan.body == "mma" and plan.tile == 128, case
            m = fd.CHUNK_M if codes == "nuq" else fd.SYNC_M
            assert plan.rows % m == 0, case
            assert m <= plan.rows <= fd.CHUNK_ROWS == 256, case
            covered = [r for rt in range(plan.n_rt)
                       for r in range(rt * plan.rows,
                                      min((rt + 1) * plan.rows, Q))]
            assert covered == list(range(Q)), case
            assert (plan.n_rt - 1) * plan.rows < Q, case
            assert plan.smem <= fd.CHUNK_SMEM_MAX <= SMEM_PER_BLOCK, case
            assert (plan.n_buf, plan.stages) in fd.CHUNK_SHAPES, case
            # the mirror of csrc chunk_layout / sync_layout, at the plan's
            # own shape
            live = fd.kernel_limits(dcfg, D, J)
            lay = fd.chunk_layout(dcfg, D, J, plan.rows, plan.stages,
                                  plan.n_buf, live)
            if codes == "nuq":
                assert plan.smem == lay.bytes == lay.end + fd.SW_ATOM, case
                assert lay.q % fd.SW_ATOM == 0 and lay.buf0 % fd.SW_ATOM == 0
                assert lay.buf0 - lay.q == plan.rows * 2 * 128, case
                assert lay.buf == lay.tiles * fd.CHUNK_PIECE * 2 * 128, case
                assert lay.buf % fd.SW_ATOM == 0, case
            else:
                assert plan.smem == lay.bytes == lay.end, case
                assert lay.buf0 - lay.q == plan.rows * 2 * 136, case
                assert lay.buf == (lay.tiles * fd.CHUNK_PIECE * 2 * 136
                                   + 2 * fd.SYNC_PW * 4), case
            assert lay.tiles == 2 + (k_out != "none") + (k_out == "slots")
            assert lay.end == lay.buf0 + plan.n_buf * lay.buf, case
            # every shape tried before the plan's would not have fit
            for n_buf, stages in fd.CHUNK_SHAPES:
                if (n_buf, stages) == (plan.n_buf, plan.stages):
                    break
                assert fd.chunk_layout(dcfg, D, J, plan.rows, stages, n_buf,
                                       live).bytes > fd.CHUNK_SMEM_MAX, case
            for B, Hkv, Tc in ((1, 32, 2048), (1, 32, 32768), (2, 4, 1024),
                               (4, 16, 256)):
                ns = fd.chunk_splits(plan, B, Hkv, Tc, 132)
                assert 1 <= ns <= Tc // 128, (case, B, Hkv, Tc, ns)


def test_chunk_plan_at_llama2_7b():
    """The two LLaMA-2-7B cells' 256-row chunks: one row block, four
    splits over 132 SMs (128 resident blocks); the longdoc cell's 2048-row
    sub-chunks at Mistral-7B's G 4: 32 blocks of 256 rows a kv head; a
    40-row last chunk: one block of 64 rows (bit planes) or 48 (the
    containers)."""
    D = LLAMA2_7B.d_head
    nuq3 = _dcfg("nuq", 3, D, False, "slots")
    x2 = _dcfg("int4x2", 2, D, True, "channels")
    for dcfg, smem in ((nuq3, 218112), (x2, 206560)):
        plan = fd.chunk_plan(dcfg, D, dcfg.n_slots, 256, 256)
        assert plan == fd.ChunkPlan("mma", 256, 1, 128, 3, 3, smem)
        assert fd.chunk_splits(plan, 1, 32, 32768, 132) == 4
    # a first chunk carries the sink rows: 261 rows in two blocks of 192
    # (five m64 tiles, three and two) or 144 (17 tiles of 16, 9 and 8)
    assert fd.chunk_plan(nuq3, D, nuq3.n_slots, 261, 261)[1:3] == (192, 2)
    assert fd.chunk_plan(x2, D, x2.n_slots, 261, 261)[1:3] == (144, 2)
    assert fd.chunk_plan(nuq3, D, nuq3.n_slots, 40, 40)[1:3] == (64, 1)
    assert fd.chunk_plan(x2, D, x2.n_slots, 40, 40)[1:3] == (48, 1)
    # longdoc: 4 x 2048 rows of one kv head in 32 blocks of 256, one split
    # (8 kv heads: 256 blocks over 132 SMs); the sink sub-chunk's 4 x 2053
    # rows in 33, each block but the last straddling no g boundary at 2048
    plan = fd.chunk_plan(nuq3, D, nuq3.n_slots, 4 * 2048, 2048)
    assert plan == fd.ChunkPlan("mma", 256, 32, 128, 3, 3, 218112)
    assert fd.chunk_splits(plan, 1, 8, 16896, 132) == 1
    assert fd.chunk_plan(nuq3, D, nuq3.n_slots, 4 * 2053, 2053)[1:3] == (
        256, 33)


def test_chunk_plan_shrinks_then_refuses():
    """int8 at D 128: with 16 channels and V slots two buffers take two
    stages; with 64 channels one buffer and two stages; with 64 channels
    and V slots nothing fits: a ValueError, never a launch."""
    def int8(n_kc, cap):
        return DeployConfig.create(bits=8, n_kv_heads=4, d_head=128,
                                   max_len=4096, sink=5, kernel="flash",
                                   head_group=4, codes="int8",
                                   k_outliers="channels", n_kc=n_kc,
                                   cap_per_side=cap)
    d16, d64, d64v = int8(16, 1), int8(64, 0), int8(64, 2)
    assert fd.chunk_plan(d16, 128, d16.n_slots, 256, 256)[4:6] == (2, 2)
    assert fd.chunk_plan(d64, 128, d64.n_slots, 256, 256)[4:6] == (2, 1)
    with pytest.raises(ValueError, match="shared memory"):
        fd.chunk_plan(d64v, 128, d64v.n_slots, 256, 256)


def _csrc_roles(codes):
    """A chunk body's roles as csrc/flash_decode.cu states them (fd_chunk's
    CHUNK_*, fd_chunk_sync's SYNC_*, and CW): (producer warps, registers a
    producer thread keeps, consumer warps, registers a consumer thread
    takes) after setmaxnreg."""
    with open(os.path.join(build.CSRC_DIR, "flash_decode.cu")) as f:
        src = f.read()
    pre = "CHUNK" if codes == "nuq" else "SYNC"
    pw, p_regs, c_regs = map(int, re.search(
        rf"constexpr int {pre}_PW = (\d+), {pre}_P_REGS = (\d+), "
        rf"{pre}_C_REGS = (\d+);", src).groups())
    cw = int(re.search(r"constexpr int CW = (\d+);", src)[1])
    return pw, p_regs, cw, c_regs


@pytest.mark.parametrize("codes,bits", MODES)
def test_chunk_register_split(codes, bits):
    """The roles' registers after setmaxnreg, read from csrc: whole
    warpgroups, counts setmaxnreg takes (multiples of 8 in 24-256), one
    block's threads within 65,536 registers; the consumers keep room for
    two row tiles' O (2 x 64 fp32), S (2 x 16) and P (2 x 8)."""
    pw, p_regs, cw, c_regs = _csrc_roles(codes)
    assert pw % 4 == 0 and cw % 4 == 0
    if codes == "nuq":  # two warpgroups of two m64 tiles
        assert (cw // 4) * 2 * fd.CHUNK_M == fd.CHUNK_ROWS
    else:  # warps of two 16-row tiles
        assert cw * 2 * fd.SYNC_M == fd.CHUNK_ROWS
    assert pw == (8 if codes == "nuq" else fd.SYNC_PW)
    for regs in (p_regs, c_regs):
        assert regs % 8 == 0 and 24 <= regs <= 256
    assert pw * 32 * p_regs + cw * 32 * c_regs <= REGS_PER_SM
    assert (pw + cw) * 32 <= 1024
    assert c_regs >= 2 * 64 + 2 * 16 + 2 * 8
    # the launch bound's registers at entry do not exceed what setmaxnreg
    # hands back and takes
    entry = REGS_PER_SM // ((pw + cw) * 32)
    assert p_regs <= entry <= c_regs


@pytest.mark.parametrize("codes,bits", MODES)
def test_fp32_dots_route_to_the_simt_body(codes, bits):
    for D in (32, 64, 128):
        dcfg = _dcfg(codes, bits, D, False, "slots", dot_bf16=False)
        for G, Tq in ((1, 256), (4, 261), (3, 1), (2, 2)):
            assert fd.body(dcfg, G * Tq, Tq) == "simt"
            plan = fd.chunk_plan(dcfg, D, dcfg.n_slots, G * Tq, Tq)
            assert plan.body == "simt" and plan.rows == fd.ROWS
            assert plan.n_rt == -(-G * Tq // fd.ROWS)
            assert plan.smem <= SMEM_PER_BLOCK


@pytest.mark.parametrize("dot_bf16", [True, False])
def test_decode_steps_are_not_chunks(dot_bf16):
    dcfg = _dcfg("nuq", 3, 128, False, "slots", dot_bf16=dot_bf16)
    for G in (1, 2, 4, 8):
        assert fd.body(dcfg, G, 1) == (
            "gqa" if dot_bf16 and G in fd.GQA_ROWS else "decode")
        with pytest.raises(ValueError, match="decode step"):
            fd.chunk_plan(dcfg, 128, dcfg.n_slots, G, 1)
    # 3 rows at Tq = 1 are a step of the tensor-core decode body fd_gqa
    # with bf16 dots and a chunk with fp32 dots; 16 rows are a chunk
    assert fd.body(dcfg, 3, 1) == ("gqa" if dot_bf16 else "simt")
    if dot_bf16:
        with pytest.raises(ValueError, match="decode step"):
            fd.chunk_plan(dcfg, 128, dcfg.n_slots, 3, 1)
    for G in (16,) if dot_bf16 else (3, 16):
        assert fd.body(dcfg, G, 1) == ("mma" if dot_bf16 else "simt")
