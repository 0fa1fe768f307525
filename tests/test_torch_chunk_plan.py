"""The host side of K1's chunk bodies (kvquant_tpu_torch/ops/kernels/
flash_decode.py): ``body`` routes each call, ``chunk_plan`` shapes the
blocks of the tensor-core body ``fd_chunk`` and ``chunk_splits`` spreads
them over the card. What the CUDA kernel relies on, checked on the CPU:

  (a) rows per block are a multiple of 16 (mma's row tile) and at most
      256; the row blocks cover each of the Q = G * Tq rows exactly once
      and none is empty;
  (b) the dynamic shared memory (the mirror of csrc ``chunk_layout``) is
      within the card's 227 KB, at the first of ``CHUNK_SHAPES`` (piece
      buffers, ring stages) that fits;
  (c) the splits lie between 1 and the capacity's 128-token tiles;
  (d) fp32 dots route to the SIMT body ``fd_partial``, decode steps to
      ``fd_decode`` (or, with bf16 dots at 3-8 rows, ``fd_gqa``) and never
      to a chunk plan.
"""

import pytest

from kvquant_tpu_torch.cache import DeployConfig
from kvquant_tpu_torch.models.config import LLAMA2_7B
from kvquant_tpu_torch.ops.kernels import flash_decode as fd

SMEM_PER_BLOCK = 227 * 1024  # H100: the most shared memory a block can use
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
        for Tq in (128, 256, 261):
            Q = G * Tq
            assert fd.body(dcfg, Q, Tq) == "mma"
            plan = fd.chunk_plan(dcfg, D, J, Q, Tq)
            case = (codes, bits, D, post, k_out, G, Tq, plan)
            assert plan.body == "mma" and plan.tile == 128, case
            assert plan.rows % 16 == 0 and 16 <= plan.rows <= 256, case
            covered = [r for rt in range(plan.n_rt)
                       for r in range(rt * plan.rows,
                                      min((rt + 1) * plan.rows, Q))]
            assert covered == list(range(Q)), case
            assert (plan.n_rt - 1) * plan.rows < Q, case
            assert plan.smem <= fd.CHUNK_SMEM_MAX <= SMEM_PER_BLOCK, case
            assert (plan.n_buf, plan.stages) in fd.CHUNK_SHAPES, case
            # the mirror of csrc chunk_layout, at the plan's own shape
            live = fd.kernel_limits(dcfg, D, J)
            assert plan.smem == fd._chunk_smem(dcfg, D, J, plan.rows,
                                               plan.stages, plan.n_buf, live)
            # every shape tried before the plan's would not have fit
            for n_buf, stages in fd.CHUNK_SHAPES:
                if (n_buf, stages) == (plan.n_buf, plan.stages):
                    break
                assert fd._chunk_smem(dcfg, D, J, plan.rows, stages, n_buf,
                                      live) > fd.CHUNK_SMEM_MAX, case
            for B, Hkv, Tc in ((1, 32, 2048), (1, 32, 32768), (2, 4, 1024),
                               (4, 16, 256)):
                ns = fd.chunk_splits(plan, B, Hkv, Tc, 132)
                assert 1 <= ns <= Tc // 128, (case, B, Hkv, Tc, ns)


def test_chunk_plan_at_llama2_7b():
    """The two LLaMA-2-7B cells' 256-row chunks: one row block, four
    splits over 132 SMs (128 resident blocks)."""
    D = LLAMA2_7B.d_head
    nuq3 = _dcfg("nuq", 3, D, False, "slots")
    x2 = _dcfg("int4x2", 2, D, True, "channels")
    for dcfg, smem in ((nuq3, 226624), (x2, 206560)):
        plan = fd.chunk_plan(dcfg, D, dcfg.n_slots, 256, 256)
        assert plan == fd.ChunkPlan("mma", 256, 1, 128, 3, 3, smem)
        assert fd.chunk_splits(plan, 1, 32, 32768, 132) == 4
    # a first chunk carries the sink rows: 261 rows in two blocks of 144
    assert fd.chunk_plan(nuq3, D, nuq3.n_slots, 261, 261)[1:3] == (144, 2)


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
