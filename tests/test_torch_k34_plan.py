"""The host plan of the two-pass kernels K3 / K4
(kvquant_tpu_torch/ops/kernels/attention.py: ``qk_plan``, ``pv_plan``),
which picks the body a call runs on the card and its block shape, and the
(cos, sin) table K3 rotates with.

  (a) routing: R <= 8 rows run the decode bodies in both dot modes; more
      rows run the tensor-core bodies with bf16 dots and the SIMT bodies
      with fp32 dots;
  (b) a decode block holds whole head groups (when slots are staged) and
      its head count divides Hkv; a row block of the tensor-core bodies
      holds whole 16-row tiles and the row blocks cover R once;
  (c) shared memory stays within the 227 KB a Hopper block may use (the
      count is passed to the kernel, which refuses a call where it differs
      from the count of its own layout), and
      the splits cover the capacity's tiles with none empty;
  (d) the LLaMA-2-7B layer's plans (nuq3, head group 4, cap 2) at Tc 34816
      and 133120 (decode) and at 261 rows over Tc 2304;
  (e) K3's table is the tensor object K1 uses for the same key.
"""

import pytest
import torch

from kvquant_tpu_torch.cache import DeployConfig
from kvquant_tpu_torch.models.config import ModelConfig
from kvquant_tpu_torch.ops.kernels import attention as at
from kvquant_tpu_torch.ops.kernels import flash_decode as fd

SMS = 132  # H100 SXM
PLANS = {"qk": at.qk_plan, "pv": at.pv_plan}


def _dcfg(bits=3, Hkv=32, D=128, Tc=2304, hg=4, cap=2, dot_bf16=True):
    return DeployConfig.create(bits=bits, n_kv_heads=Hkv, d_head=D,
                               max_len=Tc + 5, sink=5, kernel="pallas",
                               head_group=hg, cap_per_side=cap,
                               dot_bf16=dot_bf16)


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 5, 8, 9, 64, 261, 1044])
@pytest.mark.parametrize("kernel", list(PLANS))
def test_routing(kernel, R, dot_bf16):
    d = _dcfg(dot_bf16=dot_bf16)
    plan = PLANS[kernel](d, R, 128, 2304, 1, 32, d.n_slots, SMS)
    gqa_rows = at.QK_GQA_ROWS if kernel == "qk" else at.PV_GQA_ROWS
    if dot_bf16 and R in gqa_rows:
        # 3-8 rows with bf16 dots: the tensor-core decode bodies
        assert plan.body == "gqa" and plan.rows == R
    elif R <= 8:
        assert plan.body == "decode"
        assert plan.rows == next(g for g in (1, 2, 4, 8) if R <= g)
    else:
        assert plan.body == ("mma" if dot_bf16 else "simt")
    assert plan.body == at.body(d, R, kernel)


CONFIGS = [(bits, D, hg, cap, Hkv)
           for bits in (2, 3, 4) for D in (32, 64, 128)
           for hg, cap, Hkv in ((1, 0, 8), (1, 2, 8), (2, 4, 8), (4, 2, 32),
                                (4, 0, 12), (16, 0, 32))]


@pytest.mark.parametrize("bits,D,hg,cap,Hkv", CONFIGS)
@pytest.mark.parametrize("kernel", list(PLANS))
def test_blocks_and_shared_memory(kernel, bits, D, hg, cap, Hkv):
    d = _dcfg(bits=bits, Hkv=Hkv, D=D, hg=hg, cap=cap)
    slots = d.include_sparse and cap > 0
    for dot_bf16 in (False, True):
        d = _dcfg(bits=bits, Hkv=Hkv, D=D, hg=hg, cap=cap, dot_bf16=dot_bf16)
        for R in (1, 2, 8, 261, 522):
            for Tc in (128, 256, 2304, 34816, 133120):
                for B in (1, 3):
                    plan = PLANS[kernel](d, R, D, Tc, B, Hkv, d.n_slots, SMS)
                    assert plan.smem <= at.SMEM_MAX, plan
                    assert plan.per_sm >= 1
                    if plan.body in ("decode", "gqa"):  # the decode ring
                        assert Hkv % plan.hc == 0 and 1 <= plan.hc <= 8
                        if slots:
                            assert plan.hc % hg == 0
                        assert 2 <= plan.stages <= 4
                        tile = at.DECODE_TILE
                    else:
                        assert plan.hc == 1
                        assert plan.rows * plan.n_rt >= R
                        assert plan.rows * (plan.n_rt - 1) < R
                        if plan.body == "mma":
                            assert plan.rows % 16 == 0
                            most = (at.QK_MMA_ROWS if kernel == "qk"
                                    else at.PV_MMA_ROWS)
                            assert plan.rows <= most
                        tile = (at.DECODE_TILE if (kernel, plan.body)
                                == ("qk", "mma") else at.TILE)
                    n_tiles = Tc // tile
                    tps = -(-n_tiles // plan.n_split)
                    assert 1 <= plan.n_split <= n_tiles
                    assert (plan.n_split - 1) * tps < n_tiles <= \
                        plan.n_split * tps


@pytest.mark.parametrize("Tc,R,qk,pv", [
    (34816, 1, ("decode", 1, 1, 4, 3, 31, 86144, 2),
     ("decode", 1, 1, 4, 3, 31, 83072, 2)),
    (133120, 1, ("decode", 1, 1, 4, 3, 33, 86144, 2),
     ("decode", 1, 1, 4, 3, 33, 83072, 2)),
    (2304, 261, ("mma", 272, 1, 1, 0, 6, 113984, 2),
     ("mma", 144, 2, 1, 0, 4, 79520, 2)),
], ids=["decode-32K", "decode-128K", "chunk-261"])
def test_llama2_7b_plans(Tc, R, qk, pv):
    """One LLaMA-2-7B layer, nuq3, head group 4, cap 2, bf16 dots: a
    decode block is one head group (4 heads, stages of 26 KB: 24 KB of
    planes, 2 KB of K slot rows) in 3 stages, two blocks per SM, splits
    filling the card's 264 resident blocks once; the 261-row chunk runs
    K3 in one row block of 272 rows and K4 in two of 144."""
    d = _dcfg(Tc=Tc)
    assert d.cache_tokens == Tc
    assert tuple(at.qk_plan(d, R, 128, Tc, 1, 32, d.n_slots, SMS)) == qk
    assert tuple(at.pv_plan(d, R, 128, Tc, 1, 32, d.n_slots, SMS)) == pv


@pytest.mark.parametrize("Tc,sink", [(256, 5), (2304, 5), (34816, 0)])
def test_k3_table_is_k1_table(Tc, sink):
    cfg = ModelConfig(vocab_size=64, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=4, d_head=64, d_ff=64, max_seq_len=Tc)
    d = DeployConfig.create(bits=3, n_kv_heads=4, d_head=64,
                            max_len=Tc + sink, sink=sink, kernel="pallas")
    tab = fd.rope_table(cfg, d.sink, Tc, torch.device("cpu"))
    # K3's launch rotates with K1's cached table: one build serves both
    assert at.rope_table is fd.rope_table
    assert at.rope_table(cfg, d.sink, Tc, "cpu") is tab
    assert tab.shape == (Tc, 32, 2)
