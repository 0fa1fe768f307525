"""The host plan of K2 (kvquant_tpu_torch/ops/kernels/flash_serial.py:
``fs_plan``), which picks the body a decode call runs on the card and its
grid:

  (a) routes: bf16 dots on int4 / int4x2 containers run the tensor-core
      body fs_mma; fp32 dots, and int8 containers in either dot mode, the
      SIMT body fs_partial; a caller may force fs_partial (timing only),
      never fs_mma where it does not apply; d_head outside the kernel's
      instances raises, as does G < 1 (other G plan at the padded
      instance: tests/test_torch_moe.py);
  (b) fs_mma's grid is one wave at LLaMA-2-7B shapes (B 1, 32 kv heads,
      the 32K and 128K capacities, 132 SMs) and fills it;
  (c) shared memory stays within the 227 KB a Hopper block may use;
  (d) the kernel's split formula (``mma_split``) gives every split a tile
      whenever the live range has as many tiles as splits, and the splits
      cover the range once.
"""

import pytest
import torch

from kvquant_tpu_torch.cache import DeployConfig
from kvquant_tpu_torch.ops.kernels import flash_serial as fs

SMS = 132  # H100 SXM
SMEM_MAX = 227 * 1024


def _dcfg(codes="int4", dot_bf16=True, Hkv=32, D=128, hg=16, k_out="channels",
          n_kc=16, cap=0, Tc=34816, include_sparse=True):
    bits = {"int4": 4, "int8": 8, "int4x2": 2}[codes]
    return DeployConfig.create(
        bits=bits, n_kv_heads=Hkv, d_head=D, max_len=Tc + 5, sink=5,
        kernel="flash_serial", dot_bf16=dot_bf16, head_group=hg, codes=codes,
        post_rope_k=True, k_outliers=k_out, n_kc=n_kc, cap_per_side=cap,
        include_sparse=include_sparse)


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("codes", ["int4", "int4x2", "int8"])
def test_routes(codes, dot_bf16):
    d = _dcfg(codes=codes, dot_bf16=dot_bf16)
    plan = fs.fs_plan(d, 1, 32, 1, 128, d.cache_tokens, sms=SMS)
    want = "fs_mma" if dot_bf16 and codes != "int8" else "fs_partial"
    assert plan.body == fs.fs_body(d) == want
    assert plan.tile == (fs.MMA_TILE if want == "fs_mma" else fs.TILE_TOKENS)
    assert repr(plan).startswith(f"FsPlan(body='{want}'")
    forced = fs.fs_plan(d, 1, 32, 1, 128, d.cache_tokens, sms=SMS,
                        body="fs_partial")
    assert forced.body == "fs_partial"


@pytest.mark.parametrize("codes,dot_bf16", [("int4", False), ("int8", True),
                                            ("int4x2", False)])
def test_fs_mma_refused_where_it_does_not_apply(codes, dot_bf16):
    d = _dcfg(codes=codes, dot_bf16=dot_bf16)
    with pytest.raises(ValueError, match="fs_mma takes bf16 dots"):
        fs.fs_plan(d, 1, 32, 1, 128, d.cache_tokens, sms=SMS, body="fs_mma")


def test_unknown_body_raises():
    d = _dcfg()
    with pytest.raises(ValueError, match="unknown body"):
        fs.fs_plan(d, 1, 32, 1, 128, d.cache_tokens, sms=SMS, body="simt")


@pytest.mark.parametrize("G,D", [(0, 128), (1, 16), (1, 96), (2, 256)])
@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
def test_instances_outside_the_kernel_raise(G, D, dot_bf16):
    d = _dcfg(dot_bf16=dot_bf16)
    with pytest.raises(ValueError, match="query rows per kv head|d_head"):
        fs.fs_plan(d, 1, 32, G, D, d.cache_tokens, sms=SMS)


@pytest.mark.parametrize("codes", ["int4", "int4x2"])
@pytest.mark.parametrize("ctx", [32768, 131072])
def test_one_wave_at_llama2_7b(ctx, codes):
    d = _dcfg(codes=codes, hg=16 if codes == "int4" else 4,
              n_kc=16 if codes == "int4" else 4, Tc=ctx + 3)
    B, Hkv = 1, 32
    plan = fs.fs_plan(d, B, Hkv, 1, 128, d.cache_tokens, sms=SMS)
    assert plan.body == "fs_mma"
    slots = plan.per_sm * SMS
    assert 1 <= plan.per_sm <= fs.MMA_MIN_BLOCKS
    assert fs.SMEM_PER_SM // (plan.smem + 1024) >= plan.per_sm
    blocks = plan.n_split * Hkv * B
    assert blocks <= slots < blocks + Hkv * B  # one wave, filled
    # at capacity every warp of every block has a tile
    tiles = d.cache_tokens // fs.MMA_TILE
    assert tiles // plan.n_split >= fs.MMA_WARPS


@pytest.mark.parametrize("B,Hkv,Tc", [(1, 32, 256), (3, 4, 1024),
                                      (8, 32, 34816), (64, 32, 2048),
                                      (1, 8, 133120)])
def test_splits_stay_within_one_wave_and_the_capacity(B, Hkv, Tc):
    d = _dcfg(Hkv=Hkv, hg=Hkv if Hkv < 16 else 16, Tc=Tc)
    plan = fs.fs_plan(d, B, Hkv, 1, 128, Tc, sms=SMS)
    assert 1 <= plan.n_split <= max(1, Tc // (fs.MMA_TILE * fs.MMA_WARPS))
    if B * Hkv <= plan.per_sm * SMS:
        assert plan.n_split * B * Hkv <= plan.per_sm * SMS
    else:  # more heads than resident blocks: one split each
        assert plan.n_split == 1


CONFIGS = [(codes, G, D, hg, k_out, cap)
           for codes in ("int4", "int4x2", "int8")
           for G in (1, 2, 4, 8) for D in (32, 64, 128)
           for hg, k_out, cap in ((2, "channels", 0), (4, "channels", 2),
                                  (16, "channels", 0), (2, "slots", 2),
                                  (4, "slots", 2), (4, "none", 0))]


@pytest.mark.parametrize("codes,G,D,hg,k_out,cap", CONFIGS)
def test_shared_memory_within_a_block(codes, G, D, hg, k_out, cap):
    for dot_bf16 in (False, True):
        d = _dcfg(codes=codes, dot_bf16=dot_bf16, Hkv=16, D=D, hg=hg,
                  k_out="slots" if k_out == "slots" else "channels",
                  n_kc=64 if k_out == "channels" else 4, cap=cap,
                  include_sparse=k_out != "none")
        for body in (None, "fs_partial"):
            plan = fs.fs_plan(d, 1, 16, G, D, 34816, sms=SMS, body=body)
            assert 0 < plan.smem <= SMEM_MAX, plan
            if plan.body == "fs_mma":  # warp regions of whole 16-byte units
                assert plan.smem % (16 * fs.MMA_WARPS) == 0
            assert plan.per_sm >= 1


@pytest.mark.parametrize("n_split", [1, 3, 12, 16, 33])
def test_every_split_holds_a_tile(n_split):
    for n_tiles in list(range(0, 70)) + [1024, 4160]:
        spans = [fs.mma_split(n_tiles, n_split, s) for s in range(n_split)]
        assert spans[0][0] == 0 and spans[-1][1] == n_tiles
        for (b0, e0), (b1, _) in zip(spans, spans[1:]):
            assert e0 == b1  # contiguous, in order
        counts = [e - b for b, e in spans]
        assert max(counts) - min(counts) <= 1
        if n_tiles >= n_split:
            assert min(counts) >= 1


def test_mma_smem_grows_with_staged_rows():
    """The staged outlier rows are the part of fs_mma's layout that a
    configuration moves: channels beyond KC_STAGED are read in place, slot
    rows are all staged, V slots add the per-warp sums."""
    base = fs.mma_smem_bytes(1, 128, 0, 0, 0)
    four = fs.mma_smem_bytes(1, 128, fs.KC_STAGED, 0, 0)
    many = fs.mma_smem_bytes(1, 128, 64, 0, 0)
    stage_row = fs.MMA_WARPS * fs.MMA_STAGES * 4 * fs.MMA_TILE
    assert four - base >= fs.KC_STAGED * stage_row
    # channel rows beyond KC_STAGED add only their list entries
    assert many - four == fs.MMA_WARPS * (fs._round16(4 * 64 * 3)
                                          - fs._round16(4 * 4 * 3))
    assert fs.mma_smem_bytes(2, 128, 0, 4, 4) > fs.mma_smem_bytes(2, 128, 0,
                                                                  4, 0)


def test_args_carry_the_plan():
    names = [n for n, _ in fs._FsArgs._fields_]
    assert names[names.index("n_split"):] == ["n_split", "body", "smem", "inv"]
    assert fs.BODIES == {"fs_partial": 0, "fs_mma": 1}


def test_cpu_calls_count_no_route():
    assert set(fs.flash_serial_decode.route_launches) == set(fs.BODIES)
    before = dict(fs.flash_serial_decode.route_launches)
    d = _dcfg(Hkv=4, D=32, hg=2, n_kc=3, Tc=256)
    L, B, G, Tc = 1, 1, 2, d.cache_tokens
    z = lambda *s: torch.zeros(s)  # noqa: E731
    planes = torch.zeros((L, B, 4, Tc, d.code_cols), dtype=torch.uint8)
    out = fs.flash_serial_decode(
        torch.ones(B, 4, G, 32), planes, planes,
        z(L, B, 2, d.n_slots, Tc), torch.ones(L, 4, 32), z(L, 4, 32),
        torch.ones(L, B, Tc), z(L, B, Tc), z(L, B, 4, 5, 32),
        z(L, B, 4, 5, 32), torch.linspace(-1, 1, 16)[None],
        torch.linspace(-1, 1, 16)[None], 0, torch.tensor([40]), d,
        _mcfg(G), k_ressc=torch.rand(L, 4 * 32), body="fs_partial")
    assert out.shape == (B, 4, G, 32) and bool(torch.isfinite(out).all())
    assert fs.flash_serial_decode.route_launches == before


def _mcfg(G):
    from kvquant_tpu_torch.models.config import ModelConfig
    return ModelConfig(vocab_size=64, d_model=4 * G * 32, n_layers=1,
                       n_heads=4 * G, n_kv_heads=4, d_head=32, d_ff=32,
                       max_seq_len=512)
