"""Decode steps of 3-8 query rows per kv head on the two kernels whose
routes change there with bf16 dots: K4's tensor-core decode body pv_gqa
(kvquant_tpu_torch/csrc/attention.cu) and K2's fs_mma at the rows as they
are, with one merge block per row (csrc/flash_serial.cu). On the CPU the
wrappers run their plain versions, which the CUDA bodies are held against
on the card; here those plain versions are held against the JAX package's
kernels (interpret mode) on the same numpy inputs, at TINY widths:

  (a) K4 (``attention.pv_fused``) at R 3 / 6 / 7 against JAX's
      ``pv_fused``: nuq 2 / 3 / 4 bits with head groups 1 / 2 / 4, V slot
      words that collide (every slot of a token at one dim), B = 2, both
      dot modes;
  (b) K2 (``flash_serial.flash_serial_decode``) at G 3 / 6 / 7 against
      JAX's ``flash_serial_decode`` (which takes every G): int4 and int4x2
      containers, static K channels and slot words, sink 0 / 5, B = 2 at
      unequal positions, a sliding window, both dot modes;
  (c) the routing the card takes: ``attention.pv_plan`` at R 1-8 in both
      dot modes (its shared memory against the mirror of csrc
      pv_gqa_smem), ``flash_serial.fs_plan`` at G 1-8 (the rows of one
      launch, the splits), the old routes a caller may force for
      timing, and the launch counters of the new routes.

Tolerances are tests/test_torch_attention.py's for K4 (atol 2e-4, rtol
1e-4 with fp32 dots; 1e-2 * max|JAX| with bf16 dot operands) and
tests/test_torch_flash_serial.py's for K2 (1e-5 with fp32 dots; 2e-2 with
bf16 dots, where the two sides round the probabilities at different
points).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kvquant_tpu.cache import DeployConfig as JDeployConfig
from kvquant_tpu.models.config import ModelConfig as JModelConfig
from kvquant_tpu.ops import packing as jpk
from kvquant_tpu.ops.pallas import pv_fused as jax_pv
from kvquant_tpu.ops.pallas.flash_serial import flash_serial_decode as jax_fs

from kvquant_tpu_torch.cache import DeployConfig
from kvquant_tpu_torch.models.config import ModelConfig
from kvquant_tpu_torch.ops import kernels as tk
from kvquant_tpu_torch.ops import packing as tpk
from kvquant_tpu_torch.ops.kernels import attention as at
from kvquant_tpu_torch.ops.kernels import common
from kvquant_tpu_torch.ops.kernels import flash_serial as fs

torch.set_num_threads(1)

B, HKV, D, TC = 2, 4, 16, 256
SMS = 132  # H100 SXM
ROWS = [3, 6, 7]


def _words(rng, shape, hg, collide):
    """Encoded slot words (…, n, Tc) at random in-group (head, dim); with
    ``collide`` every slot of half the tokens at one (head, dim)."""
    vals = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    vals[rng.random(shape) < 0.2] = 0.0
    head = rng.integers(0, hg, shape)
    dim = rng.integers(0, D, shape)
    if collide:
        one = rng.random(shape[:-2] + (1, shape[-1])) < 0.5
        head = np.where(one, head[..., :1, :], head)
        dim = np.where(one, dim[..., :1, :], dim)
    bits = vals.view(np.uint32)
    idx = ((head << 7) | dim).astype(np.uint32)
    return ((bits & np.uint32(0xFFFFFE00)) | idx).view(np.float32)


# ---------------------------------------------------------------------------
# (a) K4 at 3-8 rows
# ---------------------------------------------------------------------------

K4_SCHEMES = [(2, 1), (3, 2), (4, 4)]  # (nuq bits, head group)


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("bits,hg", K4_SCHEMES, ids=["nuq2-hg1", "nuq3-hg2",
                                                     "nuq4-hg4"])
@pytest.mark.parametrize("R", ROWS)
def test_k4_rows_match_jax_kernel(R, bits, hg, dot_bf16):
    kw = dict(bits=bits, n_kv_heads=HKV, d_head=D, max_len=TC + 5, sink=5,
              head_group=hg, cap_per_side=2, dot_bf16=dot_bf16,
              kernel="pallas")
    jd, td = JDeployConfig.create(**kw), DeployConfig.create(**kw)
    rng = np.random.default_rng(100 * R + 10 * bits + hg)
    codes = rng.integers(0, 2 ** bits, (B, HKV, TC, D)).astype(np.int32)
    planes = np.stack([np.asarray(jpk.pack_codes(jnp.asarray(c), bits))
                       for c in codes])
    words = _words(rng, (B, HKV // hg, td.n_slots, TC), hg, collide=True)
    probs = rng.dirichlet(np.ones(TC), (B, HKV, R)).astype(np.float32)
    probs[1, :, :, TC // 2:] = 0.0  # past the second row's live length
    lut = np.sort(rng.uniform(-1, 1, 2 ** bits)).astype(np.float32)
    v_scale = (rng.random((B, TC)) + 0.1).astype(np.float32)
    v_offset = (rng.standard_normal((B, TC)) * 0.1).astype(np.float32)
    want = np.stack([np.asarray(jax_pv(
        jnp.asarray(probs[b]), jnp.asarray(planes[b]),
        jnp.asarray(v_scale[b]), jnp.asarray(v_offset[b]),
        jnp.asarray(words[b]), jnp.asarray(lut), jd)) for b in range(B)])
    # the main path hands K4 a column slice after the sink columns
    wide = torch.zeros((B, HKV, R, 5 + TC))
    wide[..., 5:] = torch.as_tensor(probs)
    got = at.pv_fused(wide[..., 5:], torch.as_tensor(planes),
                      torch.as_tensor(v_scale), torch.as_tensor(v_offset),
                      torch.as_tensor(words), torch.as_tensor(lut),
                      td).numpy()
    assert got.shape == (B, HKV, R, D)
    if dot_bf16:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# (b) K2 at 3-8 rows
# ---------------------------------------------------------------------------

L2, HG2, TC2 = 1, 2, 256


def _k2_case(G, codes, k_out, sink, dot_bf16, window=None):
    bits = {"int4": 4, "int4x2": 2}[codes]
    kw = dict(bits=bits, n_kv_heads=HKV, d_head=D, max_len=TC2 + sink,
              sink=sink, kernel="flash_serial", dot_bf16=dot_bf16,
              head_group=HG2, codes=codes, post_rope_k=True,
              k_outliers=k_out, n_kc=3,
              cap_per_side=0 if k_out == "channels" else 2)
    jd, td = JDeployConfig.create(**kw), DeployConfig.create(**kw)
    mk = dict(vocab_size=64, d_model=HKV * G * D, n_layers=L2,
              n_heads=HKV * G, n_kv_heads=HKV, d_head=D, d_ff=32,
              max_seq_len=TC2 + 64, sliding_window=window)
    jm, tm = JModelConfig(**mk), ModelConfig(**mk)
    rng = np.random.default_rng(1000 * G + 7 * sink + dot_bf16)
    ck = rng.integers(0, 2 ** bits, (L2, B, TC2, HKV, D))
    cv = rng.integers(0, 2 ** bits, (L2, B, TC2, HKV, D))

    def jcont(c):
        if codes == "int4x2":
            return jnp.moveaxis(jpk.pair_codes_int4x2(jnp.asarray(c)), -3, -2)
        return jnp.moveaxis(jpk.store_codes_int(jnp.asarray(c), bits,
                                                jnp.int4), -3, -2)

    def tcont(c):
        c = torch.as_tensor(c)
        if codes == "int4x2":
            return torch.movedim(tpk.pair_codes_int4x2(c), -3, -2).contiguous()
        return torch.movedim(tpk.store_codes_int(c, bits, td.code_dtype),
                             -2, -3).contiguous()

    NG, J, spk = HKV // HG2, td.n_slots, td.slots_per_kind
    if k_out == "channels":
        kv_out = (rng.standard_normal((L2, B, NG, J, TC2)) * 0.1).astype(
            np.float32)
    else:
        kv_out = _words(rng, (L2, B, NG, J, TC2), HG2, collide=True)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    arrays = dict(
        kv_out=kv_out,
        k_range=(rng.random((L2, HKV, D)) + 0.5).astype(np.float32),
        k_offset=f32(L2, HKV, D) * 0.1,
        v_scale=(rng.random((L2, B, TC2)) + 0.5).astype(np.float32),
        v_offset=f32(L2, B, TC2) * 0.1,
        k_sink=f32(L2, B, HKV, sink, D), v_sink=f32(L2, B, HKV, sink, D),
        k_lut=np.linspace(-1, 1, 2 ** bits, dtype=np.float32)[None],
        v_lut=np.linspace(-0.9, 1.1, 2 ** bits, dtype=np.float32)[None])
    q = f32(B, HKV, G, D)
    ressc = rng.random((L2, HKV * D)).astype(np.float32)
    # row 0 inside the sink prefix (or at the very start), row 1 deep in
    pos = np.array([3, 230] if window is None else [200, 250], np.int32)
    tail = list(arrays)
    want = jax_fs(jnp.asarray(q), jcont(ck), jcont(cv),
                  *(jnp.asarray(arrays[n]) for n in tail), jnp.int32(0),
                  jnp.asarray(pos), jd, jm, block_tokens=256,
                  k_ressc=jnp.asarray(ressc))
    got = fs.flash_serial_decode(
        torch.as_tensor(q), tcont(ck), tcont(cv),
        *(torch.as_tensor(arrays[n]) for n in tail), 0, torch.as_tensor(pos),
        td, tm, k_ressc=torch.as_tensor(ressc))
    return np.asarray(want), got.numpy()


def _k2_check(want, got, dot_bf16):
    tol = 2e-2 if dot_bf16 else 1e-5
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("codes,k_out,sink", [
    ("int4", "channels", 5), ("int4", "slots", 0),
    ("int4x2", "channels", 0), ("int4x2", "slots", 5)])
@pytest.mark.parametrize("G", ROWS)
def test_k2_rows_match_jax_kernel(G, codes, k_out, sink, dot_bf16):
    _k2_check(*_k2_case(G, codes, k_out, sink, dot_bf16), dot_bf16)


@pytest.mark.parametrize("G", ROWS)
def test_k2_rows_match_jax_kernel_window(G):
    _k2_check(*_k2_case(G, "int4", "channels", 5, True, window=64), True)


# ---------------------------------------------------------------------------
# (c) the routing
# ---------------------------------------------------------------------------


def _dbrx_pallas(dot_bf16=True, cap=2, bits=3, d_head=128, hg=4):
    """One DBRX layer's faithful storage for K3 / K4: 8 kv heads, nuq3,
    pre-RoPE K, slots cap 2 at head group 4 (other bits, widths and head
    groups for the plan's edges)."""
    return DeployConfig.create(bits=bits, n_kv_heads=8, d_head=d_head,
                               max_len=34816 + 5, sink=5, kernel="pallas",
                               head_group=hg, cap_per_side=cap,
                               dot_bf16=dot_bf16)


# (bits, d_head, head group, cap): DBRX's layer with and without slots, its
# nuq4, and head group 8 (eight heads a block), which K4 takes without
# slots only: the slot word's head field holds head_group <= 4
K4_SHAPES = {"nuq3-hg4-slots": (3, 128, 4, 2), "nuq3-hg4": (3, 128, 4, 0),
             "nuq4-hg4-slots": (4, 128, 4, 2), "nuq4-hg4": (4, 128, 4, 0),
             "nuq3-hg8": (3, 128, 8, 0), "nuq4-hg8": (4, 128, 8, 0)}


@pytest.mark.parametrize("shape", list(K4_SHAPES))
@pytest.mark.parametrize("dot_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 5, 6, 7, 8])
def test_k4_plan_at_decode_rows(R, dot_bf16, shape):
    """K4 at R rows: pv_gqa with bf16 dots at PV_GQA_ROWS (R rows, the
    decode block's heads, the P rows in each stage, as many stages as fit
    beside the V^T slot tiles, one block an SM), else pv_decode's instance;
    the shared memory mirrors csrc pv_gqa_smem."""
    bits, Dh, hg, cap = K4_SHAPES[shape]
    d = _dbrx_pallas(dot_bf16, cap, bits, Dh, hg)
    J, Tc = d.n_slots, d.cache_tokens
    nvs = at.slot_counts(d, J)[1]
    plan = at.pv_plan(d, R, Dh, Tc, 1, 8, J, SMS)
    dec = at.pv_plan(d, R, Dh, Tc, 1, 8, J, SMS, "decode")
    assert (dec.body, dec.rows) == ("decode", common.decode_rows(R))
    if not (dot_bf16 and R in at.PV_GQA_ROWS):
        assert plan == dec
        return
    assert at.PV_GQA_ROWS == (3, 4, 5, 6, 7, 8)
    assert (plan.body, plan.rows, plan.n_rt, plan.hc) == ("gqa", R, 1, dec.hc)
    ring_rows = nvs * (plan.hc // hg)
    stage = (at._stage_bytes(bits, Dh, plan.hc, ring_rows, True)
             + plan.hc * R * at.GQA_P_STRIDE * 4)
    vt = at.DECODE_WARPS * Dh * at.GQA_VT_STRIDE * 2 if nvs else 0
    assert at.GQA_P_STRIDE == 136 and at.GQA_VT_STRIDE == 40
    assert plan.smem == 128 + max(plan.stages * stage,
                                  at.DECODE_WARPS * R * (Dh + 1) * 4) + vt
    assert plan.stages == max(2, min(4, (at.SMEM_MAX - 1024 - vt) // stage))
    assert plan.smem <= at.SMEM_MAX and plan.per_sm == 1
    n_tiles = Tc // at.DECODE_TILE
    assert 1 <= plan.n_split <= n_tiles
    assert plan.n_split * (8 // plan.hc) <= SMS


def _k4_configs():
    """Every storage K4 takes at the plan's extremes: nuq 2-4, d_head 32 /
    64 / 128, head groups 1-4 with slots (cap 1-8, as the head-group block
    allows) or without, 8 and 16 without."""
    for bits in (2, 3, 4):
        for Dh in (32, 64, 128):
            for hg, caps in ((1, (0, 1, 2, 8)), (2, (0, 2, 4, 8)),
                             (4, (0, 1, 2, 4, 8)), (8, (0,)), (16, (0,))):
                for cap in caps:
                    if hg * Dh <= 512 or cap == 0:
                        yield bits, Dh, hg, cap


@pytest.mark.parametrize("Hkv", [8, 32])
def test_k4_gqa_fits_every_storage_k4_takes(Hkv):
    """pv_gqa stages eight heads' planes and P rows beside 80 KB of V^T
    slot tiles: in every storage K4 takes its two stages fit SMEM_MAX at
    R 3-8, so the route needs no second choice. Head group 8 with slots,
    where they would not (nuq3 from R 6, nuq4 from R 3 at d_head 128),
    is refused at the wrapper, as before pv_gqa: the slot word's 2-bit
    head field."""
    n = 0
    for bits, Dh, hg, cap in _k4_configs():
        if Hkv % hg:
            continue
        d = dataclasses.replace(
            _dbrx_pallas(True, cap, bits, Dh, hg if cap else 1),
            n_kv_heads=Hkv, head_group=hg)
        for R in at.PV_GQA_ROWS:
            for Tc in (128, 2304, 34816):
                plan = at.pv_plan(d, R, Dh, Tc, 1, Hkv, d.n_slots, SMS)
                assert plan.body == "gqa" and plan.smem <= at.SMEM_MAX, (
                    bits, Dh, hg, cap, R, Tc, plan)
                n += 1
    assert n > 1000
    big = dataclasses.replace(_dbrx_pallas(), head_group=8)
    with pytest.raises(ValueError, match="head field"):
        at._check_config(big, "pv_fused")


def test_k4_forced_routes():
    """The 8-row pv_decode stays reachable by ``body=`` (timing only);
    pv_gqa is refused at 1 / 2 rows and with fp32 dots."""
    d, d32 = _dbrx_pallas(), _dbrx_pallas(dot_bf16=False)
    assert at.body(d, 6, "pv") == "gqa"
    assert at.body(d32, 6, "pv") == "decode"
    assert at.body(d, 6, "pv", "decode") == "decode"
    assert at.body(d, 6, "pv", "gqa") == "gqa"
    for bad, dc, R in (("gqa", d32, 6), ("gqa", d, 2), ("gqa", d, 9),
                       ("mma", d, 6), ("decode", d, 9)):
        with pytest.raises(ValueError, match="body"):
            at.pv_plan(dc, R, 128, 34816, 1, 8, dc.n_slots, SMS, bad)


def _speed(Hkv=8, hg=8, codes="int4", dot_bf16=True):
    return DeployConfig.create(
        bits=4 if codes == "int4" else 2, n_kv_heads=Hkv, d_head=128,
        max_len=32768 + 8, sink=5, kernel="flash_serial", head_group=hg,
        codes=codes, post_rope_k=True, k_outliers="channels",
        n_kc=16 if codes == "int4" else 4, cap_per_side=0,
        dot_bf16=dot_bf16)


@pytest.mark.parametrize("codes", ["int4", "int4x2"])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 7, 8])
def test_k2_plan_rows_and_splits(G, codes):
    """fs_mma plans the G rows themselves (one launch, one merge block per
    row); at 2-8 rows, 8 kv heads over 32K, splits for WARP_TILES tiles a
    warp (half a wave); fs_partial and the forced padded route plan the
    padded instance; the one-wave bound holds."""
    d = _speed(codes=codes)
    Tc = d.cache_tokens
    plan = fs.fs_plan(d, 1, 8, G, 128, Tc, sms=SMS)
    assert (plan.body, plan.rows) == ("fs_mma", G)
    assert plan.smem == fs.mma_smem_bytes(G, 128, d.n_kc, 0, 0)
    assert plan.n_split * 8 <= plan.per_sm * SMS
    assert plan.n_split <= Tc // (fs.MMA_TILE * fs.MMA_WARPS)
    wave = plan.per_sm * SMS // 8
    most = Tc // (fs.MMA_TILE * fs.MMA_WARPS)
    if G == 1:
        assert plan.n_split == wave == 66  # one row: the one wave
    else:
        assert plan.n_split == most // fs.WARP_TILES == 34 >= wave // 2
    rows = common.decode_rows(G)
    padded = fs.fs_plan(d, 1, 8, G, 128, Tc, sms=SMS, body=fs.PADDED)
    assert padded == fs.fs_plan(d, 1, 8, rows, 128, Tc, sms=SMS)
    assert (padded.body, padded.rows) == ("fs_mma", rows)
    part = fs.fs_plan(d, 1, 8, G, 128, Tc, sms=SMS, body="fs_partial")
    assert (part.body, part.rows) == ("fs_partial", rows)


@pytest.mark.parametrize("Tc", [2048, 8192, 16384, 34816, 133120])
@pytest.mark.parametrize("Hkv", [32, 8])
def test_k2_splits_at_one_row_fill_one_wave(Hkv, Tc):
    """One query row (LLaMA's 32 kv heads, and 8) keeps the splits that
    fill the resident blocks once, at most one per warp's tile group, at
    every capacity: the fewer splits of 2-8 rows do not apply."""
    d = dataclasses.replace(_speed(Hkv=Hkv, hg=8), max_len=Tc + 5)
    plan = fs.fs_plan(d, 1, Hkv, 1, 128, Tc, sms=SMS)
    most = Tc // (fs.MMA_TILE * fs.MMA_WARPS)
    assert plan.n_split == max(1, min(plan.per_sm * SMS // Hkv, most))


def test_k2_routes_and_forcing():
    """GQA_ROWS are the rows fs_mma takes unpadded above 2; the padded
    route is refused where fs_mma does not apply; an unknown route
    raises before any launch."""
    assert fs.GQA_ROWS == (3, 4, 5, 6, 7, 8)
    assert fs.ROUTES == ("fs_partial", "fs_mma", "fs_mma_padded")
    d32 = _speed(dot_bf16=False)
    with pytest.raises(ValueError, match="fs_mma takes bf16 dots"):
        fs.fs_plan(d32, 1, 8, 6, 128, d32.cache_tokens, sms=SMS,
                   body=fs.PADDED)
    with pytest.raises(ValueError, match="unknown body"):
        fs.fs_plan(_speed(), 1, 8, 6, 128, 32768 + 128, sms=SMS, body="gqa")


def test_new_route_counters_are_snapshotted():
    """K2_gqa and K4_gqa are counters of their own: graphs record and
    replay them; launch_counts keeps one count per wrapper."""
    snap = tk.snapshot()
    assert {"K2_gqa", "K4_gqa"} <= set(snap)
    assert set(tk.launch_counts()) == {"K1", "K2", "K3", "K4", "K5",
                                       "moe_experts"}
    saved = at.pv_fused.gqa_launches, fs.flash_serial_decode.gqa_launches
    try:
        def bump():
            at.pv_fused.gqa_launches += 3
            fs.flash_serial_decode.gqa_launches += 1
        _, delta = tk.counted(bump)
        assert delta == {"K4_gqa": 3, "K2_gqa": 1}
        assert (at.pv_fused.gqa_launches,
                fs.flash_serial_decode.gqa_launches) == saved
        tk.add_launches(delta)
        assert (at.pv_fused.gqa_launches,
                fs.flash_serial_decode.gqa_launches) == (saved[0] + 3,
                                                         saved[1] + 1)
    finally:
        at.pv_fused.gqa_launches, fs.flash_serial_decode.gqa_launches = saved


def test_cpu_calls_count_no_new_route():
    """CPU tensors run the plain versions: no launch of either new route
    is counted, whatever ``body`` names."""
    before = (at.pv_fused.gqa_launches, at.pv_fused.launches,
              fs.flash_serial_decode.gqa_launches,
              fs.flash_serial_decode.launches)
    want, got = _k2_case(6, "int4", "channels", 5, True)
    _k2_check(want, got, True)
    d = dataclasses.replace(_dbrx_pallas(), n_kv_heads=HKV, d_head=D,
                            max_len=TC + 5)
    g = torch.Generator().manual_seed(0)
    args = (torch.softmax(torch.randn((1, HKV, 6, TC), generator=g), -1),
            torch.randint(-2 ** 31, 2 ** 31 - 1, (1, HKV, 3, TC // 32, D),
                          generator=g, dtype=torch.int32),
            torch.rand((1, TC), generator=g), torch.rand((1, TC), generator=g),
            None, torch.linspace(-1, 1, 8))
    torch.testing.assert_close(at.pv_fused(*args, d, body="gqa"),
                               at.pv_fused_ref(*args, d), rtol=0, atol=0)
    assert (at.pv_fused.gqa_launches, at.pv_fused.launches,
            fs.flash_serial_decode.gqa_launches,
            fs.flash_serial_decode.launches) == before
