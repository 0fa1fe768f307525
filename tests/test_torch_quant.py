"""Port of the cache containers, quantizer artifacts, append-side quant math
and integer packing (kvquant_tpu_torch/{cache,quant,ops/packing,
ops/deployed}.py) against the JAX package, bitwise, on identical numpy
inputs. The JAX functions run eagerly (op by op), so neither side fuses a
multiply-add."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kvquant_tpu import cache as jcache
from kvquant_tpu.ops import deployed as jdep, packing as jpk
from kvquant_tpu.quant import artifacts as jart, nuq as jnuq

from kvquant_tpu_torch import cache as tcache
from kvquant_tpu_torch.ops import deployed as tdep, packing as tpk
from kvquant_tpu_torch.quant import artifacts as tart, nuq as tnuq

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts")


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _dcfgs(**kw):
    return jcache.DeployConfig.create(**kw), tcache.DeployConfig.create(**kw)


# ---------------------------------------------------------------------------
# cache and artifacts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codes,bits", [("nuq", 3), ("int4", 4),
                                        ("int8", 8), ("int4x2", 2)])
def test_create_cache_shapes(codes, bits):
    jd, td = _dcfgs(bits=bits, n_kv_heads=4, d_head=16, max_len=300,
                    codes=codes, head_group=2, k_outliers="channels",
                    cap_per_side=1)
    jc = jcache.create_cache(jd, 2, 3)
    tc = tcache.create_cache(td, 2, 3, device="cpu")
    for name, t in tc.arrays().items():
        j = getattr(jc, name)
        shape = list(j.shape)
        if codes in ("int4", "int4x2") and name in ("k_planes", "v_planes"):
            shape[-1] //= 2  # nibble pairs
            assert t.dtype == torch.uint8
        else:
            assert str(t.dtype).split(".")[-1] == str(j.dtype), name
        assert list(t.shape) == shape, name
    assert tc.length.dtype == torch.int32 and tuple(tc.length.shape) == (3,)
    assert tcache.cache_bytes(td, 2, 3) == jcache.cache_bytes(jd, 2, 3)


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_toy_artifacts_load_equal(bits):
    path = os.path.join(ART, f"toy_quantizers_{bits}bit.npz")
    jq = jcache.deployed_from_quantizers(jart.load_quantizers(path), 4, 32)
    tq = tcache.deployed_from_quantizers(tart.load_quantizers(path), 4, 32,
                                         device="cpu")
    for f in ("k_range", "k_offset", "k_lower", "k_upper", "k_lut_enc",
              "k_lut_dec", "v_lut_enc", "v_lut_dec", "k_ressc"):
        _eq(getattr(tq, f), getattr(jq, f))


def test_port_written_artifact_loads_in_jax(tmp_path):
    qs = tart.load_quantizers(os.path.join(ART, "toy_quantizers_3bit.npz"))
    qs.layers[0].k.normscale, qs.layers[0].k.normoffset = 0.9, 0.01
    qs.meta["post_rope_k"] = True
    path = str(tmp_path / "q.npz")
    tart.save_quantizers(path, qs)
    back = jart.load_quantizers(path)
    assert back.meta == qs.meta and back.bits == qs.bits
    jq = jcache.deployed_from_quantizers(back, 4, 32)
    tq = tcache.deployed_from_quantizers(qs, 4, 32, device="cpu")
    _eq(tq.k_lut_dec, jq.k_lut_dec)
    _eq(tq.k_ressc, jq.k_ressc)


def test_channel_selection_ties_and_codebook_guard():
    jd, td = _dcfgs(bits=4, n_kv_heads=4, d_head=16, max_len=300,
                    codes="int4", head_group=2, k_outliers="channels",
                    n_kc=3, cap_per_side=0)
    rng = np.random.default_rng(0)
    for ressc in (np.zeros((2, 64), np.float32),  # every channel ties
                  rng.integers(0, 3, (2, 64)).astype(np.float32)):
        _eq(tcache.k_channel_onehot(torch.as_tensor(ressc), td),
            jcache.k_channel_onehot(jnp.asarray(ressc), jd))
    lut = np.stack([np.linspace(-1, 1, 16, dtype=np.float32)] * 2)
    a, b = tcache.affine_lut_coeffs(torch.as_tensor(lut))
    ja, jb = jcache.affine_lut_coeffs(lut)
    _eq(a, ja)
    _eq(b, jb)
    lut[1, 3] += 0.05
    with pytest.raises(ValueError):
        tcache.affine_lut_coeffs(lut)


# ---------------------------------------------------------------------------
# quant math and packing
# ---------------------------------------------------------------------------


def test_nearest_codes_ties_at_midpoints():
    # no midpoint at 0: XLA on the CPU flushes denormals, so the neighbour
    # of a zero midpoint would compare differently for a reason unrelated
    # to the rounding rule under test
    lut = np.linspace(-1, 1.2, 8, dtype=np.float32)
    mids = (lut[:-1] + lut[1:]) * np.float32(0.5)
    rng = np.random.default_rng(1)
    x = np.concatenate([mids, np.nextafter(mids, 2), np.nextafter(mids, -2),
                        rng.standard_normal(200).astype(np.float32),
                        np.array([np.nan, np.inf, -np.inf], np.float32)])
    _eq(tnuq.nearest_codes(torch.as_tensor(x), torch.as_tensor(lut)),
        jnuq.nearest_codes(jnp.asarray(x), jnp.asarray(lut)))


def _quant_inputs(seed, zero_range=False, zero_ressc=False):
    rng = np.random.default_rng(seed)
    L, C = 2, 64
    up = (np.abs(rng.standard_normal((L, C))) + 0.5).astype(np.float32)
    lo = (-np.abs(rng.standard_normal((L, C))) - 0.5).astype(np.float32)
    x = (rng.standard_normal((3, 5, C)) * 1.5).astype(np.float32)
    if zero_range:  # zero-range channels and zero-range tokens
        lo[:, :4] = up[:, :4]
        x[:, :, :4] = up[0, :4]
        x[1, 2] = 0.25
    ressc = np.zeros((L, C), np.float32) if zero_ressc else \
        rng.random((L, C)).astype(np.float32)
    lut = np.sort(rng.uniform(-1, 1, 8)).astype(np.float32)
    dq = dict(k_range=((up - lo) / 2).reshape(L, 4, 16),
              k_offset=((up + lo) / 2).reshape(L, 4, 16), k_lower=lo,
              k_upper=up, k_lut_enc=np.stack([lut] * L),
              k_lut_dec=np.stack([lut * 1.01] * L),
              v_lut_enc=np.stack([lut] * L), v_lut_dec=np.stack([lut] * L),
              k_ressc=ressc)
    jq = jcache.DeployedQuant(**{k: jnp.asarray(v) for k, v in dq.items()})
    tq = tcache.DeployedQuant(**{k: torch.as_tensor(v) for k, v in dq.items()})
    return x, jq.layer(1), tq.layer(1)


@pytest.mark.parametrize(
    "k_out,cap,hg", [("slots", 2, 2), ("slots", 40, 4),  # cap > outliers
                     ("channels", 0, 4), ("channels", 1, 2)])
@pytest.mark.parametrize("degenerate", [False, True],
                         ids=["random", "zero-range"])
def test_quantize_k_v_bitwise(k_out, cap, hg, degenerate):
    x, jq, tq = _quant_inputs(3, zero_range=degenerate,
                              zero_ressc=degenerate)
    jd, td = _dcfgs(bits=3, n_kv_heads=4, d_head=16, max_len=300,
                    codes="int4", head_group=hg, k_outliers=k_out, n_kc=3,
                    cap_per_side=cap)
    with np.errstate(all="ignore"):
        for fn in ("quantize_k", "quantize_v"):
            want = getattr(jdep, fn)(jnp.asarray(x), jq, jd)
            got = getattr(tdep, fn)(torch.as_tensor(x), tq, td)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if g is not None:
                    # words compare as bit patterns (NaNs of zero ranges too)
                    gb, wb = g.numpy(), np.asarray(w)
                    if gb.dtype == np.float32:
                        gb, wb = gb.view(np.int32), wb.view(np.int32)
                    _eq(gb, wb)


@pytest.mark.parametrize("bits,dt", [(4, "int4"), (3, "int4"), (8, "int8")])
def test_int_container_round_trip(bits, dt):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2 ** bits, (2, 6, 3, 16))
    jdt = jnp.int4 if dt == "int4" else jnp.int8
    tdt = torch.uint8 if dt == "int4" else torch.int8
    jv = np.asarray(jpk.store_codes_int(jnp.asarray(codes), bits, jdt)
                    .astype(jnp.int32))
    tv = tpk.store_codes_int(torch.as_tensor(codes), bits, tdt)
    signed = tpk.unpack_nibbles(tv) if dt == "int4" else tv.to(torch.int32)
    _eq(signed, jv)
    _eq(tpk.load_codes_int(tv, bits), codes)
    arr = torch.zeros((2, 3, 8, tv.shape[-1]), dtype=tdt)
    tpk.place_codes_int(arr, torch.as_tensor(codes), 2, bits)
    _eq(tpk.load_codes_int(arr, bits)[:, :, 2:8],
        np.moveaxis(codes, -3, -2))


def test_int4x2_pair_round_trip():
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, (2, 6, 4, 16))  # (..., T, H, D)
    jv = np.asarray(jpk.pair_codes_int4x2(jnp.asarray(codes))
                    .astype(jnp.int32))
    tv = tpk.pair_codes_int4x2(torch.as_tensor(codes))
    _eq(tpk.unpack_nibbles(tv), jv)
    arr = torch.zeros((2, 2, 8, 8), dtype=torch.uint8)
    tpk.place_codes_int4x2(arr, torch.as_tensor(codes), 1)
    want = np.asarray(jpk.unpair_codes_int4x2(
        jpk.place_codes_int4x2(jnp.zeros((2, 2, 8, 16), jnp.int4),
                               jnp.asarray(codes), 1)))
    _eq(tpk.unpair_codes_int4x2(arr), want)


def test_outlier_words_encode_decode():
    rng = np.random.default_rng(5)
    vals = (rng.standard_normal(300) * 3).astype(np.float32)
    vals[:5] = 0.0
    idx = rng.integers(0, 512, 300).astype(np.int32)
    jw = np.asarray(jpk.encode_outlier_words(jnp.asarray(vals),
                                             jnp.asarray(idx)))
    tw = tpk.encode_outlier_words(torch.as_tensor(vals), torch.as_tensor(idx))
    _eq(tw.numpy().view(np.int32), jw.view(np.int32))
    jv, ji = jpk.decode_outlier_words(jnp.asarray(jw))
    tv, ti = tpk.decode_outlier_words(tw)
    _eq(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))
    _eq(ti, ji)


# ---------------------------------------------------------------------------
# the port imports no JAX
# ---------------------------------------------------------------------------


def test_port_imports_no_jax():
    pkg = os.path.join(ROOT, "kvquant_tpu_torch")
    mods = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kvquant_tpu'] = None\n"
        "import importlib\n"
        f"for m in {sorted(mods)!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stderr
    sources = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(ROOT, m.replace(".", os.sep) + ".py") for m in mods]
    for path in sources:
        if not os.path.exists(path):  # package __init__ modules
            path = path[:-3] + os.sep + "__init__.py"
        with open(path) as f:
            for line in f:
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1]
                    assert mod.split(".")[0] not in ("jax", "jaxlib"), (path, s)
                    assert mod.split(".")[0] != "kvquant_tpu", (path, s)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from kvquant_tpu_torch import engine
    from kvquant_tpu_torch.models import TINY_LLAMA, init_params

    td = tcache.DeployConfig.create(
        bits=4, n_kv_heads=4, d_head=16, max_len=64, codes="int4",
        kernel="flash_serial", post_rope_k=True)
    with pytest.raises(RuntimeError, match="cuda"):
        tcache.create_cache(td, 2, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(TINY_LLAMA)
    params = init_params(TINY_LLAMA, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        engine.deployed_ppl(params, TINY_LLAMA, td, None,
                            torch.zeros((1, 8), dtype=torch.int32))
