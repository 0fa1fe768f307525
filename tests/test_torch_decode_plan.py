"""The host side of the decode body shared by K1 and K5
(kvquant_tpu_torch/ops/kernels/flash_decode.py): the cached (cos, sin)
table the kernels rotate pre-RoPE keys with, and the block plan of
``fd_decode`` (heads per block, ring stages).

  (a) ``rope_table`` equals the plain version's ``rope_cos_sin(S +
      arange(Tc))`` bitwise (the first half of its d_head columns: the
      angles repeat), and JAX's ``rope_cos_sin`` on the same positions
      within 2e-5 (the fp32 angles are the same; XLA's cos / sin on the
      CPU reduce angles of ~3e4 rad less exactly: 7.6e-6 apart at 32K);
  (b) a second call with the same key returns the same tensor; another
      capacity, sink or RoPE parameter gives another table;
  (c) the plan divides the head group, pairs int4x2 heads, keeps a stage
      within STAGE_BYTES where a smaller slice allows it and the ring
      within RING_BYTES, and routes only Tq = 1 steps with G in 1/2/4/8
      to the decode body.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kvquant_tpu.models.config import ModelConfig as JModelConfig
from kvquant_tpu.models.llama import rope_cos_sin as jax_rope_cos_sin

from kvquant_tpu_torch.cache import DeployConfig
from kvquant_tpu_torch.models.config import LLAMA2_7B, ModelConfig
from kvquant_tpu_torch.models.llama import rope_cos_sin
from kvquant_tpu_torch.ops.kernels import flash_decode as fd

torch.set_num_threads(1)


def _cfg(d_head, theta=10000.0, scaling=1.0):
    kw = dict(vocab_size=64, d_model=4 * d_head, n_layers=1, n_heads=4,
              n_kv_heads=4, d_head=d_head, d_ff=32, max_seq_len=1 << 20,
              rope_theta=theta, rope_scaling=scaling)
    return ModelConfig(**kw), JModelConfig(**kw)


@pytest.mark.parametrize("S,Tc,d_head,scaling", [
    (0, 256, 16, 1.0), (5, 2048, 64, 1.0), (5, 32768, 128, 1.0),
    (64, 4096, 32, 4.0)])
def test_rope_table_is_the_plain_tables(S, Tc, d_head, scaling):
    cfg, jcfg = _cfg(d_head, scaling=scaling)
    tab = fd.rope_table(cfg, S, Tc, "cpu")
    assert tab.shape == (Tc, d_head // 2, 2) and tab.dtype == torch.float32
    assert tab.is_contiguous()
    cos, sin = rope_cos_sin(S + torch.arange(Tc, dtype=torch.int32), cfg)
    half = d_head // 2
    assert torch.equal(tab[..., 0], cos[:, :half])
    assert torch.equal(tab[..., 1], sin[:, :half])
    jc, js = jax_rope_cos_sin(S + jnp.arange(Tc, dtype=jnp.int32), jcfg)
    np.testing.assert_allclose(tab[..., 0].numpy(), np.asarray(jc)[:, :half],
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(tab[..., 1].numpy(), np.asarray(js)[:, :half],
                               rtol=0, atol=2e-5)


def test_rope_table_is_built_once_per_key():
    cfg, _ = _cfg(32)
    tab = fd.rope_table(cfg, 5, 1024, "cpu")
    assert fd.rope_table(cfg, 5, 1024, torch.device("cpu")) is tab
    # the key is the RoPE parameters, not the config object
    assert fd.rope_table(dataclasses.replace(cfg, n_layers=7), 5, 1024,
                         "cpu") is tab
    others = [fd.rope_table(cfg, 5, 2048, "cpu"),
              fd.rope_table(cfg, 0, 1024, "cpu"),
              fd.rope_table(dataclasses.replace(cfg, rope_scaling=2.0), 5,
                            1024, "cpu"),
              fd.rope_table(dataclasses.replace(cfg, rope_theta=500000.0), 5,
                            1024, "cpu")]
    for o in others:
        assert o is not tab
    assert others[0].shape[0] == 2048
    assert not torch.equal(others[1], tab)
    assert not torch.equal(others[2], tab)
    assert not torch.equal(others[3], tab)


def _dcfg(codes, bits, hg, D, k_out="slots", cap=2, n_kc=4):
    return DeployConfig.create(
        bits=bits, n_kv_heads=16, d_head=D, max_len=4096, sink=5,
        kernel="flash", head_group=hg, codes=codes,
        k_outliers=k_out, n_kc=n_kc, cap_per_side=cap)


def test_decode_plan_at_llama2_7b():
    """The two LLaMA-2-7B cells: faithful nuq3 (slots cap 2, hg 4) and the
    2-bit int4x2 (4 static channels, hg 4)."""
    D = LLAMA2_7B.d_head
    nuq3 = _dcfg("nuq", 3, 4, D)
    assert fd.decode_plan(nuq3, D, nuq3.n_slots, True) == (2, 3, 128)
    x2 = _dcfg("int4x2", 2, 4, D, k_out="channels", cap=0)
    assert fd.decode_plan(x2, D, x2.n_slots, True) == (4, 4, 64)


@pytest.mark.parametrize("codes,bits", [("nuq", 2), ("nuq", 3), ("nuq", 4),
                                        ("int4", 4), ("int8", 8),
                                        ("int4x2", 2)])
def test_decode_plan_shapes(codes, bits):
    for hg in (1, 2, 4, 8, 16):
        if codes == "int4x2" and hg % 2:
            continue
        for D in (32, 64, 128):
            for k_out, cap, n_kc in (("slots", 2, 4), ("channels", 0, 16),
                                     ("channels", 2, 64)):
                if cap and hg * D > 512:  # slot words: 9-bit index
                    continue
                dcfg = _dcfg(codes, bits, hg, D, k_out, cap, n_kc)
                J = dcfg.n_slots
                hb, n_stage, tt = fd.decode_plan(dcfg, D, J, True)
                assert hg % hb == 0 and hb <= 8, (hg, hb)
                assert codes != "int4x2" or hb % 2 == 0
                assert tt == (128 if codes == "nuq" else 64)
                cb = {"nuq": bits * 16 * D, "int8": 64 * D}.get(codes,
                                                               32 * D)

                def stage(h):
                    units = h // 2 if codes == "int4x2" else h
                    return 2 * units * cb + (J + 2) * tt * 4
                smallest = 2 if codes == "int4x2" else 1
                assert stage(hb) <= fd.STAGE_BYTES or hb == smallest
                bigger = [h for h in (8, 4, 2) if h > hb and hg % h == 0
                          and (codes != "int4x2" or h % 2 == 0)]
                assert all(stage(h) > fd.STAGE_BYTES for h in bigger)
                assert 2 <= n_stage <= 4
                assert n_stage * stage(hb) <= fd.RING_BYTES or n_stage == 2


def test_only_single_token_steps_run_the_decode_body():
    assert all(fd.is_decode(G, 1) for G in (1, 2, 4, 8))
    # 3 / 5 rows run the tensor-core decode body fd_gqa with bf16 dots; with
    # fp32 dots (and at 16 rows) they are not decode steps
    assert all(fd.is_decode(G, 1) for G in (3, 5))
    assert not any(fd.is_decode(G, 1, dot_bf16=False) for G in (3, 5, 16))
    assert not fd.is_decode(16, 1)
    assert not fd.is_decode(2, 2) and not fd.is_decode(256, 256)
