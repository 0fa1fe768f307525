"""Port of the slot-pool server (kvquant_tpu_torch/serve.py) against the JAX
package's (kvquant_tpu/serve.py) on the same weights, quantizers and
requests: interleaved admission at per-sample positions, EOS retirement,
chunked admission, the no-stall property, capacity-class routing and
cache_bytes (tests/test_serve.py's cases). Tokens must be identical: to
the JAX server's and to the port's isolated generation. The quantizers
are uniform (the per-token V range puts elements at the outlier threshold
and k-means codebooks turn an ulp of matmul rounding into a visible
residual: ROADMAP queue 3)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kvquant_tpu import serve as jserve
from kvquant_tpu.cache import (DeployConfig as JDeployConfig,
                               cache_bytes as jcache_bytes,
                               deployed_from_quantizers as jdeployed)
from kvquant_tpu.models import TINY_LLAMA as J_TINY, init_params as jinit
from kvquant_tpu.quant.artifacts import save_quantizers
from kvquant_tpu.quant.calibration import (collect_kv_activations,
                                           fit_quantizers)

from kvquant_tpu_torch import engine, serve
from kvquant_tpu_torch.cache import DeployConfig, deployed_from_quantizers
from kvquant_tpu_torch.models import TINY_LLAMA, params_from_numpy
from kvquant_tpu_torch.quant.artifacts import load_quantizers

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params = jinit(jax.random.PRNGKey(0), J_TINY, dtype=jnp.float32)
    cal = jax.random.randint(jax.random.PRNGKey(7), (2, 40), 0,
                             J_TINY.vocab_size)
    k_acts, v_acts = collect_kv_activations(params, J_TINY, [cal])
    qs = fit_quantizers(k_acts, v_acts, bits=4, cap_outliers=True,
                        first_few_fp16=5, sample_seqlen=40, kmeans_iters=8,
                        mode="uniform")
    path = str(tmp_path_factory.mktemp("q") / "q.npz")
    save_quantizers(path, qs)
    d = dict(bits=4, n_kv_heads=4, d_head=16, max_len=69, sink=5,
             dot_bf16=False)
    return dict(
        jax=(params, J_TINY, JDeployConfig.create(**d),
             jdeployed(qs, 4, 16)),
        torch=(params_from_numpy(jax.tree.map(np.asarray, params),
                                 TINY_LLAMA, device="cpu"), TINY_LLAMA,
               DeployConfig.create(**d),
               deployed_from_quantizers(load_quantizers(path), 4, 16,
                                        device="cpu")))


def _both(setup, make, reqs, **kw):
    """Run the JAX server and the port's on the same requests."""
    out = {}
    for side, mod in (("jax", jserve), ("torch", serve)):
        p, c, d, q = setup[side]
        extra = {} if side == "jax" else {"device": "cpu"}
        srv = make(mod, p, c, d, q, **kw, **extra)
        res = srv.run([mod.Request(**dataclasses.asdict(r)) for r in reqs])
        out[side] = {rid: comp.tokens for rid, comp in res.items()}
    return out


def _isolated(setup, prompt, n, prefill_mode="fp16", dcfg=None):
    p, c, d, q = setup["torch"]
    out, _ = engine.generate(p, c, dcfg or d, q,
                             torch.as_tensor(prompt)[None],
                             engine.GenerateConfig(max_new_tokens=n),
                             prefill_mode=prefill_mode, device="cpu")
    return out[0].tolist()


def _server(mod, *a, **kw):
    return mod.Server(*a, **kw)


@pytest.mark.parametrize("admit_mode", ["sync", "chunked"])
def test_interleaved_matches_jax_and_isolated(setup, admit_mode):
    """3 requests, 2 slots: the third is admitted mid-flight; different
    prompt lengths exercise per-sample positions. Chunked admission
    prefills through the quantized trajectory."""
    rng = np.random.default_rng(0 if admit_mode == "sync" else 3)
    reqs = [serve.Request(rid=i, prompt=rng.integers(0, 256, n)
                          .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate([(12, 6), (17, 4), (9, 5)])]
    out = _both(setup, _server, reqs, n_slots=2, admit_mode=admit_mode,
                admit_chunk=256)
    assert out["torch"] == out["jax"]
    mode = "fp16" if admit_mode == "sync" else "quantized"
    for r in reqs:
        assert out["torch"][r.rid] == _isolated(setup, r.prompt,
                                                r.max_new_tokens, mode)


def test_eos_retires_slot(setup):
    rng = np.random.default_rng(1)
    p = rng.integers(0, 256, 10).astype(np.int32)
    eos = _isolated(setup, p, 1)[0]
    reqs = [serve.Request(rid=0, prompt=p, max_new_tokens=8,
                          eos_token_id=eos)]
    out = _both(setup, _server, reqs, n_slots=1)
    assert out["torch"] == out["jax"] == {0: [eos]}


def test_chunked_admission_does_not_stall_decode(setup):
    """While a 3-chunk prompt is admitted, the active slot produces a
    token every server step; the port's tokens equal the JAX server's."""
    rng = np.random.default_rng(4)
    short = rng.integers(0, 256, 10).astype(np.int32)
    long_p = rng.integers(0, 256, 3 * 128).astype(np.int32)
    toks = {}
    for side, mod in (("jax", jserve), ("torch", serve)):
        p, c, d, q = setup[side]
        d = dataclasses.replace(d, max_len=3 * 128 + 8 + d.sink)
        extra = {} if side == "jax" else {"device": "cpu"}
        srv = mod.Server(p, c, d, q, n_slots=2, admit_mode="chunked",
                         admit_chunk=128, **extra)
        srv.submit(mod.Request(rid=0, prompt=short, max_new_tokens=20))
        srv.step()
        assert srv.active[0] is not None
        srv.submit(mod.Request(rid=1, prompt=long_p, max_new_tokens=3))
        for _ in range(3):
            before = len(srv.out[0].tokens)
            srv.step()
            assert len(srv.out[0].tokens) == before + 1, "decode stalled"
        assert srv.active[1] is not None
        srv.run([])
        assert len(srv.out[1].tokens) == 3
        toks[side] = {r: c.tokens for r, c in srv.out.items()}
    assert toks["torch"] == toks["jax"]


def test_server_pool_capacity_classes(setup):
    rng = np.random.default_rng(5)
    reqs = [serve.Request(rid=0, prompt=rng.integers(0, 256, 12)
                          .astype(np.int32), max_new_tokens=4),
            serve.Request(rid=1, prompt=rng.integers(0, 256, 150)
                          .astype(np.int32), max_new_tokens=4)]
    kw = dict(classes={48: 2, 1500: 1}, admit_mode="chunked",
              admit_chunk=128)
    pools = {}

    def make(mod, *a, **k):
        pools[mod] = mod.ServerPool(*a, **k)
        return pools[mod]

    out = _both(setup, make, reqs, **kw)
    assert out["torch"] == out["jax"]
    pool = pools[serve]
    assert pool._route(reqs[0]).dcfg.max_len == 48
    assert pool._route(reqs[1]).dcfg.max_len == 1500
    assert [len(out["torch"][i]) for i in (0, 1)] == [4, 4]
    assert pool.cache_bytes() == pools[jserve].cache_bytes()
    flat = jcache_bytes(pools[jserve].servers[1500].dcfg, 2, 3)["total"]
    assert pool.cache_bytes() < flat
    with pytest.raises(ValueError, match="largest class"):
        pool._route(serve.Request(rid=2, prompt=np.zeros(1600, np.int32),
                                  max_new_tokens=1))
