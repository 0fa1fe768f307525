"""The port's tensor and data parallelism (kvquant_tpu_torch/parallel on
torch.distributed) against the single-process port and the JAX package's
sharded runs (tests/test_parallel.py, tests/test_multihost.py).

One gloo world of four CPU ranks (tests/torch_parallel_worker.py, spawned
once for the module, assembled from KVQ_* through init_distributed and
make_multihost_mesh(tp=2)) runs every sharded case; this process runs the
JAX side on conftest's 8-device virtual CPU mesh and the single-process
port, and holds the gathered results to them:

  - TINY_LLAMA fp32 at dp 2 x tp 2 and at tp 4, through every datapath
    ("xla", "pallas" K3 / K4, "flash" K1, "flash_serial" K2 with the int4
    speed config): prefill and decode logits equal the single-process port
    and JAX's sharded run (make_mesh(2, 2) / (1, 4)) at JAX's atol=2e-4,
    rtol=1e-3; the packed k / v planes gathered over tp are bitwise the
    single-process ones; a quantized chunked prefill likewise;
  - TINY_MOE with its experts over tp 2: greedy tokens equal the
    single-process port's and JAX's sharded run's (dense and sparse FFN);
  - flash_attention_sharded equal to the unsharded K1 / K2 call (the four
    cases of tests/test_parallel.py:128-360);
  - the V-range exchange equal to the unsharded quantize_v, with tokens
    whose extremes all sit on one rank;
  - the sharded Fisher step's probe gradients equal to the unsharded ones;
  - the rule tables against JAX's, the w_qkv head regathering and the
    per-channel quantizer slices, the head-group rule, init_distributed
    without the KVQ_* variables.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvquant_tpu import engine as jeng
from kvquant_tpu.cache import (DeployConfig as JDeployConfig,
                               create_cache as jcreate_cache,
                               deployed_from_quantizers as jdeployed)
from kvquant_tpu.models import TINY_LLAMA as J_TINY, init_params as jinit
from kvquant_tpu.models import moe as jmoe
from kvquant_tpu.parallel import (make_mesh as jmake_mesh,
                                  shard_cache as jshard_cache,
                                  shard_params as jshard_params,
                                  shard_quant as jshard_quant,
                                  data_sharding as jdata_sharding)
from kvquant_tpu.parallel import shardings as jshardings
from kvquant_tpu.quant.artifacts import (KQuantizer, LayerQuantizers,
                                         QuantizerSet, VQuantizer,
                                         save_quantizers)
from kvquant_tpu.quant.nuq import nf_signposts

from kvquant_tpu_torch import engine
from kvquant_tpu_torch.cache import (DeployConfig, create_cache,
                                     deployed_from_quantizers)
from kvquant_tpu_torch.fisher.fisher import _fisher_step
from kvquant_tpu_torch.models import TINY_LLAMA, params_from_numpy
from kvquant_tpu_torch.models import moe
from kvquant_tpu_torch.parallel import (Mesh, cache_shardings, make_mesh,
                                        param_shardings, quant_shardings,
                                        shard_cache, shard_config,
                                        shard_params, shard_quant,
                                        data_sharding)
from kvquant_tpu_torch.parallel.distributed import init_distributed
from kvquant_tpu_torch.quant.artifacts import load_quantizers

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
MESHES = {"dp2_tp2": (2, 2), "tp4": (1, 4)}
KERNELS = ("xla", "pallas", "flash", "flash_serial")
ATOL, RTOL = 2e-4, 1e-3  # tests/test_parallel.py's tolerance


def _qs(n_layers, C, bits, seed, uniform=False):
    """Random-threshold quantizers (tests/test_parallel.py's _toy_qs);
    ``uniform`` gives the affine codebook and channel scores of the int4
    speed config."""
    rng = np.random.default_rng(seed)
    lut = (np.linspace(-1.0, 1.0, 2 ** bits).astype(np.float32) if uniform
           else nf_signposts(bits))
    layers = []
    for _ in range(n_layers):
        u = (np.abs(rng.normal(size=C)) * 2 + 1).astype(np.float32)
        layers.append(LayerQuantizers(
            k=KQuantizer(upper=u, lower=(-u * 0.9).astype(np.float32),
                         lut=lut.copy(),
                         ressc=rng.uniform(size=C).astype(np.float32)
                         if uniform else None),
            v=VQuantizer(lut=lut.copy())))
    qs = QuantizerSet(layers=layers, bits=bits, sparsity_threshold=0.99,
                      cap_outliers=True, first_few_fp16=5)
    if uniform:
        qs.meta["post_rope_k"] = True
    return qs


def _flat(tree, prefix):
    out = {f"{prefix}/{k}": np.asarray(v) for k, v in tree.items()
           if k != "layers"}
    out.update({f"{prefix}/layers/{k}": np.asarray(v)
                for k, v in tree["layers"].items()})
    return out


def _v_rows():
    """(6, 64) V rows; tokens 0 and 1 keep all of their 4 largest and 4
    smallest values in one rank's 16 channels of tp 4 (rank 0, rank 3)."""
    v = np.random.default_rng(5).normal(size=(6, 64)).astype(np.float32)
    v[0, [1, 4, 9, 15]] = [9.0, 8.0, 7.5, 7.0]
    v[0, [0, 3, 8, 14]] = [-9.0, -8.5, -8.0, -7.0]
    v[1, [48, 50, 60, 63]] = [6.0, 5.5, 5.0, 4.5]
    v[1, [49, 52, 61, 62]] = [-6.0, -5.5, -5.0, -4.0]
    return v


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs from the JAX side, the four-rank world run once, its
    gathered results."""
    d = tmp_path_factory.mktemp("tp_world")
    jp = jinit(jax.random.PRNGKey(0), J_TINY, dtype=jnp.float32)
    mp = jmoe.init_params(jax.random.PRNGKey(0), jmoe.TINY_MOE,
                          dtype=jnp.float32)
    arrays = dict(
        prompt=np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16),
                                             0, J_TINY.vocab_size)),
        long_prompt=np.random.default_rng(2).integers(
            0, J_TINY.vocab_size, (2, 205)).astype(np.int32),
        moe_prompt=np.random.default_rng(3).integers(
            0, 256, (2, 16)).astype(np.int32),
        fisher_tokens=np.asarray(jax.random.randint(
            jax.random.PRNGKey(2), (2, 16), 0, J_TINY.vocab_size)),
        v_rows=_v_rows(),
        **_flat(jax.tree.map(np.asarray, jp), "llama"),
        **_flat(jax.tree.map(np.asarray, mp), "moe"))
    np.savez(d / "inputs.npz", **arrays)
    qs = {"q_nuq": _qs(2, 64, 4, 0), "q_int4": _qs(2, 64, 4, 0, True),
          "q_moe": _qs(2, 32, 3, 1)}
    for name, q in qs.items():
        save_quantizers(str(d / f"{name}.npz"), q)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, KVQ_COORDINATOR=f"localhost:{port}",
               KVQ_NUM_PROCESSES="4",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(d)], env=dict(env, KVQ_PROCESS_ID=str(i)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "WORKER_OK" in out, \
            f"rank {i} failed:\n{out[-4000:]}"
    with open(d / "meta.json") as fh:
        meta = json.load(fh)
    return dict(out=dict(np.load(d / "out.npz")), meta=meta, jp=jp, mp=mp,
                qs={k: load_quantizers(str(d / f"{k}.npz")) for k in qs},
                jqs=qs, arrays=arrays)


def _dcfg(cls, kernel, max_len=69):
    common = dict(n_kv_heads=4, d_head=16, max_len=max_len, sink=5,
                  kernel=kernel, head_group=1, dot_bf16=False)
    if kernel == "flash_serial":
        return cls.create(bits=4, codes="int4", post_rope_k=True,
                          k_outliers="channels", n_kc=4, cap_per_side=0,
                          **common)
    return cls.create(bits=4, **common)


def _port_single(world, kernel):
    params = params_from_numpy(jax.tree.map(np.asarray, world["jp"]),
                               TINY_LLAMA, device="cpu")
    qs = world["qs"]["q_int4" if kernel == "flash_serial" else "q_nuq"]
    dcfg = _dcfg(DeployConfig, kernel)
    dq = deployed_from_quantizers(qs, 4, 16, device="cpu")
    prompt = torch.tensor(world["arrays"]["prompt"])
    cache = create_cache(dcfg, TINY_LLAMA.n_layers, 2, device="cpu")
    cache, lg = engine.prefill(params, TINY_LLAMA, dcfg, dq, cache, prompt)
    tok = torch.argmax(lg, -1).to(torch.int32)
    cache, dec = engine.decode_step(params, TINY_LLAMA, dcfg, dq, cache,
                                    tok, 16)
    return lg.numpy(), dec.numpy(), cache


def _jax_sharded(world, kernel, dp, tp):
    jqs = world["jqs"]["q_int4" if kernel == "flash_serial" else "q_nuq"]
    dcfg = _dcfg(JDeployConfig, kernel)
    mesh = jmake_mesh(dp=dp, tp=tp)
    p_s = jshard_params(mesh, world["jp"])
    dq_s = jshard_quant(mesh, jdeployed(jqs, 4, 16))
    c = jshard_cache(mesh, jcreate_cache(dcfg, J_TINY.n_layers, 2))
    prompt = jax.device_put(jnp.asarray(world["arrays"]["prompt"]),
                            jdata_sharding(mesh))
    c, lg = jax.jit(lambda p, d, c, t: jeng.prefill(p, J_TINY, dcfg, d, c,
                                                    t))(p_s, dq_s, c, prompt)
    c, dec = jax.jit(lambda p, d, c, tok: jeng.decode_step(
        p, J_TINY, dcfg, d, c, tok, jnp.int32(16)))(
            p_s, dq_s, c, jnp.argmax(lg, -1).astype(jnp.int32))
    return np.asarray(lg), np.asarray(dec)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_llama_matches_single_and_jax(world, mesh, kernel):
    out = world["out"]
    tag = f"llama/{mesh}/{kernel}"
    lg0, dec0, cache0 = _port_single(world, kernel)
    jlg, jdec = _jax_sharded(world, kernel, *MESHES[mesh])
    for got, single, jax_s in ((out[f"{tag}/prefill"], lg0, jlg),
                               (out[f"{tag}/decode"], dec0, jdec)):
        np.testing.assert_allclose(got, single, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, jax_s, atol=ATOL, rtol=RTOL)
    for f in ("k_planes", "v_planes"):
        np.testing.assert_array_equal(out[f"{tag}/{f}"],
                                      getattr(cache0, f).numpy(), f)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_quantized_prefill(world, mesh):
    """Quantized chunked prefill (K1 over block_attention, whose V range
    is exchanged over tp) against the single-process port."""
    params = params_from_numpy(jax.tree.map(np.asarray, world["jp"]),
                               TINY_LLAMA, device="cpu")
    dcfg = _dcfg(DeployConfig, "flash", max_len=5 + 256 + 8)
    dq = deployed_from_quantizers(world["qs"]["q_nuq"], 4, 16, device="cpu")
    cache = create_cache(dcfg, TINY_LLAMA.n_layers, 2, device="cpu")
    cache, lg = engine.prefill_quantized(
        params, TINY_LLAMA, dcfg, dq, cache,
        torch.as_tensor(world["arrays"]["long_prompt"]), chunk=128)
    out = world["out"]
    tag = f"llama/{mesh}/quantized"
    np.testing.assert_allclose(out[f"{tag}/prefill"], lg.numpy(), atol=ATOL,
                               rtol=RTOL)
    # layer 1's inputs carry the tp sum's rounding: V ranges to an ulp
    np.testing.assert_allclose(out[f"{tag}/v_scale"], cache.v_scale.numpy(),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(out[f"{tag}/k_planes"],
                                  cache.k_planes.numpy())


@pytest.mark.parametrize("prefill_mode", ["fp16", "quantized"])
@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_moe_experts_over_tp(world, mode, prefill_mode):
    assert world["meta"]["moe_local_experts"] == 2  # 4 experts over tp 2
    prompt = world["arrays"]["moe_prompt"]
    jcfg = jmoe.MoEConfig(**{**jmoe.TINY_MOE.__dict__, "ffn_mode": mode})
    tcfg = moe.MoEConfig(**{**moe.TINY_MOE.__dict__, "ffn_mode": mode})
    kw = dict(bits=3, n_kv_heads=2, d_head=16, max_len=5 + 256 + 16, sink=5,
              kernel="flash", head_group=1, dot_bf16=False)
    # the port, one process
    params = moe.params_from_numpy(jax.tree.map(np.asarray, world["mp"]),
                                   tcfg, device="cpu")
    dq = deployed_from_quantizers(world["qs"]["q_moe"], 2, 16, device="cpu")
    single, _ = engine.generate(params, tcfg, DeployConfig.create(**kw), dq,
                                torch.as_tensor(prompt),
                                engine.GenerateConfig(max_new_tokens=8),
                                prefill_mode=prefill_mode, device="cpu")
    # JAX on the (dp 2, tp 2) mesh, experts over tp
    jd = JDeployConfig.create(**kw)
    mesh = jmake_mesh(dp=2, tp=2)
    want, _ = jeng.generate(
        jshard_params(mesh, world["mp"]), jcfg, jd,
        jshard_quant(mesh, jdeployed(world["jqs"]["q_moe"], 2, 16)),
        jax.device_put(jnp.asarray(prompt), jdata_sharding(mesh)),
        jeng.GenerateConfig(max_new_tokens=8),
        cache=jshard_cache(mesh, jcreate_cache(jd, jcfg.n_layers, 2)),
        prefill_mode=prefill_mode)
    got = world["out"][f"moe/{mode}/{prefill_mode}"]
    assert got.tolist() == single.tolist()
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("case", ["nuq", "int4", "channels", "serial"])
def test_flash_attention_sharded(world, case):
    out = world["out"]
    np.testing.assert_allclose(out[f"flash_sharded/{case}/got"],
                               out[f"flash_sharded/{case}/want"],
                               atol=1e-5, rtol=1e-5)


def test_v_range_exchange(world):
    out = world["out"]
    for k in ("lo", "hi", "codes", "scale", "words"):
        np.testing.assert_array_equal(out[f"vrange/{k}"],
                                      out[f"vrange/want_{k}"], k)
    # tokens 0 and 1 took every extreme from one rank
    assert out["vrange/hi"][0, 0] == 7.0 and out["vrange/lo"][0, 0] == -7.0
    assert out["vrange/hi"][1, 0] == 4.5 and out["vrange/lo"][1, 0] == -4.0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_fisher_step(world, mesh):
    """Each rank's probe gradients are its heads' channels of the
    unsharded step's on its own batch (rank-side comparison), and the
    gathered ones equal the unsharded step's on the whole batch when dp
    is 1."""
    out = world["out"]
    assert float(out[f"fisher/{mesh}/nonzero"]) == 1.0
    assert float(out[f"fisher/{mesh}/rel_err"]) < 1e-5
    if MESHES[mesh][0] == 1:
        params = params_from_numpy(jax.tree.map(np.asarray, world["jp"]),
                                   TINY_LLAMA, device="cpu")
        gk, _ = _fisher_step(params, TINY_LLAMA, torch.as_tensor(
            world["arrays"]["fisher_tokens"]))
        # squared gradients of the fp32 forward, summed in another order
        np.testing.assert_allclose(out[f"fisher/{mesh}/grad_k"], gk.numpy(),
                                   rtol=1e-4, atol=1e-5 * float(gk.max()))


def test_multihost_world(world):
    """The counterpart of tests/test_multihost.py: the world came from
    KVQ_* through init_distributed, make_multihost_mesh(tp=2) spans dp
    over the processes, and its sharded decode step equals the
    single-process logits."""
    meta = world["meta"]
    assert meta["backend"] == "gloo" and meta["world"] == 4
    assert meta["mesh22"] == {"dp": 2, "tp": 2}
    assert meta["mesh14"] == {"dp": 1, "tp": 4}
    _, dec0, _ = _port_single(world, "xla")
    np.testing.assert_allclose(world["out"]["llama/dp2_tp2/xla/decode"],
                               dec0, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# without a process group
# ---------------------------------------------------------------------------


def _norm(spec):
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_rule_tables_match_jax(family):
    """Every field splits over the JAX package's axis; the per-channel
    quantizer rows (replicated in JAX, split by heads in
    flash_attention_sharded) follow their heads here."""
    mesh = Mesh(2, 2, 0, 0, torch.device("cpu"))
    jmesh = jmake_mesh(dp=2, tp=2)
    if family == "llama":
        jp = jinit(jax.random.PRNGKey(0), J_TINY, dtype=jnp.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), TINY_LLAMA,
                               device="cpu")
    else:
        jp = jmoe.init_params(jax.random.PRNGKey(0), jmoe.TINY_MOE,
                              dtype=jnp.float32)
        tp = moe.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   moe.TINY_MOE, device="cpu")
    want = jshardings.param_shardings(jmesh, jp)
    got = param_shardings(mesh, tp)
    assert set(got) == set(want)
    for k in ("embed", "final_norm", "lm_head"):
        assert _norm(got[k]) == _norm(want[k].spec)
    for k, s in want["layers"].items():
        assert _norm(got["layers"][k]) == _norm(s.spec), k
    jc, tc = jshardings.cache_shardings(jmesh), cache_shardings(mesh)
    for f in jc.__dataclass_fields__:
        assert _norm(getattr(tc, f)) == _norm(getattr(jc, f).spec), f
    jq, tq = jshardings.quant_shardings(jmesh), quant_shardings(mesh)
    for f in jq.__dataclass_fields__:
        if f in ("k_lower", "k_upper", "k_ressc"):
            assert _norm(getattr(tq, f)) == (None, "tp"), f
        else:
            assert _norm(getattr(tq, f)) == _norm(getattr(jq, f).spec), f
    assert data_sharding(mesh) == tuple(jshardings.data_sharding(jmesh).spec)


@pytest.mark.parametrize("tp_rank", [0, 1])
def test_shard_params_heads_and_channels(tp_rank):
    """Rank tp_rank of tp 2: MoE w_qkv holds its q, k and v heads (so
    split_qkv gives the unsharded projections' columns of those heads);
    Llama wq / wo split by heads; the quantizer rows by channels."""
    mesh = Mesh(1, 2, 0, tp_rank, torch.device("cpu"))
    mp = moe.init_params(moe.TINY_MOE, device="cpu", dtype=torch.float32)
    local = shard_params(mesh, mp)
    lcfg = local.cfg
    assert (lcfg.n_heads, lcfg.n_kv_heads, lcfg.n_experts, lcfg.d_ff) == \
        (2, 1, 2, moe.TINY_MOE.d_ff)
    assert lcfg.tp_size == 2 and lcfg.tp_rank == tp_rank
    x = torch.randn(3, 64)
    q, k, v = moe.split_qkv(x @ mp.layers["w_qkv"][0], moe.TINY_MOE)
    lq, lk, lv = moe.split_qkv(x @ local.layers["w_qkv"][0], lcfg)
    Dh = 16
    torch.testing.assert_close(lq, q[:, tp_rank * 2 * Dh:(tp_rank + 1) * 2
                                     * Dh])
    torch.testing.assert_close(lk, k[:, tp_rank * Dh:(tp_rank + 1) * Dh])
    torch.testing.assert_close(lv, v[:, tp_rank * Dh:(tp_rank + 1) * Dh])
    assert torch.equal(local.layers["w_gate"],
                       mp.layers["w_gate"][:, 2 * tp_rank:2 * tp_rank + 2])
    assert torch.equal(local.layers["w_router"], mp.layers["w_router"])

    lp = params_from_numpy(jax.tree.map(np.asarray, jinit(
        jax.random.PRNGKey(0), J_TINY, dtype=jnp.float32)), TINY_LLAMA,
        device="cpu")
    ll = shard_params(mesh, lp)
    assert ll.cfg.d_ff == TINY_LLAMA.d_ff // 2
    assert torch.equal(ll.layers["wq"], lp.layers["wq"][..., tp_rank * 32:
                                                        (tp_rank + 1) * 32])
    assert torch.equal(ll.layers["wo"], lp.layers["wo"][:, tp_rank * 32:
                                                        (tp_rank + 1) * 32])
    dq = deployed_from_quantizers(_qs(2, 64, 4, 0, True), 4, 16,
                                  device="cpu")
    ldq = shard_quant(mesh, dq)
    sl = slice(tp_rank * 32, (tp_rank + 1) * 32)
    for f in ("k_lower", "k_upper", "k_ressc"):
        assert torch.equal(getattr(ldq, f), getattr(dq, f)[:, sl]), f
    assert torch.equal(ldq.k_range, dq.k_range[:, 2 * tp_rank:
                                               2 * tp_rank + 2])
    assert torch.equal(ldq.k_lut_dec, dq.k_lut_dec)
    # the cache: heads (groups) over tp, the per-token V range whole
    dcfg = DeployConfig.create(bits=3, n_kv_heads=4, d_head=16, max_len=69,
                               head_group=2)
    full = create_cache(dcfg, 2, 2, device="cpu")
    for f in ("k_planes", "kv_out", "v_scale"):
        getattr(full, f).copy_(torch.randn(getattr(full, f).shape)
                               .to(getattr(full, f).dtype))
    local = shard_cache(mesh, full)
    assert torch.equal(local.k_planes,
                       full.k_planes[:, :, 2 * tp_rank:2 * tp_rank + 2])
    assert torch.equal(local.kv_out, full.kv_out[:, :, tp_rank:tp_rank + 1])
    assert torch.equal(local.v_scale, full.v_scale)
    assert local.k_sink.shape == (2, 2, 2, 5, 16)


def test_head_group_rule_raises():
    """tp may not split a head group: 4 kv heads in groups of 4 at tp 2
    (JAX's flash_attention_sharded asserts the same rule)."""
    mesh = Mesh(1, 2, 0, 0, torch.device("cpu"))
    dcfg = DeployConfig.create(bits=3, n_kv_heads=4, d_head=16, max_len=64,
                               head_group=4)
    with pytest.raises(ValueError, match=r"% head_group == 0"):
        shard_config(mesh, dcfg)
    assert shard_config(mesh, DeployConfig.create(
        bits=3, n_kv_heads=4, d_head=16, max_len=64,
        head_group=2)).n_kv_heads == 2
    with pytest.raises(ValueError, match="does not divide"):
        shard_config(Mesh(1, 3, 0, 0, torch.device("cpu")), TINY_LLAMA)


def test_init_distributed_without_env(monkeypatch):
    for k in ("KVQ_COORDINATOR", "KVQ_NUM_PROCESSES", "KVQ_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed(device="cpu") is False
    mesh = make_mesh(device="cpu")  # the trivial mesh, no process group
    assert mesh.shape == {"dp": 1, "tp": 1}
    assert mesh.tp_group is None and mesh.dp_group is None
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(dp=1, tp=2, device="cpu")
    # NCCL with more local ranks than cards (none here) names gloo
    with pytest.raises(RuntimeError, match='backend="gloo"'):
        init_distributed("localhost:1", 2, 0, backend="nccl", device="cuda")
