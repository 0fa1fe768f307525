"""One rank of the gloo world of tests/test_torch_parallel.py (run as a
script, one process per rank; imports torch and the port, never JAX).

The world is assembled as tests/test_multihost.py assembles its own: from
the KVQ_* variables through ``init_distributed``, then
``make_multihost_mesh(tp=2)`` (dp 2 spanning the processes) and, over the
same four ranks, ``make_mesh(dp=1, tp=4)``. Every case runs on this
rank's shards; the results are gathered over the mesh and rank 0 writes
them to ``<dir>/out.npz`` for the test process, which holds them against
the single-process port and the JAX package.

    KVQ_COORDINATOR=localhost:<port> KVQ_NUM_PROCESSES=4 KVQ_PROCESS_ID=i \
        python tests/torch_parallel_worker.py <dir>
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from kvquant_tpu_torch import engine
from kvquant_tpu_torch.cache import (DeployConfig, create_cache,
                                     deployed_from_quantizers)
from kvquant_tpu_torch.fisher.fisher import _fisher_step
from kvquant_tpu_torch.models import TINY_LLAMA, params_from_numpy
from kvquant_tpu_torch.models import moe
from kvquant_tpu_torch.ops.deployed import quantize_v
from kvquant_tpu_torch.ops.kernels.flash_decode import flash_attention
from kvquant_tpu_torch.ops.kernels.flash_serial import flash_serial_decode
from kvquant_tpu_torch.parallel import (make_mesh, shard_config, shard_data,
                                        shard_params, shard_quant)
from kvquant_tpu_torch.parallel.collectives import topk_range
from kvquant_tpu_torch.parallel.distributed import (init_distributed,
                                                    make_multihost_mesh)
from kvquant_tpu_torch.parallel.shardings import (flash_attention_sharded,
                                                  gather_data, shard_tensor)
from kvquant_tpu_torch.quant.artifacts import load_quantizers

torch.set_num_threads(1)
DIR = sys.argv[1]
OUT: dict = {}
META: dict = {}


def tree(z, prefix):
    """Nested dict of the npz arrays stored as prefix/name and
    prefix/layers/name."""
    t = {"layers": {}}
    for k in z.files:
        if not k.startswith(prefix + "/"):
            continue
        parts = k.split("/")[1:]
        if parts[0] == "layers":
            t["layers"][parts[1]] = z[k]
        else:
            t[parts[0]] = z[k]
    return t


def gather(x, group, axis):
    """Concatenation along ``axis`` of every rank's ``x`` in ``group``."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=axis)


def gather_mesh(mesh, x, tp_axis=None, dp_axis=None):
    if tp_axis is not None:
        x = gather(x, mesh.tp_group, tp_axis)
    if dp_axis is not None:
        x = gather(x, mesh.dp_group, dp_axis)
    return x


def put(name, x):
    OUT[name] = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def deploy_config(kernel, max_len=69):
    """The datapaths' storage (nuq4 slots; the int4 speed config for K2)."""
    common = dict(n_kv_heads=TINY_LLAMA.n_kv_heads,
                  d_head=TINY_LLAMA.d_head, max_len=max_len, sink=5,
                  kernel=kernel, head_group=1, dot_bf16=False)
    if kernel == "flash_serial":
        return DeployConfig.create(bits=4, codes="int4", post_rope_k=True,
                                   k_outliers="channels", n_kc=4,
                                   cap_per_side=0, **common)
    return DeployConfig.create(bits=4, **common)


def llama_cases(z, meshes):
    """Prefill + one decode step through every datapath on both meshes,
    and a quantized chunked prefill through K1."""
    params = params_from_numpy(tree(z, "llama"), TINY_LLAMA, device="cpu")
    prompt = torch.as_tensor(z["prompt"])
    long_prompt = torch.as_tensor(z["long_prompt"])
    quant = {"nuq": load_quantizers(os.path.join(DIR, "q_nuq.npz")),
             "int4": load_quantizers(os.path.join(DIR, "q_int4.npz"))}
    for mname, mesh in meshes.items():
        lp = shard_params(mesh, params)
        for kernel in ("xla", "pallas", "flash", "flash_serial"):
            dcfg = deploy_config(kernel)
            qs = quant["int4" if kernel == "flash_serial" else "nuq"]
            dq = deployed_from_quantizers(qs, TINY_LLAMA.n_kv_heads,
                                          TINY_LLAMA.d_head, device="cpu")
            ld, ldq = shard_config(mesh, dcfg), shard_quant(mesh, dq)
            cache = create_cache(ld, TINY_LLAMA.n_layers,
                                 prompt.shape[0] // mesh.dp, device="cpu")
            cache, lg = engine.prefill(lp, lp.cfg, ld, ldq, cache,
                                       shard_data(mesh, prompt))
            tok = torch.argmax(lg, -1).to(torch.int32)
            cache, dec = engine.decode_step(lp, lp.cfg, ld, ldq, cache, tok,
                                            prompt.shape[1])
            tag = f"llama/{mname}/{kernel}"
            put(f"{tag}/prefill", gather_data(mesh, lg))
            put(f"{tag}/decode", gather_data(mesh, dec))
            for f in ("k_planes", "v_planes"):
                put(f"{tag}/{f}", gather_mesh(mesh, getattr(cache, f),
                                              tp_axis=2, dp_axis=1))

        # quantized chunked prefill through K1 (block_attention's V range)
        dcfg = deploy_config("flash", max_len=5 + 256 + 8)
        dq = deployed_from_quantizers(quant["nuq"], TINY_LLAMA.n_kv_heads,
                                      TINY_LLAMA.d_head, device="cpu")
        ld, ldq = shard_config(mesh, dcfg), shard_quant(mesh, dq)
        cache = create_cache(ld, TINY_LLAMA.n_layers,
                             long_prompt.shape[0] // mesh.dp, device="cpu")
        cache, lg = engine.prefill_quantized(
            lp, lp.cfg, ld, ldq, cache, shard_data(mesh, long_prompt),
            chunk=128)
        tag = f"llama/{mname}/quantized"
        put(f"{tag}/prefill", gather_mesh(mesh, lg, dp_axis=0))
        put(f"{tag}/v_scale", gather_mesh(mesh, cache.v_scale, dp_axis=1))
        put(f"{tag}/k_planes", gather_mesh(mesh, cache.k_planes, tp_axis=2,
                                           dp_axis=1))


def moe_case(z, mesh):
    """TINY_MOE, experts over tp 2: greedy tokens through K1, fp16 and
    quantized prefill, dense and sparse expert FFN."""
    qs = load_quantizers(os.path.join(DIR, "q_moe.npz"))
    prompt = torch.as_tensor(z["moe_prompt"])
    for mode in ("dense", "sparse"):
        cfg = dataclasses.replace(moe.TINY_MOE, ffn_mode=mode)
        params = moe.params_from_numpy(tree(z, "moe"), cfg, device="cpu")
        lp = shard_params(mesh, params)
        dcfg = DeployConfig.create(
            bits=3, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
            max_len=5 + 256 + 16, sink=5, kernel="flash", head_group=1,
            dot_bf16=False)
        dq = deployed_from_quantizers(qs, cfg.n_kv_heads, cfg.d_head,
                                      device="cpu")
        ld, ldq = shard_config(mesh, dcfg), shard_quant(mesh, dq)
        META["moe_local_experts"] = lp.cfg.n_experts
        for prefill_mode in ("fp16", "quantized"):
            toks, _ = engine.generate(
                lp, lp.cfg, ld, ldq, shard_data(mesh, prompt),
                engine.GenerateConfig(max_new_tokens=8),
                prefill_mode=prefill_mode, device="cpu")
            put(f"moe/{mode}/{prefill_mode}",
                gather_mesh(mesh, toks, dp_axis=0))


def fisher_case(z, meshes):
    """The sharded Fisher step: each rank's probe gradients, gathered over
    tp, against the unsharded step on the rank's own batch."""
    params = params_from_numpy(tree(z, "llama"), TINY_LLAMA, device="cpu")
    tokens = torch.as_tensor(z["fisher_tokens"])
    for mname, mesh in meshes.items():
        lp = shard_params(mesh, params)
        mine = shard_data(mesh, tokens)
        gk, gv = _fisher_step(lp, lp.cfg, mine)
        gk, gv = (gather(g, mesh.tp_group, -1) for g in (gk, gv))
        wk, wv = _fisher_step(params, TINY_LLAMA, mine)
        err = max(float((gk - wk).abs().max()), float((gv - wv).abs().max()))
        rel = err / float(torch.maximum(wk.abs().max(), wv.abs().max()))
        both = torch.tensor([rel, float(gk.abs().max() > 0)])
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
        put(f"fisher/{mname}/rel_err", both[0])
        put(f"fisher/{mname}/nonzero", both[1])
        put(f"fisher/{mname}/grad_k", gather(gk, mesh.dp_group, 1))


def v_range_case(z, mesh):
    """topk_range / quantize_v over the tp group against the unsharded
    ones, including tokens whose extremes all sit on one rank."""
    v = torch.as_tensor(z["v_rows"])  # (T, C)
    vl = shard_tensor(mesh, v, (None, "tp"))
    r = 3
    lo, hi = topk_range(vl, r + 1, mesh.tp_group)
    wlo, whi = topk_range(v, r + 1, None)
    put("vrange/lo", lo)
    put("vrange/hi", hi)
    put("vrange/want_lo", wlo)
    put("vrange/want_hi", whi)
    dcfg = dataclasses.replace(deploy_config("flash"), v_range_exclude=r)
    dq = deployed_from_quantizers(
        load_quantizers(os.path.join(DIR, "q_nuq.npz")),
        TINY_LLAMA.n_kv_heads, TINY_LLAMA.d_head, device="cpu")
    got = quantize_v(vl, shard_quant(mesh, dq).layer(0),
                     shard_config(mesh, dcfg), mesh.tp_group)
    want = quantize_v(v, dq.layer(0), dcfg)
    put("vrange/codes", gather(got[0], mesh.tp_group, -2))
    put("vrange/want_codes", want[0])
    put("vrange/scale", got[2])
    put("vrange/want_scale", want[2])
    put("vrange/words", gather(got[1], mesh.tp_group, -2))
    put("vrange/want_words", want[1])


def flash_sharded_case(z, mesh):
    """flash_attention_sharded on this rank's shards against the
    unsharded K1 / K2 call (tests/test_parallel.py's four cases)."""
    from kvquant_tpu_torch.models.config import ModelConfig
    from kvquant_tpu_torch.ops.packing import (encode_outlier_words,
                                               store_codes_int)

    L, B, Hkv, G, D = 2, 2, 4, 1, 16
    Tc, S, hg = 256, 5, 2
    gen = torch.Generator().manual_seed(0)

    def randn(*s, scale=1.0):
        return torch.randn(s, generator=gen) * scale

    def rint(lo, hi, *s):
        return torch.randint(lo, hi, s, generator=gen)

    def idx9(*s):  # head_in_group << 7 | dim
        return rint(0, hg, *s) * 128 + rint(0, D, *s)

    for case in ("nuq", "int4", "channels", "serial"):
        bits = 3 if case in ("nuq", "channels") else 4
        kw = dict(bits=bits, n_kv_heads=Hkv, d_head=D, max_len=Tc + S,
                  sink=S, kernel="flash", dot_bf16=False, head_group=hg)
        if case == "int4":
            kw.update(codes="int4")
        if case == "channels":
            kw.update(k_outliers="channels", n_kc=4)
        if case == "serial":
            kw.update(kernel="flash_serial", codes="int4", post_rope_k=True,
                      k_outliers="channels", n_kc=4, cap_per_side=0)
        dcfg = DeployConfig.create(**kw)
        mcfg = ModelConfig(vocab_size=64, d_model=Hkv * D, n_layers=L,
                           n_heads=Hkv * G, n_kv_heads=Hkv, d_head=D,
                           d_ff=32, max_seq_len=Tc + 64)
        J, spk = dcfg.n_slots, dcfg.slots_per_kind
        if dcfg.codes == "nuq":
            planes = [rint(0, 2 ** 31 - 1, L, B, Hkv, bits, Tc // 32, D)
                      .to(torch.int32) for _ in range(2)]
        else:
            planes = [store_codes_int(rint(0, 16, L, B, Hkv, Tc, D), bits,
                                      dcfg.code_dtype) for _ in range(2)]
        if case == "nuq" or case == "int4":
            kv_out = encode_outlier_words(randn(L, B, Hkv // hg, J, Tc,
                                                scale=0.1),
                                          idx9(L, B, Hkv // hg, J, Tc))
        elif case == "channels":
            kv_out = torch.cat([
                randn(L, B, Hkv // hg, spk, Tc, scale=0.1),
                encode_outlier_words(
                    randn(L, B, Hkv // hg, J - spk, Tc, scale=0.1),
                    idx9(L, B, Hkv // hg, J - spk, Tc))], dim=3)
        else:
            kv_out = randn(L, B, Hkv // hg, J, Tc, scale=0.1)
        lut = (torch.sort(randn(L, 2 ** bits), dim=-1).values
               if dcfg.codes == "nuq"
               else torch.linspace(-1.0, 1.0, 2 ** bits).expand(L, -1))
        ops = dict(
            q_rot=randn(B, Hkv, G, D), k_planes=planes[0],
            v_planes=planes[1], kv_out=kv_out,
            k_range=torch.rand((L, Hkv, D), generator=gen) + 0.5,
            k_offset=randn(L, Hkv, D, scale=0.1),
            v_scale=torch.rand((L, B, Tc), generator=gen) + 0.5,
            v_offset=randn(L, B, Tc, scale=0.1),
            k_sink=randn(L, B, Hkv, S, D), v_sink=randn(L, B, Hkv, S, D),
            k_lut=lut.contiguous(), v_lut=lut.contiguous())
        ressc = torch.rand((L, Hkv * D), generator=gen)
        pos = torch.tensor([100, 37], dtype=torch.int32)
        specs = dict(q_rot=("dp", "tp"), k_range=(None, "tp"),
                     k_offset=(None, "tp"), v_scale=(None, "dp"),
                     v_offset=(None, "dp"), k_lut=(), v_lut=())
        mine = {k: shard_tensor(mesh, x, specs.get(k, (None, "dp", "tp")))
                for k, x in ops.items()}
        fn = flash_serial_decode if case == "serial" else flash_attention
        want = fn(*ops.values(), 1, pos, dcfg, mcfg, k_ressc=ressc)
        got = flash_attention_sharded(
            mesh, *mine.values(), 1, shard_tensor(mesh, pos, ("dp",)),
            dcfg, mcfg, k_ressc=shard_tensor(mesh, ressc, (None, "tp")))
        put(f"flash_sharded/{case}/got",
            gather_mesh(mesh, got, tp_axis=1, dp_axis=0))
        put(f"flash_sharded/{case}/want", want)


def main():
    assert init_distributed(device="cpu")
    META["backend"] = dist.get_backend()
    META["world"] = dist.get_world_size()
    mesh22 = make_multihost_mesh(tp=2, device="cpu")
    mesh14 = make_mesh(dp=1, tp=4, device="cpu")
    META["mesh22"] = mesh22.shape
    META["mesh14"] = mesh14.shape
    z = np.load(os.path.join(DIR, "inputs.npz"))
    meshes = {"dp2_tp2": mesh22, "tp4": mesh14}
    llama_cases(z, meshes)
    moe_case(z, mesh22)
    fisher_case(z, meshes)
    v_range_case(z, mesh14)
    flash_sharded_case(z, mesh22)
    if dist.get_rank() == 0:
        np.savez(os.path.join(DIR, "out.npz"), **OUT)
        with open(os.path.join(DIR, "meta.json"), "w") as fh:
            json.dump(META, fh)
    dist.barrier()
    dist.destroy_process_group()
    print("WORKER_OK")


if __name__ == "__main__":
    main()
