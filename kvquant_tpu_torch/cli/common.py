"""Shared CLI plumbing: model loading, data and the tokenizer (port of
kvquant_tpu/cli/common.py:14-81,126-187).

Every port CLI takes ``--device`` (default ``cuda``, which raises without a
card; ``cpu`` runs the kernels' plain PyTorch versions). Without
``--model`` the model is a random init drawn on that device from a
``torch.Generator`` seeded 0, with the JAX CLIs' ``--toy-*`` shape formulas
(d_head = d_model / heads, d_ff = 3 * d_model); its weights differ from
the JAX CLIs' ``jax.random.PRNGKey(0)`` draws, and between the card's and
the CPU's generators. ``--moe`` makes the random model a DBRX-style MoE
(``--toy-experts`` / ``--toy-top-k``); ``--model DIR`` loads a local HF
checkpoint (LLaMA / Mistral / DBRX safetensors, ``models.hf_loader``) onto
the device. The parallel flags (``add_parallel_args``): ``--tp`` /
``--dp`` with ``--distributed`` make this process one rank of a
torch.distributed process group (``setup_parallel``); without
``--distributed`` the CLI starts the dp * tp local ranks itself
(``spawn_ranks``), as the JAX CLIs mesh their local devices.
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models import llama


def add_model_args(ap: argparse.ArgumentParser):
    ap.add_argument("--model", default=None,
                    help="local HF checkpoint dir (safetensors); omit for a "
                         "random-init model (--toy-* flags)")
    ap.add_argument("--maxseqlen", type=int, default=None,
                    help="extend context via linear RoPE scaling "
                         "(quant/llama_simquant.py:35-38)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--toy-layers", type=int, default=2)
    ap.add_argument("--toy-dmodel", type=int, default=256)
    ap.add_argument("--toy-heads", type=int, default=8)
    ap.add_argument("--toy-kv-heads", type=int, default=None)
    ap.add_argument("--toy-vocab", type=int, default=32000)
    ap.add_argument("--moe", action="store_true",
                    help="toy model is a DBRX-style MoE (fused Wqkv + "
                         "top-k experts)")
    ap.add_argument("--toy-experts", type=int, default=4)
    ap.add_argument("--toy-top-k", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the Hopper kernels) or cpu "
                         "(their plain PyTorch versions)")


def add_quant_args(ap: argparse.ArgumentParser):
    ap.add_argument("--abits", type=int, default=4, choices=[2, 3, 4],
                    help="KV quantization bits")
    ap.add_argument("--include-sparse", action="store_true", default=True)
    ap.add_argument("--no-sparse", dest="include_sparse", action="store_false")
    ap.add_argument("--sparsity-threshold", type=float, default=0.99,
                    help="dense fraction for calibration thresholds and the "
                         "V range exclusion (e.g. 0.99 => 1%% beyond "
                         "threshold). The STORED outlier budget is the fixed "
                         "per-(token, kv-head) cap_per_side of DeployConfig, "
                         "not this flag")
    ap.add_argument("--first-few-fp16", type=int, default=5,
                    help="attention-sink tokens kept exact")
    ap.add_argument("--cap-outliers", action="store_true", default=True)
    ap.add_argument("--qnorm", action="store_true", default=False)
    add_storage_args(ap)


def add_storage_args(ap: argparse.ArgumentParser):
    """Deployed-cache storage knobs, shared by every deployment-side CLI."""
    ap.add_argument("--head-group", type=int, default=4,
                    help="kv heads sharing one outlier slot tile (1/2/4; "
                         "auto-clamped to divide the kv-head count)")
    ap.add_argument("--codes", default="nuq", choices=["nuq", "int4", "int8"],
                    help="code STORAGE: 'nuq' bit-planes + LUT (any "
                         "codebook), 'int4'/'int8' integer containers + "
                         "affine dequant; requires --mode uniform "
                         "calibration (affine codebook)")
    ap.add_argument("--post-rope-k", action="store_true", default=False,
                    help="store keys POST-rotary: the deployed kernel skips "
                         "all rotation work. Calibration then fits roped "
                         "activations; the reference scheme (and default) is "
                         "pre-RoPE")
    ap.add_argument("--k-outliers", default="slots",
                    choices=["slots", "channels"],
                    help="K outlier storage: 'slots' per-token fixed-budget "
                         "encoded words (reference-faithful); 'channels' "
                         "n-kc STATIC channels per head group stored as "
                         "dense fp residual rows (V outliers stay "
                         "per-token)")
    ap.add_argument("--n-kc", type=int, default=4,
                    help="static K outlier channels per head group "
                         "(--k-outliers channels)")


def add_parallel_args(ap: argparse.ArgumentParser):
    """Mesh / multi-process flags (``parallel.mesh`` and
    ``parallel.distributed``): data-parallel size, tensor-parallel size,
    and the process group of ``--distributed``."""
    ap.add_argument("--dp", type=int, default=1, help="data-parallel size")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel size (must divide the kv-head "
                         "count, in whole head groups)")
    ap.add_argument("--distributed", action="store_true",
                    help="this process is one rank: join the process group "
                         "from KVQ_COORDINATOR / KVQ_NUM_PROCESSES / "
                         "KVQ_PROCESS_ID or the flags below. Without it, "
                         "dp * tp > 1 starts that many local ranks, one "
                         "per device")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend (default nccl on cuda, "
                         "gloo on cpu); ranks sharing one card need gloo")


def n_ranks(args) -> int:
    """Ranks a run without --distributed needs: dp * tp."""
    return args.dp * (args.tp or 1)


def setup_parallel(args):
    """This rank's mesh, or None for one process on one device. With
    ``--distributed`` it joins the process group (``init_distributed``)
    and lays out the multi-host mesh (tp from ``--tp``, dp across the
    rest); otherwise only one rank may be asked for (``spawn_ranks``
    starts the ranks of a larger mesh)."""
    from ..parallel.distributed import init_distributed, make_multihost_mesh

    if getattr(args, "distributed", False):
        if not init_distributed(args.coordinator, args.num_processes,
                                args.process_id, backend=args.dist_backend,
                                device=args.device):
            raise ValueError("--distributed needs --coordinator or "
                             "KVQ_COORDINATOR")
        mesh = make_multihost_mesh(tp=args.tp or 1, device=args.device)
        if mesh.dp != args.dp and args.dp != 1:
            raise ValueError(f"--dp {args.dp} with --tp {args.tp or 1} over "
                             f"{mesh.size} ranks gives dp {mesh.dp}")
        return mesh
    if n_ranks(args) != 1:
        raise ValueError(f"dp {args.dp} x tp {args.tp} needs "
                         f"{n_ranks(args)} ranks: pass --distributed to "
                         f"each rank, or let spawn_ranks start them")
    return None


def _rank_entry(rank: int, fn, argv: list, port: int, n: int, results):
    import os

    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
    try:
        out = fn(argv + ["--distributed", "--coordinator",
                         f"localhost:{port}", "--num-processes", str(n),
                         "--process-id", str(rank)])
        results.put((rank, "ok", out))
    except BaseException as e:
        results.put((rank, "error", (type(e).__name__, str(e))))
        raise


def spawn_ranks(fn, argv: list, n: int, timeout_s: float = 3600.0):
    """Run ``fn(argv + --distributed flags)`` in ``n`` local rank
    processes (torch.multiprocessing, one process group on a free
    localhost port) and return rank 0's result. A rank's ValueError /
    RuntimeError / NotImplementedError is raised here with its message;
    the ranks are stopped on any failure."""
    import socket
    import time

    import torch.multiprocessing as mp

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, fn, list(argv), port, n, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got = {}

    def drain():
        while not results.empty():
            r, status, val = results.get()
            got[r] = (status, val)

    deadline = time.monotonic() + timeout_s
    try:
        # a failed rank leaves the others waiting in a collective: stop
        # waiting at the first failure
        while (any(p.is_alive() for p in procs)
               and time.monotonic() < deadline
               and not any(p.exitcode for p in procs)):
            drain()
            time.sleep(0.05)
        for p in procs:
            p.join(1.0)
        drain()
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: v for r, (st, v) in got.items() if st == "error"}
    if errors:
        r = min(errors)
        name, msg = errors[r]
        exc = {"ValueError": ValueError,
               "NotImplementedError": NotImplementedError}.get(
                   name, RuntimeError)
        raise exc(f"rank {r}: {msg}" if exc is not RuntimeError
                  else f"rank {r}: {name}: {msg}")
    codes = [p.exitcode for p in procs]
    if any(codes) or 0 not in got:
        raise RuntimeError(f"rank processes exited with {codes}")
    return got[0][1]


def add_data_args(ap: argparse.ArgumentParser):
    ap.add_argument("--dataset", default="synthetic",
                    help="synthetic | text (with --dataset-path)")
    ap.add_argument("--dataset-path", default=None)
    ap.add_argument("--nsamples", type=int, default=16)
    ap.add_argument("--seqlen", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)


def load_data(args, cfg):
    """(calibration windows, eval windows) as numpy (N, seqlen) int32, the
    JAX CLIs' windows for the same flags (data.get_loaders)."""
    from ..data import get_loaders

    return get_loaders(
        args.dataset, nsamples=args.nsamples, seed=args.seed,
        seqlen=args.seqlen, vocab_size=cfg.vocab_size,
        tokenizer=load_tokenizer(args) if args.dataset_path else None,
        path=args.dataset_path,
    )


def load_model(args):
    """(params, cfg) on ``args.device``: the HF checkpoint of ``--model``,
    or a random-init model (an MoE one under ``--moe``)."""
    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.model:
        from ..models.hf_loader import load_hf_checkpoint

        return load_hf_checkpoint(args.model, dtype=dtype,
                                  max_seq_len=args.maxseqlen, device=dev)
    common_kw = dict(
        vocab_size=args.toy_vocab, d_model=args.toy_dmodel,
        n_layers=args.toy_layers, n_heads=args.toy_heads,
        n_kv_heads=args.toy_kv_heads or args.toy_heads,
        d_head=args.toy_dmodel // args.toy_heads,
        d_ff=args.toy_dmodel * 3,
    )
    if getattr(args, "moe", False):
        from ..models import moe

        cfg = moe.MoEConfig(n_experts=args.toy_experts,
                            top_k=args.toy_top_k, **common_kw)
        init = moe.init_params
    else:
        cfg = ModelConfig(**common_kw)
        init = llama.init_params
    if args.maxseqlen:
        cfg = cfg.scaled(args.maxseqlen)
    params = init(cfg, torch.Generator(device=dev).manual_seed(0),
                  dtype=dtype, device=dev)
    return params, cfg


def load_tokenizer(args):
    """``transformers.AutoTokenizer`` of ``--model`` when that loads, else
    the whitespace word tokenizer."""
    if args.model:
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(args.model)
        except Exception:  # no transformers, or no tokenizer files in DIR
            pass
    from ..utils.toytokenizer import WordTokenizer

    return WordTokenizer()
