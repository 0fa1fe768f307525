"""Shared CLI plumbing: model loading, data and the tokenizer (port of
kvquant_tpu/cli/common.py:14-81,126-187).

Every port CLI takes ``--device`` (default ``cuda``, which raises without a
card; ``cpu`` runs the kernels' plain PyTorch versions). Without
``--model`` the model is a random init drawn on that device from a
``torch.Generator`` seeded 0, with the JAX CLIs' ``--toy-*`` shape formulas
(d_head = d_model / heads, d_ff = 3 * d_model); its weights differ from
the JAX CLIs' ``jax.random.PRNGKey(0)`` draws, and between the card's and
the CPU's generators. ``--model`` (the HF loader) and ``--moe`` are not
ported (ROADMAP queue 1 item 11) and raise NotImplementedError. The
parallel flags (``add_parallel_args``) are accepted; anything but one
device raises NotImplementedError until parallelism is ported (ROADMAP
queue 1 item 12).
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
                         "random-init model (--toy-* flags). Not ported yet "
                         "(ROADMAP queue 1 item 11)")
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
                         "top-k experts). Not ported yet (ROADMAP queue 1 "
                         "item 11)")
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
    """The JAX CLIs' mesh / multi-host flags (data-parallel size,
    tensor-parallel size, multi-host initialization)."""
    ap.add_argument("--dp", type=int, default=1, help="data-parallel size")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel size (must divide the kv-head "
                         "count). Only 1 is ported (ROADMAP queue 1 item 12)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host initialization from the flags below. "
                         "Not ported yet (ROADMAP queue 1 item 12)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)


def setup_parallel(args):
    """None (one device) for dp 1, tp unset or 1 and no --distributed;
    anything else raises until parallelism is ported."""
    if (getattr(args, "distributed", False) or args.dp != 1
            or args.tp not in (None, 1)):
        raise NotImplementedError(
            f"dp={args.dp} tp={args.tp} distributed="
            f"{getattr(args, 'distributed', False)}: the port runs on one "
            f"device; parallelism is ROADMAP queue 1 item 12")
    return None


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
    """(params, cfg): a random-init model on ``args.device``."""
    if args.model:
        raise NotImplementedError(
            "--model (the HF checkpoint loader) is not ported yet (ROADMAP "
            "queue 1 item 11); omit it for a random-init model")
    if getattr(args, "moe", False):
        raise NotImplementedError(
            "--moe (DBRX-style MoE) is not ported yet (ROADMAP queue 1 item "
            "11)")
    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    cfg = ModelConfig(
        vocab_size=args.toy_vocab, d_model=args.toy_dmodel,
        n_layers=args.toy_layers, n_heads=args.toy_heads,
        n_kv_heads=args.toy_kv_heads or args.toy_heads,
        d_head=args.toy_dmodel // args.toy_heads,
        d_ff=args.toy_dmodel * 3,
    )
    if args.maxseqlen:
        cfg = cfg.scaled(args.maxseqlen)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dtype=dtype, device=dev)
    return params, cfg


def load_tokenizer(args):
    """The whitespace word tokenizer (a HF tokenizer arrives with
    ``--model``)."""
    from ..utils.toytokenizer import WordTokenizer

    return WordTokenizer()
