"""Load HuggingFace LLaMA / Mistral / DBRX checkpoints from a local
directory (port of kvquant_tpu/models/hf_loader.py:21-207).

Only local files are read: ``config.json`` and ``model.safetensors``, or
the shards named by ``model.safetensors.index.json``. The safetensors
format is read here directly (``SafetensorsFile``: an 8-byte little-endian
header length, a JSON header of ``dtype`` / ``shape`` / ``data_offsets``,
then the raw little-endian bytes), so the ``safetensors`` package is not
needed. F32, F16 and BF16 tensors are read; a BF16 tensor's 16-bit
patterns are viewed as ``torch.bfloat16`` (the JAX loader's numpy path
cannot read BF16).

Weights are written layer by layer into stacked (L, ...) tensors allocated
once on ``device`` in the target dtype: one layer's tensor at a time is in
host memory, and the model never exists twice on the card. HF's
``nn.Linear`` stores (out, in); the parameters here are (in, out), used as
``x @ W``. DBRX's ``attn_config.clip_qkv`` is not applied, as in the JAX
package.
"""

from __future__ import annotations

import json
import os
import struct

import torch

from ..device import resolve_device
from .config import ModelConfig

_DTYPES = {"F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16}


class SafetensorsFile:
    """The header of one ``.safetensors`` file, and its tensors on demand
    (``get_tensor``: a CPU tensor read from the file's bytes)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.header = header
        self.data_start = 8 + n

    def get_tensor(self, name: str) -> torch.Tensor:
        meta = self.header[name]
        if meta["dtype"] not in _DTYPES:
            raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                             f"{meta['dtype']}; the loader reads "
                             f"{', '.join(_DTYPES)}")
        begin, end = meta["data_offsets"]
        raw = torch.empty(end - begin, dtype=torch.uint8)
        with open(self.path, "rb") as f:
            f.seek(self.data_start + begin)
            if f.readinto(raw.numpy()) != end - begin:
                raise ValueError(f"{self.path}: tensor {name!r} is cut off")
        # the bytes as the stored dtype (BF16: its 16-bit patterns)
        return raw.view(_DTYPES[meta["dtype"]]).reshape(meta["shape"])


def config_from_hf(path: str) -> ModelConfig:
    """The model config of ``path``/config.json: a ModelConfig for the
    LLaMA / Mistral schema, a ``moe.MoEConfig`` for DBRX."""
    with open(os.path.join(path, "config.json")) as f:
        c = json.load(f)
    if c.get("model_type") == "dbrx":
        return _dbrx_config(c)
    rope_scaling = 1.0
    if isinstance(c.get("rope_scaling"), dict):
        rope_scaling = float(c["rope_scaling"].get("factor", 1.0))
    return ModelConfig(
        vocab_size=c["vocab_size"],
        d_model=c["hidden_size"],
        n_layers=c["num_hidden_layers"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c.get("num_key_value_heads", c["num_attention_heads"]),
        d_head=c["hidden_size"] // c["num_attention_heads"],
        d_ff=c["intermediate_size"],
        rms_eps=c.get("rms_norm_eps", 1e-5),
        rope_theta=c.get("rope_theta", 10000.0),
        rope_scaling=rope_scaling,
        max_seq_len=c.get("max_position_embeddings", 4096),
        tie_embeddings=c.get("tie_word_embeddings", False),
        sliding_window=c.get("sliding_window", None),
    )


def _dbrx_config(c: dict):
    """DBRX's schema: top-level d_model / n_heads / n_layers with
    ``attn_config`` and ``ffn_config`` sub-dicts; sparse expert dispatch
    and bias-free LayerNorm."""
    from .moe import MoEConfig

    attn = c.get("attn_config", {})
    ffn = c.get("ffn_config", {})
    d_model = c["d_model"]
    n_heads = c["n_heads"]
    return MoEConfig(
        vocab_size=c["vocab_size"],
        d_model=d_model,
        n_layers=c["n_layers"],
        n_heads=n_heads,
        n_kv_heads=attn.get("kv_n_heads", n_heads),
        d_head=d_model // n_heads,
        d_ff=ffn.get("ffn_hidden_size", 4 * d_model),
        rms_eps=1e-5,
        rope_theta=attn.get("rope_theta", 500000.0),
        max_seq_len=c.get("max_seq_len", 32768),
        tie_embeddings=c.get("tie_word_embeddings", False),
        n_experts=ffn.get("moe_num_experts", 16),
        top_k=ffn.get("moe_top_k", 4),
        ffn_mode="sparse",
        norm_type="layernorm",
    )


def _open_shards(path: str):
    """``get(name)`` -> the CPU tensor ``name`` of the checkpoint: through
    ``model.safetensors.index.json``'s weight map when present, else from
    ``model.safetensors``."""
    idx = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            weight_map = json.load(f)["weight_map"]
        shards = {s: SafetensorsFile(os.path.join(path, s))
                  for s in sorted(set(weight_map.values()))}
        return lambda name: shards[weight_map[name]].get_tensor(name)
    return SafetensorsFile(os.path.join(path, "model.safetensors")).get_tensor


class _Writer:
    """Stacked (L, ...) tensors on ``dev``, allocated at the first layer's
    shape and filled one layer at a time (cast on the card)."""

    def __init__(self, get, n_layers: int, dev):
        self.get, self.L, self.dev = get, n_layers, dev

    def one(self, name, dtype, fn=lambda t: t):
        return fn(self.get(name).to(self.dev)).to(dtype).contiguous()

    def stack(self, fmt, dtype, fn=lambda t: t.T):
        out = None
        for i in range(self.L):
            t = fn(self.get(fmt.format(i=i)).to(self.dev))
            if out is None:
                out = torch.empty((self.L, *t.shape), dtype=dtype,
                                  device=self.dev)
            out[i].copy_(t)
        return out


def load_hf_checkpoint(path: str, dtype=torch.bfloat16, max_seq_len=None,
                       device="cuda"):
    """(params, cfg) of the checkpoint in ``path`` on ``device``: a
    ``llama.Llama`` or a ``moe.MoE``. Matmul weights in ``dtype``, norms in
    fp32. ``max_seq_len`` beyond the pretraining window applies linear
    RoPE scaling (``ModelConfig.scaled``)."""
    from .llama import Llama
    from .moe import MoEConfig

    dev = resolve_device(device)
    cfg = config_from_hf(path)
    if max_seq_len is not None and max_seq_len > cfg.max_seq_len:
        cfg = cfg.scaled(max_seq_len)
    w = _Writer(_open_shards(path), cfg.n_layers, dev)
    if isinstance(cfg, MoEConfig):
        return _load_dbrx(w, cfg, dtype), cfg

    p = "model.layers.{i}."
    names = dict(wq="self_attn.q_proj", wk="self_attn.k_proj",
                 wv="self_attn.v_proj", wo="self_attn.o_proj",
                 w_gate="mlp.gate_proj", w_up="mlp.up_proj",
                 w_down="mlp.down_proj")
    layers = {k: w.stack(p + n + ".weight", dtype) for k, n in names.items()}
    keep = lambda t: t  # noqa: E731  (norm weights are stored as used)
    layers["ln_attn"] = w.stack(p + "input_layernorm.weight", torch.float32,
                                keep)
    layers["ln_mlp"] = w.stack(p + "post_attention_layernorm.weight",
                               torch.float32, keep)
    head = None if cfg.tie_embeddings else w.one("lm_head.weight", dtype,
                                                 lambda t: t.T)
    return Llama(cfg, w.one("model.embed_tokens.weight", dtype),
                 w.one("model.norm.weight", torch.float32), layers,
                 head), cfg


def _load_dbrx(w: _Writer, cfg, dtype):
    """DBRX-schema weights into a ``moe.MoE``:
      transformer.blocks.{i}.norm_attn_norm.attn.Wqkv.weight  (qkv_out, D)
      transformer.blocks.{i}.norm_attn_norm.attn.out_proj.weight  (D, H Dh)
      transformer.blocks.{i}.norm_attn_norm.norm_{1,2}.weight  (LayerNorm)
      transformer.blocks.{i}.ffn.router.layer.weight  (E, D)
      transformer.blocks.{i}.ffn.experts.mlp.{w1,v1,w2}  (E F, D), fused:
        w1 / v1 act as x @ chunk.T (gate / up), w2 as h @ chunk (down)
      transformer.wte.weight, transformer.norm_f.weight, lm_head.weight"""
    from .moe import MoE

    E, Fd, D = cfg.n_experts, cfg.d_ff, cfg.d_model
    p = "transformer.blocks.{i}."

    def experts(name, down):
        return w.stack(p + f"ffn.experts.mlp.{name}", dtype,
                       lambda t: t.reshape(E, Fd, D) if down
                       else t.reshape(E, Fd, D).transpose(1, 2))

    keep = lambda t: t  # noqa: E731
    layers = dict(
        w_qkv=w.stack(p + "norm_attn_norm.attn.Wqkv.weight", dtype),
        wo=w.stack(p + "norm_attn_norm.attn.out_proj.weight", dtype),
        w_router=w.stack(p + "ffn.router.layer.weight", dtype),
        w_gate=experts("w1", down=False),
        w_up=experts("v1", down=False),
        w_down=experts("w2", down=True),
        ln_attn=w.stack(p + "norm_attn_norm.norm_1.weight", torch.float32,
                        keep),
        ln_mlp=w.stack(p + "norm_attn_norm.norm_2.weight", torch.float32,
                       keep),
    )
    head = None if cfg.tie_embeddings else w.one("lm_head.weight", dtype,
                                                 lambda t: t.T)
    return MoE(cfg, w.one("transformer.wte.weight", dtype),
               w.one("transformer.norm_f.weight", torch.float32), layers,
               head)
