"""fp16/bf16 KV-cache decode baseline (port of
kvquant_tpu/baseline_fp16.py:24-143).

The comparison surface for the quantized engine: a preallocated
full-precision KV cache with the same static-shape decode structure, so
throughput ratios isolate the cost / benefit of KV quantization rather than
engine differences. Attention is plain PyTorch and, as in the JAX function,
casts the cache to fp32 (scores and values contract in fp32).

Differences from the JAX module: the cache is updated in place (and
returned); ``pos`` is a host int; MoE configs are not ported (ROADMAP
queue 1 item 11) and raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .device import resolve_device
from .models.config import ModelConfig
from .models import llama


@dataclass
class Fp16Cache:
    k: torch.Tensor  # (L, B, Hkv, T, Dh) post-RoPE keys
    v: torch.Tensor  # (L, B, Hkv, T, Dh)
    length: torch.Tensor  # (B,) int32


def _no_moe(cfg):
    if hasattr(cfg, "n_experts"):
        raise NotImplementedError(
            "the fp16 baseline for MoE configs is not ported (ROADMAP queue "
            "1 item 11, MoE and the HF loader)")


def create_fp16_cache(cfg: ModelConfig, max_len: int, batch: int,
                      dtype=torch.bfloat16, device="cuda") -> Fp16Cache:
    dev = resolve_device(device)
    L, H, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    return Fp16Cache(
        k=torch.zeros((L, batch, H, max_len, Dh), dtype=dtype, device=dev),
        v=torch.zeros((L, batch, H, max_len, Dh), dtype=dtype, device=dev),
        length=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def prefill(params, cfg: ModelConfig, cache: Fp16Cache, tokens,
            attn_chunk: int | None = None):
    """Full forward over the prompt; store post-RoPE K and V in place.
    ``attn_chunk`` forwards to the blockwise attention of models.llama (long
    prompts). Returns (cache, logits_last (B, V) fp32)."""
    _no_moe(cfg)
    B, T0 = tokens.shape
    logits, aux = llama.forward(params, cfg, tokens, capture_kv=True,
                                attn_chunk=attn_chunk)
    dev = cache.k.device
    cos, sin = llama.rope_cos_sin(
        torch.arange(T0, dtype=torch.int32, device=dev), cfg)
    k = aux["k_acts"].reshape(-1, B, T0, cfg.n_kv_heads, cfg.d_head)
    v = aux["v_acts"].reshape(-1, B, T0, cfg.n_kv_heads, cfg.d_head)
    k = llama.apply_rope(k, cos, sin)
    cache.k[:, :, :, :T0] = k.transpose(2, 3).to(cache.k.dtype)
    cache.v[:, :, :, :T0] = v.transpose(2, 3).to(cache.v.dtype)
    cache.length.fill_(T0)
    return cache, logits[:, -1].to(torch.float32)


def decode_step(params, cfg: ModelConfig, cache: Fp16Cache, token, pos: int):
    """Single-token decode against the fp16 cache at position ``pos`` (an
    int, the same for every sequence): one row written per layer in place,
    attention over positions 0..pos. Returns (cache, logits (B, V) fp32)."""
    _no_moe(cfg)
    B = token.shape[0]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // Hkv
    T = cache.k.shape[3]
    pos = int(pos)
    dev = params.embed.device

    x = params.embed[token.to(dev).long()]
    cos, sin = llama.rope_cos_sin(
        torch.tensor([pos], dtype=torch.int32, device=dev), cfg)  # (1, Dh)
    valid = torch.arange(T, device=dev) <= pos
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        h = llama.norm(x, lp["ln_attn"], cfg)
        q = (h @ lp["wq"]).reshape(B, Hkv, G, Dh).to(torch.float32)
        k = (h @ lp["wk"]).reshape(B, Hkv, Dh).to(torch.float32)
        v = (h @ lp["wv"]).reshape(B, Hkv, Dh)
        q = q * cos + llama.rotate_half(q) * sin
        k = k * cos + llama.rotate_half(k) * sin
        cache.k[li, :, :, pos] = k.to(cache.k.dtype)
        cache.v[li, :, :, pos] = v.to(cache.v.dtype)

        scores = torch.einsum("bhgd,bhtd->bhgt", q,
                              cache.k[li].to(torch.float32)) / (Dh ** 0.5)
        scores = scores.masked_fill(~valid, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhgt,bhtd->bhgd", probs,
                            cache.v[li].to(torch.float32))
        x = x + attn.reshape(B, H * Dh).to(x.dtype) @ lp["wo"]
        h = llama.norm(x, lp["ln_mlp"], cfg)
        x = x + (torch.nn.functional.silu(h @ lp["w_gate"])
                 * (h @ lp["w_up"])) @ lp["w_down"]

    x = llama.norm(x, params.final_norm, cfg)
    logits = (x @ params.head()).to(torch.float32)
    cache.length.fill_(pos + 1)
    return cache, logits
