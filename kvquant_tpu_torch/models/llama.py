"""LLaMA-family transformer, full-precision forward (port of
kvquant_tpu/models/llama.py:42-131,374-567).

Parameters live in an ``nn.Module`` (``Llama``) holding the JAX package's
stacked per-layer layout: weights (L, in, out) used as ``x @ W``, norms
(L, d_model). Dtype policy as in the JAX package: matmuls in the parameter
dtype (bf16 for real models), RMSNorm, softmax and RoPE in fp32.

Prompt attention is plain PyTorch (a materialized masked softmax, or the
online-softmax chunk loop for long prompts): the JAX package leaves it to
XLA and has no kernel for it, and the port calls no library attention.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .config import ModelConfig

LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "ln_attn", "ln_mlp")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class Llama(nn.Module):
    """Parameter container: ``embed`` (V, D), ``final_norm`` (D,),
    ``lm_head`` (D, V) or None when tied, ``layers[name]`` (L, ...)."""

    def __init__(self, cfg: ModelConfig, embed, final_norm, layers: dict,
                 lm_head=None):
        super().__init__()
        self.cfg = cfg

        def p(t):
            return nn.Parameter(t, requires_grad=False)

        self.embed = p(embed)
        self.final_norm = p(final_norm)
        self.lm_head = None if lm_head is None else p(lm_head)
        self.layers = nn.ParameterDict({k: p(layers[k]) for k in LAYER_KEYS})

    def head(self) -> torch.Tensor:
        return self.embed.T if self.lm_head is None else self.lm_head

    def layer(self, i) -> dict:
        return {k: v[i] for k, v in self.layers.items()}

    def forward(self, tokens, **kw):
        return forward(self, self.cfg, tokens, **kw)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                dtype=torch.bfloat16, device="cuda", seed: int = 0) -> Llama:
    """Random-init model, drawn layer by layer on ``device`` from
    ``generator`` (a fresh one seeded with ``seed`` when None). Same
    distributions as the JAX init (normal / sqrt(fan_in), embed 0.02, unit
    norms); the draws differ from jax.random's."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)

    def dense(shape, scale=None):
        scale = scale or 1.0 / shape[-2] ** 0.5
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * scale).to(dtype)

    L, D, H, Hkv, Dh, Fd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                            cfg.n_kv_heads, cfg.d_head, cfg.d_ff)
    shapes = dict(wq=(D, H * Dh), wk=(D, Hkv * Dh), wv=(D, Hkv * Dh),
                  wo=(H * Dh, D), w_gate=(D, Fd), w_up=(D, Fd),
                  w_down=(Fd, D))
    layers = {k: torch.stack([dense(s) for _ in range(L)])
              for k, s in shapes.items()}
    layers["ln_attn"] = torch.ones((L, D), dtype=torch.float32, device=dev)
    layers["ln_mlp"] = torch.ones((L, D), dtype=torch.float32, device=dev)
    embed = dense((cfg.vocab_size, D), scale=0.02)
    head = None if cfg.tie_embeddings else dense((D, cfg.vocab_size))
    return Llama(cfg, embed,
                 torch.ones((D,), dtype=torch.float32, device=dev),
                 layers, head)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda",
                      dtype=None) -> Llama:
    """The JAX parameter pytree, as nested dicts of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)`` or ``load_toy_checkpoint``), as the
    port's module. ``dtype`` casts the matmul weights (norms stay fp32)."""
    dev = resolve_device(device)

    def t(a, cast=True):
        x = torch.tensor(np.asarray(a), device=dev)
        return x.to(dtype) if (cast and dtype is not None) else x

    layers = {k: t(tree["layers"][k], cast=not k.startswith("ln_"))
              for k in LAYER_KEYS}
    head = tree.get("lm_head")
    return Llama(cfg, t(tree["embed"]), t(tree["final_norm"], cast=False),
                 layers, None if head is None else t(head))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps):
    xf = x.to(torch.float32)
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale * w).to(x.dtype)


def norm(x, w, cfg: ModelConfig):
    """RMSNorm (LLaMA family) or bias-free LayerNorm, by cfg.norm_type."""
    if cfg.norm_type == "layernorm":
        xf = x.to(torch.float32)
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        return ((xf - mu) * torch.rsqrt(var + cfg.rms_eps) * w).to(x.dtype)
    return rms_norm(x, w, cfg.rms_eps)


def rope_inv_freq(cfg: ModelConfig, device) -> torch.Tensor:
    """(d_head/2,) fp32 ``theta ** (-2i / d_head)``, in the JAX function's
    fp32 order."""
    ar = torch.arange(0, cfg.d_head // 2, dtype=torch.float32, device=device)
    return torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32),
                     -ar * 2.0 / cfg.d_head)


def rope_cos_sin(positions: torch.Tensor, cfg: ModelConfig):
    """fp32 cos/sin tables for ``positions``: (..., d_head), HF rotate-half
    convention (angles of pair i at i and i + d_head/2); the same fp32
    operation order as the JAX function: ``(pos / scaling) * inv_freq``."""
    inv_freq = rope_inv_freq(cfg, positions.device)
    pos = positions.to(torch.float32) / cfg.rope_scaling
    angles = pos[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(x, cos, sin):
    """x: (..., T, n, d_head) with cos/sin (..., T, d_head)."""
    c = cos.unsqueeze(-2)
    s = sin.unsqueeze(-2)
    xf = x.to(torch.float32)
    return (xf * c + rotate_half(xf) * s).to(x.dtype)


def _mask(cfg: ModelConfig, pq, pk):
    """causal (+ optional sliding window) mask from absolute positions."""
    m = pk <= pq
    if cfg.sliding_window is not None:
        m &= pk > pq - cfg.sliding_window
    return m


def _attention_full(q, k, v, cfg: ModelConfig, positions):
    """Materialized causal attention. q: (B,T,H,Dh), k/v: (B,T,Hkv,Dh)."""
    B, T, H, Dh = q.shape
    g = cfg.q_per_kv
    qh = q.reshape(B, T, cfg.n_kv_heads, g, Dh)
    scores = torch.einsum(
        "bqhgd,bkhd->bhgqk", qh.to(torch.float32), k.to(torch.float32)
    ) / (Dh ** 0.5)
    mask = _mask(cfg, positions[:, :, None], positions[:, None, :])
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhgqk,bkhd->bqhgd", probs.to(v.dtype).to(torch.float32),
        v.to(torch.float32),
    )
    return out.reshape(B, T, H * Dh).to(q.dtype)


def _attention_chunked(q, k, v, cfg: ModelConfig, positions, chunk: int):
    """Blockwise online-softmax causal attention: O(T*chunk) score memory
    (the loop the JAX package runs as a lax.scan over KV chunks)."""
    B, T, H, Dh = q.shape
    g = cfg.q_per_kv
    Hkv = cfg.n_kv_heads
    nb = T // chunk
    assert T % chunk == 0
    qh = q.reshape(B, T, Hkv, g, Dh).to(torch.float32) / (Dh ** 0.5)
    kb = k.to(torch.float32).reshape(B, nb, chunk, Hkv, Dh)
    vb = v.to(torch.float32).reshape(B, nb, chunk, Hkv, Dh)
    pb = positions.reshape(B, nb, chunk)

    dev = q.device
    m = torch.full((B, Hkv, g, T), float("-inf"), device=dev)
    l = torch.zeros((B, Hkv, g, T), device=dev)
    acc = torch.zeros((B, Hkv, g, T, Dh), device=dev)
    for i in range(nb):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh, kb[:, i])
        mask = _mask(cfg, positions[:, :, None], pb[:, i][:, None, :])
        s = s.masked_fill(~mask[:, None, None], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully-masked rows keep m = -inf; exp(-inf - -inf) -> use 0
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_new),
                           torch.zeros_like(m))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, vb[:, i])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.movedim(out, 3, 1)  # (B,T,Hkv,g,Dh)
    return out.reshape(B, T, H * Dh).to(q.dtype)


def _attention(q, k, v, cfg: ModelConfig, positions, chunk=None):
    """Causal attention; the blockwise path for long sequences (T > 4096)
    or when ``chunk`` is forced."""
    T = q.shape[1]
    if chunk is None and T > 4096:
        chunk = 2048
    if chunk is not None and T % chunk == 0 and T > chunk:
        return _attention_chunked(q, k, v, cfg, positions, chunk)
    return _attention_full(q, k, v, cfg, positions)


def forward(params: Llama, cfg: ModelConfig, tokens, *, positions=None,
            capture_kv: bool = False, attn_chunk: int | None = None):
    """Full-sequence forward. Returns (logits fp32 (B,T,V), aux dict);
    aux["k_acts"]/aux["v_acts"]: (L, B, T, C) fp32 pre-RoPE k / v
    projections when capture_kv=True."""
    B, T = tokens.shape
    dev = params.embed.device
    tokens = tokens.to(dev)
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=dev).expand(B, T)
    cos, sin = rope_cos_sin(positions, cfg)

    x = params.embed[tokens.long()]
    k_acts, v_acts = [], []
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        h = norm(x, lp["ln_attn"], cfg)
        q = h @ lp["wq"]
        k = h @ lp["wk"]
        v = h @ lp["wv"]
        if capture_kv:
            k_acts.append(k.to(torch.float32))
            v_acts.append(v.to(torch.float32))
        q = apply_rope(q.reshape(B, T, cfg.n_heads, cfg.d_head), cos, sin)
        k = apply_rope(k.reshape(B, T, cfg.n_kv_heads, cfg.d_head), cos, sin)
        v = v.reshape(B, T, cfg.n_kv_heads, cfg.d_head)
        attn = _attention(q, k, v, cfg, positions, chunk=attn_chunk)
        x = x + attn @ lp["wo"]
        h = norm(x, lp["ln_mlp"], cfg)
        x = x + (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]

    x = norm(x, params.final_norm, cfg)
    logits = (x @ params.head()).to(torch.float32)
    aux = {}
    if capture_kv:
        aux["k_acts"] = torch.stack(k_acts)
        aux["v_acts"] = torch.stack(v_acts)
    return logits, aux
