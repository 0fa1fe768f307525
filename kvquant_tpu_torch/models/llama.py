"""LLaMA-family transformer: full-precision forward, the simulated KV
quantization hook and the Fisher probes (port of
kvquant_tpu/models/llama.py:42-577).

Parameters live in an ``nn.Module`` (``Llama``) holding the JAX package's
stacked per-layer layout: weights (L, in, out) used as ``x @ W``, norms
(L, d_model). Dtype policy as in the JAX package: matmuls in the parameter
dtype (bf16 for real models), RMSNorm, softmax and RoPE in fp32.

Prompt attention is plain PyTorch (a materialized masked softmax, or the
online-softmax chunk loop for long prompts): the JAX package leaves it to
XLA and has no kernel for it, and the port calls no library attention.

Simulated quantization (``forward(..., simquant=)``) fake-quantizes the k / v
projections of every layer: keys per channel with static calibrated
thresholds (before RoPE, or after it for the post-RoPE scheme), values per
token with a dynamic range; the accuracy oracle the deployed cache is held
to (``evals.ppl.perplexity`` against ``engine.deployed_ppl``).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..quant.nuq import quant_lut
from ..quant.outliers import (apply_sink_mask, capped_outlier_mask_headwise,
                              dynamic_outlier_mask,
                              headwise_range_outlier_mask,
                              outlier_budget_per_side, static_outlier_mask)
from ..utils.topk import top_k
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


# ---------------------------------------------------------------------------
# simulated KV quantization hook
# ---------------------------------------------------------------------------


@dataclass
class SimQuantArrays:
    """Stacked (leading L axis) quantizer arrays: k_lower / k_upper (L, C)
    static per-channel K thresholds; k_lut / v_lut (L, 2**bits) sorted
    normalized codebooks; *_normscale / *_normoffset (L,) Q-Norm affine (1 /
    0 when unused); k_ressc (L, C) per-channel residual energy (read in the
    static-channel K outlier mode)."""

    k_lower: torch.Tensor
    k_upper: torch.Tensor
    k_lut: torch.Tensor
    v_lut: torch.Tensor
    k_normscale: torch.Tensor
    k_normoffset: torch.Tensor
    v_normscale: torch.Tensor
    v_normoffset: torch.Tensor
    k_ressc: torch.Tensor | None = None

    def layer(self, i) -> "SimQuantArrays":
        return SimQuantArrays(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name)[i] for f in fields(self)})


@dataclass(frozen=True)
class SimQuantConfig:
    """Static scheme config (fields as in the JAX package). v_mode "topk":
    the per-token V range from the token's two-sided global top-k, with the
    per-head capped outlier storage of the deployed cache; "percentile":
    the reference's simulated-eval semantics. ``cap_per_side`` is per
    (token, kv-head group of ``n_kv_heads``); ``v_range_exclude`` the global
    per-side extreme count that defines the V range."""

    bits: int
    include_sparse: bool = True
    sparsity_threshold: float = 0.99
    cap_per_side: int = 0  # 0 => uncapped static mask
    n_kv_heads: int = 1
    v_range_exclude: int = 0  # 0 => derive from sparsity_threshold
    first_few_fp16: int = 0
    v_mode: str = "topk"  # or "percentile"
    qnorm: bool = False
    k_outliers: str = "slots"  # "channels": the n_kc highest-residual
    #   channels of each head group kept exact for every token
    n_kc: int = 4
    post_rope_k: bool = False  # quantize keys after the rotary embedding


@dataclass
class SimQuantParams:
    arrays: SimQuantArrays
    config: SimQuantConfig


def simquant_from_quantizers(qs, v_mode="topk", n_kv_heads=1,
                             cap_per_side=2, head_group=1, post_rope_k=None,
                             k_outliers="slots", n_kc=4,
                             device="cuda") -> SimQuantParams:
    """Stacked simulated-quant params from a ``QuantizerSet``, on
    ``device``. ``n_kv_heads`` / ``cap_per_side`` / ``head_group`` set the
    per-(token, head group) outlier budget as DeployConfig does, so the
    oracle matches deployment."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def aff(vals, default):
        return t([default if v is None else v for v in vals])

    k_lower = np.stack([lq.k.lower for lq in qs.layers])
    arrays = SimQuantArrays(
        k_lower=t(k_lower),
        k_upper=t(np.stack([lq.k.upper for lq in qs.layers])),
        k_lut=t(np.stack([np.sort(lq.k.lut.reshape(-1)) for lq in qs.layers])),
        v_lut=t(np.stack([np.sort(lq.v.lut.reshape(-1)) for lq in qs.layers])),
        k_normscale=aff([lq.k.normscale for lq in qs.layers], 1.0),
        k_normoffset=aff([lq.k.normoffset for lq in qs.layers], 0.0),
        v_normscale=aff([lq.v.normscale for lq in qs.layers], 1.0),
        v_normoffset=aff([lq.v.normoffset for lq in qs.layers], 0.0),
        k_ressc=t(np.stack([
            np.zeros_like(lq.k.upper) if lq.k.ressc is None
            else np.asarray(lq.k.ressc, np.float32) for lq in qs.layers])),
    )
    C = k_lower.shape[-1]
    assert n_kv_heads % head_group == 0, (n_kv_heads, head_group)
    cfg = SimQuantConfig(
        bits=qs.bits,
        include_sparse=True,
        sparsity_threshold=qs.sparsity_threshold,
        cap_per_side=cap_per_side if qs.cap_outliers else 0,
        n_kv_heads=n_kv_heads // head_group,
        v_range_exclude=outlier_budget_per_side(C, qs.sparsity_threshold),
        first_few_fp16=qs.first_few_fp16,
        v_mode=v_mode,
        qnorm=any(lq.k.normscale is not None for lq in qs.layers),
        post_rope_k=(bool(qs.meta.get("post_rope_k", False))
                     if post_rope_k is None else post_rope_k),
        k_outliers=k_outliers,
        n_kc=n_kc,
    )
    return SimQuantParams(arrays=arrays, config=cfg)


def simquant_k(k, arrs: SimQuantArrays, cfg: SimQuantConfig):
    """Fake-quantize keys (B, T, C) of one layer, per-channel static
    scheme (pre-RoPE keys, or roped ones under ``post_rope_k``)."""
    kf = k.to(torch.float32)
    mask = None
    if cfg.include_sparse:
        if cfg.k_outliers == "channels":
            # the deployed cache stores the full residual of each group's
            # top-n_kc residual-energy channels: exact there for every token
            C = kf.shape[-1]
            gw = C // cfg.n_kv_heads
            idx = top_k(arrs.k_ressc.reshape(cfg.n_kv_heads, gw), cfg.n_kc)[1]
            chmask = (idx[..., None] == torch.arange(gw, device=kf.device)
                      ).any(dim=-2).reshape(C)
            mask = chmask.expand(kf.shape)
        elif cfg.cap_per_side > 0:
            mask = capped_outlier_mask_headwise(
                kf, arrs.k_lower, arrs.k_upper, cfg.cap_per_side,
                cfg.n_kv_heads)
        else:
            mask = static_outlier_mask(kf, arrs.k_lower, arrs.k_upper, axis=0)
        mask = apply_sink_mask(mask, cfg.first_few_fp16, token_axis=-2)
    deq = quant_lut(
        kf, arrs.k_lut, axis=0, minval=arrs.k_lower, maxval=arrs.k_upper,
        outlier_mask=mask,
        normscale=arrs.k_normscale if cfg.qnorm else None,
        normoffset=arrs.k_normoffset if cfg.qnorm else None,
        sink=cfg.first_few_fp16, token_axis=-2)
    return deq.to(k.dtype)


def _topk_range(vf, r: int):
    """(minval, maxval) (..., 1): the (r+1)-th largest value on each side."""
    top_v = top_k(vf, r + 1)[0]
    bot_v = top_k(-vf, r + 1)[0]
    return -bot_v[..., -1:], top_v[..., -1:]


def v_topk_range_and_mask(vf, r_exclude: int, cap_per_side: int,
                          n_kv_heads: int):
    """Deployed V semantics: range = the (r+1)-th global extreme on each
    side; the stored outliers are the per-head top-cap beyond-range
    elements. Returns (minval, maxval, mask)."""
    minval, maxval = _topk_range(vf, r_exclude)
    mask = headwise_range_outlier_mask(vf, minval, maxval, cap_per_side,
                                       n_kv_heads)
    return minval, maxval, mask


def simquant_v(v, arrs: SimQuantArrays, cfg: SimQuantConfig):
    """Fake-quantize values (B, T, C) of one layer, per-token dynamic
    scheme."""
    vf = v.to(torch.float32)
    minval = maxval = mask = None
    dynamic = True
    if cfg.include_sparse:
        if cfg.v_mode == "topk":
            r = cfg.v_range_exclude or outlier_budget_per_side(
                v.shape[-1], cfg.sparsity_threshold)
            cap = cfg.cap_per_side or outlier_budget_per_side(
                v.shape[-1] // cfg.n_kv_heads, cfg.sparsity_threshold)
            if cfg.k_outliers == "channels" and cfg.cap_per_side == 0:
                # V slots off: per-token range only, no stored V outliers
                minval, maxval = _topk_range(vf, r)
                mask = torch.zeros(vf.shape, dtype=torch.bool,
                                   device=vf.device)
            else:
                minval, maxval, mask = v_topk_range_and_mask(
                    vf, r, cap, cfg.n_kv_heads)
            dynamic = False
        else:
            mask = dynamic_outlier_mask(vf, cfg.sparsity_threshold, axis=-1)
        mask = apply_sink_mask(mask, cfg.first_few_fp16, token_axis=-2)
    deq = quant_lut(
        vf, arrs.v_lut, axis=-1, minval=minval, maxval=maxval,
        dynamic=dynamic, outlier_mask=mask,
        normscale=arrs.v_normscale if cfg.qnorm else None,
        normoffset=arrs.v_normoffset if cfg.qnorm else None,
        sink=cfg.first_few_fp16, token_axis=-2)
    return deq.to(v.dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


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


def _attention_chunked(q, k, v, cfg: ModelConfig, positions, chunk: int,
                       remat: bool = False):
    """Blockwise online-softmax causal attention: O(T*chunk) score memory
    (the loop the JAX package runs as a lax.scan over KV chunks). ``remat``
    recomputes each chunk's (T, chunk) score block in the backward instead
    of keeping all of them (``jax.checkpoint`` of the scan body there)."""
    B, T, H, Dh = q.shape
    g = cfg.q_per_kv
    Hkv = cfg.n_kv_heads
    nb = T // chunk
    assert T % chunk == 0
    qh = q.reshape(B, T, Hkv, g, Dh).to(torch.float32) / (Dh ** 0.5)
    kb = k.to(torch.float32).reshape(B, nb, chunk, Hkv, Dh)
    vb = v.to(torch.float32).reshape(B, nb, chunk, Hkv, Dh)
    pb = positions.reshape(B, nb, chunk)

    def body(m, l, acc, k_c, v_c, p_c):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k_c)
        mask = _mask(cfg, positions[:, :, None], p_c[:, None, :])
        s = s.masked_fill(~mask[:, None, None], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully-masked rows keep m = -inf; exp(-inf - -inf) -> use 0
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_new),
                           torch.zeros_like(m))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                   v_c)
        return m_new, l, acc

    dev = q.device
    m = torch.full((B, Hkv, g, T), float("-inf"), device=dev)
    l = torch.zeros((B, Hkv, g, T), device=dev)
    acc = torch.zeros((B, Hkv, g, T, Dh), device=dev)
    for i in range(nb):
        blk = (m, l, acc, kb[:, i], vb[:, i], pb[:, i])
        m, l, acc = (checkpoint(body, *blk, use_reentrant=False) if remat
                     else body(*blk))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.movedim(out, 3, 1)  # (B,T,Hkv,g,Dh)
    return out.reshape(B, T, H * Dh).to(q.dtype)


def _attention(q, k, v, cfg: ModelConfig, positions, chunk=None,
               remat=False):
    """Causal attention; the blockwise path for long sequences (T > 4096)
    or when ``chunk`` is forced."""
    T = q.shape[1]
    if chunk is None and T > 4096:
        chunk = 2048
    if chunk is not None and T % chunk == 0 and T > chunk:
        return _attention_chunked(q, k, v, cfg, positions, chunk,
                                  remat=remat)
    return _attention_full(q, k, v, cfg, positions)


def forward(params: Llama, cfg: ModelConfig, tokens, *, positions=None,
            simquant: SimQuantParams | None = None, capture_kv: bool = False,
            kv_probes: dict | None = None, attn_chunk: int | None = None,
            remat: bool = False):
    """Full-sequence forward. Returns (logits fp32 (B,T,V), aux dict);
    aux["k_acts"]/aux["v_acts"]: (L, B, T, C) fp32 pre-RoPE k / v
    projections when capture_kv=True (captured before any simulated
    quantization). ``simquant`` fake-quantizes every layer's keys (before
    RoPE, or after it under ``post_rope_k``) and values. ``kv_probes``
    (``make_kv_probes``) are added to the k / v projections before the
    capture: their gradients are d(loss)/d(k / v activations), the Fisher
    signal. ``remat`` runs each layer (and each attention chunk) under
    ``torch.utils.checkpoint``: the backward keeps each layer's input and
    recomputes the rest."""
    B, T = tokens.shape
    dev = params.embed.device
    tokens = tokens.to(dev)
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=dev).expand(B, T)
    cos, sin = rope_cos_sin(positions, cfg)

    def layer(x, li, probe_k, probe_v):
        lp = params.layer(li)
        h = norm(x, lp["ln_attn"], cfg)
        q = h @ lp["wq"]
        k = h @ lp["wk"]
        v = h @ lp["wv"]
        if probe_k is not None:
            # fp32 probes promote k / v to fp32 for the rest of the layer,
            # as in the JAX forward
            k = k + probe_k
            v = v + probe_v
        captured = ((k.to(torch.float32), v.to(torch.float32)) if capture_kv
                    else ())
        if simquant is not None:
            sq, sc = simquant.arrays.layer(li), simquant.config
            if not sc.post_rope_k:
                k = simquant_k(k, sq, sc)
            v = simquant_v(v, sq, sc)
        q = apply_rope(q.reshape(B, T, cfg.n_heads, cfg.d_head), cos, sin)
        k = apply_rope(k.reshape(B, T, cfg.n_kv_heads, cfg.d_head), cos, sin)
        if simquant is not None and sc.post_rope_k:
            # the post-RoPE scheme fake-quantizes the roped keys
            k = simquant_k(k.reshape(B, T, cfg.kv_hidden), sq, sc).reshape(
                B, T, cfg.n_kv_heads, cfg.d_head)
        v = v.reshape(B, T, cfg.n_kv_heads, cfg.d_head)
        attn = _attention(q, k, v, cfg, positions, chunk=attn_chunk,
                          remat=remat)
        x = x + attn @ lp["wo"]
        h = norm(x, lp["ln_mlp"], cfg)
        x = x + (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]
        return (x,) + captured

    x = params.embed[tokens.long()]
    k_acts, v_acts = [], []
    for li in range(cfg.n_layers):
        probes = ((kv_probes["k"][li], kv_probes["v"][li])
                  if kv_probes is not None else (None, None))
        out = (checkpoint(layer, x, li, *probes, use_reentrant=False)
               if remat else layer(x, li, *probes))
        x = out[0]
        if capture_kv:
            k_acts.append(out[1])
            v_acts.append(out[2])

    x = norm(x, params.final_norm, cfg)
    logits = (x @ params.head()).to(torch.float32)
    aux = {}
    if capture_kv:
        aux["k_acts"] = torch.stack(k_acts)
        aux["v_acts"] = torch.stack(v_acts)
    return logits, aux


def make_kv_probes(cfg: ModelConfig, batch: int, seq: int,
                   device="cuda") -> dict:
    """Zero fp32 probes {"k", "v"}, each (L, batch, seq, kv_hidden), for
    ``forward(kv_probes=)``: their gradients are d(loss)/d(k_act) and
    d(loss)/d(v_act). The caller sets ``requires_grad``."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, seq, cfg.kv_hidden)
    return {"k": torch.zeros(shape, dtype=torch.float32, device=dev),
            "v": torch.zeros(shape, dtype=torch.float32, device=dev)}
