"""DBRX-style Mixture-of-Experts transformer with a fused Wqkv projection
(port of kvquant_tpu/models/moe.py:38-247).

The attention block is the LLaMA family's (``models.llama``: norm, RoPE,
causal attention, the simulated-quantization hook and the Fisher probes);
only the projection and the FFN differ:

  - one fused ``w_qkv`` (D, (H + 2 Hkv) Dh) whose output is sliced into
    q / k / v (``split_qkv``);
  - a top-k gated expert FFN (``moe_ffn``): a router (D, E), then each
    token's top_k experts (SwiGLU, (E, D, F) gate / up, (E, F, D) down)
    weighted by the softmax of its top_k router logits.

``ffn_mode="dense"`` computes every expert and combines them with the
masked router weights (exact; the JAX function's einsums).
``ffn_mode="sparse"`` is the JAX package's capacity dispatch: each expert
takes at most C = min(N, ceil(N K / E) * max(1, round(capacity_factor)))
tokens in arrival order, and a token past an expert's capacity loses that
expert, without renormalisation. The JAX function dispatches with one-hot
einsums over (N, E, C), which suit the TPU; here the same fixed shapes are
built on the device by index (``dispatch_slots``): each kept pair's token
goes to slot e C + its arrival order in expert e of an (E, C) slot table,
whose unused slots point at a zero row; the slots' rows (E, C, D) go
through the experts, and each token gathers its top_k experts' outputs
back from their slots and sums them times the router weights in fp32, in
ascending expert order, with one cast at the end, as the bf16 einsum
does. Nothing is read back to the host, so a CUDA graph captures the FFN
(``engine.DecodeGraph``). The experts' products take C <= 8 rows an
expert (decode) through the Hopper kernel ``ops.kernels.moe_experts``,
which reads only the weights of experts with a live slot, and larger C
(prefill chunks) through ``torch.bmm`` over (E, C, ·), the JAX einsums'
own products.

Router ties: the top_k experts come from ``utils.topk.top_k``, which orders
as ``jax.lax.top_k`` does (ties to the lower index), not ``torch.topk``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..parallel.collectives import reduce_from_tp, tp_group
from ..utils.topk import top_k
from . import llama
from .config import ModelConfig

LAYER_KEYS = ("w_qkv", "wo", "w_router", "w_gate", "w_up", "w_down",
              "ln_attn", "ln_mlp")


@dataclass(frozen=True)
class MoEConfig(ModelConfig):
    n_experts: int = 8
    top_k: int = 2
    # "dense": every expert computed, mask-combined (exact); "sparse":
    # capacity dispatch, expert work scales with top_k, not E
    ffn_mode: str = "dense"
    capacity_factor: float = 2.0


TINY_MOE = MoEConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=96, max_seq_len=256, n_experts=4, top_k=2,
)


class MoE(llama.Llama):
    """Parameter container of the MoE family: ``embed``, ``final_norm``,
    ``lm_head`` (None when tied), ``head()``, ``layer(i)`` as
    ``llama.Llama``, with the layer keys ``w_qkv`` (L, D, (H + 2 Hkv) Dh),
    ``wo``, ``w_router`` (L, D, E), ``w_gate`` / ``w_up`` (L, E, D, F),
    ``w_down`` (L, E, F, D), ``ln_attn``, ``ln_mlp``."""

    LAYER_KEYS = LAYER_KEYS


def layer_shapes(cfg: MoEConfig) -> dict:
    """Per-layer shape of every matmul weight."""
    D, H, Hkv, Dh, Fd, E = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.d_head, cfg.d_ff, cfg.n_experts)
    return dict(w_qkv=(D, (H + 2 * Hkv) * Dh), wo=(H * Dh, D),
                w_router=(D, E), w_gate=(E, D, Fd), w_up=(E, D, Fd),
                w_down=(E, Fd, D))


def init_params(cfg: MoEConfig, generator: torch.Generator | None = None,
                dtype=torch.bfloat16, device="cuda", seed: int = 0) -> MoE:
    """Random-init model on ``device`` from ``generator`` (a fresh one
    seeded with ``seed`` when None). Same distributions as the JAX init
    (normal / sqrt(fan_in), embed 0.02, unit norms); the draws differ from
    jax.random's. Each (layer, expert) matrix is drawn in fp32 and written
    into the preallocated (L, ...) tensors, so the model never exists
    twice."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size

    def fill(dst, scale=None):
        scale = scale or 1.0 / dst.shape[-2] ** 0.5
        dst.copy_(torch.randn(dst.shape, generator=generator, device=dev,
                              dtype=torch.float32) * scale)
        return dst

    layers = {k: torch.empty((L, *s), dtype=dtype, device=dev)
              for k, s in layer_shapes(cfg).items()}
    for li in range(L):
        for w in layers.values():
            for m in (w[li] if w.dim() == 4 else [w[li]]):  # expert by expert
                fill(m)
    layers["ln_attn"] = torch.ones((L, D), dtype=torch.float32, device=dev)
    layers["ln_mlp"] = torch.ones((L, D), dtype=torch.float32, device=dev)
    embed = fill(torch.empty((V, D), dtype=dtype, device=dev), scale=0.02)
    head = None if cfg.tie_embeddings else fill(
        torch.empty((D, V), dtype=dtype, device=dev))
    return MoE(cfg, embed, torch.ones((D,), dtype=torch.float32, device=dev),
               layers, head)


def params_from_numpy(tree: dict, cfg: MoEConfig, device="cuda",
                      dtype=None) -> MoE:
    """The JAX MoE parameter pytree, as nested dicts of numpy arrays, as
    the port's module. ``dtype`` casts the matmul weights (norms stay
    fp32)."""
    dev = resolve_device(device)

    def t(a, cast=True):
        x = torch.tensor(np.asarray(a), device=dev)
        return x.to(dtype) if (cast and dtype is not None) else x

    layers = {k: t(tree["layers"][k], cast=not k.startswith("ln_"))
              for k in LAYER_KEYS}
    head = tree.get("lm_head")
    return MoE(cfg, t(tree["embed"]), t(tree["final_norm"], cast=False),
               layers, None if head is None else t(head))


# ---------------------------------------------------------------------------
# router and experts
# ---------------------------------------------------------------------------


def _router_weights(h, lp, cfg: MoEConfig):
    """(fp32 router logits, softmax over each token's top_k logits with the
    other experts at exactly 0, in h's dtype), each (..., E)."""
    logits = (h @ lp["w_router"]).to(torch.float32)
    # a strict top-k mask from the indices: a >= threshold compare would
    # route a token through more than top_k experts on exact ties
    idx = top_k(logits, cfg.top_k)[1]
    sel = torch.zeros_like(logits, dtype=torch.bool).scatter_(-1, idx, True)
    masked = logits.masked_fill(~sel, float("-inf"))
    return logits, torch.softmax(masked, dim=-1).to(h.dtype)


def _expert(x, lp, e: int):
    """SwiGLU expert ``e`` on rows x (n, D)."""
    gate, up, down = lp["w_gate"][e], lp["w_up"][e], lp["w_down"][e]
    return (F.silu(x @ gate) * (x @ up)) @ down


def _local_experts(cfg: MoEConfig) -> tuple[int, int]:
    """(first global expert, count) of this rank's experts: all of them
    unsharded; under a rank-local config (experts split over tp) the
    ``cfg.n_experts`` experts from ``tp_rank * cfg.n_experts``."""
    return getattr(cfg, "tp_rank", 0) * cfg.n_experts, cfg.n_experts


def moe_ffn(h, lp, cfg: MoEConfig):
    """Top-k gated expert FFN of h (..., D), by ``cfg.ffn_mode``. Under a
    rank-local config the router (replicated) routes over every expert,
    the rank runs its own and the fp32 partial sums are summed over the tp
    group before the one cast to h's dtype."""
    if cfg.ffn_mode == "sparse":
        return moe_ffn_sparse(h, lp, cfg)
    _, w = _router_weights(h, lp, cfg)
    gate = torch.einsum("...d,edf->...ef", h, lp["w_gate"])
    up = torch.einsum("...d,edf->...ef", h, lp["w_up"])
    y = torch.einsum("...ef,efd->...ed", F.silu(gate) * up, lp["w_down"])
    group = tp_group(cfg)
    if group is None:
        return torch.einsum("...e,...ed->...d", w, y)
    e0, n = _local_experts(cfg)
    part = torch.einsum("...e,...ed->...d",
                        w[..., e0:e0 + n].to(torch.float32),
                        y.to(torch.float32))
    return reduce_from_tp(part, group).to(h.dtype)


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Tokens an expert takes in one call (Python's round: half to even),
    from the count of every expert, a rank-local config's included."""
    n_experts = cfg.n_experts * getattr(cfg, "tp_size", 1)
    return min(n_tokens, -(-n_tokens * cfg.top_k // n_experts)
               * max(1, int(round(cfg.capacity_factor))))


def dispatch(w, C: int):
    """(N, E) bool: the (token, expert) pairs kept under capacity C. A pair
    is routed where its weight is > 0; each expert keeps its first C routed
    tokens in token order (the exclusive cumsum of the JAX function)."""
    return dispatch_slots(w, C).keep


class Slots(NamedTuple):
    """The capacity dispatch of N tokens over E experts on the device:
    ``keep`` (N, E) bool the kept pairs, ``pos`` (N, E) int32 each pair's
    arrival order in its expert (the JAX function's ``pos_in_e``),
    ``tokens`` (E_local, C) int64 the token of each slot of this rank's
    experts (N, the appended zero row, where a slot is unused) and
    ``count`` (E_local,) int32 their kept pairs."""
    keep: torch.Tensor
    pos: torch.Tensor
    tokens: torch.Tensor
    count: torch.Tensor


def dispatch_slots(w, C: int, e0: int = 0, n_local: int | None = None):
    """The ``Slots`` of the router weights w (N, E) under capacity C, for
    the ``n_local`` experts from ``e0`` (all by default). Kept pair (n, e)
    writes n into slot (e - e0) C + pos[n, e]; a dropped pair writes into a
    slot of its own past the table, so every index has one writer."""
    N, E = w.shape
    n_local = E if n_local is None else n_local
    routed = (w > 0).to(torch.int32)
    pos = torch.cumsum(routed, dim=0, dtype=torch.int32) - routed
    keep = (routed > 0) & (pos < C)
    kl, pl = keep[:, e0:e0 + n_local], pos[:, e0:e0 + n_local]
    dev = w.device
    pair = torch.arange(N * n_local, device=dev).reshape(N, n_local)
    expert = torch.arange(n_local, device=dev)
    idx = torch.where(kl, expert * C + pl, n_local * C + pair)
    tokens = torch.full((n_local * C + N * n_local,), N, dtype=torch.int64,
                        device=dev)
    tokens.scatter_(0, idx.reshape(-1), torch.arange(
        N, device=dev)[:, None].expand(N, n_local).reshape(-1))
    return Slots(keep, pos, tokens[:n_local * C].reshape(n_local, C),
                 kl.sum(0, dtype=torch.int32))


def moe_ffn_sparse(h, lp, cfg: MoEConfig):
    """Capacity dispatch of h (..., D) over the flattened N tokens
    (``dispatch_slots``): the rows of every expert's C capacity slots run
    through the SwiGLU experts as one (E, C, D) batch, through the kernel
    ``moe_experts`` at C <= ``KERNEL_ROWS`` and ``torch.bmm`` above (and
    for a call that needs a gradient: the kernel has no backward); each
    token sums its kept experts' outputs times their router weights in
    fp32, in ascending expert order, cast once to h's dtype. No host read.
    Under a rank-local config every rank computes the global routing and
    capacity dispatch, runs its own experts, and the fp32 sums are summed
    over the tp group before the cast."""
    from ..ops.kernels.moe_experts import (KERNEL_ROWS, moe_experts,
                                           swiglu_products)

    shape = h.shape
    hf = h.reshape(-1, shape[-1])
    N, D = hf.shape
    _, w = _router_weights(hf, lp, cfg)
    C = capacity(N, cfg)
    e0, n_local = _local_experts(cfg)
    s = dispatch_slots(w, C, e0, n_local)
    xe = torch.cat([hf, hf.new_zeros((1, D))])[s.tokens]  # (E, C, D)
    wts = (lp["w_gate"], lp["w_up"], lp["w_down"])
    if C <= KERNEL_ROWS and not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (xe, *wts))):
        y = moe_experts(xe, s.count, *wts)
    else:
        y = swiglu_products(xe, *wts)
    # each token's top_k experts, the routed ones first in ascending
    # order; a pair that is not kept here reads the zero row past the table
    ids = torch.argsort((w <= 0).to(torch.int32), dim=-1,
                        stable=True)[:, :cfg.top_k]
    local = ids - e0
    live = (local >= 0) & (local < n_local) & torch.gather(s.keep, 1, ids)
    slot = torch.where(live, local.clamp(0, n_local - 1) * C
                       + torch.gather(s.pos, 1, ids), n_local * C)
    ye = torch.cat([y.reshape(n_local * C, D), y.new_zeros((1, D))])
    wk = torch.gather(w, 1, ids).to(torch.float32)
    out = torch.zeros((N, D), dtype=torch.float32, device=h.device)
    for k in range(cfg.top_k):
        out = out + ye[slot[:, k]].to(torch.float32) * wk[:, k, None]
    return reduce_from_tp(out, tp_group(cfg)).to(h.dtype).reshape(shape)


def split_qkv(y, cfg: MoEConfig):
    """The fused projection's output sliced into (q, k, v)."""
    q_dim = cfg.n_heads * cfg.d_head
    kv = cfg.n_kv_heads * cfg.d_head
    return y[..., :q_dim], y[..., q_dim:q_dim + kv], y[..., q_dim + kv:]


def forward(params: MoE, cfg: MoEConfig, tokens, **kw):
    """Full-sequence forward with the contract of ``llama.forward`` (the
    same keywords: ``positions``, ``simquant``, ``capture_kv``,
    ``kv_probes``, ``attn_chunk``, ``remat``; the same (logits, aux)):
    the LLaMA block with the fused projection and the expert FFN
    (``llama.project_qkv`` / ``llama.ffn`` dispatch on the config)."""
    return llama.forward(params, cfg, tokens, **kw)
