"""fp16/bf16 KV-cache decode baseline (port of
kvquant_tpu/baseline_fp16.py:24-143).

The comparison surface for the quantized engine: a preallocated
full-precision KV cache with the same static-shape decode structure, so
throughput ratios isolate the cost / benefit of KV quantization rather than
engine differences. Attention is plain PyTorch and, as in the JAX function,
casts the cache to fp32 (scores and values contract in fp32).

Differences from the JAX module: the cache is updated in place (and
returned); ``decode_step`` takes ``pos`` as an int or as an int32 tensor
on the card and then reads nothing back to the host, and
``decode_stepper`` replays it as one CUDA graph on a card (JAX's bench
jits the baseline's loop); ``prefill`` runs the model family's forward
(``models.get_forward``), so it also prefills an MoE model, where the JAX
function calls the Llama forward whatever the family and fails on MoE
parameters.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .device import resolve_device
from .models.config import ModelConfig
from .models import get_forward, llama


@dataclass
class Fp16Cache:
    k: torch.Tensor  # (L, B, Hkv, T, Dh) post-RoPE keys
    v: torch.Tensor  # (L, B, Hkv, T, Dh)
    length: torch.Tensor  # (B,) int32


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
    B, T0 = tokens.shape
    logits, aux = get_forward(cfg)(params, cfg, tokens, capture_kv=True,
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


def decode_step(params, cfg: ModelConfig, cache: Fp16Cache, token, pos):
    """Single-token decode against the fp16 cache at position ``pos``, the
    same for every sequence: an int, or a 0-d / (1,) int32 tensor on the
    cache's device (then the step reads nothing back to the host). One row
    written per layer in place (``index_copy_`` along the token axis),
    attention over positions 0..pos. Returns (cache, logits (B, V) fp32)."""
    B = token.shape[0]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // Hkv
    T = cache.k.shape[3]
    dev = params.embed.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).reshape(1)

    x = params.embed[token.to(dev).long()]
    cos, sin = llama.rope_cos_sin(pos, cfg)  # (1, Dh)
    valid = torch.arange(T, device=dev) <= pos
    row = pos.long()
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        q, k, v = llama.project_qkv(llama.norm(x, lp["ln_attn"], cfg), lp,
                                    cfg)
        q = q.reshape(B, Hkv, G, Dh).to(torch.float32)
        k = k.reshape(B, Hkv, Dh).to(torch.float32)
        v = v.reshape(B, Hkv, Dh)
        q = q * cos + llama.rotate_half(q) * sin
        k = k * cos + llama.rotate_half(k) * sin
        cache.k[li].index_copy_(2, row, k.to(cache.k.dtype)[:, :, None])
        cache.v[li].index_copy_(2, row, v.to(cache.v.dtype)[:, :, None])

        scores = torch.einsum("bhgd,bhtd->bhgt", q,
                              cache.k[li].to(torch.float32)) / (Dh ** 0.5)
        scores = scores.masked_fill(~valid, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhgt,bhtd->bhgd", probs,
                            cache.v[li].to(torch.float32))
        x = x + attn.reshape(B, H * Dh).to(x.dtype) @ lp["wo"]
        x = x + llama.ffn(llama.norm(x, lp["ln_mlp"], cfg), lp, cfg)

    x = llama.norm(x, params.final_norm, cfg)
    logits = (x @ params.head()).to(torch.float32)
    cache.length.copy_((pos + 1).expand_as(cache.length))
    return cache, logits


def first_row_keeper(cache: Fp16Cache):
    """Keep what a decode step at position 0 writes (row 0 of every
    layer's K and V, and the length); returns a function that puts it back
    in place (``ops.deployed.first_row_keeper``'s counterpart)."""
    kept = [(view, view.clone()) for view in
            (cache.k.narrow(3, 0, 1), cache.v.narrow(3, 0, 1), cache.length)]

    def restore():
        for view, old in kept:
            view.copy_(old)

    return restore


class DecodeGraph:
    """One baseline ``decode_step`` captured as a CUDA graph over a cache
    on a card (``engine.CapturedStep``): the counterpart of the JAX bench's
    jitted baseline step. Static (B,) int32 ``token`` and (1,) int32
    ``pos`` buffers; ``graph(token, pos)`` copies them in, replays (writing
    ``cache`` in place) and returns the (B, V) ``logits``, which the next
    call overwrites. The warm-up step runs at position 0 and what it wrote
    is put back (``first_row_keeper``). ``launches``, ``capture_s`` and
    ``pool_mib`` are the capture's. Raises ValueError for a cache that is
    not on a card and for the configurations that
    ``engine.graph_unsupported`` names; a capture that fails raises."""

    def __init__(self, params, cfg: ModelConfig, cache: Fp16Cache):
        from .engine import CapturedStep, graph_unsupported

        why = graph_unsupported(cfg)
        if why is not None:
            raise ValueError(f"baseline DecodeGraph: cannot capture {why}")
        dev = cache.k.device
        if dev.type != "cuda":
            raise ValueError(f"baseline DecodeGraph: the cache is on {dev}; "
                             f"a CUDA graph needs a card (call decode_step)")
        self.token = torch.zeros_like(cache.length)
        self.pos = torch.zeros((1,), dtype=torch.int32, device=dev)
        # the graph reads and writes these tensors' memory: they live as
        # long as it does
        self._inputs = (params, cache)

        def step():
            return decode_step(params, cfg, cache, self.token, self.pos)[1]

        self._captured = c = CapturedStep(step, dev, first_row_keeper(cache))
        self.logits, self.launches = c.out, c.launches
        self.capture_s, self.pool_mib = c.capture_s, c.pool_mib

    def __call__(self, token, pos):
        self.token.copy_(token)
        if isinstance(pos, int):
            self.pos.fill_(pos)
        else:
            self.pos.copy_(torch.as_tensor(pos).reshape(1))
        return self._captured.replay()


def decode_stepper(params, cfg: ModelConfig, cache: Fp16Cache):
    """``step(token, pos) -> logits (B, V)`` over ``cache``: a DecodeGraph
    when the cache lies on a card, unless ``engine.graph_unsupported(cfg)``
    names the configuration; else decode_step."""
    from .engine import graph_unsupported

    if cache.k.is_cuda and graph_unsupported(cfg) is None:
        return DecodeGraph(params, cfg, cache)
    return lambda token, pos: decode_step(params, cfg, cache, token, pos)[1]
