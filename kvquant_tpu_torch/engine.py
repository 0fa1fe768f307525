"""Deployed inference engine over the quantized KV cache (port of
kvquant_tpu/engine.py: prefill, decode_step, generate, deployed_ppl).

  - ``prefill``: one full-precision forward over the prompt that captures
    the pre-RoPE K/V and packs every layer's cache (ops.deployed.prefill_pack).
  - ``decode_step``: one token through every layer; ``dcfg.kernel`` picks
    the datapath: "xla" (the eager oracle) and "pallas" (the two-pass
    Hopper kernels K3 qk_fused / K4 pv_fused) run the per-layer
    ops.deployed.decode_attention; "flash" (row-level append + the Hopper
    kernel K1, flash_decode) and "flash_serial" (row-level append + K2)
    append into and attend over the stacked arrays.
  - ``prefill_chunk`` / ``prefill_quantized``: chunked prefill through the
    quantized datapath (ops.deployed.block_attention: K1 with Tq > 1 under
    "flash" / "flash_serial", K3 / K4 under "pallas"); the JAX engine's
    chunk scan is a Python loop.
  - ``generate`` / ``deployed_ppl``: Python loops over decode_step.

The cache is updated in place (the JAX engine threads an immutable pytree).
Positions are host integers; the JAX engine's ``lax.scan`` loops become
Python loops. Entry points that allocate take ``device`` (default "cuda",
which raises when no card is present).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .cache import (KVCache, DeployConfig, DeployedQuant, create_cache,
                    check_intn_codebook, k_channel_index)
from .models.config import ModelConfig
from .models import llama
from .ops import deployed


def _check_kernel(dcfg: DeployConfig):
    if dcfg.kernel not in ("xla", "pallas", "flash", "flash_serial"):
        raise ValueError(f"unknown kernel {dcfg.kernel!r}")


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def prefill(params, cfg: ModelConfig, dcfg: DeployConfig, dq: DeployedQuant,
            cache: KVCache, tokens):
    """Full-precision prompt forward + parallel pack of every layer's cache
    (in place). tokens (B, T0) int. Returns (cache, logits_last (B, V))."""
    check_intn_codebook(dcfg, dq)
    logits, aux = llama.forward(params, cfg, tokens, capture_kv=True)
    for li in range(cfg.n_layers):
        deployed.prefill_pack(cache.layer(li), dq.layer(li), dcfg, cfg,
                              aux["k_acts"][li], aux["v_acts"][li])
    return cache, logits[:, -1].to(torch.float32)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _mlp(x, lp, cfg):
    h = llama.norm(x, lp["ln_mlp"], cfg)
    return x + (torch.nn.functional.silu(h @ lp["w_gate"])
                * (h @ lp["w_up"])) @ lp["w_down"]


def _logits(params, x, cfg):
    x = llama.norm(x, params.final_norm, cfg)
    return (x @ params.head()).to(torch.float32)


def decode_step(params, cfg: ModelConfig, dcfg: DeployConfig,
                dq: DeployedQuant, cache: KVCache, token, pos):
    """Append ``token`` (B,) at ``pos`` (int, or B ints) to every layer's
    cache in place and return (cache, logits (B, V) fp32) for the next
    position."""
    _check_kernel(dcfg)
    check_intn_codebook(dcfg, dq)
    if dcfg.kernel in ("flash", "flash_serial"):
        return _decode_step_flash(params, cfg, dcfg, dq, cache, token, pos)

    B = token.shape[0]
    H, Dh = cfg.n_heads, cfg.d_head
    x = params.embed[token.to(params.embed.device).long()]
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        h = llama.norm(x, lp["ln_attn"], cfg)
        q = (h @ lp["wq"]).reshape(B, H, Dh)
        k = h @ lp["wk"]
        v = h @ lp["wv"]
        _, attn = deployed.decode_attention(cache.layer(li), dq.layer(li),
                                            dcfg, cfg, q, k, v, pos)
        x = x + attn.reshape(B, H * Dh).to(x.dtype) @ lp["wo"]
        x = _mlp(x, lp, cfg)
    return cache, _logits(params, x, cfg)


def _decode_step_flash(params, cfg: ModelConfig, dcfg: DeployConfig,
                       dq: DeployedQuant, cache: KVCache, token, pos):
    """decode_step for kernel="flash" (K1, flash_decode) and "flash_serial"
    (K2): per layer a row-level append into the stacked (L, ...) arrays,
    then the kernel over layer ``li`` of those arrays (no layer slice of the
    cache is copied)."""
    from .ops.kernels.flash_decode import flash_decode
    from .ops.kernels.flash_serial import flash_serial_decode

    attn_fn = (flash_serial_decode if dcfg.kernel == "flash_serial"
               else flash_decode)

    B = token.shape[0]
    H, Dh, Hkv = cfg.n_heads, cfg.d_head, cfg.n_kv_heads
    G = H // Hkv
    dev = params.embed.device
    pl = deployed.host_positions(pos, B)
    posb = torch.tensor(pl, dtype=torch.int32, device=dev)
    cos, sin = llama.rope_cos_sin(posb, cfg)  # (B, Dh)
    k_chan = None
    if dcfg.include_sparse and dcfg.k_outliers == "channels":
        k_chan = k_channel_index(dq.k_ressc, dcfg).to(torch.int32)

    arrs = cache.arrays()
    x = params.embed[token.to(dev).long()]
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        h = llama.norm(x, lp["ln_attn"], cfg)
        q = (h @ lp["wq"]).reshape(B, H, Dh)
        k = h @ lp["wk"]
        v = h @ lp["wv"]
        deployed.append_token_flash(arrs, dq.layer(li), dcfg, cfg, k, v,
                                    pos, li)
        q_h = q.reshape(B, Hkv, G, Dh).to(torch.float32)
        q_rot = q_h * cos[:, None, None] + (
            llama.rotate_half(q_h) * sin[:, None, None])
        attn = attn_fn(
            q_rot, arrs["k_planes"], arrs["v_planes"], arrs["kv_out"],
            dq.k_range, dq.k_offset, arrs["v_scale"], arrs["v_offset"],
            arrs["k_sink"], arrs["v_sink"], dq.k_lut_dec, dq.v_lut_dec,
            li, posb, dcfg, cfg, k_ressc=dq.k_ressc, k_chan=k_chan,
        )  # (B, Hkv, G, Dh)
        x = x + attn.reshape(B, H * Dh).to(x.dtype) @ lp["wo"]
        x = _mlp(x, lp, cfg)
    cache.length.copy_(posb + 1)
    return cache, _logits(params, x, cfg)


# ---------------------------------------------------------------------------
# generation loop
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int
    temperature: float = 0.0  # 0 => greedy
    top_p: float = 1.0
    eos_token_id: int | None = None


def _sample(logits, gcfg: GenerateConfig, generator=None):
    """Greedy argmax, or temperature / top-p sampling from ``generator``
    (torch's draws differ from jax.random.categorical's: only greedy
    decoding matches the JAX engine token for token)."""
    if gcfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / gcfg.temperature
    if gcfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = torch.sum(cum < gcfg.top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def generate(params, cfg: ModelConfig, dcfg: DeployConfig, dq: DeployedQuant,
             prompt, gcfg: GenerateConfig, *, cache: KVCache | None = None,
             generator: torch.Generator | None = None,
             prefill_mode: str = "fp16", device="cuda"):
    """Prefill + ``max_new_tokens`` decode steps. Returns (tokens (B, N)
    int32, cache). Positions past ``dcfg.max_len`` or after EOS emit
    ``eos`` (or 0). ``device`` places a cache created here.
    ``prefill_mode`` "fp16" packs a full-precision prompt forward (the
    reference's semantics); "quantized" runs ``prefill_quantized``."""
    if prefill_mode not in ("fp16", "quantized"):
        raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
    _check_kernel(dcfg)
    B, T0 = prompt.shape
    if cache is None:
        cache = create_cache(dcfg, cfg.n_layers, B, device=device)
    prompt = prompt.to(cache.length.device)
    if prefill_mode == "quantized":
        cache, logits = prefill_quantized(params, cfg, dcfg, dq, cache, prompt)
    else:
        cache, logits = prefill(params, cfg, dcfg, dq, cache, prompt)

    pad_id = gcfg.eos_token_id if gcfg.eos_token_id is not None else 0
    done = torch.zeros((B,), dtype=torch.bool, device=logits.device)
    toks = []
    for i in range(gcfg.max_new_tokens):
        pos = T0 + i
        tok = _sample(logits, gcfg, generator)
        tok = torch.where(done, torch.full_like(tok, pad_id), tok)
        cache, logits = decode_step(params, cfg, dcfg, dq, cache, tok, pos)
        done = done | (pos + 1 >= dcfg.max_len)
        if gcfg.eos_token_id is not None:
            done = done | (tok == gcfg.eos_token_id)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache


# ---------------------------------------------------------------------------
# deployed perplexity check (token-by-token decode over the quantized cache,
# accumulating next-token NLL)
# ---------------------------------------------------------------------------


def deployed_ppl(params, cfg: ModelConfig, dcfg: DeployConfig,
                 dq: DeployedQuant, tokens, *, prefill_tokens: int = 0,
                 device="cuda") -> float:
    """Perplexity of ``tokens`` (B, T) decoded token by token through the
    quantized cache; ``prefill_tokens`` > sink runs that prefix through the
    fp16 prefill first."""
    _check_kernel(dcfg)
    B, T = tokens.shape
    cache = create_cache(dcfg, cfg.n_layers, B, device=device)
    tokens = tokens.to(cache.length.device)
    if prefill_tokens > dcfg.sink:
        t0 = prefill_tokens
        cache, logits = prefill(params, cfg, dcfg, dq, cache, tokens[:, :t0])
    else:
        t0 = 1
        cache, logits = decode_step(params, cfg, dcfg, dq, cache,
                                    tokens[:, 0], 0)
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for t in range(t0, T):
        tgt = tokens[:, t]
        logp = torch.log_softmax(logits, dim=-1)
        total = total - torch.gather(logp, -1, tgt[:, None].long())[:, 0].sum()
        cache, logits = decode_step(params, cfg, dcfg, dq, cache, tgt, t)
    n = (T - t0) * B
    return float(torch.exp(total / n))


# ---------------------------------------------------------------------------
# quantized-trajectory chunked prefill: each chunk attends over the already
# quantized cache, so the prompt's KV follows the same trajectory as
# token-by-token decode, at block throughput
# ---------------------------------------------------------------------------


def prefill_chunk(params, cfg: ModelConfig, dcfg: DeployConfig,
                  dq: DeployedQuant, cache: KVCache, tok_blk, pos0: int,
                  sink_fill: bool):
    """One chunk of quantized prefill: embed, every layer's block_attention
    (pack + attend over the quantized cache, in place), the MLP. tok_blk
    (B, Tq) holds the chunk's tokens (after the ``sink`` leading sink
    tokens when ``sink_fill``); ``pos0`` is the absolute position of its
    first non-sink token. Returns (cache, logits (B, Tq, V) fp32)."""
    _check_kernel(dcfg)
    B, T = tok_blk.shape
    H, Dh = cfg.n_heads, cfg.d_head
    x = params.embed[tok_blk.to(params.embed.device).long()]
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        h = llama.norm(x, lp["ln_attn"], cfg)
        q = (h @ lp["wq"]).reshape(B, T, H, Dh)
        k = h @ lp["wk"]
        v = h @ lp["wv"]
        _, attn = deployed.block_attention(cache.layer(li), dq.layer(li),
                                           dcfg, cfg, q, k, v, pos0,
                                           sink_fill=sink_fill)
        x = x + attn.to(x.dtype) @ lp["wo"]
        x = _mlp(x, lp, cfg)
    return cache, _logits(params, x, cfg)


def prefill_quantized(params, cfg: ModelConfig, dcfg: DeployConfig,
                      dq: DeployedQuant, cache: KVCache, tokens,
                      chunk: int = 256, max_scan_chunks: int | None = None):
    """Chunked prefill through the quantized datapath (in place). Returns
    (cache, logits_last (B, V) fp32). Pad tokens beyond T0 (to reach chunk
    alignment) are packed but masked from every real query and overwritten
    by later decode steps. ``max_scan_chunks`` splits the JAX engine's
    device scan into host dispatches; the chunks here run as a Python loop
    already, so it is accepted and has no effect."""
    check_intn_codebook(dcfg, dq)
    B, T0 = tokens.shape
    S = dcfg.sink
    assert T0 > S, "prompt must extend beyond the sink prefix"
    assert chunk % 128 == 0
    n_pack = T0 - S
    n_chunks = -(-n_pack // chunk)
    assert n_chunks * chunk <= dcfg.cache_tokens, (
        f"prompt needs {n_chunks * chunk} packed tokens (chunk-aligned) but "
        f"cache holds {dcfg.cache_tokens}")
    toks = torch.nn.functional.pad(tokens.to(cache.length.device),
                                   (0, n_chunks * chunk - n_pack))
    # chunk 0 carries the sink prefix
    cache, logits = prefill_chunk(params, cfg, dcfg, dq, cache,
                                  toks[:, :S + chunk], S, True)
    for c in range(1, n_chunks):
        start = S + c * chunk
        cache, logits = prefill_chunk(params, cfg, dcfg, dq, cache,
                                      toks[:, start:start + chunk], start,
                                      False)
    # logits of the last REAL token (pad-safe)
    last = (T0 - 1) - (S + (n_chunks - 1) * chunk) if n_chunks > 1 \
        else T0 - 1
    cache.length.fill_(T0)
    return cache, logits[:, last]
