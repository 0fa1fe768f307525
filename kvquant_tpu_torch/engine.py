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
    "flash" / "flash_serial", K3 / K4 under "pallas") at a device ``pos0``;
    on a card the chunks after the first replay one ``ChunkGraph`` (for a
    prompt of ``CHUNK_GRAPH_MIN_REPLAYS`` + 2 chunks or more), where the
    JAX engine scans its jitted chunk.
  - ``DecodeGraph``: one decode step captured as a CUDA graph, the
    counterpart of the JAX engine's ``jax.jit(decode_step)``: static token
    and position buffers, one replay per step.
  - ``generate`` / ``deployed_ppl``: Python loops over one DecodeGraph on
    a card (over decode_step on the CPU, and for the configurations a
    graph cannot capture: tp > 1); sampling, EOS and ``done`` stay outside
    the graph.

Both model families run here, and both are captured: the MoE family's
fused projection and expert FFN come in through ``models.llama.
project_qkv`` / ``ffn`` (the JAX engine's ``is_moe`` branches), and its
capacity dispatch runs on the device (``models.moe.moe_ffn_sparse``).

Tensor parallelism: with rank-local params and configs
(``parallel.shardings``), every entry point runs this rank's heads and its
part of the FFN over its shard of the cache, and sums the row-sharded
output projections over the tp group where GSPMD inserts that sum in the
JAX engine (after ``wo`` here, after the FFN in ``llama.ffn``); the V
range is exchanged inside ``ops.deployed.quantize_v``. The logits come out
whole on every rank of a tp group.

The cache is updated in place (the JAX engine threads an immutable pytree).
A decode step takes its positions as a (B,) int32 tensor on the cache's
device and reads nothing back to the host; the JAX engine's ``lax.scan``
over layers is a Python loop inside the captured step, its scan over steps
a loop of replays. Entry points that allocate take ``device`` (default
"cuda", which raises when no card is present).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from .cache import (KVCache, DeployConfig, DeployedQuant, create_cache,
                    check_intn_codebook, static_channels)
from .models.config import ModelConfig
from .models import get_forward, llama
from .ops import deployed
from .parallel.collectives import row_parallel, tp_group
from .utils.profiling import SPANS


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
    logits, aux = get_forward(cfg)(params, cfg, tokens, capture_kv=True)
    for li in range(cfg.n_layers):
        deployed.prefill_pack(cache.layer(li), dq.layer(li), dcfg, cfg,
                              aux["k_acts"][li], aux["v_acts"][li])
    return cache, logits[:, -1].to(torch.float32)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _mlp(x, lp, cfg):
    """x plus the feed-forward block (SwiGLU, or the MoE family's experts;
    summed over the tp group in ``llama.ffn`` under a rank-local config)."""
    return x + llama.ffn(llama.norm(x, lp["ln_mlp"], cfg), lp, cfg)


def _logits(params, x, cfg):
    x = llama.norm(x, params.final_norm, cfg)
    return (x @ params.head()).to(torch.float32)


def decode_step(params, cfg: ModelConfig, dcfg: DeployConfig,
                dq: DeployedQuant, cache: KVCache, token, pos, *,
                k_chan=None):
    """Append ``token`` (B,) at ``pos`` to every layer's cache in place and
    return (cache, logits (B, V) fp32) for the next position. ``pos`` is a
    (B,) int32 tensor on the cache's device (an int or B ints are
    converted once); the step reads nothing back to the host. ``k_chan``:
    the static K channels (``static_channels``), computed here when not
    given (``decode_stepper`` computes them once)."""
    _check_kernel(dcfg)
    check_intn_codebook(dcfg, dq)
    B = token.shape[0]
    pos = deployed.device_positions(pos, B, cache.length.device)
    if k_chan is None:
        k_chan = static_channels(dq, dcfg)
    if dcfg.kernel in ("flash", "flash_serial"):
        return _decode_step_flash(params, cfg, dcfg, dq, cache, token, pos,
                                  k_chan)

    H, Dh = cfg.n_heads, cfg.d_head
    rows = deployed.token_rows(pos, dcfg)
    cos_sin = llama.rope_cos_sin(pos, cfg)
    x = params.embed[token.to(params.embed.device).long()]
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        q, k, v = llama.project_qkv(llama.norm(x, lp["ln_attn"], cfg), lp,
                                    cfg)
        q = q.reshape(B, H, Dh)
        _, attn = deployed.decode_attention(
            cache.layer(li), dq.layer(li), dcfg, cfg, q, k, v, pos,
            rows=rows, cos_sin=cos_sin,
            k_chan=None if k_chan is None else k_chan[li])
        x = x + row_parallel(attn.reshape(B, H * Dh).to(x.dtype),
                             lp["wo"], tp_group(cfg))
        x = _mlp(x, lp, cfg)
    return cache, _logits(params, x, cfg)


def _decode_step_flash(params, cfg: ModelConfig, dcfg: DeployConfig,
                       dq: DeployedQuant, cache: KVCache, token, pos,
                       k_chan):
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
    cos, sin = llama.rope_cos_sin(pos, cfg)  # (B, Dh)
    rows = deployed.token_rows(pos, dcfg)
    k_chan32 = None if k_chan is None else k_chan.to(torch.int32)

    arrs = cache.arrays()
    x = params.embed[token.to(dev).long()]
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        q, k, v = llama.project_qkv(llama.norm(x, lp["ln_attn"], cfg), lp,
                                    cfg)
        q = q.reshape(B, H, Dh)
        deployed.append_token_flash(
            arrs, dq.layer(li), dcfg, cfg, k, v, pos, li, rows=rows,
            cos_sin=(cos, sin), k_chan=None if k_chan is None else k_chan[li])
        q_h = q.reshape(B, Hkv, G, Dh).to(torch.float32)
        q_rot = q_h * cos[:, None, None] + (
            llama.rotate_half(q_h) * sin[:, None, None])
        attn = attn_fn(
            q_rot, arrs["k_planes"], arrs["v_planes"], arrs["kv_out"],
            dq.k_range, dq.k_offset, arrs["v_scale"], arrs["v_offset"],
            arrs["k_sink"], arrs["v_sink"], dq.k_lut_dec, dq.v_lut_dec,
            li, pos, dcfg, cfg, k_ressc=dq.k_ressc, k_chan=k_chan32,
        )  # (B, Hkv, G, Dh)
        x = x + row_parallel(attn.reshape(B, H * Dh).to(x.dtype),
                             lp["wo"], tp_group(cfg))
        x = _mlp(x, lp, cfg)
    cache.length.copy_(pos + 1)
    return cache, _logits(params, x, cfg)


# ---------------------------------------------------------------------------
# the compiled decode step: one CUDA graph per decode step
# ---------------------------------------------------------------------------


def graph_unsupported(cfg: ModelConfig) -> str | None:
    """Why a decode step of ``cfg`` cannot be captured in a CUDA graph, or
    None when it can (both model families at tp 1)."""
    if tp_group(cfg) is not None:
        return ("tensor parallelism: the tp group's collectives run over "
                "gloo on the host")
    return None


# eager steps before a capture (torch.cuda.graphs asks for warm-up on a side
# stream): the first loads the kernel libraries and sets up cuBLAS
_WARMUP_STEPS = 1


class CapturedStep:
    """``step()`` captured as one CUDA graph on the card ``dev``: the
    counterpart of ``jax.jit``. The graph reads and writes the memory of
    the tensors ``step`` closes over, so they must live as long as it.

    Before the capture, ``_WARMUP_STEPS`` eager calls run on a side stream,
    then ``restore()`` (when given) puts back what they wrote. They load the
    kernel libraries, set the kernels' shared-memory limits, build the
    cached tables and set up cuBLAS; their launches are not counted
    (``setup_launches`` keeps them). The capture's launches (``launches``)
    are added to the counters at each replay (``ops.kernels.add_launches``):
    they are the wrapper calls a replay makes. ``out`` is what ``step()``
    returned while captured, overwritten by each replay; ``capture_s`` the
    wall time of the warm-up and the capture, ``pool_mib`` the memory the
    graph's private pool took (its growth, where ``pool``, a
    ``torch.cuda.graph_pool_handle()``, is shared with graphs that never
    replay at the same time). A capture that fails raises."""

    def __init__(self, step, dev: torch.device, restore=None, pool=None):
        from .ops.kernels import counted

        t0 = time.perf_counter()

        def warm():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(_WARMUP_STEPS):
                    out = step()
            torch.cuda.current_stream(dev).wait_stream(side)
            if restore is not None:
                restore()
            torch.cuda.synchronize(dev)
            return out

        self.warm_out, self.setup_launches = counted(warm)
        # torch.cuda.graph empties the allocator's cache as it enters; so
        # does this, first, so that the growth is the graph's own pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(self.graph, pool=pool):
                return step()

        self.out, self.launches = counted(capture)
        torch.cuda.synchronize(dev)
        self.pool_mib = (torch.cuda.memory_reserved(dev) - reserved) / 2 ** 20
        self.capture_s = time.perf_counter() - t0

    def replay(self):
        """Replay the step and count its launches; returns ``out``. The
        serving path's recorder marks the launch (``SPANS.launch``)."""
        from .ops.kernels import add_launches

        SPANS.launch()
        self.graph.replay()
        add_launches(self.launches)
        return self.out


def _hold_rope_table(cfg: ModelConfig, dcfg: DeployConfig, cache_tokens: int,
                     dev):
    """The RoPE table the kernels read under pre-RoPE keys (K1, K5 and
    K3 / K4 rotate in the kernel), or None. The kernels take it from a
    bounded cache of tables; a graph holds this reference so that its table
    outlives eviction."""
    from .ops.kernels.flash_decode import rope_table

    if dcfg.kernel == "pallas" or (dcfg.kernel == "flash"
                                   and not dcfg.post_rope_k):
        return rope_table(cfg, dcfg.sink, cache_tokens, dev)
    return None


class DecodeGraph:
    """One ``decode_step`` captured as a CUDA graph over a cache on a card
    (``CapturedStep``): the counterpart of ``jax.jit(decode_step)``.

    It holds static (B,) int32 ``token`` and ``pos`` buffers (B is the
    cache's batch) and the step's ``logits`` (B, V) fp32. ``graph(token,
    pos)`` copies the inputs in, replays the step (which appends to
    ``cache`` in place, as decode_step does) and returns ``logits``, which
    the next call overwrites. ``pos`` is an int, B ints or a tensor.

    The warm-up steps run over the cache itself at position S
    (``dcfg.sink``); what they write (``ops.deployed.first_row_keeper``) is
    put back after them. ``launches``, ``setup_launches``, ``capture_s``
    and ``pool_mib`` are the capture's (``CapturedStep``).

    Raises ValueError for a cache that is not on a card and for the
    configurations ``graph_unsupported`` names; a capture that fails
    raises. Nothing falls back to the eager step."""

    def __init__(self, params, cfg: ModelConfig, dcfg: DeployConfig,
                 dq: DeployedQuant, cache: KVCache):
        _check_kernel(dcfg)
        why = graph_unsupported(cfg)
        if why is not None:
            raise ValueError(f"DecodeGraph: cannot capture {why}")
        dev = cache.length.device
        if dev.type != "cuda":
            raise ValueError(f"DecodeGraph: the cache is on {dev}; a CUDA "
                             f"graph needs a card (call decode_step)")
        t0 = time.perf_counter()
        k_chan = static_channels(dq, dcfg)
        self.token = torch.zeros_like(cache.length)
        self.pos = torch.full_like(cache.length, dcfg.sink)
        self._rope = _hold_rope_table(cfg, dcfg, dcfg.cache_tokens, dev)
        # the graph reads and writes these tensors' memory: they live as
        # long as it does
        self._inputs = (params, dq, cache, k_chan)

        def step():
            return decode_step(params, cfg, dcfg, dq, cache, self.token,
                               self.pos, k_chan=k_chan)[1]

        self._captured = CapturedStep(step, dev,
                                      deployed.first_row_keeper(cache))
        c = self._captured
        self.logits, self.launches = c.out, c.launches
        self.setup_launches, self.pool_mib = c.setup_launches, c.pool_mib
        self.capture_s = time.perf_counter() - t0

    def __call__(self, token, pos):
        self.token.copy_(token)
        if isinstance(pos, int):
            self.pos.fill_(pos)
        else:
            self.pos.copy_(torch.as_tensor(pos, dtype=torch.int32))
        return self._captured.replay()


def decode_stepper(params, cfg: ModelConfig, dcfg: DeployConfig,
                   dq: DeployedQuant, cache: KVCache):
    """``step(token, pos) -> logits (B, V)`` over ``cache``: a DecodeGraph
    when the cache lies on a card, unless ``graph_unsupported(cfg)`` (tp >
    1); else decode_step, with the static K channels computed once."""
    if cache.length.is_cuda and graph_unsupported(cfg) is None:
        return DecodeGraph(params, cfg, dcfg, dq, cache)
    k_chan = static_channels(dq, dcfg)

    def step(token, pos):
        SPANS.launch()
        return decode_step(params, cfg, dcfg, dq, cache, token, pos,
                           k_chan=k_chan)[1]
    return step


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
    """Prefill + ``max_new_tokens`` decode steps (``decode_stepper``: one
    DecodeGraph on a card). Returns (tokens (B, N) int32, cache).
    Positions past ``dcfg.max_len`` or after EOS emit ``eos`` (or 0); the
    sampling, with the caller's ``generator``, runs outside the graph.
    ``device`` places a cache created here.
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
    step = decode_stepper(params, cfg, dcfg, dq, cache) \
        if gcfg.max_new_tokens else None
    for i in range(gcfg.max_new_tokens):
        pos = T0 + i
        tok = _sample(logits, gcfg, generator)
        tok = torch.where(done, torch.full_like(tok, pad_id), tok)
        logits = step(tok, pos)
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
    quantized cache (``decode_stepper``: one DecodeGraph on a card);
    ``prefill_tokens`` > sink runs that prefix through the fp16 prefill
    first."""
    _check_kernel(dcfg)
    B, T = tokens.shape
    cache = create_cache(dcfg, cfg.n_layers, B, device=device)
    tokens = tokens.to(cache.length.device)
    prefilled = prefill_tokens > dcfg.sink
    t0 = prefill_tokens if prefilled else 1
    if prefilled:
        cache, logits = prefill(params, cfg, dcfg, dq, cache, tokens[:, :t0])
    step = decode_stepper(params, cfg, dcfg, dq, cache)
    if not prefilled:
        logits = step(tokens[:, 0], 0)
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for t in range(t0, T):
        tgt = tokens[:, t]
        logp = torch.log_softmax(logits, dim=-1)
        total = total - torch.gather(logp, -1, tgt[:, None].long())[:, 0].sum()
        logits = step(tgt, t)
    n = (T - t0) * B
    return float(torch.exp(total / n))


# ---------------------------------------------------------------------------
# quantized-trajectory chunked prefill: each chunk attends over the already
# quantized cache, so the prompt's KV follows the same trajectory as
# token-by-token decode, at block throughput
# ---------------------------------------------------------------------------


def prefill_chunk(params, cfg: ModelConfig, dcfg: DeployConfig,
                  dq: DeployedQuant, cache: KVCache, tok_blk, pos0,
                  sink_fill: bool, row=None):
    """One chunk of quantized prefill: embed, every layer's block_attention
    (pack + attend over the quantized cache, in place), the MLP. tok_blk
    (B, Tq) holds the chunk's tokens (after the ``sink`` leading sink
    tokens when ``sink_fill``); ``pos0`` is the absolute position of its
    first non-sink token, an int or a 0-d / (1,) int32 tensor on the
    cache's device (then the chunk reads nothing back to the host, and
    its caller checks that the chunk fits the cache; an int is checked
    here and made a tensor once for every layer). Returns (cache, logits
    (B, Tq, V) fp32), or with ``row`` (an index into the chunk's Tq
    rows: an int, or a 0-d int32 tensor on the cache's device) the final
    norm and LM head of that row alone, (B, V) fp32."""
    _check_kernel(dcfg)
    B, T = tok_blk.shape
    pos0 = deployed.block_pos0(pos0, T - (dcfg.sink if sink_fill else 0),
                               dcfg, cache.length.device)
    H, Dh = cfg.n_heads, cfg.d_head
    x = params.embed[tok_blk.to(params.embed.device).long()]
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        q, k, v = llama.project_qkv(llama.norm(x, lp["ln_attn"], cfg), lp,
                                    cfg)
        q = q.reshape(B, T, H, Dh)
        _, attn = deployed.block_attention(cache.layer(li), dq.layer(li),
                                           dcfg, cfg, q, k, v, pos0,
                                           sink_fill=sink_fill)
        x = x + row_parallel(attn.to(x.dtype), lp["wo"], tp_group(cfg))
        x = _mlp(x, lp, cfg)
    if row is not None:
        x = x[:, row] if isinstance(row, int) else x.index_select(
            1, row.reshape(1))[:, 0]
    return cache, _logits(params, x, cfg)


class ChunkGraph:
    """One ``prefill_chunk`` captured as a CUDA graph over a cache on a card
    (``CapturedStep``): the counterpart of the JAX engine's jitted chunk,
    ``sink_fill`` static, and of its ``rest_chunks`` scan body.

    It holds static (B, Tq_all) int32 ``tokens`` and 0-d int32 ``pos0``
    buffers and the chunk's ``logits`` (B, Tq_all, V) fp32. It is built
    from the first chunk it runs, ``tok_blk`` at ``pos0``: the warm-up is
    that real chunk, so nothing is put back, its launches are counted, and
    ``first`` holds its logits. ``graph(tok_blk, pos0)`` then copies a
    chunk in, replays (writing ``cache`` in place, as prefill_chunk does)
    and returns ``logits``, which the next call overwrites. K1's split
    count depends on the capacity, not on ``pos0``, so one capture serves
    every position. ``launches``, ``setup_launches``, ``capture_s`` and
    ``pool_mib`` are the capture's.

    With ``row`` (an int: the first chunk's row) the graph computes the
    logits of one row alone (``prefill_chunk``'s ``row``), picked by a
    0-d int32 buffer ``row`` that each call loads (``graph(tok_blk,
    pos0, row)``), so one capture serves every row; ``logits`` is then
    (B, V).

    Graphs that take turns over one memory (``serve.AdmissionCache``) pass
    ``out``, a fp32 buffer on the card of the logits' shape that they are
    copied into (``logits`` and ``first`` are then that buffer), and
    ``pool``, a graph pool handle they share.

    Raises ValueError for a cache that is not on a card and for the
    configurations ``graph_unsupported`` names; a capture that fails
    raises. Nothing falls back to the eager chunk."""

    def __init__(self, params, cfg: ModelConfig, dcfg: DeployConfig,
                 dq: DeployedQuant, cache: KVCache, tok_blk, pos0,
                 sink_fill: bool, out: torch.Tensor | None = None,
                 pool=None, row: int | None = None):
        from .ops.kernels import add_launches

        _check_kernel(dcfg)
        why = graph_unsupported(cfg)
        if why is not None:
            raise ValueError(f"ChunkGraph: cannot capture {why}")
        dev = cache.length.device
        if dev.type != "cuda":
            raise ValueError(f"ChunkGraph: the cache is on {dev}; a CUDA "
                             f"graph needs a card (call prefill_chunk)")
        t0 = time.perf_counter()
        self.tokens = torch.zeros(tuple(tok_blk.shape), dtype=torch.int32,
                                  device=dev)
        self.pos0 = torch.zeros((), dtype=torch.int32, device=dev)
        self.row = None if row is None else torch.zeros(
            (), dtype=torch.int32, device=dev)
        self._load(tok_blk, pos0, row)
        self._rope = _hold_rope_table(cfg, dcfg, dcfg.cache_tokens, dev)
        # the graph reads and writes these tensors' memory: they live as
        # long as it does
        self._inputs = (params, dq, cache)

        def step():
            logits = prefill_chunk(params, cfg, dcfg, dq, cache, self.tokens,
                                   self.pos0, sink_fill, self.row)[1]
            return logits if out is None else out.copy_(logits)

        self._captured = c = CapturedStep(step, dev, pool=pool)
        add_launches(c.setup_launches)  # the warm-up ran the real chunk
        self.first = c.warm_out
        self.logits, self.launches = c.out, c.launches
        self.setup_launches, self.pool_mib = c.setup_launches, c.pool_mib
        self.capture_s = time.perf_counter() - t0

    def _load(self, tok_blk, pos0, row=None):
        self.tokens.copy_(tok_blk)
        if isinstance(pos0, int):
            self.pos0.fill_(pos0)
        else:
            self.pos0.copy_(torch.as_tensor(pos0).reshape(()))
        if self.row is not None:
            self.row.fill_(row)

    def __call__(self, tok_blk, pos0, row: int | None = None):
        self._load(tok_blk, pos0, row)
        return self._captured.replay()


# the replays a prompt must leave (its chunks beyond the first two, the
# eager sink chunk and the graph's warm-up) before prefill_quantized
# captures a ChunkGraph: a shorter prompt runs its chunks eagerly, since
# the capture would cost more than its replays save. chip_smoke.py phase
# 30 times prompts of 2 to 5 chunks of 256 both ways at LLaMA-2-7B width
# on an H100: eager was faster at 2 and 3 chunks, at 4 on the "pallas"
# route, and the graph at 5 on every route.
CHUNK_GRAPH_MIN_REPLAYS = 3


def chunk_graphable(cache: KVCache, cfg: ModelConfig) -> bool:
    """Whether the chunks over ``cache`` run through a ChunkGraph: the
    cache lies on a card and ``graph_unsupported(cfg)`` is None."""
    return cache.length.is_cuda and graph_unsupported(cfg) is None


def prefill_quantized(params, cfg: ModelConfig, dcfg: DeployConfig,
                      dq: DeployedQuant, cache: KVCache, tokens,
                      chunk: int = 256, max_scan_chunks: int | None = None):
    """Chunked prefill through the quantized datapath (in place). Returns
    (cache, logits_last (B, V) fp32). Pad tokens beyond T0 (to reach chunk
    alignment) are packed but masked from every real query and overwritten
    by later decode steps. Chunk 0, which carries the sink prefix, runs
    eagerly: it runs once. On a card (``chunk_graphable``) the rest go
    through one ``ChunkGraph`` of the ``chunk``-token chunk, the JAX
    engine's scan: its warm-up is chunk 1, chunks 2... are replays at
    device positions. Elsewhere, and for a prompt that leaves fewer than
    ``CHUNK_GRAPH_MIN_REPLAYS`` replays, they run as prefill_chunk
    calls.
    ``max_scan_chunks`` splits the JAX engine's device scan into host
    dispatches; the replays here are dispatched one by one already, so it
    is accepted and has no effect."""
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
    blk = lambda c: toks[:, S + c * chunk:S + (c + 1) * chunk]  # noqa: E731
    if n_chunks - 2 >= CHUNK_GRAPH_MIN_REPLAYS and \
            chunk_graphable(cache, cfg):
        graph = ChunkGraph(params, cfg, dcfg, dq, cache, blk(1), S + chunk,
                           False)
        logits = graph.first
        for c in range(2, n_chunks):
            logits = graph(blk(c), S + c * chunk)
    else:
        for c in range(1, n_chunks):
            cache, logits = prefill_chunk(params, cfg, dcfg, dq, cache,
                                          blk(c), S + c * chunk, False)
    # logits of the last REAL token (pad-safe)
    last = (T0 - 1) - (S + (n_chunks - 1) * chunk) if n_chunks > 1 \
        else T0 - 1
    cache.length.fill_(T0)
    return cache, logits[:, last].clone()  # the graph's buffer goes with it
