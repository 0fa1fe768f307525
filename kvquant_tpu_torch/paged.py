"""Paged quantized KV cache and the paged continuous-batching server (port of
kvquant_tpu/paged.py).

The packed cache is a POOL of ``page_tokens``-token pages shared by all
slots; a slot holds a row of a (n_slots, MP) int32 page table, and memory
is consumed in proportion to the tokens actually cached. Retired slots
return their pages to the free list. Pages are cross-layer: pool arrays
carry (L, NP, ...) and page ``i`` holds the same token range in every
layer.

Layout per storage mode (cache.py's with the batch axis replaced by the
page axis):
  nuq : k/v_planes (L, NP, Hkv, bits, P//32, D) int32
  intN: k/v_planes (L, NP, Hkv, P, Dc) uint8 nibble pairs / int8
  kv_out (L, NP, n_groups, J, P) fp32 ; v_scale / v_offset (L, NP, P)
  sinks stay per slot: (L, B, Hkv, S, D) fp32

Attention goes through ``paged_flash_decode`` (the K5 kernel, K1's body
addressed through the page table; ``ops/kernels/paged_decode.py``).

Differences from the JAX module: the pool is updated IN PLACE (JAX donates
it to each jitted step). A step takes the page table, positions and active
mask as tensors on the pool's device and reads nothing back to the host;
the server keeps them on the host (numpy) and copies them in. On a card the
server's greedy step is one CUDA graph (``PagedGraph``), the counterpart of
the JAX server's jitted step, replayed once per step and H times for a
burst, where JAX scans its burst; the JAX step's ``lax.scan`` over layers
is a Python loop inside the captured step. Chunked admission replays the
chunk graphs of a held admission cache (``serve.AdmissionCache``), where
JAX jits one chunk function per temporary capacity.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, fields, replace
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from .cache import (DeployConfig, DeployedQuant, check_intn_codebook,
                    create_cache, static_channels)
from .device import resolve_device
from .models import llama
from .models.config import ModelConfig
from .ops.deployed import _encode_rows, _quantize_token, device_positions
# the paged kernel K5, here under its JAX name (paged.paged_flash_decode)
from .ops.kernels.paged_decode import paged_flash_decode
from .ops.packing import token_bits, token_word_bit, write_rows


@dataclass
class PagedPool:
    k_planes: torch.Tensor
    v_planes: torch.Tensor
    kv_out: torch.Tensor
    v_scale: torch.Tensor
    v_offset: torch.Tensor
    k_sink: torch.Tensor
    v_sink: torch.Tensor


def create_paged_pool(dcfg: DeployConfig, n_layers: int, n_pages: int,
                      n_slots: int, device="cuda") -> PagedPool:
    L, NP, B = n_layers, n_pages, n_slots
    H, D, S = dcfg.n_kv_heads, dcfg.d_head, dcfg.sink
    P = dcfg.page_tokens
    dev = resolve_device(device)

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    if dcfg.codes == "nuq":
        planes = lambda: z((L, NP, H, dcfg.bits, P // 32, D), torch.int32)  # noqa: E731
    else:
        planes = lambda: z((L, NP, dcfg.code_heads, P, dcfg.code_cols),  # noqa: E731
                           dcfg.code_dtype)
    return PagedPool(
        k_planes=planes(),
        v_planes=planes(),
        kv_out=z((L, NP, dcfg.n_groups, dcfg.n_slots, P), torch.float32),
        v_scale=z((L, NP, P), torch.float32),
        v_offset=z((L, NP, P), torch.float32),
        k_sink=z((L, B, H, S, D), torch.float32),
        v_sink=z((L, B, H, S, D), torch.float32),
    )


def paged_pool_bytes(dcfg: DeployConfig, n_layers: int, n_pages: int,
                     n_slots: int) -> int:
    """Bytes of the pool's arrays (shapes only: built on the meta device)."""
    pool = create_paged_pool(dcfg, n_layers, n_pages, n_slots, device="meta")
    return sum(t.numel() * t.element_size()
               for t in (getattr(pool, f.name) for f in fields(PagedPool)))


# ---------------------------------------------------------------------------
# append + page-granular writes
# ---------------------------------------------------------------------------


class PageRows(NamedTuple):
    """Where each slot's token lands in the pool, from its position, its
    page-table row and the active mask; a step computes it once and every
    layer's writes share it. ``packed`` (B,) bool: the slot writes its
    packed row (pos >= S and active); ``sink``: it writes its exact sink
    row ``s`` (pos < S and active; ``s`` is None without a sink). ``bit``:
    its bit in the bit planes' word (nuq). ``offsets``: by pool array
    ("planes", "k_out", "v_out", "scalars"), the flat element offsets
    (B, ...) of the slot's row (the bit planes' word row) within one layer,
    and the same offsets with every slot that does not write sent to the
    first slot that does (``_scatter_targets``)."""
    packed: torch.Tensor
    sink: torch.Tensor
    s: torch.Tensor | None
    bit: torch.Tensor | None
    src: torch.Tensor
    offsets: dict


def _row_offsets(shape, axis: int, page, idx, part=None):
    """Flat element offsets (B, ...) into one layer, of contiguous shape
    ``shape`` (NP, ...), of a pool array: slot b's page ``page[b]`` at
    index ``idx[b]`` along ``axis`` (size 1 there), every element of the
    other axes (``part`` = (axis, start, stop) keeps that range of one)."""
    n = len(shape)
    stride = [1] * n
    for d in range(n - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    lead = (-1,) + (1,) * (n - 1)
    off = page.view(lead) * stride[0] + idx.view(lead) * stride[axis]
    for d in range(1, n):
        if d != axis:
            lo, hi = part[1:] if part and part[0] == d else (0, shape[d])
            view = [1] * n
            view[d] = hi - lo
            off = off + (torch.arange(lo, hi, device=page.device)
                         * stride[d]).view(view)
    return off


def page_rows(pool: PagedPool, page_table, pos, active,
              dcfg: DeployConfig) -> PageRows:
    """The ``PageRows`` of a step, as JAX's paged_append_token locates its
    rows (``kvquant_tpu/paged.py:324-334``): packed position p = max(pos -
    S, 0) lies in page ``page_table[b, clip(p // P, 0, MP - 1)]`` at row
    p % P. ``page_table`` (B, MP), ``pos`` (B,) and ``active`` (B,) bool
    (None: every slot) on the pool's device; host values are copied there,
    nothing is read back."""
    dev = pool.k_planes.device
    table = torch.as_tensor(page_table, dtype=torch.int32, device=dev)
    B, MP = table.shape
    pos = device_positions(pos, B, dev)
    act = (torch.ones(B, dtype=torch.bool, device=dev) if active is None
           else torch.as_tensor(active, device=dev).to(torch.bool))
    S, P = dcfg.sink, dcfg.page_tokens
    p = (pos - S).clamp(min=0).long()
    page = torch.gather(table, 1, (p // P).clamp(max=MP - 1)[:, None])[:, 0]
    page, row = page.long(), p % P
    packed = (pos >= S) & act
    # the pool has no batch axis and a slot that does not write may alias
    # a row that another slot writes (a retired slot keeps its position and
    # its table row reads page 0): its scatter repeats the first writing
    # slot's, element for element, so no element gets two values
    src = torch.where(packed, torch.arange(B, device=dev),
                      packed.to(torch.int32).argmax())
    nuq = dcfg.codes == "nuq"
    word, bit = token_word_bit(row) if nuq else (row, None)
    # (one layer's shape (NP, ...), the row axis, its index[, a range])
    planes = pool.k_planes.shape[1:]
    where = {"planes": (planes, len(planes) - 2, word),
             "scalars": (pool.v_scale.shape[1:], 1, row)}
    J, spk = pool.kv_out.shape[-2], dcfg.slots_per_kind
    if dcfg.include_sparse and spk:
        where["k_out"] = (pool.kv_out.shape[1:], 3, row, (2, 0, spk))
    if dcfg.include_sparse and J > spk:
        where["v_out"] = (pool.kv_out.shape[1:], 3, row, (2, spk, J))
    offsets = {}
    for name, (shape, axis, idx, *part) in where.items():
        off = _row_offsets(shape, axis, page, idx, *part)
        offsets[name] = (off, off.index_select(0, src))
    return PageRows(packed, (pos < S) & act,
                    pos.clamp(max=S - 1).long() if S > 0 else None, bit,
                    src, offsets)


def _scatter_targets(arr, off, at: PageRows, new):
    """Write each slot's row into one layer ``arr`` (contiguous) of a pool
    array, in place: gathered at its flat offsets ``off[0]``, replaced by
    ``new`` (its rows, or a function of the old rows) where the slot writes
    its packed row, scattered at ``off[1]`` with the values of the slot
    each one repeats. A slot that does not write puts back the value its
    target row gets anyway, so the scatter is the same whichever of two
    writes to an element lands."""
    flat = arr.view(-1)
    frm, to = off
    old = torch.gather(flat, 0, frm.reshape(-1)).view(frm.shape)
    lead = (-1,) + (1,) * (old.dim() - 1)
    val = torch.where(at.packed.view(lead),
                      new(old) if callable(new) else new.to(old.dtype), old)
    flat.scatter_(0, to.reshape(-1), val.index_select(0, at.src).reshape(-1))


def paged_append_token(pool: PagedPool, page_table, lq: DeployedQuant,
                       dcfg: DeployConfig, mcfg: ModelConfig, k_new, v_new,
                       pos, li: int, active=None, *, rows=None, cos_sin=None,
                       k_chan=None) -> PagedPool:
    """Append one token per slot at layer ``li``, in place: packed position
    p maps to (page_table[b, p // P], p % P). ``page_table`` (B, MP) int32,
    ``pos`` (B,) int32 and ``active`` (B,) bool on the pool's device (host
    values are copied there); nothing is read back to the host. Row-level
    predicated writes by device-indexed gathers and scatters, one per pool
    array: slots that are not active write NOTHING (a paged slot's table
    row may alias pages that now belong to another request), and the sink
    rows go to the per-slot sinks. ``rows`` (``page_rows``), ``cos_sin``
    (``rope_cos_sin(pos)``) and the layer's static K channels ``k_chan``
    (``quantize_k``) may come precomputed."""
    at = rows or page_rows(pool, page_table, pos, active, dcfg)
    if cos_sin is None:
        cos_sin = llama.rope_cos_sin(
            device_positions(pos, k_new.shape[0], k_new.device), mcfg)
    (codes_k, codes_v, k_words, v_words, v_sc, v_off, k_roped,
     v_h) = _quantize_token(lq, dcfg, mcfg, k_new, v_new, *cos_sin, k_chan)
    off = at.offsets
    for arr, codes in ((pool.k_planes, codes_k), (pool.v_planes, codes_v)):
        new = (partial(token_bits, codes=codes, bit=at.bit)
               if dcfg.codes == "nuq"
               else _encode_rows(codes, dcfg).unsqueeze(2))
        _scatter_targets(arr[li], off["planes"], at, new)
    for name, words in (("k_out", k_words), ("v_out", v_words)):
        if name in off and words is not None:
            _scatter_targets(pool.kv_out[li], off[name], at,
                             words.unsqueeze(-1))
    for arr, val in ((pool.v_scale, v_sc), (pool.v_offset, v_off)):
        _scatter_targets(arr[li], off["scalars"], at, val.unsqueeze(1))
    if at.s is not None:
        write_rows(pool.k_sink[li], k_roped, at.s, at.sink, axis=2)
        write_rows(pool.v_sink[li], v_h, at.s, at.sink, axis=2)
    return pool


def write_pages_from_cache(pool: PagedPool, cache_l_arrays: dict, page_ids,
                           slot: int, dcfg: DeployConfig) -> PagedPool:
    """Copy a CONTIGUOUS 1-sequence cache (arrays with their (L, 1, ...)
    batch axis, e.g. ``KVCache.arrays()`` of a prefill) into the allocated
    pool pages, in place, page by page: page i of ``page_ids`` gets packed
    tokens [i*P, (i+1)*P). Pages past the prompt copy the zero-padded tail
    (masked dead in attention). The sequence's sink rows go to the slot's
    row of the per-slot sinks."""
    P = dcfg.page_tokens
    ids = torch.as_tensor(page_ids).reshape(-1).tolist()
    # (token axis once the batch axis is dropped, rows per page) by array
    code = (3, P // 32) if dcfg.codes == "nuq" else (2, P)
    blocks = {"k_planes": code, "v_planes": code, "kv_out": (3, P),
              "v_scale": (1, P), "v_offset": (1, P)}
    for name, (ax, rows) in blocks.items():
        src = cache_l_arrays[name][:, 0]
        dst = getattr(pool, name)
        for i, pg in enumerate(ids):
            dst[:, pg] = src.narrow(ax, i * rows, rows)
    pool.k_sink[:, slot] = cache_l_arrays["k_sink"][:, 0]
    pool.v_sink[:, slot] = cache_l_arrays["v_sink"][:, 0]
    return pool


# ---------------------------------------------------------------------------
# full-model paged decode step
# ---------------------------------------------------------------------------


def paged_decode_step(params, cfg: ModelConfig, dcfg: DeployConfig,
                      dq: DeployedQuant, pool: PagedPool, page_table, token,
                      pos, active=None, *, k_chan=None):
    """One decode step over the paged pool: append at each slot's position
    and attend through its page table, every layer (the pool in place).
    token (B,) int; page_table (B, MP) int32, pos (B,) int32 and active
    (B,) bool as tensors on the pool's device (host values are copied
    there); the step reads nothing back to the host. ``k_chan``: the static
    K channels (``static_channels``), computed here when not given (a
    server computes them once). Returns (pool, logits (B, V) fp32)."""
    from .engine import _logits, _mlp

    check_intn_codebook(dcfg, dq)
    B = token.shape[0]
    H, Dh, Hkv = cfg.n_heads, cfg.d_head, cfg.n_kv_heads
    G = H // Hkv
    dev = pool.k_planes.device
    table = torch.as_tensor(page_table, dtype=torch.int32, device=dev)
    pos = device_positions(pos, B, dev)
    if k_chan is None:
        k_chan = static_channels(dq, dcfg)
    k_chan32 = None if k_chan is None else k_chan.to(torch.int32)
    at = page_rows(pool, table, pos, active, dcfg)
    cos, sin = llama.rope_cos_sin(pos, cfg)

    x = params.embed[token.to(dev).long()]
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        h = llama.norm(x, lp["ln_attn"], cfg)
        q = (h @ lp["wq"]).reshape(B, H, Dh)
        k = h @ lp["wk"]
        v = h @ lp["wv"]
        paged_append_token(pool, table, dq.layer(li), dcfg, cfg, k, v, pos,
                           li, rows=at, cos_sin=(cos, sin),
                           k_chan=None if k_chan is None else k_chan[li])
        q_h = q.reshape(B, Hkv, G, Dh).to(torch.float32)
        q_rot = q_h * cos[:, None, None] + (
            llama.rotate_half(q_h) * sin[:, None, None])
        attn = paged_flash_decode(q_rot, pool, table, dq, li, pos, dcfg,
                                  cfg, k_chan=k_chan32)
        x = x + attn.reshape(B, H * Dh).to(x.dtype) @ lp["wo"]
        x = _mlp(x, lp, cfg)
    return pool, _logits(params, x, cfg)


# ---------------------------------------------------------------------------
# the server's greedy step: eager, or one CUDA graph
# ---------------------------------------------------------------------------


class PagedStep:
    """The greedy paged step over static device buffers, JAX's burst body
    (``kvquant_tpu/paged.py:823-834``): ``token`` (B,) int32, ``pos`` (B,)
    int32, ``active`` (B,) bool and ``table`` (B, MP) int32 on the pool's
    device. A call runs ``paged_decode_step`` over them, then where a slot
    is active advances it in place (``token`` <- the logits' argmax,
    ``pos`` += 1) and returns the logits (B, V) fp32. ``load`` copies host
    values in. The static K channels are computed once. This class steps
    eagerly; ``PagedGraph`` replays the same body."""

    def __init__(self, params, cfg: ModelConfig, dcfg: DeployConfig,
                 dq: DeployedQuant, pool: PagedPool, max_pages: int):
        dev = pool.k_planes.device
        B = pool.k_sink.shape[1]
        self.token = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.table = torch.zeros((B, max_pages), dtype=torch.int32,
                                 device=dev)
        self._args = (params, cfg, dcfg, dq, pool)
        self.k_chan = static_channels(dq, dcfg)

    def load(self, token, pos, active, table):
        """Copy host values (numpy) into the buffers."""
        for buf, a in ((self.token, token), (self.pos, pos),
                       (self.active, active), (self.table, table)):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))

    def body(self):
        _, logits = paged_decode_step(*self._args, self.table, self.token,
                                      self.pos, self.active,
                                      k_chan=self.k_chan)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        self.token.copy_(torch.where(self.active, nxt, self.token))
        self.pos.copy_(torch.where(self.active, self.pos + 1, self.pos))
        return logits

    def __call__(self):
        return self.body()


class PagedGraph(PagedStep):
    """``PagedStep``'s body captured as one CUDA graph over a pool on a
    card (``engine.CapturedStep``): the counterpart of the JAX server's
    jitted step and of its scanned burst, whose body it is. A call replays
    it and returns ``logits``, which the next call overwrites. The warm-up
    runs with every slot inactive, so it writes nothing to the pool.
    ``launches``, ``setup_launches``, ``capture_s`` and ``pool_mib`` are
    the capture's. Raises ValueError for a pool that is not on a card; a
    capture that fails raises."""

    def __init__(self, params, cfg: ModelConfig, dcfg: DeployConfig,
                 dq: DeployedQuant, pool: PagedPool, max_pages: int):
        from .engine import CapturedStep, _hold_rope_table

        dev = pool.k_planes.device
        if dev.type != "cuda":
            raise ValueError(f"PagedGraph: the pool is on {dev}; a CUDA "
                             f"graph needs a card (use PagedStep)")
        t0 = time.perf_counter()
        super().__init__(params, cfg, dcfg, dq, pool, max_pages)
        self._rope = _hold_rope_table(cfg, dcfg,
                                      max_pages * dcfg.page_tokens, dev)
        self._captured = c = CapturedStep(self.body, dev)
        self.logits, self.launches = c.out, c.launches
        self.setup_launches, self.pool_mib = c.setup_launches, c.pool_mib
        self.capture_s = time.perf_counter() - t0

    def __call__(self):
        return self._captured.replay()


# ---------------------------------------------------------------------------
# paged continuous-batching server
# ---------------------------------------------------------------------------


class PagedServer:
    """One page pool shared by all slots, memory proportional to cached
    tokens. Admission fills a temporary contiguous 1-sequence cache —
    whole-prompt (admit_mode="sync") or ONE quantized-trajectory chunk per
    server step (admit_mode="chunked", the default: active slots keep
    decoding while a long prompt streams in) — then copies it page by page
    into freshly allocated pages. Pages are reserved when the admission
    STARTS (a started admission can never deadlock waiting for pages) and
    returned to the free list at retirement.

    Host state: the free list, each slot's page-table row (int32 numpy),
    positions and budgets. The pool is updated in place by every step (the
    JAX server donates it to its jitted step). ``device`` places the pool
    and the temporary caches (default "cuda"). The decode step is the
    greedy ``PagedStep``: on a card one ``PagedGraph`` captured here and
    replayed once per step, H times per burst; on the CPU the same body
    steps eagerly. Chunked admission runs in a held temporary cache per
    temporary capacity (``serve.AdmissionCache``), owned by the admission
    that advances and reset as it starts; on a card its chunks replay that
    cache's two ``engine.ChunkGraph``s (the sink chunk, a later chunk).
    The caches of every capacity view one buffer of ``MP`` pages and their
    graphs share one pool (``serve.AdmissionMemory``)."""

    def __init__(self, params, cfg, dcfg: DeployConfig, dq, n_pages: int,
                 n_slots: int, max_pages_per_slot: int, seed: int = 0,
                 admit_mode: str = "chunked", admit_chunk: int = 256,
                 burst: int = 32, device="cuda"):
        from . import engine

        self.params, self.cfg, self.dcfg, self.dq = params, cfg, dcfg, dq
        self.n_slots = n_slots
        self.MP = max_pages_per_slot
        self.admit_mode = admit_mode
        self.admit_chunk = admit_chunk
        # at most this many greedy decode steps per host read (0 disables):
        # run() keeps the burst's tokens on the device whenever no
        # admission is pending
        self.burst = burst
        self.admitting = []
        self._adm_caches = {}  # cache_tokens -> serve.AdmissionCache
        self._adm_memory = None  # serve.AdmissionMemory, which they share
        assert admit_chunk % 128 == 0
        self.device = resolve_device(device)
        self.pool = create_paged_pool(dcfg, cfg.n_layers, n_pages, n_slots,
                                      device=self.device)
        self.free = list(range(n_pages))
        self.table = np.zeros((n_slots, self.MP), np.int32)
        self.pos = np.zeros((n_slots,), np.int32)
        self.active = np.zeros((n_slots,), bool)
        self.slot_req = [None] * n_slots
        self.slot_pages = [[] for _ in range(n_slots)]
        self.completions = {}
        self.queue = []
        self._engine = engine
        self._rng = np.random.default_rng(seed)
        self._last_tok = np.zeros((n_slots,), np.int32)
        stepper = PagedGraph if self.device.type == "cuda" else PagedStep
        self._step = stepper(params, cfg, dcfg, dq, self.pool, self.MP)
        # row h: the tokens a burst's step h appended, kept on the device
        self._emitted = torch.zeros((max(burst, 1), n_slots),
                                    dtype=torch.int32, device=self.device)

    def submit(self, req):
        self.queue.append(req)

    def _pages_needed(self, req) -> int:
        t = len(req.prompt) + req.max_new_tokens - self.dcfg.sink
        return max(1, -(-t // self.dcfg.page_tokens))

    def _claim(self):
        """Pop the queue head if a slot AND its pages are available.
        Returns (req, slot, pages, tmp_dcfg) or None."""
        if not self.queue:
            return None
        busy = {a["slot"] for a in self.admitting}
        free_slots = [b for b in range(self.n_slots)
                      if not self.active[b] and b not in busy]
        if not free_slots:
            return None
        req = self.queue[0]
        need = self._pages_needed(req)
        assert need <= self.MP, (
            f"request {req.rid} needs {need} pages > per-slot max {self.MP}")
        if need > len(self.free):
            return None
        self.queue.pop(0)
        b = free_slots[0]
        pages = [self.free.pop() for _ in range(need)]
        tmp_len = self.dcfg.sink + need * self.dcfg.page_tokens
        tmp_dcfg = replace(self.dcfg, max_len=tmp_len)
        assert tmp_dcfg.cache_tokens % self.dcfg.page_tokens == 0
        return req, b, pages, tmp_dcfg

    def _activate(self, req, b, pages, tmp_cache, logits_last):
        from .serve import Completion

        write_pages_from_cache(self.pool, tmp_cache.arrays(), pages, b,
                               self.dcfg)
        self.table[b, :len(pages)] = pages
        self.table[b, len(pages):] = pages[-1]  # clamp-safe padding
        self.pos[b] = len(req.prompt)
        self.active[b] = True
        self.slot_req[b] = req
        self.slot_pages[b] = pages
        self.completions[req.rid] = Completion(rid=req.rid)
        # the prefill's argmax is the first token, whatever the request's
        # temperature (as the JAX server does)
        self._last_tok[b] = int(torch.as_tensor(logits_last).argmax())

    def _admit_sync(self):
        while True:
            claim = self._claim()
            if claim is None:
                return
            req, b, pages, tmp_dcfg = claim
            tmp = create_cache(tmp_dcfg, self.cfg.n_layers, 1,
                               device=self.device)
            prompt = torch.as_tensor(np.array(req.prompt, np.int32)[None],
                                     device=self.device)
            tmp, logits = self._engine.prefill(
                self.params, self.cfg, tmp_dcfg, self.dq, tmp, prompt)
            self._activate(req, b, pages, tmp, logits[0])

    # -- chunked (non-blocking) paged admission ------------------------
    def _start_admissions(self):
        while True:
            claim = self._claim()
            if claim is None:
                return
            req, b, pages, tmp_dcfg = claim
            S, chunk = self.dcfg.sink, self.admit_chunk
            T0 = len(req.prompt)
            assert T0 > S, "prompt must extend beyond the sink prefix"
            n_chunks = -(-(T0 - S) // chunk)
            toks = np.zeros((1, S + n_chunks * chunk), np.int32)
            toks[0, :T0] = req.prompt
            self.admitting.append(dict(
                req=req, slot=b, pages=pages, tmp_dcfg=tmp_dcfg,
                toks=toks, n_chunks=n_chunks, ci=0,
            ))

    def _admission_cache(self, tmp_dcfg: DeployConfig):
        """The held admission cache (``serve.AdmissionCache``: the cache
        and, on a card, its sink-chunk and later-chunk graphs) of the
        temporary capacity ``tmp_dcfg.cache_tokens``, as JAX's chunk
        functions are keyed; at most ``MP`` of them. They share one
        ``serve.AdmissionMemory``: a cache of ``MP`` pages, one graph pool
        and one logits buffer for each chunk shape."""
        from .serve import AdmissionCache, AdmissionMemory

        key = tmp_dcfg.cache_tokens
        if key not in self._adm_caches:
            if self._adm_memory is None:
                self._adm_memory = AdmissionMemory.create(
                    replace(self.dcfg, max_len=self.dcfg.sink
                            + self.MP * self.dcfg.page_tokens),
                    self.cfg.n_layers, self.device)
            self._adm_caches[key] = AdmissionCache(
                self.params, self.cfg, tmp_dcfg, self.dq, self.device,
                memory=self._adm_memory)
        return self._adm_caches[key]

    def _step_admission(self, adm) -> bool:
        """Run ONE quantized-trajectory prompt chunk into the admission
        cache of its capacity (reset at the admission's first chunk); True
        when finished."""
        S, chunk = self.dcfg.sink, self.admit_chunk
        held = self._admission_cache(adm["tmp_dcfg"])
        ci = adm["ci"]
        if ci == 0:
            held.start()
            blk, pos0, sf = adm["toks"][:, :S + chunk], S, True
        else:
            a = S + ci * chunk
            blk, pos0, sf = adm["toks"][:, a:a + chunk], a, False
        logits = held.chunk(torch.as_tensor(blk, device=self.device), pos0,
                            sf)
        adm["ci"] += 1
        if adm["ci"] < adm["n_chunks"]:
            return False
        T0 = len(adm["req"].prompt)
        last = (T0 - 1) - (S + (adm["n_chunks"] - 1) * chunk) \
            if adm["n_chunks"] > 1 else T0 - 1
        adm["last_logits"] = logits[0, last].cpu()
        return True

    def _admit_chunked(self):
        self._start_admissions()
        if not self.admitting:
            return
        # advance ONE admission per server step: decode stall per admit is
        # bounded by a single chunk's compute sharing the step
        adm = self.admitting[0]
        if self._step_admission(adm):
            self.admitting.pop(0)
            # copied into the pages on the stream, before the next
            # admission's reset
            self._activate(adm["req"], adm["slot"], adm["pages"],
                           self._admission_cache(adm["tmp_dcfg"]).cache,
                           adm["last_logits"])

    def _admit(self):
        if self.admit_mode == "chunked":
            self._admit_chunked()
        else:
            self._admit_sync()

    # -- device-side decode bursts --------------------------------------
    def _step_burst(self) -> int:
        """Run one burst: H = largest power of two <= min remaining budget
        over active slots (so no slot overshoots its reserved pages),
        capped at ``self.burst``; H greedy steps (H replays on a card) whose
        argmax and next token stay on the device, then ONE host read of the
        H tokens per slot. The page table and active mask are fixed for the
        burst. Falls back to a single hosted step when no slot is active, H
        < 2, or any active request samples with a temperature (host RNG).
        EOS inside a burst wastes the slot's tail steps (junk appends land
        in the slot's own reserved pages); the tokens after it are discarded
        and the slot retires exactly as in step(). Returns the number of
        decode steps executed (0 when idle)."""
        act_idx = [b for b in range(self.n_slots) if self.active[b]]
        if not act_idx:
            return 1 if self.step() else 0
        rem = min(self.slot_req[b].max_new_tokens
                  - len(self.completions[self.slot_req[b].rid].tokens)
                  for b in act_idx)
        if rem < 2 or any(self.slot_req[b].temperature != 0.0
                          for b in act_idx):
            return 1 if self.step() else 0
        H = 1
        while H * 2 <= min(rem, self.burst):
            H *= 2
        st = self._step
        st.load(self._last_tok, self.pos, self.active, self.table)
        for h in range(H):
            self._emitted[h].copy_(st.token)  # the token APPENDED this step
            st()
        out = torch.cat([self._emitted[:H], st.token[None],
                         st.pos[None]]).cpu().numpy()  # the one read
        toks = out[:H]  # (H, n_slots)
        self._last_tok = out[H].copy()
        self.pos = out[H + 1].copy()
        for b in act_idx:
            req = self.slot_req[b]
            comp = self.completions[req.rid]
            done = False
            for h in range(H):
                t = int(toks[h, b])
                comp.tokens.append(t)
                if req.eos_token_id is not None and t == req.eos_token_id:
                    done = True
                    break
            if done or len(comp.tokens) >= req.max_new_tokens:
                self._retire(b)
        return H

    def _retire(self, b):
        self.free.extend(self.slot_pages[b])
        self.slot_pages[b] = []
        self.table[b] = 0
        self.active[b] = False
        self.slot_req[b] = None

    def step(self) -> bool:
        self._admit()
        if not self.active.any() and not self.queue and not self.admitting:
            return False
        # one greedy step: its token and position updates are not read
        # (the next load overwrites them); the host samples from the logits
        self._step.load(self._last_tok, self.pos, self.active, self.table)
        logits = self._step().cpu().numpy()
        for b in range(self.n_slots):
            if not self.active[b]:
                continue
            req = self.slot_req[b]
            comp = self.completions[req.rid]
            tok = self._last_tok[b]  # token just appended at pos[b]
            comp.tokens.append(int(tok))
            self.pos[b] += 1
            if req.temperature == 0.0:
                nxt = int(logits[b].argmax())
            else:
                z = logits[b] / req.temperature
                z = z - z.max()
                p = np.exp(z)
                nxt = int(self._rng.choice(len(p), p=p / p.sum()))
            self._last_tok[b] = nxt
            done = len(comp.tokens) >= req.max_new_tokens
            if req.eos_token_id is not None and tok == req.eos_token_id:
                done = True
            if done:
                self._retire(b)
        return True

    def run(self, requests, max_steps: int = 10_000):
        """Drive until done or ``max_steps`` decode steps. A burst of H
        tokens counts as H steps, so max_steps bounds decode WORK, not
        host round trips."""
        for r in requests:
            self.submit(r)
        steps = 0
        while steps < max_steps:
            if self.burst > 1 and self.active.any() and not self.queue \
                    and not self.admitting:
                n = self._step_burst()
            else:
                n = 1 if self.step() else 0
            if n == 0:
                break
            steps += n
        return self.completions
