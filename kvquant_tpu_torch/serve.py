"""Continuous-batching server over the quantized KV cache (port of
kvquant_tpu/serve.py).

  - a fixed pool of ``n_slots`` batch slots shares ONE batched KVCache;
    every decode step advances ALL slots in one decode step at per-sample
    positions (each slot an independent sequence): on a card one replay
    of an ``engine.DecodeGraph`` (the JAX server's jitted step), its
    positions copied to the card each step; on the CPU, and for the
    configurations a graph cannot capture, ``engine.decode_step``;
  - requests queue on the host; a finished or empty slot is re-admitted by
    prefilling the new prompt into a 1-sequence cache and copying it into
    the slot's batch row. admit_mode="chunked" spreads that prefill over
    server steps, ONE quantized-trajectory prompt chunk of ``admit_chunk``
    rows per step (engine.prefill_chunk), so active slots keep decoding
    while a long prompt streams in. A chunk runs as sub-chunks of
    ``sub_width`` rows (``ADMIT_SUB_CHUNK`` where it divides
    ``admit_chunk``), up to the one that holds the prompt's last real row:
    a chunk as wide as the longest prompt admits a prompt in one step
    without running its padding. The server holds one admission cache,
    which the admission that advances owns (reset as it starts), and on a
    card two ``engine.ChunkGraph``s over it, the sink sub-chunk and a later
    sub-chunk (the JAX server's jitted chunk, ``sink_fill`` static), each
    computing the logits of the one row an admission reads; pending
    admissions hold only their tokens;
  - ServerPool adds capacity classes: one Server per max_len class;
  - sampling is host-side per request (greedy / temperature, numpy RNG as
    the JAX server's);
  - every step records spans into ``utils.profiling.SPANS`` (switched off
    with ``SPANS.enabled = False``): ``server.step`` (the root),
    ``server.admit`` (starting admissions and the step's one chunk),
    ``engine.chunk`` (the reset, the input copy and the chunk's
    sub-chunks, with its ``rid`` and each sub-chunk's rows,
    ``SPANS.replayed``), ``server.first_token`` (an admission's last
    logits read, its slot write and first token), ``engine.decode`` (the
    input copies and the decode step), ``server.logits_read`` (the
    blocking read of the decode logits) and ``server.sample`` (host
    sampling and the slots' bookkeeping). On a card ``engine.chunk`` and
    ``engine.decode`` carry CUDA events from the first replay's launch to
    the span's end (its device time); the blocking reads mark the device
    idle until the next reset, slot write or launch (the recorder's host
    gaps).

The scheduler is host-side Python as in the JAX package; the cache is
updated in place by each step (the JAX server donates it to its jitted
step). ``device`` places the caches (default "cuda").
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field, fields, replace

import numpy as np
import torch

from . import engine
from .cache import (KVCache, DeployConfig, DeployedQuant, create_cache,
                    cache_storage_bytes, check_intn_codebook, reset_cache)
from .device import resolve_device
from .models.config import ModelConfig
from .utils.profiling import SPANS


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (T,) int32
    max_new_tokens: int
    temperature: float = 0.0
    eos_token_id: int | None = None


@dataclass
class Completion:
    rid: int
    tokens: list = field(default_factory=list)


# rows of one replay of an admission chunk (``sub_width``), from
# Mistral-7B-v0.2 admissions timed on an H100 (admission_ablation.py,
# PERF.md): a 2K prompt takes 131 ms at 2048 (142 at 1024, 1478 as one
# padded 16K chunk), a 16K prompt 1665 ms (1741 at 1024, 1568 padded)
ADMIT_SUB_CHUNK = 2048


def sub_width(admit_chunk: int) -> int:
    """The rows of one sub-chunk of an admission chunk of ``admit_chunk``
    rows: ``ADMIT_SUB_CHUNK`` where it divides the chunk, else the whole
    chunk (one replay a chunk)."""
    return ADMIT_SUB_CHUNK if admit_chunk % ADMIT_SUB_CHUNK == 0 \
        else admit_chunk


@dataclass
class _Admission:
    """In-flight chunked admission: its padded prompt, run one chunk per
    server step into the admission cache (``AdmissionCache``) once it is
    the first in line."""

    req: Request
    slot: int
    toks: np.ndarray  # (1, S + n_chunks*chunk) padded prompt
    n_chunks: int
    ci: int = 0


@dataclass
class AdmissionMemory:
    """The memory that a server's admission caches share: ``storage``, a
    byte buffer that the cache of every capacity views
    (``cache.create_cache(storage=...)``), and on a card ``pool``, the
    graph pool of their chunk graphs, and ``logits``, the buffers those
    graphs write the read row's logits into, one for each batch. Only one
    admission advances at a time and it resets its cache as it starts, so
    the caches take turns: the memory held is that of the largest cache
    and of one chunk's work, however many capacities there are."""

    storage: torch.Tensor
    pool: object = None
    logits: dict = field(default_factory=dict)  # (B,) -> (B, V)

    @classmethod
    def create(cls, dcfg: DeployConfig, n_layers: int, device):
        """Room for a 1-sequence cache of ``dcfg``'s capacity (or less)."""
        dev = resolve_device(device)
        storage = torch.empty(cache_storage_bytes(dcfg, n_layers, 1),
                              dtype=torch.uint8, device=dev)
        return cls(storage, torch.cuda.graph_pool_handle()
                   if dev.type == "cuda" else None)

    def logits_buffer(self, shape, vocab: int) -> torch.Tensor:
        if tuple(shape) not in self.logits:
            self.logits[tuple(shape)] = torch.empty(
                (*shape, vocab), dtype=torch.float32,
                device=self.storage.device)
        return self.logits[tuple(shape)]


class AdmissionCache:
    """The 1-sequence cache that chunked admission fills, held for the
    server's life in ``memory`` (an ``AdmissionMemory``, its own unless
    the server shares one between capacities), and on a card the two
    ``engine.ChunkGraph``s over it (the sink chunk, a later chunk), each
    captured at the first chunk of its kind; elsewhere, and for the
    configurations that ``engine.graph_unsupported`` names, the chunks run
    as ``engine.prefill_chunk`` calls. Only the admission that advances
    owns the cache, and ``start()`` resets it, so a graph's warm-up may
    write anything into it."""

    def __init__(self, params, cfg: ModelConfig, dcfg: DeployConfig,
                 dq: DeployedQuant, device,
                 memory: AdmissionMemory | None = None):
        self.params, self.cfg, self.dcfg, self.dq = params, cfg, dcfg, dq
        self.memory = memory or AdmissionMemory.create(dcfg, cfg.n_layers,
                                                       device)
        self.cache = create_cache(dcfg, cfg.n_layers, 1,
                                  storage=self.memory.storage)
        self.graphed = engine.chunk_graphable(self.cache, cfg)
        self.graphs: dict[bool, engine.ChunkGraph] = {}  # by sink_fill

    def start(self):
        """A new admission owns the cache: zero it."""
        reset_cache(self.cache)

    def chunk(self, blk: torch.Tensor, pos0: int, sink_fill: bool,
              row: int):
        """One prompt chunk ``blk`` (1, Tq) at ``pos0`` into the cache;
        returns the logits (1, V) of its row ``row``, which the next chunk
        may overwrite. The innermost open span records its rows
        (``SPANS.replayed``)."""
        S = self.dcfg.sink
        p0, n = max(pos0 - S, 0), blk.shape[1] - (S if sink_fill else 0)
        assert p0 + n <= self.dcfg.cache_tokens, (
            f"packed tokens [{p0}, {p0 + n}) exceed the cache's "
            f"{self.dcfg.cache_tokens}")
        SPANS.replayed(blk.shape[1])
        if not self.graphed:
            SPANS.launch()
            return engine.prefill_chunk(self.params, self.cfg, self.dcfg,
                                        self.dq, self.cache, blk, pos0,
                                        sink_fill, row)[1]
        graph = self.graphs.get(sink_fill)
        if graph is None:
            SPANS.launch()  # the capture runs the chunk first
            m = self.memory
            graph = self.graphs[sink_fill] = engine.ChunkGraph(
                self.params, self.cfg, self.dcfg, self.dq, self.cache, blk,
                pos0, sink_fill,
                out=m.logits_buffer(blk.shape[:1], self.cfg.vocab_size),
                pool=m.pool, row=row)
            return graph.first
        return graph(blk, pos0, row)


class Server:
    def __init__(self, params, cfg: ModelConfig, dcfg: DeployConfig,
                 dq: DeployedQuant, n_slots: int = 4, seed: int = 0,
                 admit_mode: str = "sync", admit_chunk: int = 256,
                 device="cuda"):
        self.params = params
        self.cfg = cfg
        self.dcfg = dcfg
        self.dq = dq
        self.n = n_slots
        self.admit_mode = admit_mode
        self.admit_chunk = admit_chunk
        self.sub_chunk = sub_width(admit_chunk)
        self.device = resolve_device(device)
        check_intn_codebook(dcfg, dq)
        self.cache = create_cache(dcfg, cfg.n_layers, n_slots,
                                  device=self.device)
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * n_slots
        self.admitting: list[_Admission] = []
        self.out: dict[int, Completion] = {}
        self.last_tok = np.zeros(n_slots, np.int32)
        self.pos = np.zeros(n_slots, np.int32)
        self.remaining = np.zeros(n_slots, np.int32)
        self._rng = np.random.default_rng(seed)
        self.decode_steps = 0  # telemetry: decode advanced this many steps
        self._step = None  # engine.decode_stepper, built at the first step
        self._adm = None  # AdmissionCache, built at the first chunk
        # the stream the graphs replay on: the replays' spans time it
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)
        self.out[req.rid] = Completion(req.rid)

    def _write_slot(self, b: int, one_cache: KVCache):
        # INVARIANT: this must overwrite EVERY KVCache field for slot b.
        # Retired / never-admitted slots keep decoding (step() runs the
        # whole batch) and append junk at their frozen position; correct
        # re-admission depends on this loop covering all fields, length
        # included: it iterates the dataclass, so a new field is included.
        for f in fields(KVCache):
            full, one = getattr(self.cache, f.name), getattr(one_cache, f.name)
            if full.dim() == 1:  # length (B,)
                full[b] = one[0]
            else:
                full[:, b] = one[:, 0]

    def _activate(self, b: int, req: Request, one: KVCache, logits):
        SPANS.enqueue()
        self._write_slot(b, one)
        if torch.is_tensor(logits):  # sync admission reads after the write
            logits = logits.cpu().numpy()
            SPANS.device_idle()
        self.active[b] = req
        self.pos[b] = len(req.prompt)
        self.remaining[b] = req.max_new_tokens
        tok = self._sample_with(req, logits)
        self.out[req.rid].tokens.append(tok)
        self.last_tok[b] = tok
        self.remaining[b] -= 1
        self._maybe_retire(b, tok)

    def _prompt(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.array(toks, np.int32), device=self.device)

    def _admit_sync(self):
        for b in range(self.n):
            if self.active[b] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            SPANS.enqueue()
            one = create_cache(self.dcfg, self.cfg.n_layers, 1,
                               device=self.device)
            one, logits = engine.prefill(self.params, self.cfg, self.dcfg,
                                         self.dq, one,
                                         self._prompt(req.prompt)[None])
            with SPANS.span("server.first_token", req.rid):
                self._activate(b, req, one, logits[0])

    # -- chunked (non-blocking) admission ------------------------------
    def _start_admissions(self):
        busy = {a.slot for a in self.admitting}
        for b in range(self.n):
            if self.active[b] is not None or b in busy or not self.queue:
                continue
            req = self.queue.popleft()
            S, chunk = self.dcfg.sink, self.admit_chunk
            T0 = len(req.prompt)
            assert T0 > S, "prompt must extend beyond the sink prefix"
            n_chunks = -(-(T0 - S) // chunk)
            toks = np.zeros((1, S + n_chunks * chunk), np.int32)
            toks[0, :T0] = req.prompt
            self.admitting.append(_Admission(req=req, slot=b, toks=toks,
                                             n_chunks=n_chunks))
            busy.add(b)

    def _step_admission(self, adm: _Admission):
        """Run ONE prompt chunk into the admission cache (reset at the
        admission's first chunk): its sub-chunks of ``sub_chunk`` rows
        (the first chunk's first with the sink rows before it), up to the
        one that holds the prompt's last real row. Returns the last
        sub-chunk's logits (1, V): those of the prompt's last real row
        once the chunk holds it."""
        S, chunk, w = self.dcfg.sink, self.admit_chunk, self.sub_chunk
        if self._adm is None:
            self._adm = AdmissionCache(self.params, self.cfg, self.dcfg,
                                       self.dq, self.device)
        T0 = len(adm.req.prompt)
        a = S + adm.ci * chunk  # the chunk's first packed position
        n_sub = -(-(min(a + chunk, T0) - a) // w)
        lo = 0 if adm.ci == 0 else a  # its first row, the sinks' at 0
        with SPANS.span("engine.chunk", adm.req.rid, self._stream):
            if adm.ci == 0:
                SPANS.enqueue()
                self._adm.start()
            toks = self._prompt(adm.toks[:, lo:a + n_sub * w])
            for j in range(n_sub):
                p = a + j * w
                r0 = lo if j == 0 else p
                logits = self._adm.chunk(
                    toks[:, r0 - lo:p + w - lo], p, r0 < S,
                    min(T0 - 1, p + w - 1) - r0)
        adm.ci += 1
        return logits

    def _finish_admission(self, adm: _Admission, logits):
        """After the admission's last chunk: read its last real row's
        logits and activate its slot."""
        self._adm.cache.length.fill_(len(adm.req.prompt))
        first = logits[0].cpu().numpy()
        SPANS.device_idle()
        # copied out on the stream, before the next admission's reset
        self._activate(adm.slot, adm.req, self._adm.cache, first)

    def _admit_chunked(self):
        self._start_admissions()
        if not self.admitting:
            return
        # at most ONE chunk of ONE admission per server step: the decode
        # stall per step is bounded by a single chunk
        adm = self.admitting[0]
        logits = self._step_admission(adm)
        if adm.ci == adm.n_chunks:
            self.admitting.pop(0)
            with SPANS.span("server.first_token", adm.req.rid):
                self._finish_admission(adm, logits)

    def _admit(self):
        if self.admit_mode == "sync":
            self._admit_sync()
        else:
            self._admit_chunked()

    def _sample_with(self, req: Request, logits: np.ndarray) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits / req.temperature
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    def _maybe_retire(self, b: int, tok: int):
        req = self.active[b]
        if req is None:
            return
        done = (
            self.remaining[b] <= 0
            or (req.eos_token_id is not None and tok == req.eos_token_id)
            or self.pos[b] + 1 >= self.dcfg.max_len
        )
        if done:
            self.active[b] = None

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """Admit (one prompt chunk max in chunked mode) and advance every
        active slot by one token. Returns True while any work remains."""
        with SPANS.span("server.step"):
            return self._step_spanned()

    def _step_spanned(self) -> bool:
        if self.queue or self.admitting:
            with SPANS.span("server.admit"):
                self._admit()
        if all(a is None for a in self.active):
            return bool(self.queue) or bool(self.admitting)

        if self._step is None:
            SPANS.enqueue()  # the capture's warm-up steps
            self._step = engine.decode_stepper(
                self.params, self.cfg, self.dcfg, self.dq, self.cache)
        with SPANS.span("engine.decode", stream=self._stream):
            logits = self._step(self._prompt(self.last_tok), self.pos)
        self.decode_steps += 1
        with SPANS.span("server.logits_read"):
            logits_np = logits.cpu().numpy()
            SPANS.device_idle()
        with SPANS.span("server.sample"):
            for b in range(self.n):
                if self.active[b] is None:
                    continue
                self.pos[b] += 1
                tok = self._sample_with(self.active[b], logits_np[b])
                self.out[self.active[b].rid].tokens.append(tok)
                self.last_tok[b] = tok
                self.remaining[b] -= 1
                self._maybe_retire(b, tok)
        return (bool(self.queue) or bool(self.admitting)
                or any(a is not None for a in self.active))

    def run(self, requests, max_steps: int = 10_000) -> dict[int, Completion]:
        for r in requests:
            self.submit(r)
        steps = 0
        while self.step():
            steps += 1
            assert steps < max_steps, "serving loop did not converge"
        return self.out


class ServerPool:
    """Capacity-class routing: one Server per cache-capacity class, so short
    requests do not reserve a ``max_len`` cache slot; routing picks the
    smallest class that fits prompt + max_new_tokens. ``classes``:
    {max_len: n_slots}."""

    def __init__(self, params, cfg: ModelConfig, dcfg: DeployConfig,
                 dq: DeployedQuant, classes: dict[int, int], seed: int = 0,
                 admit_mode: str = "chunked", admit_chunk: int = 256,
                 device="cuda"):
        self.servers: dict[int, Server] = {}
        for max_len, n_slots in sorted(classes.items()):
            d = replace(dcfg, max_len=max_len)
            self.servers[max_len] = Server(
                params, cfg, d, dq, n_slots=n_slots, seed=seed,
                admit_mode=admit_mode, admit_chunk=admit_chunk,
                device=device,
            )

    def _route(self, req: Request) -> Server:
        need = len(req.prompt) + req.max_new_tokens + 1
        for max_len, srv in self.servers.items():  # sorted ascending
            if need <= max_len:
                return srv
        raise ValueError(
            f"request {req.rid} needs {need} tokens; largest class is "
            f"{max(self.servers)}")

    def submit(self, req: Request):
        self._route(req).submit(req)

    def run(self, requests, max_steps: int = 10_000) -> dict[int, Completion]:
        for r in requests:
            self.submit(r)
        out: dict[int, Completion] = {}
        steps = 0
        live = True
        while live:
            live = False
            for srv in self.servers.values():
                live |= srv.step()
            steps += 1
            assert steps < max_steps, "serving loop did not converge"
        for srv in self.servers.values():
            out.update(srv.out)
        return out

    def cache_bytes(self) -> int:
        from .cache import cache_bytes

        return sum(cache_bytes(s.dcfg, s.cfg.n_layers, s.n)["total"]
                   for s in self.servers.values())
