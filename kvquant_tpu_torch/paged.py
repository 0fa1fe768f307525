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
it to each jitted step); page tables, positions and the active mask are
host values (numpy), as the server keeps them; the JAX package's jitted
step and its ``lax.scan`` burst become Python loops whose kernels run on
the card.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from .cache import (DeployConfig, DeployedQuant, check_intn_codebook,
                    create_cache, k_channel_index)
from .device import resolve_device
from .models import llama
from .models.config import ModelConfig
from .ops.deployed import _encode_rows, quantize_k, quantize_v
# the paged kernel K5, here under its JAX name (paged.paged_flash_decode)
from .ops.kernels.paged_decode import paged_flash_decode
from .ops.packing import set_token_codes, set_token_rows


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


def _host(a) -> np.ndarray:
    """A page table, position vector or mask as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def _positions(pos, B: int) -> list[int]:
    """``pos`` (an int or B values, host or tensor) as B host integers."""
    return [int(p) for p in np.broadcast_to(_host(pos).reshape(-1), (B,))]


# ---------------------------------------------------------------------------
# append + page-granular writes
# ---------------------------------------------------------------------------


def paged_append_token(pool: PagedPool, page_table, lq: DeployedQuant,
                       dcfg: DeployConfig, mcfg: ModelConfig, k_new, v_new,
                       pos, li: int, active=None) -> PagedPool:
    """Append one token per slot at layer ``li``, in place: packed position
    p maps to (page_table[b, p // P], p % P). Row-level writes through
    views of ``pool[li, page]`` (``packing.set_token_codes`` /
    ``set_token_rows``), as the contiguous append. ``active`` (B,) bool:
    slots that are False write NOTHING (a paged slot's table row may alias
    pages that now belong to another request). ``page_table`` (B, MP),
    ``pos`` and ``active`` are host values."""
    B = k_new.shape[0]
    S, P = dcfg.sink, dcfg.page_tokens
    Hkv, Dh = dcfg.n_kv_heads, dcfg.d_head
    table = _host(page_table)
    MP = table.shape[1]
    pl = _positions(pos, B)
    act = [True] * B if active is None else \
        [bool(x) for x in _host(active).reshape(-1)]
    in_sink = [p < S and a for p, a in zip(pl, act)]
    not_sink = [p >= S and a for p, a in zip(pl, act)]
    pk = [max(p - S, 0) for p in pl]
    page_of = [int(table[b, min(pk[b] // P, MP - 1)]) for b in range(B)]
    row = [x % P for x in pk]

    dev = k_new.device
    cos, sin = llama.rope_cos_sin(
        torch.tensor(pl, dtype=torch.int32, device=dev), mcfg)
    k_h = k_new.reshape(B, Hkv, Dh).to(torch.float32)
    k_roped = k_h * cos[:, None] + llama.rotate_half(k_h) * sin[:, None]
    k_store = k_roped.reshape(B, Hkv * Dh) if dcfg.post_rope_k else k_new
    codes_k, k_words = quantize_k(k_store, lq, dcfg)
    codes_v, v_words, v_sc, v_off = quantize_v(v_new, lq, dcfg)
    nuq = dcfg.codes == "nuq"
    rows_k = codes_k if nuq else _encode_rows(codes_k, dcfg)  # (B, H', Dc)
    rows_v = codes_v if nuq else _encode_rows(codes_v, dcfg)
    put = set_token_codes if nuq else set_token_rows
    v_h = v_new.reshape(B, Hkv, Dh).to(torch.float32)
    spk = dcfg.slots_per_kind

    # two active slots never share a page row, so the order is irrelevant
    for b in range(B):
        if not_sink[b]:
            pg, r = page_of[b], row[b]
            put(pool.k_planes[li, pg], rows_k[b], r)
            put(pool.v_planes[li, pg], rows_v[b], r)
            if dcfg.include_sparse:
                pool.kv_out[li, pg, :, :spk, r] = k_words[b]
                if v_words is not None:
                    pool.kv_out[li, pg, :, spk:spk + v_words.shape[-1],
                                r] = v_words[b]
            pool.v_scale[li, pg, r] = v_sc[b]
            pool.v_offset[li, pg, r] = v_off[b]
        elif in_sink[b] and S > 0:
            pool.k_sink[li, b, :, pl[b]] = k_roped[b]
            pool.v_sink[li, b, :, pl[b]] = v_h[b]
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
    ids = [int(i) for i in _host(page_ids).reshape(-1)]
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
                      pos, active=None):
    """One decode step over the paged pool: append at each slot's position
    and attend through its page table, every layer (the pool in place).
    token (B,) int (on the card a device tensor, so a burst's tokens never
    leave it); page_table (B, MP), pos (B,) and active (B,) are host
    values. Returns (pool, logits (B, V) fp32)."""
    from .engine import _logits, _mlp

    check_intn_codebook(dcfg, dq)
    B = token.shape[0]
    H, Dh, Hkv = cfg.n_heads, cfg.d_head, cfg.n_kv_heads
    G = H // Hkv
    dev = params.embed.device
    table = _host(page_table).astype(np.int32)
    pl = _positions(pos, B)
    posb = torch.tensor(pl, dtype=torch.int32, device=dev)
    table_d = torch.as_tensor(table, device=dev)
    cos, sin = llama.rope_cos_sin(posb, cfg)
    k_chan = None
    if dcfg.include_sparse and dcfg.k_outliers == "channels":
        k_chan = k_channel_index(dq.k_ressc, dcfg).to(torch.int32)

    x = params.embed[token.to(dev).long()]
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        h = llama.norm(x, lp["ln_attn"], cfg)
        q = (h @ lp["wq"]).reshape(B, H, Dh)
        k = h @ lp["wk"]
        v = h @ lp["wv"]
        paged_append_token(pool, table, dq.layer(li), dcfg, cfg, k, v, pl, li,
                           active)
        q_h = q.reshape(B, Hkv, G, Dh).to(torch.float32)
        q_rot = q_h * cos[:, None, None] + (
            llama.rotate_half(q_h) * sin[:, None, None])
        attn = paged_flash_decode(q_rot, pool, table_d, dq, li, posb, dcfg,
                                  cfg, k_chan=k_chan)
        x = x + attn.reshape(B, H * Dh).to(x.dtype) @ lp["wo"]
        x = _mlp(x, lp, cfg)
    return pool, _logits(params, x, cfg)


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
    and the temporary caches (default "cuda")."""

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
                cache=create_cache(tmp_dcfg, self.cfg.n_layers, 1,
                                   device=self.device),
                toks=toks, n_chunks=n_chunks, ci=0,
            ))

    def _step_admission(self, adm) -> bool:
        """Run ONE quantized-trajectory prompt chunk; True when finished."""
        S, chunk = self.dcfg.sink, self.admit_chunk
        ci = adm["ci"]
        if ci == 0:
            blk, pos0, sf = adm["toks"][:, :S + chunk], S, True
        else:
            a = S + ci * chunk
            blk, pos0, sf = adm["toks"][:, a:a + chunk], a, False
        adm["cache"], logits = self._engine.prefill_chunk(
            self.params, self.cfg, adm["tmp_dcfg"], self.dq, adm["cache"],
            torch.as_tensor(blk, device=self.device), pos0, sf)
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
            self._activate(adm["req"], adm["slot"], adm["pages"],
                           adm["cache"], adm["last_logits"])

    def _admit(self):
        if self.admit_mode == "chunked":
            self._admit_chunked()
        else:
            self._admit_sync()

    # -- device-side decode bursts --------------------------------------
    def _step_burst(self) -> int:
        """Run one burst: H = largest power of two <= min remaining budget
        over active slots (so no slot overshoots its reserved pages),
        capped at ``self.burst``; H greedy steps whose argmax and next
        token stay on the device, then ONE host read of the H tokens per
        slot. The page table and active mask are fixed for the burst.
        Falls back to a single hosted step when no slot is active, H < 2,
        or any active request samples with a temperature (host RNG). EOS
        inside a burst wastes the slot's tail steps (junk appends land in
        the slot's own reserved pages); the tokens after it are discarded
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
        act = self.active.copy()
        act_d = torch.as_tensor(act, device=self.device)
        tok = torch.as_tensor(self._last_tok, device=self.device)
        emitted = []
        for h in range(H):
            _, logits = paged_decode_step(
                self.params, self.cfg, self.dcfg, self.dq, self.pool,
                self.table, tok, self.pos + h * act, act)
            emitted.append(tok)  # the token APPENDED this step
            nxt = torch.argmax(logits, -1).to(torch.int32)
            tok = torch.where(act_d, nxt, tok)
        out = torch.stack(emitted + [tok]).cpu().numpy()  # the one read
        toks = out[:H]  # (H, n_slots)
        self._last_tok = out[H].astype(np.int32)
        self.pos = (self.pos + H * act).astype(np.int32)
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
        _, logits = paged_decode_step(
            self.params, self.cfg, self.dcfg, self.dq, self.pool, self.table,
            torch.as_tensor(self._last_tok, device=self.device), self.pos,
            self.active)
        logits = logits.cpu().numpy()
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
