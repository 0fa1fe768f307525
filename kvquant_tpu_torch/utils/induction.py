"""Induction-retrieval language and its trained checkpoint (port of
kvquant_tpu/utils/induction.py): real long-context retrieval measured
without network access.

The bigram toy (utils/toymodel.py) has no retrieval ability, so its needle
numbers only measure fp16 parity. This language needs a long-range
induction circuit: haystacks over a 500-token alphabet with planted needles
``[QUERY, key, v1, v2]`` (keys from a disjoint 10-token alphabet) or
planted segments that reappear after a position jump; a small LLaMA
trained on it (``train_induction_model``, then
``finetune_retrieval_robust``) retrieves through the quantized cache at
long context. The JAX module's docstrings give the history of each
sampler and curriculum stage.

Length generalization comes from position jumps: a batch computes T
tokens, but the positions jump by up to ~128K before the query block
(``forward(..., positions=...)``), so RoPE attention trains at the
distances a long-context eval exercises. Loss is masked to the answer
tokens.

The samplers run on the device from an explicit ``torch.Generator`` (the
counterpart of a jax.random key; the draws differ from jax.random's, so
they match the JAX package by structure and marginals, not bit for bit).
``difficulty`` may be a tensor, and no sampler reads a device value on the
host. The eval prompts (``build_retrieval_prompt``, ``build_copy_prompt``)
are numpy and equal the JAX package's bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.llama import (Llama, forward, init_params, params_from_numpy,
                            trainable)
from .toymodel import (adam, load_toy_checkpoint, save_toy_checkpoint,
                       train_step)

HAY = 500          # haystack alphabet [0, HAY)
KEY0, NKEYS = 500, 10  # key alphabet [KEY0, KEY0+NKEYS), disjoint from HAY
QUERY = 511
VL = 2             # value token count
N_NEEDLES = 3      # planted needles (distinct keys; one is queried)
W = 2 + VL         # planted needle width ([QUERY, key, values])
QW = 1 + 1 + VL    # query block width ([QUERY, key, values])
SEG_LEN = 48       # nominal segment length (eval probes use <= this)
SEG_MIN = 8        # shortest trained copy segment

IND_CFG = ModelConfig(
    vocab_size=512, d_model=256, n_layers=4, n_heads=8, n_kv_heads=4,
    d_head=32, d_ff=512, max_seq_len=131072 + 512,
    # long-context RoPE base: at theta 1e4 and d_head 32 the lowest band
    # rotates ~23 rad across a 128K jump; 1e7 leaves ~0.04 rad
    rope_theta=1e7,
)

# the same file as the JAX package's: one checkpoint serves both
CKPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "artifacts", "induction_model.npz",
)


def generator(seed: int, device="cuda") -> torch.Generator:
    """A torch.Generator on ``device`` seeded with ``seed`` (the port's
    ``jax.random.PRNGKey(seed)``)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def _randint(gen, lo, hi, shape):
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device)


def _uniform(gen, shape):
    return torch.rand(shape, generator=gen, device=gen.device)


def _plant(toks, seg, start, Lw, idx):
    """``toks`` with seg[:, :Lw] written at ``start`` in each row."""
    rel = idx[None, :] - start
    inside = (rel >= 0) & (rel < Lw)
    g = torch.gather(seg, 1, rel.clamp(0, seg.shape[1] - 1))
    return torch.where(inside, g, toks)


def _jumped(idx, start, jump):
    """Positions ``idx`` shifted by ``jump`` (B, 1) from ``start`` on."""
    return idx[None, :] + torch.where(idx[None, :] >= start, jump, 0)


def _scalar(difficulty, dev):
    """``difficulty`` as a 0-d fp32 tensor on ``dev``; a float is filled
    in on the device (a host-to-device copy would wait for the stream)."""
    if isinstance(difficulty, torch.Tensor):
        return difficulty.to(dev, torch.float32)
    return torch.full((), float(difficulty), dtype=torch.float32, device=dev)


def _out(toks, positions, mask):
    return toks.to(torch.int32), positions.to(torch.int32), mask


def sample_batch(gen: torch.Generator, batch: int, T: int, max_jump: int):
    """One needle batch. Returns (tokens (B, T) int32, positions (B, T)
    int32, loss_mask (B, T) bool: True on the answer tokens of the query
    block only)."""
    idx = torch.arange(T, device=gen.device)
    toks = _randint(gen, 0, HAY, (batch, T))
    # distinct keys per sequence: the first N_NEEDLES of a per-row
    # permutation of the key alphabet
    keys = KEY0 + _uniform(gen, (batch, NKEYS)).argsort(dim=1)[:, :N_NEEDLES]
    vals = _randint(gen, 0, HAY, (batch, N_NEEDLES, VL))

    region = T - QW                      # needles live in [0, region)
    slice_len = region // N_NEEDLES      # disjoint slice per needle
    offs = _randint(gen, 0, slice_len - W, (batch, N_NEEDLES))
    starts = offs + slice_len * torch.arange(N_NEEDLES, device=gen.device)
    query = torch.full((batch, 1), QUERY, device=gen.device)
    for n in range(N_NEEDLES):
        pattern = torch.cat([query, keys[:, n:n + 1], vals[:, n]], dim=1)
        toks = _plant(toks, pattern, starts[:, n:n + 1], W, idx)

    qi = _randint(gen, 0, N_NEEDLES, (batch, 1))
    qk = torch.gather(keys, 1, qi)
    qv = torch.gather(vals, 1, qi[:, :, None].expand(batch, 1, VL))[:, 0]
    toks = torch.cat([toks[:, :region], query, qk, qv], dim=1)

    jump = _randint(gen, 0, max_jump, (batch, 1))
    mask = ((idx >= region + 2) & (idx < region + 2 + VL)).expand(batch, T)
    return _out(toks, _jumped(idx, region, jump), mask)


def sample_repeat_batch(gen: torch.Generator, batch: int, T: int,
                        max_jump: int):
    """Repeated-segment sequences ``[segment (T/2) | jump | segment]``
    over the full vocab; the loss covers the second half but its first
    token."""
    R = T // 2
    idx = torch.arange(T, device=gen.device)
    seg = _randint(gen, 0, QUERY + 1, (batch, R))
    toks = torch.cat([seg, seg], dim=1)
    jump = _randint(gen, 0, max_jump, (batch, 1))
    mask = (idx >= R + 1).expand(batch, T)
    return _out(toks, _jumped(idx, R, jump), mask)


def sample_copy_batch(gen: torch.Generator, batch: int, T: int,
                      max_jump: int, difficulty=1.0):
    """Noise-embedded segment copy with a continuous ``difficulty`` d in
    [0, 1] (a float or a 0-d tensor): from the full repeat (Lw = T/2,
    source at 0, copy at T/2) to Lw ~ U[SEG_MIN, T/2] at random offsets.
    An Lw-token segment planted in the first half reappears in the jumped
    second half; the loss covers its continuation (Lw - 1 tokens)."""
    dev = gen.device
    R = T // 2
    d = _scalar(difficulty, dev)
    idx = torch.arange(T, device=dev)
    toks = _randint(gen, 0, HAY, (batch, T))
    seg = _randint(gen, 0, HAY, (batch, R))
    # Lw ~ U[lw_min(d), R] with lw_min: R -> SEG_MIN
    lw_min = torch.round(R - d * (R - SEG_MIN)).to(torch.int64)
    Lw = lw_min + torch.floor(_uniform(gen, (batch, 1))
                              * (R - lw_min + 1)).to(torch.int64)
    # start offsets ~ U[0, d * (R - Lw)]
    s1 = torch.floor(_uniform(gen, (batch, 1))
                     * (d * (R - Lw) + 1)).to(torch.int64)
    s2 = R + torch.floor(_uniform(gen, (batch, 1))
                         * (d * (R - Lw) + 1)).to(torch.int64)
    toks = _plant(_plant(toks, seg, s1, Lw, idx), seg, s2, Lw, idx)
    jump = _randint(gen, 0, max_jump, (batch, 1))
    rel2 = idx[None, :] - s2
    mask = (rel2 >= 1) & (rel2 < Lw)
    return _out(toks, _jumped(idx, R, jump), mask)


def sample_mixed_batch(gen: torch.Generator, batch: int, T: int,
                       max_jump: int, difficulty=1.0):
    """The annealed noise-embedded copy of stage 1 (``sample_copy_batch``)."""
    return sample_copy_batch(gen, batch, T, max_jump, difficulty)


def sample_blocks_batch(gen: torch.Generator, batch: int, T: int,
                        difficulty=1.0):
    """Stage 2: six 128-token history blocks separated by independent
    position jumps (half zero, half ~U[0, 16K]); an Lw-token segment
    planted in a history block (the last at d = 0, a uniform one at d = 1)
    reappears in the query region (the last T - 768 tokens)."""
    NB_BLOCKS, BLOCK = 6, 128
    H0 = NB_BLOCKS * BLOCK
    QH = T - H0
    assert QH >= 64, (T, H0)
    dev = gen.device
    d = _scalar(difficulty, dev)
    idx = torch.arange(T, device=dev)
    toks = _randint(gen, 0, HAY, (batch, T))
    seg = _randint(gen, 0, HAY, (batch, BLOCK))
    u_blk = _uniform(gen, (batch, 1))
    blk = torch.where(_uniform(gen, (batch, 1)) < d,
                      torch.floor(u_blk * NB_BLOCKS),
                      float(NB_BLOCKS - 1)).to(torch.int64)
    lw_min = torch.round(BLOCK - d * (BLOCK - SEG_MIN)).to(torch.int64)
    Lw = lw_min + torch.floor(_uniform(gen, (batch, 1))
                              * (BLOCK - lw_min + 1)).to(torch.int64)
    s1 = blk * BLOCK + torch.floor(_uniform(gen, (batch, 1))
                                   * (d * (BLOCK - Lw) + 1)).to(torch.int64)
    s2 = H0 + torch.floor(_uniform(gen, (batch, 1))
                          * (d * (QH - Lw) + 1)).to(torch.int64)
    toks = _plant(_plant(toks, seg, s1, Lw, idx), seg, s2, Lw, idx)
    jz = _randint(gen, 0, 16384, (batch, NB_BLOCKS))
    jumps = torch.where(_uniform(gen, (batch, NB_BLOCKS)) < 0.5, jz, 0)
    bnd = (torch.arange(NB_BLOCKS, device=dev) + 1) * BLOCK
    after = idx[None, None, :] >= bnd[None, :, None]  # (1, NB, T)
    positions = idx[None, :] + (after * jumps[:, :, None]).sum(dim=1)
    rel2 = idx[None, :] - s2
    mask = (rel2 >= 1) & (rel2 < Lw)
    return _out(toks, positions, mask)


def sample_long_batch(gen: torch.Generator, batch: int, T: int,
                      qz: int = 256, max_jump: int = 131072,
                      seg_max: int = 128):
    """Stage 3: long real context. A segment (Lw ~ U[SEG_MIN, seg_max])
    planted anywhere in the first T - qz tokens reappears in the last qz
    (the query zone, after a position jump of up to ``max_jump``)."""
    dev = gen.device
    H0 = T - qz
    idx = torch.arange(T, device=dev)
    toks = _randint(gen, 0, HAY, (batch, T))
    seg = _randint(gen, 0, HAY, (batch, seg_max))
    Lw = SEG_MIN + torch.floor(_uniform(gen, (batch, 1))
                               * (seg_max - SEG_MIN + 1)).to(torch.int64)
    s1 = torch.floor(_uniform(gen, (batch, 1))
                     * (H0 - Lw + 1)).to(torch.int64)
    s2 = H0 + torch.floor(_uniform(gen, (batch, 1))
                          * (qz - Lw + 1)).to(torch.int64)
    toks = _plant(_plant(toks, seg, s1, Lw, idx), seg, s2, Lw, idx)
    jump = _randint(gen, 0, max_jump, (batch, 1))
    rel2 = idx[None, :] - s2
    mask = (rel2 >= 1) & (rel2 < Lw)
    return _out(toks, _jumped(idx, H0, jump), mask)


def _masked_nll(logits, toks, mask):
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    tgt = toks[:, 1:].long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    m = mask[:, 1:].to(torch.float32)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def masked_loss(params: Llama, cfg: ModelConfig, toks, positions, mask):
    """Cross-entropy on the masked label positions only (the haystack is
    uniform noise)."""
    logits, _ = forward(params, cfg, toks, positions=positions)
    return _masked_nll(logits, toks.to(logits.device), mask)


def _difficulty(s: int, r0: int, r1: int) -> float:
    return min(max((s - r0) / max(r1 - r0, 1), 0.0), 1.0)


def train_induction_model(cfg: ModelConfig = IND_CFG, steps: int = 16000,
                          batch: int = 32, seq_len: int = 512,
                          max_jump: int = 131072, lr: float = 1e-3,
                          seed: int = 0, segment: int = 250, log=print,
                          device="cuda"):
    """Train the retrieval checkpoint on ``device``, in fp32. Stage 1:
    ``steps`` of the annealed copy task (repeat for the first 1/8, ramp to
    full difficulty by 5/8), batch ``batch`` x ``seq_len``; stage 2:
    steps * 5/8 of the multi-block task at twice the length and half the
    batch, with a fresh optimizer. Step s draws its batch from a generator
    seeded 1000 + s (stage 2: 10**6 + s). The loss is read on the host
    every ``segment`` steps and at each stage's end, with stage 1's loss at
    full difficulty. The initial weights are drawn from ``seed`` (torch's
    draws). Returns (params, final masked loss); the params are frozen (no
    grad)."""
    dev = resolve_device(device)
    params = trainable(init_params(cfg, dtype=torch.float32, device=dev,
                                   seed=seed))

    def step(opt, batch_of):
        return train_step(opt, masked_loss(params, cfg, *batch_of))

    opt = adam(params, lr)
    ramp0, ramp1 = steps // 8, 5 * steps // 8
    loss = float("nan")
    for s in range(steps):
        d = _difficulty(s, ramp0, ramp1)
        loss_d = step(opt, sample_mixed_batch(generator(1000 + s, dev), batch,
                                              seq_len, max_jump, d))
        if (s + 1) % segment == 0 or s + 1 == steps:
            loss = float(loss_d)
            with torch.no_grad():
                # loss at full difficulty: the distribution the eval draws
                lc = float(masked_loss(params, cfg, *sample_copy_batch(
                    generator(17 + s, dev), batch, seq_len, max_jump, 1.0)))
            log(f"[induction] stage1 step {s + 1} d={d:.2f}: masked loss "
                f"{loss:.4f} (full-difficulty {lc:.4f})")

    # stage 2: multi-block jumped history, warm-started from stage 1
    steps2 = steps * 5 // 8
    T2, B2 = seq_len * 2, max(batch // 2, 1)
    opt = adam(params, lr)
    r0, r1 = steps2 // 20, 7 * steps2 // 20
    for s in range(steps2):
        d = _difficulty(s, r0, r1)
        loss_d = step(opt, sample_blocks_batch(generator(10 ** 6 + s, dev),
                                               B2, T2, d))
        if (s + 1) % segment == 0 or s + 1 == steps2:
            loss = float(loss_d)
            log(f"[induction] stage2 step {s + 1} d={d:.2f}: masked loss "
                f"{loss:.4f}")
    return params.requires_grad_(False), loss


def kv_stds(params: Llama, cfg: ModelConfig):
    """Per-layer std (over batch, tokens, channels) of the k and v
    projections on a full-difficulty copy batch (4 x 512, generator 0):
    the scale of the fine-tune's noise."""
    toks, pos, _ = sample_copy_batch(generator(0, params.embed.device), 4,
                                     512, 1000, 1.0)
    with torch.no_grad():
        _, aux = forward(params, cfg, toks, positions=pos, capture_kv=True)
    return (aux["k_acts"].std(dim=(1, 2, 3), correction=0),
            aux["v_acts"].std(dim=(1, 2, 3), correction=0))


def noise_probes(gen: torch.Generator, cfg: ModelConfig, B: int, T: int,
                 kscale, vscale) -> dict:
    """Gaussian {"k", "v"} probes (L, B, T, kv_hidden), per-layer std
    ``kscale`` / ``vscale`` (L,)."""
    shape = (cfg.n_layers, B, T, cfg.kv_hidden)
    return {n: torch.randn(shape, generator=gen, device=gen.device)
            * sc[:, None, None, None]
            for n, sc in (("k", kscale), ("v", vscale))}


def noisy_loss(params: Llama, cfg: ModelConfig, toks, pos, mask,
               probes: dict, chunk: int | None = None,
               remat: bool = False):
    """``masked_loss`` with ``probes`` added to every layer's k / v
    projections (``forward``'s kv_probes hook)."""
    logits, _ = forward(params, cfg, toks, positions=pos, kv_probes=probes,
                        attn_chunk=chunk, remat=remat)
    return _masked_nll(logits, toks.to(logits.device), mask)


def finetune_retrieval_robust(params: Llama, cfg: ModelConfig = IND_CFG,
                              steps: int = 3000, long_T: int = 8192,
                              k_noise: float = 0.08, v_noise: float = 0.05,
                              lr: float = 3e-4, log=print):
    """Stages 3-5: the noise-robust long-context fine-tune, in place on
    the fp32 ``params`` (on their device; frozen again on return).
    Gaussian noise at ``k_noise`` / ``v_noise`` of each layer's K / V std
    enters the projections; each
    step takes an Adam update on a 2 x ``long_T`` long batch (chunked
    attention, chunk 1024, with remat), then one on an 8 x 1024 blocks
    batch at full difficulty, both drawn from a generator seeded
    11 * 10**6 + s. Returns params."""
    dev = params.embed.device
    kstd, vstd = kv_stds(params, cfg)
    kscale, vscale = k_noise * kstd, v_noise * vstd
    opt = adam(params.requires_grad_(True), lr)

    def update(batch_of, gen, chunk, remat):
        toks, pos, mask = batch_of
        B, T = toks.shape
        probes = noise_probes(gen, cfg, B, T, kscale, vscale)
        return train_step(opt, noisy_loss(params, cfg, toks, pos, mask,
                                          probes, chunk, remat))

    for s in range(steps):
        gen = generator(11 * 10 ** 6 + s, dev)
        l1 = update(sample_long_batch(gen, 2, long_T), gen, 1024, True)
        l2 = update(sample_blocks_batch(gen, 8, 1024, 1.0), gen, None, False)
        if (s + 1) % 250 == 0 or s + 1 == steps:
            log(f"[induction] robust step {s + 1}: long {float(l1):.4f} "
                f"blocks {float(l2):.4f}")
    return params.requires_grad_(False)


def cached_induction_model(path: str = CKPT, log=print, device="cuda"):
    """(params on ``device``, final masked loss) of the retrieval
    checkpoint at ``path``; on a miss, train, fine-tune and save it."""
    if os.path.exists(path):
        tree, loss, _ = load_toy_checkpoint(path)
        return params_from_numpy(tree, IND_CFG, device=device), loss
    params, loss = train_induction_model(log=log, device=device)
    params = finetune_retrieval_robust(params, log=log)
    save_toy_checkpoint(path, params, loss, seed=0)
    return params, loss


# ---------------------------------------------------------------------------
# evaluation prompts (numpy: the JAX package's draws)
# ---------------------------------------------------------------------------


def build_retrieval_prompt(ctx: int, depth: float, seed: int):
    """A ctx-token haystack with the queried needle at ``depth`` in [0, 1]
    and N_NEEDLES - 1 distractors at other depths, ending in the query
    block [QUERY, key]. Returns (ids (ctx,) int32, answer (VL,) int32)."""
    r = np.random.default_rng(seed)
    ids = r.integers(0, HAY, size=ctx).astype(np.int32)
    keys = KEY0 + r.permutation(NKEYS)[:N_NEEDLES]
    vals = r.integers(0, HAY, size=(N_NEEDLES, VL))

    region = ctx - 2  # prompt ends after [QUERY, key]
    starts = [int(depth * (region - W))]
    while len(starts) < N_NEEDLES:
        s = int(r.integers(0, region - W))
        if all(abs(s - t) >= W for t in starts):
            starts.append(s)
    for n, s in enumerate(starts):
        ids[s] = QUERY
        ids[s + 1] = keys[n]
        ids[s + 2:s + W] = vals[n]
    ids[region] = QUERY
    ids[region + 1] = keys[0]
    return ids, vals[0].astype(np.int32)


def build_copy_prompt(ctx: int, depth: float, seed: int,
                      prefix: int = 16, answer: int = VL):
    """Segment-copy retrieval prompt (the format sample_copy_batch
    trains): a (prefix + answer)-token segment planted at ``depth`` in a
    ctx-token haystack, a distractor segment at another depth, and the
    prompt ending in the segment's first ``prefix`` tokens. Returns (ids
    (ctx,) int32, answer (answer,) int32)."""
    r = np.random.default_rng(seed)
    ids = r.integers(0, HAY, size=ctx).astype(np.int32)
    Lw = prefix + answer
    region = ctx - prefix
    s = int(depth * (region - Lw))
    seg = r.integers(0, HAY, size=Lw).astype(np.int32)
    while True:
        sd = int(r.integers(0, region - Lw))
        if abs(sd - s) >= Lw:
            break
    ids[sd:sd + Lw] = r.integers(0, HAY, size=Lw)
    ids[s:s + Lw] = seg
    ids[region:] = seg[:prefix]
    return ids, seg[prefix:].astype(np.int32)
