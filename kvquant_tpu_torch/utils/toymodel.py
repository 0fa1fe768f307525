"""The trained toy model harness (port of kvquant_tpu/utils/toymodel.py): the
synthetic bigram language with a known entropy floor, the committed
checkpoint's config, training and the npz checkpoint format.

Without network access there is no wikitext and no LLaMA checkpoint, so
quantization quality is measured as ppl deltas of a small LLaMA trained
near the floor of this language (the reference's wikitext protocol).
``train_toy_model`` trains it with ``torch.optim.Adam`` (optax.adam's
update); ``save_toy_checkpoint`` writes the JAX package's npz keys, so
either package loads what the other wrote; ``cached_toy_model`` loads the
checkpoint, or trains and saves one on a miss.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..fisher.fisher import clm_loss
from ..models.config import ModelConfig
from ..models.llama import (Llama, init_params, params_from_numpy,
                            params_to_numpy, trainable)

TOY_CFG = ModelConfig(
    vocab_size=512, d_model=256, n_layers=4, n_heads=8, n_kv_heads=4,
    d_head=32, d_ff=512, max_seq_len=512,
)


class BigramLM:
    """Synthetic language with known next-token entropy (numpy; the same
    seed gives the JAX package's transition matrix and samples)."""

    def __init__(self, vocab_size: int, alpha: float = 0.05, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.trans = rng.dirichlet(
            np.full(vocab_size, alpha), size=vocab_size
        ).astype(np.float32)
        # each row's cumsum once: the same float32 values the JAX package
        # recomputes for every drawn token (a row's cumsum does not depend
        # on the other rows), so the same tokens
        self._cum = self.trans.cumsum(1)
        self.vocab_size = vocab_size

    @property
    def entropy(self) -> float:
        t = self.trans
        return float(-(t * np.log(t + 1e-12)).sum(1).mean())

    @property
    def ideal_ppl(self) -> float:
        return float(np.exp(self.entropy))

    def sample(self, n: int, seq_len: int, seed: int) -> torch.Tensor:
        """(n, seq_len) int32 token sequences (on the CPU)."""
        r = np.random.default_rng(seed)
        out = np.empty((n, seq_len), np.int32)
        out[:, 0] = r.integers(0, self.vocab_size, n)
        u = r.random((seq_len, n, 1), np.float32)
        for t in range(1, seq_len):
            out[:, t] = (self._cum[out[:, t - 1]] > u[t]).argmax(1)
        return torch.from_numpy(out)


def adam(params: Llama, lr: float) -> torch.optim.Adam:
    """optax.adam(lr): m_hat / (sqrt(v_hat) + eps), eps outside the root."""
    return torch.optim.Adam(params.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def train_step(opt: torch.optim.Optimizer, loss: torch.Tensor):
    """One update of ``opt``'s parameters down the gradient of ``loss``;
    returns ``loss``, detached (still on the device)."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def to_device(tokens: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host batch on ``dev`` without waiting for the device: a plain
    copy to a card synchronizes the stream, so the batch goes through
    pinned memory with a non-blocking copy, and the host draws the next
    batch while the card runs this step."""
    if dev.type != "cuda":
        return tokens.to(dev)
    return tokens.pin_memory().to(dev, non_blocking=True)


def train_toy_model(cfg: ModelConfig = TOY_CFG, steps: int = 1200,
                    batch: int = 16, seq_len: int = 256, lr: float = 1e-3,
                    seed: int = 0, device="cuda", init: dict | None = None):
    """Train a small LLaMA on the bigram language, in fp32, on ``device``.
    Returns (params (frozen), lm, final loss). ``init`` (a nested dict of
    numpy arrays, e.g. ``load_toy_checkpoint``'s) gives the initial
    weights; without it they are drawn from ``seed`` (torch's draws, not
    jax.random's). The batches are the JAX package's numpy draws. Nothing
    waits for the device until the end: the batches go over
    asynchronously (``to_device``) and the loss is read once."""
    dev = resolve_device(device)
    lm = BigramLM(cfg.vocab_size, seed=seed)
    params = trainable(
        init_params(cfg, dtype=torch.float32, device=dev, seed=seed)
        if init is None else params_from_numpy(init, cfg, device=dev))
    opt = adam(params, lr)
    loss = None
    for i in range(steps):
        tokens = to_device(lm.sample(batch, seq_len, i), dev)
        loss = train_step(opt, clm_loss(params, cfg, tokens))
    return params.requires_grad_(False), lm, float(loss)


def _flatten(params: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def save_toy_checkpoint(path: str, params, loss: float, seed: int):
    """npz checkpoint (slash-joined pytree paths, the JAX package's keys
    and no-pickle policy) of ``params``: a ``Llama`` or its nested dict of
    numpy arrays."""
    if isinstance(params, Llama):
        params = params_to_numpy(params)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path, __loss__=np.float32(loss), __seed__=np.int32(seed),
        **_flatten(params),
    )


def load_toy_checkpoint(path: str):
    """npz checkpoint (slash-joined pytree paths) -> (nested dict of numpy
    arrays, final training loss, seed); ``params_from_numpy`` turns the
    dict into a model."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if not k.startswith("__")}
        loss = float(z["__loss__"])
        seed = int(z["__seed__"])
    return _unflatten(flat), loss, seed


def cached_toy_model(path: str = "artifacts/toy_model.npz", cfg=TOY_CFG,
                     device="cuda", **kw):
    """(params on ``device``, BigramLM, final training loss) of the
    checkpoint at ``path``; on a miss, ``train_toy_model(cfg, **kw)`` on
    ``device`` and save its result there first."""
    if not os.path.exists(path):
        params, lm, loss = train_toy_model(cfg, device=device, **kw)
        save_toy_checkpoint(path, params, loss, kw.get("seed", 0))
        return params, lm, loss
    tree, loss, seed = load_toy_checkpoint(path)
    return (params_from_numpy(tree, cfg, device=device),
            BigramLM(cfg.vocab_size, seed=seed), loss)
