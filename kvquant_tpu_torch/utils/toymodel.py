"""The trained toy model harness (port of kvquant_tpu/utils/toymodel.py): the
synthetic bigram language with a known entropy floor, the committed
checkpoint's config and an npz reader of the port's own.

Without network access there is no wikitext and no LLaMA checkpoint, so
quantization quality is measured as ppl deltas of a small LLaMA trained
near the floor of this language (the reference's wikitext protocol).
Training the toy model stays with the JAX package (it needs optax):
``cached_toy_model`` loads the committed checkpoint and raises where the
JAX package would train one.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.config import ModelConfig

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
            out[:, t] = (
                self.trans[out[:, t - 1]].cumsum(1) > u[t]
            ).argmax(1)
        return torch.from_numpy(out)


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


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
                     device="cuda"):
    """(params on ``device``, BigramLM, final training loss) of the trained
    checkpoint at ``path``; a missing checkpoint raises (train it with the
    JAX package: kvquant_tpu.utils.toymodel.cached_toy_model)."""
    from ..models.llama import params_from_numpy

    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: no toy checkpoint; training it needs the JAX package "
            f"(kvquant_tpu.utils.toymodel.cached_toy_model)")
    tree, loss, seed = load_toy_checkpoint(path)
    return (params_from_numpy(tree, cfg, device=device),
            BigramLM(cfg.vocab_size, seed=seed), loss)
