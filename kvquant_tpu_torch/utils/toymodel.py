"""The committed trained toy checkpoint (port of
kvquant_tpu/utils/toymodel.py:23,120): its config and an npz reader of the
port's own. Training the toy model stays with the JAX package."""

from __future__ import annotations

import numpy as np

from ..models.config import ModelConfig

TOY_CFG = ModelConfig(
    vocab_size=512, d_model=256, n_layers=4, n_heads=8, n_kv_heads=4,
    d_head=32, d_ff=512, max_seq_len=512,
)


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
