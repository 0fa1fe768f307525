"""KV-cache checkpointing: save and restore a packed quantized cache (port
of kvquant_tpu/cache_io.py).

The file is the JAX package's npz: one array per ``KVCache`` field under
its name, in JAX's shapes, and ``__dcfg__``, the JSON of the
``DeployConfig`` as uint8 bytes. Either package loads a file the other
wrote. The int4 and int4x2 containers, uint8 nibble pairs (..., D/2) here,
are written as the int8 codes of JAX's (..., D) arrays and packed back
into nibbles on load, for both modes (JAX's ``load_cache`` restores only
``codes="int4"`` to its int4 dtype and returns int4x2 codes as int8).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .cache import DeployConfig, KVCache
from .device import resolve_device
from .ops.packing import pack_nibbles, unpack_nibbles

_CODES = ("k_planes", "v_planes")


def _nibbles(dcfg: DeployConfig, name: str) -> bool:
    return name in _CODES and dcfg.codes in ("int4", "int4x2")


def save_cache(path: str, cache: KVCache, dcfg: DeployConfig) -> None:
    arrays = {}
    for f in dataclasses.fields(KVCache):
        a = getattr(cache, f.name)
        if _nibbles(dcfg, f.name):
            a = unpack_nibbles(a).to(torch.int8)
        arrays[f.name] = a.cpu().numpy()
    arrays["__dcfg__"] = np.frombuffer(
        json.dumps(dataclasses.asdict(dcfg)).encode(), dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def load_cache(path: str, device="cuda") -> tuple[KVCache, DeployConfig]:
    """(cache on ``device``, its DeployConfig) from a file either package
    wrote."""
    dev = resolve_device(device)
    with np.load(path) as z:
        dcfg = DeployConfig(**json.loads(bytes(z["__dcfg__"]).decode()))
        arrays = {}
        for f in dataclasses.fields(KVCache):
            a = torch.from_numpy(z[f.name]).to(dev)
            arrays[f.name] = pack_nibbles(a) if _nibbles(dcfg, f.name) else a
    return KVCache(**arrays), dcfg
