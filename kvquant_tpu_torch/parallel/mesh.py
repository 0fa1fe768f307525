"""The (dp, tp) mesh over the ranks of a torch.distributed process group
(port of kvquant_tpu/parallel/mesh.py).

The JAX package keeps one program: a 2-D device mesh whose GSPMD shardings
split the arrays, with XLA inserting the collectives. The port runs one
process per rank, each holding its rank-local shards and calling the
collectives itself (``parallel.collectives``). A ``Mesh`` is this rank's
view of the layout: its (dp, tp) coordinates, its device and the process
groups of its tp row and its dp column. Ranks are laid out dp-major, as
the JAX mesh reshapes its devices: rank = dp_rank * tp + tp_rank, so the
ranks of one tp group are consecutive.

A group of one rank is None: with tp 1 (or dp 1) no collective runs over
that axis, and a world of 1 is the trivial mesh with no process group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    tp: int = 1


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, tp) layout."""

    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    device: torch.device
    tp_group: object = None  # torch ProcessGroup of this rank's tp row
    dp_group: object = None  # ... of its dp column

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def rank(self) -> int:
        return self.dp_rank * self.tp + self.tp_rank

    @property
    def size(self) -> int:
        return self.dp * self.tp


def rank_device(device="cuda", rank: int = 0) -> torch.device:
    """The device of rank ``rank``: ``device`` as given when it names an
    index or the CPU; for a bare "cuda", the card of the rank's local index
    (``LOCAL_RANK`` when set, else rank modulo the visible cards)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(dp: int = 1, tp: int | None = None, device="cuda") -> Mesh:
    """This rank's (dp, tp) mesh over the initialised process group (the
    trivial mesh when none is). With ``tp=None`` every rank left after
    ``dp`` goes to tensor parallelism. dp * tp must equal the world size.
    Every rank must call this with the same arguments, in the same order
    as its other ``new_group`` calls. ``device`` places this rank (see
    ``rank_device``); nothing falls back to the CPU."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if tp is None:
        if world % dp:
            raise ValueError(f"dp {dp} does not divide the world of {world}")
        tp = world // dp
    if dp * tp != world:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks, the "
                         f"process group has {world}")
    dev = rank_device(device, rank)
    if world == 1:
        return Mesh(1, 1, 0, 0, dev)
    dp_rank, tp_rank = divmod(rank, tp)
    tp_group = dp_group = None
    # every rank creates every group, in one order
    for i in range(dp):
        g = dist.new_group(list(range(i * tp, (i + 1) * tp)))
        if i == dp_rank and tp > 1:
            tp_group = g
    for j in range(tp):
        g = dist.new_group(list(range(j, world, tp)))
        if j == tp_rank and dp > 1:
            dp_group = g
    return Mesh(dp, tp, dp_rank, tp_rank, dev, tp_group, dp_group)
