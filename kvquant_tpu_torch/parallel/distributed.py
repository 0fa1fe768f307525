"""Multi-process wiring (port of kvquant_tpu/parallel/distributed.py).

Each rank is one process. ``init_distributed`` joins the process group
from its arguments or the ``KVQ_COORDINATOR`` / ``KVQ_NUM_PROCESSES`` /
``KVQ_PROCESS_ID`` variables (``torch.distributed.init_process_group``
with ``init_method="tcp://<coordinator>"``); ``make_multihost_mesh`` lays
the (dp, tp) mesh out process-major over every rank, with tp inside a
group of consecutive ranks and dp across them.

Launch recipe (N processes, one per rank):

  KVQ_COORDINATOR=host0:8476 KVQ_NUM_PROCESSES=N KVQ_PROCESS_ID=i \\
      python -m kvquant_tpu_torch.cli.deploy ... --tp 2 --distributed

The backend is NCCL on CUDA and gloo on the CPU. NCCL takes one card per
rank: ranks that outnumber a machine's cards (two ranks sharing one card)
need ``backend="gloo"``, whose collectives on CUDA tensors go through host
memory. That backend is never chosen silently.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh


def _local_ranks(coordinator: str, num_processes: int) -> int:
    """Ranks on this machine when ``LOCAL_WORLD_SIZE`` is not set: all of
    them for a coordinator on this machine, else one."""
    host = coordinator.rsplit(":", 1)[0]
    local = host in ("localhost", "127.0.0.1", socket.gethostname())
    return num_processes if local else 1


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, device="cuda",
                     timeout_s: float = 600.0) -> bool:
    """Join the process group from the arguments or the KVQ_* variables.
    Returns True once initialised, False for the single-process fallback
    (no coordinator given or set). ``backend`` None picks NCCL for a CUDA
    ``device`` and gloo for the CPU; NCCL with more local ranks than cards
    raises."""
    coordinator = coordinator or os.environ.get("KVQ_COORDINATOR")
    if coordinator is None:
        return False
    num_processes = int(num_processes if num_processes is not None
                        else os.environ.get("KVQ_NUM_PROCESSES", "1"))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("KVQ_PROCESS_ID", "0"))
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local = int(os.environ.get("LOCAL_WORLD_SIZE", _local_ranks(
            coordinator, num_processes)))
        if local > cards:
            raise RuntimeError(
                f"{local} ranks on a machine with {cards} CUDA device(s): "
                f"NCCL needs one card per rank. To share a card, pass "
                f'backend="gloo" (--dist-backend gloo), whose collectives '
                f"go through host memory")
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    return True


def make_multihost_mesh(tp: int | None = None, device="cuda") -> Mesh:
    """The global (dp, tp) mesh over every rank, process-major: tp groups
    of consecutive ranks, dp across them. With ``tp=None``, tp is the
    number of ranks on this machine (``LOCAL_WORLD_SIZE``, else 1): tensor
    parallel within a host, data parallel across hosts."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp is None:
        tp = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if world % tp:
        raise ValueError(f"tp {tp} does not divide the world of {world}")
    return make_mesh(dp=world // tp, tp=tp, device=device)
