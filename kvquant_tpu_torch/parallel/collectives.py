"""The tensor-parallel collectives the port's model and engine call
explicitly, where GSPMD inserts them in the JAX package.

  - ``reduce_from_tp``: the sum over the tp group of a row-sharded output
    projection (``wo``, the FFN's ``w_down``; ``row_parallel`` keeps the
    partial products in fp32); all-reduce forward, identity backward.
  - ``copy_to_tp``: the entry of a column-sharded block (q / k / v, the
    FFN's gate / up, the experts); identity forward, all-reduce backward.
    The two are Megatron-LM's ``f`` / ``g`` operators, so that the
    backward of a sharded forward (the Fisher probes) sums each rank's part
    of the input gradient.
  - ``topk_range``: the V quantizer's per-token range, the (r+1)-th
    extreme over all ``Hkv * D`` channels of a token, from the channels of
    this rank's heads: local top-(r+1) maxima and minima, exchanged over
    the group, the (r+1)-th of their union. The global top-(r+1) lies inside
    the union of the local ones, so the result is the unsharded one.

Every function takes the group explicitly; with ``group`` None (one
process, or a tp size of 1) it computes exactly what the unsharded code
does and calls no collective. Sums run in fp32 (one cast back to the
input's dtype); the exchange of ``topk_range`` is an all-reduce of MAX
over a -inf padded buffer (exact, and gloo takes CUDA tensors only for
broadcast and all-reduce).

``STATS`` counts the collectives and, after ``timing(True)``, the host
seconds spent in them (a device synchronize before each, so queued kernels
are not charged to the collective).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "timed": False}


def tp_group(cfg):
    """The tensor-parallel group of a rank-local config
    (``parallel.shardings.shard_config``), else None."""
    return getattr(cfg, "tp_group", None)


def timing(on: bool = True):
    """Time every collective from now on (``STATS["seconds"]``)."""
    STATS["timed"] = bool(on)


def reset_stats():
    STATS.update(calls=0, bytes=0, seconds=0.0)


def _all_reduce(buf: torch.Tensor, group, op=dist.ReduceOp.SUM):
    timed = STATS["timed"]
    if timed:
        if buf.is_cuda:
            torch.cuda.synchronize(buf.device)
        t0 = time.perf_counter()
    dist.all_reduce(buf, op=op, group=group)
    STATS["calls"] += 1
    STATS["bytes"] += buf.numel() * buf.element_size()
    if timed:
        STATS["seconds"] += time.perf_counter() - t0
    return buf


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` in fp32, cast back to x's dtype (a new
    tensor; ``x`` itself when ``group`` is None)."""
    if group is None:
        return x
    buf = x.to(torch.float32, copy=True)
    return _all_reduce(buf, group).to(x.dtype)


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous(), ctx.group), None


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward."""
    if group is None:
        return x
    return _ReduceFromTP.apply(x, group)


def _fp32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in fp32, from bf16 / fp16
    operands without a rounding of the product to their dtype."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.to(torch.float32) @ w.to(torch.float32)


def row_parallel(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """``x @ w`` for a row-sharded ``w`` (``wo``, ``w_down``): each rank's
    partial product summed over ``group``, in x's dtype. Unsharded it is
    ``x @ w`` itself; sharded, the partial products stay in fp32 and the
    sum is rounded once, as the unsharded product is."""
    if group is None:
        return x @ w
    return reduce_from_tp(_fp32_matmul(x, w), group).to(x.dtype)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce (sum) of the gradient backward."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToTP.apply(x, group)


def gather_max(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` at its rank index in ``group``,
    by an all-reduce of MAX over a -inf padded buffer (exact)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    buf = torch.full((n, *x.shape), float("-inf"), dtype=x.dtype,
                     device=x.device)
    buf[r] = x
    return _all_reduce(buf, group, op=dist.ReduceOp.MAX)


def topk_range(vf: torch.Tensor, k: int, group=None):
    """(minval, maxval), each (..., 1): the k-th smallest and k-th largest
    entry of each row of ``vf`` (..., C), over the channels of every rank
    of ``group`` (of ``vf`` alone when ``group`` is None)."""
    if group is None:
        # values only: torch.topk's tie order does not matter here
        maxval = torch.topk(vf, k, dim=-1).values[..., -1:]
        minval = -torch.topk(-vf, k, dim=-1).values[..., -1:]
        return minval, maxval
    kl = min(k, vf.shape[-1])
    loc = torch.cat([torch.topk(vf, kl, dim=-1).values,
                     torch.topk(-vf, kl, dim=-1).values], dim=-1)
    allv = torch.movedim(gather_max(loc, group), 0, -2)  # (..., n, 2 kl)
    tops = allv[..., :kl].flatten(-2)
    bots = allv[..., kl:].flatten(-2)
    maxval = torch.topk(tops, k, dim=-1).values[..., -1:]
    minval = -torch.topk(bots, k, dim=-1).values[..., -1:]
    return minval, maxval
