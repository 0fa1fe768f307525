"""``jax.lax.top_k`` semantics in PyTorch.

``torch.topk`` promises no order among equal values, while the JAX package
relies on ``lax.top_k``'s: descending in the IEEE total order (so +0.0 ranks
above -0.0) with ties broken to the lower index. The static channel
selection (an all-zero ``k_ressc`` ties every channel) and the indices of
non-genuine outlier slots (which land in the encoded slot word) depend on
that order, so the port sorts explicitly."""

from __future__ import annotations

import torch


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> int32 key whose signed order is the IEEE total order."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def top_k(x: torch.Tensor, k: int):
    """(values, int64 indices) of the ``k`` largest entries along the last
    axis, ordered as ``jax.lax.top_k`` orders them."""
    _, idx = torch.sort(_total_order_key(x), dim=-1, descending=True,
                        stable=True)
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx
