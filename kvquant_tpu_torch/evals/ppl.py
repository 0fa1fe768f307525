"""Perplexity evaluation (port of kvquant_tpu/evals/ppl.py: the reference's
end-to-end correctness oracle, windowed next-token NLL, ppl = exp(mean))."""

from __future__ import annotations

import torch

from ..models import get_forward


def perplexity(params, cfg, token_windows, simquant=None,
               forward_fn=None) -> float:
    """Perplexity over every next-token position of ``token_windows``: an
    (N, T) int array or tensor (one window per row), or an iterable of
    (B, T) batches. ``simquant`` (``models.SimQuantParams``) fake-quantizes
    the KV projections. ``forward_fn`` defaults to the model family's
    (``models.get_forward``). Runs under ``torch.no_grad`` on the params'
    device."""
    forward = forward_fn or get_forward(cfg)
    if hasattr(token_windows, "shape"):
        token_windows = [token_windows[i:i + 1]
                         for i in range(token_windows.shape[0])]
    dev = params.embed.device
    total, count = 0.0, 0
    with torch.no_grad():
        for tokens in token_windows:
            tokens = torch.as_tensor(tokens).to(dev)
            logits, _ = forward(params, cfg, tokens, simquant=simquant)
            logp = torch.log_softmax(logits[:, :-1], dim=-1)
            nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
            total += float(nll.sum())
            count += nll.numel()
    return float(torch.exp(torch.tensor(total / count, dtype=torch.float32)))
