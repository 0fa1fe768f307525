"""Fisher-information calibration (port of kvquant_tpu/fisher/fisher.py).

The forward takes zero fp32 probes added to the k / v projection outputs
(``models.llama.make_kv_probes``); the gradient of the loss with respect
to a probe is the gradient with respect to that activation. The empirical
Fisher of an activation element is its squared gradient, per sample (the
reference's gradients/run-fisher.py:285-295).

Only the probes require grad: ``torch.autograd.grad`` runs the backward of
the full-precision forward, which reaches no CUDA kernel of the port.
"""

from __future__ import annotations

import torch

from ..models import get_forward, make_kv_probes
from ..models.config import ModelConfig


def clm_loss(params, cfg: ModelConfig, tokens, kv_probes=None,
             remat: bool = False):
    """Mean next-token NLL over B * (T - 1) (labels = inputs shifted)."""
    tokens = torch.as_tensor(tokens).to(params.embed.device)
    logits, _ = get_forward(cfg)(params, cfg, tokens, kv_probes=kv_probes,
                                 remat=remat)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    tgt = tokens[:, 1:].long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    return nll.mean()


def _fisher_step(params, cfg: ModelConfig, tokens, remat: bool = False):
    """(grad_k ** 2, grad_v ** 2), each (L, B, T, C) fp32, of one batch;
    ``remat`` checkpoints every layer (less memory, one more forward)."""
    B, T = tokens.shape
    probes = make_kv_probes(cfg, B, T, device=params.embed.device)
    for p in probes.values():
        p.requires_grad_(True)
    with torch.enable_grad():
        loss = clm_loss(params, cfg, tokens, kv_probes=probes, remat=remat)
        gk, gv = torch.autograd.grad(loss, (probes["k"], probes["v"]))
    return gk ** 2, gv ** 2


def fisher_info(params, cfg: ModelConfig, batches):
    """Per-element Fisher information over calibration batches.

    batches: iterable of (B, T) int token arrays (same T). Returns
    (fisher_k, fisher_v), each (L, N_tokens_total, C) fp32 on the model's
    device: token rows concatenated over batches in order, each batch
    flattened b-major, so they line up with the rows
    ``quant.calibration.collect_kv_activations`` captures over the same
    batches."""
    ks, vs = [], []
    for tokens in batches:
        fk, fv = _fisher_step(params, cfg, torch.as_tensor(tokens))
        L = fk.shape[0]
        ks.append(fk.reshape(L, -1, fk.shape[-1]))
        vs.append(fv.reshape(L, -1, fv.shape[-1]))
    return torch.cat(ks, dim=1), torch.cat(vs, dim=1)
