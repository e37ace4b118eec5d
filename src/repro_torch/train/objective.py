"""Training objective: next-token cross entropy.

PyTorch twin of :func:`repro.train.objective.lm_loss` for the dense family,
run under :func:`torch.no_grad` as the evaluation entry point (the MoE aux
terms are zero here).  ``grad_accum_step`` comes with the training slice
(ROADMAP.md A10).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import transformer as T


@torch.no_grad()
def lm_loss(cfg: ArchConfig, params, batch, *, device=None):
    """Mean next-token CE over ``batch['tokens']`` against
    ``batch['labels']``.  Returns (loss, metrics)."""
    logits, aux = T.forward(cfg, params, batch, device=device)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    logp = torch.log_softmax(logits.float(), dim=-1)
    del logits
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    ce = -ll.mean()
    return ce, {"loss": ce, **aux}
