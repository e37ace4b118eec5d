"""Training objective: next-token cross entropy plus the MoE aux losses.

PyTorch twin of :func:`repro.train.objective.lm_loss`, run under
:func:`torch.no_grad` as the evaluation entry point.  ``grad_accum_step``
comes with the training slice (ROADMAP.md A10).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import transformer as T

LB_COEF = 0.01   # weight of the MoE load-balance loss
Z_COEF = 1e-4    # weight of the router z-loss


@torch.no_grad()
def lm_loss(cfg: ArchConfig, params, batch, *, device=None):
    """Mean next-token CE over the text positions of the forward of
    ``batch`` (``tokens``, and ``frames`` or ``patch_embeds`` where the
    model takes them; the vision stub's first ``cfg.vision_patches``
    positions are left out) against ``batch['labels']``, plus
    ``LB_COEF·lb_loss + Z_COEF·router_z`` for a MoE config.  Returns
    (loss, metrics); ``metrics['loss']`` is the CE."""
    logits, aux = T.forward(cfg, params, batch, device=device)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    P = cfg.vision_patches or 0
    if P:
        logits = logits[:, P:]                 # loss only on text positions
    logp = torch.log_softmax(logits.float(), dim=-1)
    del logits
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    ce = -ll.mean()
    loss = ce
    if cfg.n_experts:
        loss = loss + LB_COEF * aux["lb_loss"] + Z_COEF * aux["router_z"]
    return loss, {"loss": ce, **aux}
