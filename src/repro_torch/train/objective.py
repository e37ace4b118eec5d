"""Training objective: next-token cross entropy plus the MoE aux losses,
and the micro-batched gradient step (gradient accumulation).

PyTorch twin of :mod:`repro.train.objective`.  :func:`lm_loss` is
differentiable; the model's parameters are frozen outside a training step,
so an evaluation call builds no graph and keeps a forward's memory.
:func:`grad_accum_step` unfreezes them for its own duration
(:func:`trainable`) and returns gradients by parameter name.
"""
from __future__ import annotations

import contextlib

import torch

from ..configs.base import ArchConfig
from ..device import to_device
from ..models import transformer as T

LB_COEF = 0.01   # weight of the MoE load-balance loss
Z_COEF = 1e-4    # weight of the router z-loss


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


@contextlib.contextmanager
def trainable(model: torch.nn.Module):
    """Every parameter of ``model`` requires grad inside the block, and
    is restored to its previous setting after.  Yields the parameters by
    name."""
    named = dict(model.named_parameters())
    prev = {k: p.requires_grad for k, p in named.items()}
    for p in named.values():
        p.requires_grad_(True)
    try:
        yield named
    finally:
        for k, p in named.items():
            p.requires_grad_(prev[k])


def _grads(cfg, model, batch, loss_fn, device):
    """(loss, metrics, grads by name) of one (micro)batch."""
    with trainable(model) as named:
        loss, metrics = loss_fn(cfg, model, batch, device=device)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(named.items(), grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def grad_accum_step(cfg: ArchConfig, params, batch, *, accum: int = 1,
                    loss_fn=lm_loss, device=None):
    """Gradients of ``loss_fn`` over ``accum`` microbatches.  Returns
    (grads by parameter name, loss, metrics).

    ``accum == 1``: one backward, gradients in the parameters' dtype.
    Otherwise the batch splits as the reference splits it, on the
    *trailing* factor — (B, ...) → (B/accum, accum, ...), microbatch i
    the rows ``i, i + accum, ...`` — and the gradients are summed in
    float32 and scaled by ``1/accum``, as are the loss and metrics (their
    means).  The microbatches run one after another, so the activations
    of one are alive at a time.  ``batch`` may hold numpy arrays or
    tensors; it is moved to the parameters' device, which must be
    ``device`` (None: the card).  ``loss_fn(cfg, params, batch, *,
    device)`` returns (loss, metrics) as :func:`lm_loss` does."""
    dev = T.check_device(params, device)
    batch = to_device(batch, dev)
    if accum == 1:
        loss, metrics, grads = _grads(cfg, params, batch, loss_fn, dev)
        return grads, loss, metrics
    b = batch["tokens"].shape[0]
    if b % accum:
        raise ValueError(f"batch of {b} does not split into {accum} "
                         "microbatches")
    micro = {k: v.reshape(b // accum, accum, *v.shape[1:]).swapaxes(0, 1)
             for k, v in batch.items()}
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.named_parameters()}
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    met_acc = {k: torch.zeros((), dtype=torch.float32, device=dev)
               for k in ("loss", "lb_loss", "router_z", "drop_frac")}
    for i in range(accum):
        mb = {k: v[i] for k, v in micro.items()}
        loss, metrics, grads = _grads(cfg, params, mb, loss_fn, dev)
        for k, g in grads.items():
            acc[k].add_(g)
        del grads
        loss_acc = loss_acc + loss
        met_acc = {k: met_acc[k] + metrics[k] for k in met_acc}
    inv = 1.0 / accum
    for g in acc.values():
        g.mul_(inv)
    return acc, loss_acc * inv, {k: m * inv for k, m in met_acc.items()}
