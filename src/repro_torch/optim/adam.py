"""AdamW with float32 master weights, in plain PyTorch.

PyTorch twin of :mod:`repro.optim.adam`, with the reference's arithmetic:
parameters live in the model dtype (bfloat16 in production); the optimizer
carries float32 master copies and moments; the gradients are clipped by
their global norm, the moments and the bias corrections are float32, the
weight decay joins the update before the learning rate multiplies it, and
the masters are cast back to the parameters' dtype.  (Not
``torch.optim.AdamW``: its decay scales the weights by ``1 - lr·wd``
before the Adam step, a different order of operations.)

The port updates in place where the reference returns new arrays: the
parameters, masters and moments keep their storage, so a step allocates
no second copy of the model (1.7 B parameters carry 20.6 GB of float32
state).  Parameters are a :class:`torch.nn.Module` (its
``named_parameters()``) or a dict of tensors; gradients and the state's
``master``, ``m`` and ``v`` are dicts under the same names.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn


@dataclasses.dataclass
class AdamState:
    """``step`` (0-d int32 on the parameters' device), and float32
    ``master`` weights and moments ``m``, ``v`` by parameter name."""
    step: torch.Tensor
    master: dict
    m: dict
    v: dict


def named(params) -> dict:
    """Parameters by name: a module's ``named_parameters()``, or a dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    def init(self, params) -> AdamState:
        p = named(params)
        dev = next(iter(p.values())).device
        # copy=True: ``.float()`` of a float32 parameter is the parameter
        # itself, and a master sharing its storage would be written by the
        # cast-back of every update
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            master={k: x.detach().to(torch.float32, copy=True)
                    for k, x in p.items()},
            m={k: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
               for k, x in p.items()},
            v={k: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
               for k, x in p.items()})

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    def _corrections(self, step: torch.Tensor):
        """The bias corrections ``1 - b^step`` of both moments, from the
        float32 step."""
        s = step.float()
        return 1 - torch.pow(self.b1, s), 1 - torch.pow(self.b2, s)

    @torch.no_grad()
    def update(self, grads: dict, state: AdamState, params):
        """One step.  Returns (params, state, stats): the same parameters
        and state, updated in place (``step`` too), and the stats
        ``grad_norm``, ``lr`` and ``clip_scale`` (0-d float32)."""
        p = named(params)
        state.step.add_(1)
        step = state.step
        gnorm = global_norm([grads[k] for k in p])
        scale = torch.ones_like(gnorm)
        if self.grad_clip > 0:
            scale = torch.minimum(scale, self.grad_clip / (gnorm + 1e-9))
        b1, b2 = self.b1, self.b2
        c1, c2 = self._corrections(step)
        lr = self._lr(step)
        for k, param in p.items():
            g = grads[k].float() * scale
            m, v, mw = state.m[k], state.v[k], state.master[k]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * mw
            mw.sub_(lr * u)
            param.copy_(mw)                  # cast to the parameter dtype
        stats = {"grad_norm": gnorm,
                 "lr": torch.as_tensor(lr, dtype=torch.float32,
                                       device=gnorm.device),
                 "clip_scale": scale}
        return params, state, stats


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32; ``tree`` is a
    dict or a list of tensors (the leaves summed in turn, as the
    reference's Python ``sum``)."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    total = None
    for x in leaves:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)
