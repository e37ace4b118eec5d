"""Trainer — the Loop-of-stencil-reduce-s pattern at system scale.

PyTorch twin of :mod:`repro.train.trainer`.  Pattern instantiation:
    stencil step f : (params, opt) → (params, opt)    (k=0 map case)
    reduce /⊕     : the step's mean loss
    state s       : optimizer state + step counter + fault counters
    condition c   : step budget ∧ target loss ∧ NaN fault detector

Two execution modes:

* :meth:`Trainer.run` — the production host loop: one-step-ahead batch
  prefetch onto the card, periodic step-atomic checkpoints, NaN rollback
  with a batch skip and a fault budget, the preemption-signal flush,
  resume from the latest checkpoint.
* :meth:`Trainer.run_fused` — K steps over pre-staged batches as one
  :class:`~repro_torch.core.pattern.LoopOfStencilReduce` in step mode on
  the ``"torch"`` backend (the reference lowers it into one
  ``while_loop``; here the loop is a host loop over device-resident state,
  one host read of the condition a step).

A step runs on the attention's einsum route, as the reference trains with
its flash flag off (the kernel has no backward): the trainer sets
``set_flash_swa(False)`` around each step and restores the flag after.
Parameters and optimizer state are updated in place (see
:mod:`repro_torch.optim.adam`); the returned objects are the ones passed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import signal
import time
from typing import Callable, Optional

import torch

from ..configs.base import ArchConfig
from ..core.pattern import LoopOfStencilReduce
from ..data.pipeline import Prefetcher
from ..device import resolve_device, to_device
from ..models import attention as TA
from ..models.transformer import check_device
from ..optim import AdamState, AdamW
from . import checkpoint as ckpt_lib
from .objective import grad_accum_step, lm_loss


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    accum: int = 1
    ckpt_dir: str = ""
    ckpt_every: int = 100
    keep_ckpts: int = 3
    target_loss: float = 0.0        # 0 = disabled
    log_every: int = 10
    rollback_on_nan: bool = True
    max_faults: int = 10
    seed: int = 0


@contextlib.contextmanager
def einsum_route():
    """Self-attention on the einsum route inside the block; the flash
    flag is restored after."""
    prev = TA.USE_FLASH_SWA
    TA.set_flash_swa(False)
    try:
        yield
    finally:
        TA.set_flash_swa(prev)


def _host_copy(params, opt_state: AdamState):
    """CPU copies of the parameters and the optimizer state (the
    rollback point)."""
    cpu = lambda d: {k: t.detach().to("cpu", copy=True)
                     for k, t in d.items()}
    return (cpu(dict(params.named_parameters())),
            AdamState(opt_state.step.to("cpu", copy=True),
                      cpu(opt_state.master), cpu(opt_state.m),
                      cpu(opt_state.v)))


@torch.no_grad()
def _copy_back(params, opt_state: AdamState, saved) -> AdamState:
    """Write a :func:`_host_copy` back into the parameters and the state's
    tensors (its step too); returns the state."""
    p, s = saved
    for k, t in params.named_parameters():
        t.copy_(p[k])
    for dst, src in ((opt_state.master, s.master), (opt_state.m, s.m),
                     (opt_state.v, s.v)):
        for k, t in dst.items():
            t.copy_(src[k])
    opt_state.step.copy_(s.step)
    return opt_state


class Trainer:
    """Trains on ``device`` (None: the CUDA card), where the parameters
    handed to :meth:`run` and :meth:`run_fused` must lie."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig, optimizer: AdamW,
                 *, loss_fn=lm_loss, device=None):
        self.cfg, self.tcfg, self.opt = cfg, tcfg, optimizer
        self.loss_fn = loss_fn
        self.device = resolve_device(device)
        self._preempted = False
        self._faults = 0

    def train_step(self, params, opt_state: AdamState, batch):
        """Gradients over ``accum`` microbatches on the einsum route, then
        one AdamW update.  Returns (params, opt_state, metrics): the loss
        metrics, the optimizer's stats and ``total_loss``."""
        with einsum_route():
            grads, loss, metrics = grad_accum_step(
                self.cfg, params, batch, accum=self.tcfg.accum,
                loss_fn=self.loss_fn, device=self.device)
        params, opt_state, stats = self.opt.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, **stats, total_loss=loss)

    # -- fault tolerance hooks -------------------------------------------
    def install_preemption_handler(self, signals=(signal.SIGTERM,)) -> dict:
        """Set the preemption flag on ``signals``; returns the handlers it
        replaced, by signal."""
        def _h(sig, frame):
            self._preempted = True
        return {s: signal.signal(s, _h) for s in signals}

    # -- production host loop --------------------------------------------
    def run(self, params, batches, *, opt_state: Optional[AdamState] = None,
            start_step: int = 0, log: Callable = print):
        """Train ``params`` (a :class:`~repro_torch.models.transformer.
        Transformer`) to ``tcfg.steps`` on ``batches`` (an iterable of
        batches, or a function of the start step returning one, as
        ``SyntheticLM.batches``).  Returns (params, opt_state, info) with
        info ``history`` (the finite losses), ``steps`` and ``faults``."""
        tc = self.tcfg
        check_device(params, self.device)
        opt_state = opt_state if opt_state is not None \
            else self.opt.init(params)
        step = start_step

        # resume from the latest checkpoint if present
        if tc.ckpt_dir and ckpt_lib.latest_step(tc.ckpt_dir) is not None:
            (params, opt_state), step, _ = ckpt_lib.restore(
                tc.ckpt_dir, (params, opt_state))
            log(f"[trainer] resumed from step {step}")

        last_good = None
        history = []
        it = Prefetcher(iter(batches(step) if callable(batches)
                             else batches), self.device)
        t0 = time.time()
        while step < tc.steps:
            batch = next(it)
            params, opt_state, m = self.train_step(params, opt_state, batch)
            loss = float(m["total_loss"])
            step += 1

            if tc.rollback_on_nan and (loss != loss):      # NaN fault
                self._faults += 1
                log(f"[trainer] step {step}: NaN loss — fault "
                    f"{self._faults}/{tc.max_faults}")
                if self._faults > tc.max_faults:
                    raise RuntimeError("fault budget exhausted")
                if last_good is not None:
                    opt_state = _copy_back(params, opt_state, last_good[:2])
                    step = last_good[2]
                elif tc.ckpt_dir and ckpt_lib.latest_step(tc.ckpt_dir) \
                        is not None:
                    (params, opt_state), step, _ = ckpt_lib.restore(
                        tc.ckpt_dir, (params, opt_state))
                continue                                    # skip the batch

            history.append(loss)
            if step % tc.log_every == 0:
                dt = (time.time() - t0) / tc.log_every
                log(f"[trainer] step {step} loss={loss:.4f} "
                    f"gnorm={float(m['grad_norm']):.3f} {dt*1e3:.0f}ms/it")
                t0 = time.time()
            if tc.ckpt_dir and step % tc.ckpt_every == 0:
                ckpt_lib.save(tc.ckpt_dir, step, (params, opt_state),
                              keep=tc.keep_ckpts)
                last_good = (*_host_copy(params, opt_state), step)
            if self._preempted:
                if tc.ckpt_dir:
                    ckpt_lib.save(tc.ckpt_dir, step, (params, opt_state),
                                  keep=tc.keep_ckpts)
                log(f"[trainer] preempted at step {step}; checkpoint "
                    "flushed")
                break
            if tc.target_loss and loss < tc.target_loss:
                log(f"[trainer] target loss reached at step {step}")
                break
        if tc.ckpt_dir:
            ckpt_lib.save(tc.ckpt_dir, step, (params, opt_state),
                          keep=tc.keep_ckpts)
        return params, opt_state, {"history": history, "steps": step,
                                   "faults": self._faults}

    # -- fused segment: K steps as one pattern application ---------------
    def run_fused(self, params, opt_state: AdamState, stacked_batches, *,
                  target_loss: float = 0.0):
        """Run K = leading-axis steps as one Loop-of-stencil-reduce-s in
        step mode: the carry is (params, opt_state, batch pointer, loss),
        ⊕ = min over the step's loss, the state counts the steps, and the
        loop stops after K steps or below ``target_loss``.

        ``stacked_batches``: a dict of arrays with a leading K axis, moved
        to the parameters' device once.  Returns (params, opt_state,
        last_loss, iters)."""
        dev = check_device(params, self.device)
        stacked = to_device(stacked_batches, dev)
        K = next(iter(stacked.values())).shape[0]

        def step_fn(carry):
            params, opt_state, ptr, _ = carry
            batch = {k: v[ptr] for k, v in stacked.items()}
            params, opt_state, m = self.train_step(params, opt_state, batch)
            return (params, opt_state, ptr + 1, m["total_loss"])

        def cond(r, s):
            done = s >= K
            return done | (r < target_loss) if target_loss else done

        loop = LoopOfStencilReduce(
            f=step_fn, mode="step", combine="min", identity=float("inf"),
            measure=lambda c: c[3][None], cond=cond,
            state_init=lambda: torch.zeros((), dtype=torch.int32,
                                           device=dev),
            state_update=lambda s, a, it: s + 1,
            max_iters=K, backend="torch", device=dev)
        res = loop.run((params, opt_state, 0,
                        torch.full((), float("inf"), device=dev)))
        params, opt_state, _, last_loss = res.a
        return params, opt_state, last_loss, res.iters
