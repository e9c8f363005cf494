"""The training step and a fault-tolerant loop.

The port of the reference's ``repro.training.train_loop`` without a mesh.
:func:`make_train_step` builds a (params, opt_state, batch) -> (params,
opt_state, metrics) step: the loss and its gradients by autograd
(:func:`loss_and_grads`), optional gradient accumulation over
microbatches, the global-norm clip and :func:`adamw_update`, which writes
the parameters and the optimizer state in place. :class:`TrainLoop` adds
checkpointing, the deterministic data cursor, resume and a straggler
watchdog.

With ``microbatches > 1`` the gradients are summed in float32 and divided
by the count, as the reference sums them; with one microbatch they stay
in the parameters' dtype. A mesh of one rank trains as no mesh does; a
mesh of more than one rank (FSDP / tensor-parallel shardings) raises
``NotImplementedError`` (ROADMAP §1, item 6): serving runs on such a mesh,
training does not yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..models.params import map_tree
from .optimizer import AdamWConfig, adamw_update, clip_by_global_norm


def _flat(tree) -> list:
    """The leaves of ``tree`` in :func:`map_tree`'s order."""
    out = []
    map_tree(out.append, tree)
    return out


def loss_and_grads(lm, params, batch):
    """(loss, metrics, grads) of ``lm.train_loss(params, batch)``: the loss
    detached, the gradients as a tree shaped like ``params`` (a leaf the
    loss does not reach, such as the MoE's routing bias, gets zeros). The
    leaves of ``params`` are not changed; autograd runs on views of them
    that require gradients."""
    req = map_tree(lambda t: t.detach().requires_grad_(True), params)
    flat = _flat(req)
    with torch.enable_grad():
        loss, metrics = lm.train_loss(req, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(flat, grads)])
    return loss.detach(), metrics, map_tree(lambda _: next(it), params)


def make_train_step(lm, opt_cfg: Optional[AdamWConfig] = None,
                    microbatches: int = 1, *, mesh=None):
    """The step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``params`` and ``opt_state`` are updated in place and
    returned. ``metrics``: the model's (``xent``, ``aux``, ``tokens``,
    ``mtp``; ``xent`` alone with microbatches), ``loss`` and the
    gradients' ``grad_norm`` before the clip, as device scalars. On a
    ``mesh`` of more than one rank it raises ``NotImplementedError``."""
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"training on a mesh of {mesh.size} ranks is not ported; one "
            f"rank (or mesh=None) is")
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            B = batch["tokens"].shape[0]
            mb = B // microbatches
            gsum, lsum = None, 0.0
            for i in range(microbatches):
                sl = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, _, g = loss_and_grads(lm, params, sl)
                g32 = map_tree(lambda t: t.to(torch.float32), g)
                gsum = g32 if gsum is None else map_tree(torch.add, gsum, g32)
                lsum = lsum + l.to(torch.float32)
            grads = map_tree(lambda t: t / microbatches, gsum)
            loss = lsum / microbatches
            metrics = {"xent": loss}
        else:
            loss, metrics, grads = loss_and_grads(lm, params, batch)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        params, opt_state = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags a step slower than ``factor`` x the running median (of the
    last 50, once 5 are in); the loop then checkpoints early."""
    factor: float = 3.0
    history: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        self.history.append(seconds)
        if len(self.history) < 5:
            return False
        med = float(np.median(self.history[-50:]))
        if seconds > self.factor * med:
            self.events.append((step, seconds, med))
            return True
        return False


class TrainLoop:
    """Deterministic, preemption-safe loop: its state is (params, opt,
    data cursor), and resuming from a checkpoint replays the exact batch
    sequence (``loader.batch_at(step)``)."""

    def __init__(self, lm, loader, step_fn, checkpointer=None,
                 ckpt_every: int = 50,
                 watchdog: Optional[StragglerWatchdog] = None):
        self.lm = lm
        self.loader = loader
        self.step_fn = step_fn
        self.ckpt = checkpointer
        self.ckpt_every = ckpt_every
        self.watchdog = watchdog or StragglerWatchdog()

    def run(self, params, opt_state, start_step: int, n_steps: int,
            log_every: int = 10):
        """Steps ``start_step`` .. ``start_step + n_steps - 1``; a
        checkpoint of ``{"params", "opt"}`` after every ``ckpt_every``-th
        step and after a straggler. Returns (params, opt_state, losses)."""
        history = []
        for step in range(start_step, start_step + n_steps):
            batch = self.loader.batch_at(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            loss = float(metrics["loss"])          # waits for the step
            dt = time.perf_counter() - t0
            straggle = self.watchdog.observe(step, dt)
            history.append(loss)
            if self.ckpt and ((step + 1) % self.ckpt_every == 0 or straggle):
                self.ckpt.save(step + 1, {"params": params, "opt": opt_state})
            if log_every and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
        return params, opt_state, history
