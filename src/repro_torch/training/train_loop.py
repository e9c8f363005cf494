"""The training step and a fault-tolerant loop.

The port of the reference's ``repro.training.train_loop``.
:func:`make_train_step` builds a (params, opt_state, batch) -> (params,
opt_state, metrics) step: the loss and its gradients by autograd
(:func:`loss_and_grads`), optional gradient accumulation over
microbatches, the global-norm clip and :func:`adamw_update`, which writes
the parameters and the optimizer state in place. :class:`TrainLoop` adds
checkpointing, the deterministic data cursor, resume and a straggler
watchdog.

With ``microbatches > 1`` the gradients are summed in float32 and divided
by the count, as the reference sums them; with one microbatch they stay
in the parameters' dtype.

On a mesh of ranks (FSDP over ``data`` x tensor parallelism over
``model``, the reference's ``DEFAULT_RULES``) the parameters and the
optimizer's ``m`` / ``v`` are this rank's shards, laid out by the step's
``param_specs`` / ``opt_specs`` (the reference's ``param_shardings`` /
``opt_shardings``), and every rank is given the same global batch; the
model scores this rank's rows of it, split over ``batch_axes``. A
microbatch is a run of the global batch's rows, split the same way, as
the reference slices its global batch. The gradients come from autograd
through the collectives' backward rules; a leaf replicated over a batch
axis then has its gradient summed over that axis (:func:`sync_grads`).
A mesh of one rank trains as no mesh does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..distributed import collectives as coll
from ..distributed.sharding import spec_axes
from ..models.params import DEFAULT_RULES, map_tree, spec_tree
from .optimizer import AdamWConfig, adamw_update, clip_by_global_norm


def _flat(tree) -> list:
    """The leaves of ``tree`` in :func:`map_tree`'s order."""
    out = []
    map_tree(out.append, tree)
    return out


def sync_grads(grads, specs, mesh, batch_axes):
    """Each gradient leaf summed over the ``batch_axes`` that its spec
    does not shard it over: such a leaf is replicated over them, and each
    rank's gradient holds only its own rows' part. (A leaf sharded over a
    batch axis got the sum from its all-gather's backward.)"""
    batch_axes = tuple(a for a in batch_axes if a in mesh.shape)

    def one(g, spec):
        return coll.psum(g, mesh, tuple(a for a in batch_axes
                                        if a not in spec_axes(spec)))

    return map_tree(one, grads, specs)


def loss_and_grads(lm, params, batch, *, mesh=None, batch_axes=("data",)):
    """(loss, metrics, grads) of ``lm.train_loss(params, batch)``: the loss
    detached, the gradients as a tree shaped like ``params`` (a leaf the
    loss does not reach, such as the MoE's routing bias, gets zeros). The
    leaves of ``params`` are not changed; autograd runs on views of them
    that require gradients. On ``mesh`` (more than one rank), ``params``
    are this rank's shards under ``DEFAULT_RULES``, ``batch`` the global
    batch, and the gradients this rank's rows' part of its shards of the
    global batch's: :func:`sync_grads` sums them over the batch axes."""
    req = map_tree(lambda t: t.detach().requires_grad_(True), params)
    flat = _flat(req)
    with torch.enable_grad():
        loss, metrics = lm.train_loss(req, batch, mesh=mesh,
                                      batch_axes=batch_axes)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(flat, grads)])
    return loss.detach(), metrics, map_tree(lambda _: next(it), params)


def make_train_step(lm, opt_cfg: Optional[AdamWConfig] = None,
                    microbatches: int = 1, *, mesh=None,
                    batch_axes=("data",)):
    """The step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``params`` and ``opt_state`` are updated in place and
    returned. ``metrics``: the model's (``xent``, ``aux``, ``tokens``,
    ``mtp``; ``xent`` alone with microbatches), ``loss`` and the
    gradients' ``grad_norm`` before the clip, as device scalars.

    On ``mesh`` (a mesh of ranks) ``params`` and ``opt_state``'s ``m`` /
    ``v`` are this rank's shards, laid out by the step's ``param_specs``
    and ``opt_specs`` (``spec_tree(metas, mesh)`` under
    ``DEFAULT_RULES``; ``step`` whole), ``batch`` is the global batch on
    every rank, and the metrics are the global batch's on every rank. A
    global batch (or microbatch) that the present ``batch_axes`` do not
    divide raises ``ValueError``. The step also has ``mesh`` (it is itself
    the reference's un-jitted ``step_fn``)."""
    opt_cfg = opt_cfg or AdamWConfig()
    if mesh is not None and mesh.size == 1:
        mesh = None
    specs = opt_specs = None
    ba = ()
    if mesh is not None:
        specs = spec_tree(lm.abstract_params(), mesh, DEFAULT_RULES)
        opt_specs = {"m": specs, "v": specs, "step": ()}
        ba = tuple(a for a in batch_axes if a in mesh.shape)
    dp = coll.axis_size(mesh, ba)

    def train_step(params, opt_state, batch):
        B = len(batch["tokens"])
        if B % microbatches or (B // microbatches) % dp:
            raise ValueError(f"a batch of {B} in {microbatches} "
                             f"microbatches does not split over {ba} "
                             f"({dp} ranks)")
        kw = dict(mesh=mesh, batch_axes=ba)
        if microbatches > 1:
            mb = B // microbatches
            gsum, lsum = None, 0.0
            for i in range(microbatches):
                sl = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, _, g = loss_and_grads(lm, params, sl, **kw)
                g32 = map_tree(lambda t: t.to(torch.float32), g)
                gsum = g32 if gsum is None else map_tree(torch.add, gsum, g32)
                lsum = lsum + l.to(torch.float32)
            grads = map_tree(lambda t: t / microbatches, gsum)
            loss = lsum / microbatches
            metrics = {"xent": loss}
        else:
            loss, metrics, grads = loss_and_grads(lm, params, batch, **kw)
        if mesh is not None:        # once, on the accumulated gradients
            grads = sync_grads(grads, specs, mesh, ba)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip,
                                           mesh=mesh, specs=specs)
        params, opt_state = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    train_step.mesh = mesh
    train_step.param_specs = specs
    train_step.opt_specs = opt_specs
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
        step and after a straggler. Returns (params, opt_state, losses).

        With a mesh step (its ``mesh`` attribute), every rank takes the
        same global batch, a straggler on any rank checkpoints on all of
        them, and the checkpoint gathers whole leaves by the step's
        specs (:meth:`repro_torch.checkpoint.Checkpointer.save`)."""
        mesh = getattr(self.step_fn, "mesh", None)
        save_kw = {} if mesh is None else dict(
            mesh=mesh, specs={"params": self.step_fn.param_specs,
                              "opt": self.step_fn.opt_specs})
        history = []
        for step in range(start_step, start_step + n_steps):
            batch = self.loader.batch_at(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            loss = float(metrics["loss"])          # waits for the step
            dt = time.perf_counter() - t0
            straggle = self.watchdog.observe(step, dt)
            if mesh is not None:                   # the ranks agree
                flag = torch.tensor(float(straggle), device=mesh.device)
                straggle = bool(coll.psum(flag, mesh, tuple(mesh.shape)) > 0)
            history.append(loss)
            if self.ckpt and ((step + 1) % self.ckpt_every == 0 or straggle):
                self.ckpt.save(step + 1, {"params": params, "opt": opt_state},
                               **save_kw)
            if log_every and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
        return params, opt_state, history
