"""AdamW with float32 moments, on parameter trees of tensors.

The port of the reference's ``repro.training.optimizer``, with its dtype
rounds kept: the moments are float32 whatever the parameters' dtype; the
global-norm clip scales each gradient in float32 and casts it back to the
gradient's dtype; the update works on a float32 copy of each parameter and
casts the result back; weight decay applies to leaves of two or more
dimensions only; ``step`` is an int32 scalar. The learning rate, the bias
corrections and the clip scale stay on the parameters' device, so a step
never waits for the card.

The reference returns new trees. Here :func:`adamw_update` writes the new
parameters and moments **into the tensors it was given** and returns the
same trees (the reference donates its parameter and optimizer buffers, so
neither package holds a second copy).

On a mesh of ranks each rank holds its shards of the parameters, their
gradients and ``m`` / ``v`` (the parameters' specs; ``step`` whole).
AdamW is elementwise, so it runs on the shards as it is. The clip's global
norm (:func:`global_norm` with ``mesh`` and ``specs``) sums each leaf's
partial squares over the axes that shard it, so a leaf replicated over an
axis counts once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..distributed import collectives as coll
from ..distributed.sharding import spec_axes
from ..models.params import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def adamw_init(params) -> Dict[str, Any]:
    """``{"m", "v"}``: float32 zeros shaped as ``params``, on each leaf's
    device; ``"step"``: an int32 zero."""
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return {"m": map_tree(f32, params), "v": map_tree(f32, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``cfg.warmup_steps``, in float32."""
    warm = torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1),
                       max=1.0)
    return cfg.lr * warm


def global_norm(tree, *, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32. On ``mesh``,
    ``tree`` holds this rank's shards laid out by ``specs`` (a matching
    tree of specs): the leaves' partial squares are summed over the axes
    that shard them, one ``psum`` for each set of axes, and the norm is
    the same on every rank."""
    sq = lambda x: torch.sum(torch.square(x.to(torch.float32)))
    if mesh is None:
        return torch.sqrt(torch.sum(torch.stack([sq(x)
                                                 for x in leaves(tree)])))
    by_axes = {}

    def add(x, spec):
        by_axes.setdefault(spec_axes(spec), []).append(sq(x))

    map_tree(add, tree, specs)
    parts = [coll.psum(torch.sum(torch.stack(v)), mesh, axes)
             for axes, v in sorted(by_axes.items())]
    return torch.sqrt(torch.sum(torch.stack(parts)))


def clip_by_global_norm(tree, max_norm: float, *, mesh=None, specs=None):
    """(the tree scaled by min(1, max_norm / max(norm, 1e-9)), the norm):
    each leaf scaled in float32 and cast back to its dtype. ``mesh`` and
    ``specs`` as in :func:`global_norm`."""
    gn = global_norm(tree, mesh=mesh, specs=specs)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return map_tree(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    tree), gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state) -> Tuple[Any, Dict]:
    """One AdamW step: ``state["step"]`` + 1, bias-corrected moments, the
    decoupled decay. Writes the parameters, ``m``, ``v`` and ``step`` in
    place and returns (params, state)."""
    step = state["step"].add_(1)
    stepf = step.to(torch.float32)
    lr = lr_schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        g32 = g.to(torch.float32)
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g32)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g32 * g32)
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = p.to(torch.float32)
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        p.copy_((p32 - lr * (upd + wd * p32)).to(p.dtype))
    return params, state
