"""Parameter metadata trees: shapes + logical axes, materialized lazily.

The port of the reference's ``repro.models.params``. Models declare
``ParamMeta`` trees (nested dicts and lists whose leaves carry a shape, a
torch dtype, logical axis names and an init kind). From a meta tree, without
allocating, come the parameter count and bytes; :func:`init_tree` makes real
tensors from an explicit ``torch.Generator`` on an explicit device.

The reference's ``spec_for`` / ``spec_tree`` / ``sharding_tree`` map the
logical axes onto a device mesh; they wait for the port's multi-process mesh
(ROADMAP §1), and the axes ride along unused until then.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"   # normal | zeros | ones | embed
    scale: Optional[float] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in length")


def meta(shape, axes, dtype=torch.float32, init="normal",
         scale=None) -> ParamMeta:
    return ParamMeta(tuple(int(s) for s in shape), tuple(axes), dtype, init,
                     scale)


def is_meta(x) -> bool:
    return isinstance(x, ParamMeta)


def map_tree(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its dicts, lists and tuples. Anything else, a
    ``ParamMeta`` included, is a leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_tree(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def leaves(tree: Tree) -> list:
    """The leaves of ``tree``, dict keys in sorted order (as jax flattens
    a dict)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


# The most elements of one float32 draw (see init_tree):
# 2**26 float32 draws, 256 MiB, against qwen3-moe-30b-a3b's 38.7 GB
# float32 draw of one stacked expert leaf (48, 128, 2048, 768) whole.
SLAB_ELEMS = 1 << 26


def init_tree(metas: Tree, generator: torch.Generator, device) -> Tree:
    """Materialize parameters on ``device``. Leaves draw from ``generator``
    one after another, in :func:`leaves` order, so one seed gives one tree;
    the draws run on the generator's device. A random leaf is allocated
    once in its own dtype on ``device`` and filled in slabs: consecutive
    runs of at most :data:`SLAB_ELEMS` elements in row-major order (so
    along the leading axis), each drawn in float32, scaled and cast into
    place, so no float32 copy of a leaf larger than a slab ever exists. The
    kinds and scales are the reference's: ``normal`` at ``scale`` or
    1/sqrt(fan_in) (fan_in = shape[-2], or shape[-1] for a vector),
    ``embed`` at ``scale`` or 1, ``zeros``, ``ones``."""
    def draw(n: int, scale: float) -> torch.Tensor:
        x = torch.randn(n, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return x.mul_(scale)

    def make(m: ParamMeta) -> torch.Tensor:
        if m.init == "zeros":
            return torch.zeros(m.shape, dtype=m.dtype, device=device)
        if m.init == "ones":
            return torch.ones(m.shape, dtype=m.dtype, device=device)
        fan_in = m.shape[-2] if len(m.shape) >= 2 else m.shape[-1]
        scale = m.scale if m.scale is not None else 1.0 / math.sqrt(fan_in)
        if m.init == "embed":
            scale = m.scale if m.scale is not None else 1.0
        numel = math.prod(m.shape)
        out = torch.empty(m.shape, dtype=m.dtype, device=device)
        flat = out.view(-1)
        for lo in range(0, numel, SLAB_ELEMS):
            n = min(SLAB_ELEMS, numel - lo)
            flat[lo:lo + n].copy_(draw(n, scale))
        return out

    def walk(t):
        if isinstance(t, dict):
            made = {k: walk(t[k]) for k in sorted(t)}
            return {k: made[k] for k in t}
        if isinstance(t, (list, tuple)):
            out = [walk(v) for v in t]
            return out if isinstance(t, list) else tuple(out)
        return make(t)

    return walk(metas)


def count_params(metas: Tree) -> int:
    return int(sum(math.prod(m.shape) for m in leaves(metas)))


def tree_bytes(metas: Tree) -> int:
    return int(sum(math.prod(m.shape) * m.dtype.itemsize
                   for m in leaves(metas)))
