"""Parameter metadata trees: shapes + logical axes, materialized lazily.

The port of the reference's ``repro.models.params``. Models declare
``ParamMeta`` trees (nested dicts and lists whose leaves carry a shape, a
torch dtype, logical axis names and an init kind). From a meta tree, without
allocating, come the parameter count and bytes, :func:`shape_dtype_tree`
(``meta``-device tensors, the reference's ``ShapeDtypeStruct`` tree) and,
on a mesh, each leaf's spec (:func:`spec_for` / :func:`spec_tree`: the
logical axes mapped to mesh axes by a rule set, replicated where the mesh
axes do not divide the dim) and its sharding (:func:`sharding_tree`, a
:class:`repro_torch.distributed.sharding.NamedSharding` a leaf: this
rank's shard shape and slice). :func:`init_tree` makes real tensors from
an explicit ``torch.Generator`` on an explicit device, the whole tree or,
with ``mesh=``, this rank's shard of each leaf.

Logical axes: embed, vocab, heads, kv_heads, head_dim, mlp, expert,
expert_mlp, layers, q_lora, kv_lora, conv, stack. :data:`DEFAULT_RULES` is
the training posture, FSDP ("embed" over data) x TP ("vocab" / "heads" /
"mlp" / "expert" over model); :data:`SERVE_RULES` the serving posture, TP
only, with the experts over the whole mesh. A model on a mesh of ranks
holds its parameters under :func:`rules_for` its mode: serving under
``SERVE_RULES``, training under ``DEFAULT_RULES``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..distributed.sharding import NamedSharding

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


def shape_dtype_tree(metas: Tree) -> Tree:
    """Each leaf as a ``meta``-device tensor of its shape and dtype."""
    return map_tree(lambda m: torch.empty(m.shape, dtype=m.dtype,
                                          device="meta"), metas)


# Default logical-axis -> mesh-axis rules (training posture: FSDP x TP).
DEFAULT_RULES: Dict[str, Optional[Sequence[str]]] = {
    "embed": ("data",),          # FSDP shard over the data axis
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "expert_mlp": None,
    "head_dim": None,
    "q_lora": None,
    "kv_lora": ("model",),
    "layers": None,
    "stack": None,
    "conv": None,
}

# Inference posture: no FSDP (weights stationary), TP only, except the
# experts, which shard over the whole mesh (pod x data x model): a 671B MoE
# does not fit 16 ways; 512-way expert parallelism does.
SERVE_RULES = dict(DEFAULT_RULES, embed=None,
                   expert=("pod", "data", "model"))


def rules_for(mode: str) -> dict:
    """The rules a model's parameters are held under in ``mode``:
    :data:`DEFAULT_RULES` for ``train``, :data:`SERVE_RULES` otherwise."""
    return DEFAULT_RULES if mode == "train" else SERVE_RULES


def spec_for(m: ParamMeta, mesh, rules) -> tuple:
    """``m``'s spec on ``mesh`` (reads ``mesh.shape`` only): each dim's
    rule, with the axes the mesh lacks or an earlier dim used taken out
    and the leading ones dropped until their product divides the dim and
    exceeds 1 (experts over (data, model) degrade to (model,) when E is
    smaller than the mesh); ``None`` where nothing is left."""
    parts, used = [], set()
    for dim, ax in zip(m.shape, m.axes):
        r = rules.get(ax) if ax else None
        if r is None:
            parts.append(None)
            continue
        r = (r,) if isinstance(r, str) else tuple(r)
        r = tuple(a for a in r if a in mesh.shape and a not in used)
        while r and (dim % math.prod(mesh.shape[a] for a in r) != 0
                     or math.prod(mesh.shape[a] for a in r) <= 1):
            r = r[1:]
        if not r:
            parts.append(None)
            continue
        used.update(r)
        parts.append(r[0] if len(r) == 1 else r)
    return tuple(parts)


def spec_tree(metas: Tree, mesh, rules: Optional[dict] = None) -> Tree:
    rules = rules or DEFAULT_RULES
    return map_tree(lambda m: spec_for(m, mesh, rules), metas)


def sharding_tree(metas: Tree, mesh, rules: Optional[dict] = None) -> Tree:
    rules = rules or DEFAULT_RULES
    return map_tree(lambda m: NamedSharding(mesh, spec_for(m, mesh, rules)),
                    metas)


def shard_metas(metas: Tree, mesh, rules: dict) -> Tree:
    """``metas`` with each shape this rank's shard shape under ``rules``:
    what :func:`init_tree` with ``mesh=`` makes, and what :func:`tree_bytes`
    of it counts."""
    return map_tree(lambda m: dataclasses.replace(
        m, shape=NamedSharding(mesh, spec_for(m, mesh, rules)).shard_shape(
            m.shape)), metas)


def _fill_box(out: torch.Tensor, src: torch.Tensor, lo: int,
              shape: Tuple[int, ...], box: Tuple[slice, ...]) -> None:
    """Copy into ``out`` (the ``box`` of a leaf of ``shape``) the part of
    the box that ``src`` covers, ``src`` holding the leaf's row-major
    elements ``lo`` .. ``lo + len(src)``: whole rows of the leading dim at
    once, and the at most two rows ``src`` cuts into by recursion."""
    hi = lo + src.numel()
    b0, b1 = box[0].start, box[0].stop
    if len(shape) == 1:
        a, b = max(lo, b0), min(hi, b1)
        if a < b:
            out[a - b0:b - b0].copy_(src[a - lo:b - lo])
        return
    row = math.prod(shape[1:])
    f0, f1 = -(-lo // row), hi // row            # rows src holds whole
    a, b = max(f0, b0), min(f1, b1)
    if a < b:
        rows = src[a * row - lo:b * row - lo].view(b - a, *shape[1:])
        out[a - b0:b - b0].copy_(rows[(slice(None),) + tuple(box[1:])])
    for r in sorted({lo // row, (hi - 1) // row}):
        if f0 <= r < f1 or not b0 <= r < b1:
            continue
        s, e = max(lo, r * row), min(hi, (r + 1) * row)
        _fill_box(out[r - b0], src[s - lo:e - lo], s - r * row, shape[1:],
                  box[1:])


# The most elements of one float32 draw (see init_tree):
# 2**26 float32 draws, 256 MiB, against qwen3-moe-30b-a3b's 38.7 GB
# float32 draw of one stacked expert leaf (48, 128, 2048, 768) whole.
SLAB_ELEMS = 1 << 26


def init_tree(metas: Tree, generator: torch.Generator, device, *,
              mesh=None, rules: Optional[dict] = None) -> Tree:
    """Materialize parameters on ``device``. Leaves draw from ``generator``
    one after another, in :func:`leaves` order, so one seed gives one tree;
    the draws run on the generator's device. A random leaf is allocated
    once in its own dtype on ``device`` and filled in slabs: consecutive
    runs of at most :data:`SLAB_ELEMS` elements in row-major order (so
    along the leading axis), each drawn in float32, scaled and cast into
    place, so no float32 copy of a leaf larger than a slab ever exists. The
    kinds and scales are the reference's: ``normal`` at ``scale`` or
    1/sqrt(fan_in) (fan_in = shape[-2], or shape[-1] for a vector),
    ``embed`` at ``scale`` or 1, ``zeros``, ``ones``.

    With ``mesh`` (a mesh of ranks), each leaf is this rank's shard under
    ``rules``, which a mesh requires (``ValueError`` without): every rank draws every slab
    of every leaf, as the whole init does, and keeps the part that falls in
    its slice, so the shard equals the whole init's slice bit for bit and
    costs one slab of float32 beyond the shard itself."""
    def draw(n: int, scale: float) -> torch.Tensor:
        x = torch.randn(n, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return x.mul_(scale)

    if mesh is not None and rules is None:
        raise ValueError("init_tree on a mesh needs its rules "
                         "(SERVE_RULES or DEFAULT_RULES)")

    def make(m: ParamMeta) -> torch.Tensor:
        box = (NamedSharding(mesh, spec_for(m, mesh, rules)).index(m.shape)
               if mesh is not None else tuple(slice(0, n) for n in m.shape))
        local = tuple(b.stop - b.start for b in box)
        if m.init == "zeros":
            return torch.zeros(local, dtype=m.dtype, device=device)
        if m.init == "ones":
            return torch.ones(local, dtype=m.dtype, device=device)
        fan_in = m.shape[-2] if len(m.shape) >= 2 else m.shape[-1]
        scale = m.scale if m.scale is not None else 1.0 / math.sqrt(fan_in)
        if m.init == "embed":
            scale = m.scale if m.scale is not None else 1.0
        numel = math.prod(m.shape)
        out = torch.empty(local, dtype=m.dtype, device=device)
        whole = local == m.shape
        for lo in range(0, numel, SLAB_ELEMS):
            n = min(SLAB_ELEMS, numel - lo)
            if whole:
                out.view(-1)[lo:lo + n].copy_(draw(n, scale))
            else:
                _fill_box(out, draw(n, scale), lo, m.shape, box)
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
