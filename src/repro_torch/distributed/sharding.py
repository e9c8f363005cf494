"""Small sharding helpers shared by the model and the serving engine (the
reference's ``repro.distributed.sharding``).

A spec is a plain tuple, one entry a dim: ``None`` (whole), an axis name,
or a tuple of axis names (one axis of their product, the last varying
fastest). :class:`NamedSharding` pairs a spec with a mesh of ranks and
gives what a ``jax.sharding.NamedSharding`` gives the reference: the shape
of this rank's shard of a leaf and where that shard lies in the whole.
Every helper reads only ``mesh.shape``, except the shard's index, which
reads this rank's coordinate.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple, Union

from .collectives import axis_index, axis_size

Spec = Tuple[Any, ...]


mesh_axis_size = axis_size     # the reference's name


def shard_or_replicate(mesh, dim_size: int,
                       axes: Union[str, Sequence[str], None]):
    """``axes`` for this dim only if they divide it evenly, else ``None``
    (replicate): small models (gemma3-1b has 4 heads) or tiny batches
    cannot shard every logical axis on a 16-wide mesh."""
    if axes is None:
        return None
    size = mesh_axis_size(mesh, axes)
    if size <= 1 or dim_size % size != 0:
        return None
    return axes if isinstance(axes, str) else tuple(axes)


def batch_spec(mesh, batch: int, axes=("pod", "data")) -> Spec:
    """The batch dim over the present ``axes`` when they divide it; the
    leading axes dropped until they do (the reference's
    ``P(present or None)``, a single axis by its name)."""
    present = tuple(a for a in axes if a in mesh.shape)
    while present and (mesh_axis_size(mesh, present) == 0 or
                       batch % mesh_axis_size(mesh, present) != 0):
        present = present[1:]
    if not present:
        return (None,)
    return (present[0] if len(present) == 1 else present,)


def batch_split(mesh, batch: int, axes=("data",)) -> Tuple[str, ...]:
    """The axes a serving batch of ``batch`` rows is split over: the
    present ``axes`` that divide it, the leading ones dropped until they do
    (:func:`batch_spec`), as a tuple, less the axes of one rank (a split
    over one rank is no split); () where the batch is replicated."""
    entry = batch_spec(mesh, batch, axes)[0]
    entry = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    return tuple(a for a in entry if mesh.shape[a] > 1)


def spec_axes(spec) -> Tuple[str, ...]:
    """The mesh axes that ``spec`` shards a leaf over, sorted."""
    return tuple(sorted({a for e in spec if e is not None
                         for a in ((e,) if isinstance(e, str) else e)}))


def batch_rows(batch: dict, mesh, axes=("data",)) -> dict:
    """This rank's rows of ``batch`` (a dict of arrays or tensors whose
    first dim is the global batch) split over the present ``axes`` as the
    reference's training step splits it (``batch_spec(mesh, 1 << 30,
    axes)``: every present axis); ``ValueError`` where they do not divide
    the batch."""
    present = tuple(a for a in axes if a in mesh.shape)
    n = mesh_axis_size(mesh, present)
    B = len(next(iter(batch.values())))
    if B % n:
        raise ValueError(f"a batch of {B} does not split over {present} "
                         f"({n} ranks)")
    i, m = axis_index(mesh, present), B // n
    return {k: v[i * m:(i + 1) * m] for k, v in batch.items()}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf laid out over ``mesh`` by ``spec`` (entries past the spec's
    length are whole)."""

    mesh: Any
    spec: Spec

    def _entry(self, d: int):
        return self.spec[d] if d < len(self.spec) else None

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of each rank's shard of a leaf of ``shape``."""
        out = []
        for d, n in enumerate(shape):
            k = axis_size(self.mesh, self._entry(d))
            if n % k:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"split over {self._entry(d)} ({k})")
            out.append(n // k)
        return tuple(out)

    def index(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's shard of a leaf of ``shape``, a slice a dim."""
        out = []
        for d, n in enumerate(self.shard_shape(shape)):
            i = axis_index(self.mesh, self._entry(d))
            out.append(slice(i * n, (i + 1) * n))
        return tuple(out)


def rank_box(mesh, spec, shape: Sequence[int], whole=()) -> Tuple[slice, ...]:
    """This rank's box of a leaf of ``shape`` laid out by ``spec``
    (:meth:`NamedSharding.index`), a slice a dim, with the dims in
    ``whole`` taken whole: a cache leaf that holds this rank's rows
    already keeps its batch dim."""
    box = NamedSharding(mesh, tuple(spec)).index(shape)
    return tuple(slice(None) if d in whole else b for d, b in enumerate(box))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def named(mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(spec))
