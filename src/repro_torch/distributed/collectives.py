"""The reference's named-axis collectives over a mesh of ranks
(:func:`repro_torch.launch.mesh.make_rank_mesh`): ``lax.psum``,
``lax.pmean``, ``lax.all_gather(..., tiled=True)`` and ``lax.axis_index``,
each over one axis or a tuple of axes; and :func:`unshard`, a whole leaf
from this rank's shard of it.

A tuple of axes is one axis of their product with the last axis varying
fastest, as in an entry of a ``PartitionSpec``. A collective runs over the
axes one after another, each on ``DeviceMesh.get_group(axis)``, whose group
ranks follow the coordinate on that axis. Each call adds one to
``mesh.counts[name]`` (``psum``, ``all_gather``).

Transport (:meth:`repro_torch.launch.mesh.Mesh.transport`): NCCL with CUDA
tensors and gloo with CPU tensors run on the tensor's own device. Gloo with
CUDA tensors copies the tensor to the host once, runs every axis's
collective there and copies the result back once, adding the bytes of both
copies to ``mesh.counts["staged_bytes"]``. Any other pairing raises. The
collectives are not differentiable: they serve inference.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str], None]


def _axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes: Axes) -> int:
    """The product of the sizes of ``axes`` (1 for none)."""
    return math.prod(mesh.shape[a] for a in _axes(axes))


def axis_index(mesh, axes: Axes) -> int:
    """This rank's index on ``axes`` as one axis, the last varying
    fastest (``lax.axis_index``; the reference's ``e_lo`` sum over several
    axes)."""
    if mesh.coord is None:
        raise ValueError("a logical mesh has no rank coordinate")
    i = 0
    for a in _axes(axes):
        i = i * mesh.shape[a] + mesh.coord[a]
    return i


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _run(mesh, name: str, x: torch.Tensor, fn, axes) -> torch.Tensor:
    """``fn`` on ``x`` where the mesh's backend can take it: on ``x``'s
    device, or on a host copy whose result is copied back; ``x`` itself
    over no axes."""
    if not _axes(axes):
        return x
    how = mesh.transport(x.device)
    mesh.counts[name] += 1
    if how == "direct":
        return fn(x.contiguous())
    out = fn(x.detach().to("cpu").contiguous())
    mesh.counts["staged_bytes"] += _nbytes(x) + _nbytes(out)
    return out.to(x.device)


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (``lax.psum``), the
    same on every one of them."""
    def run(t):
        t = t.clone()
        for a in _axes(axes):
            dist.all_reduce(t, group=mesh.device_mesh.get_group(a))
        return t
    return _run(mesh, "psum", x, run, axes)


def pmean(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """:func:`psum` over the number of ranks of ``axes`` (``lax.pmean``)."""
    return psum(x, mesh, axes) / axis_size(mesh, axes)


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int = 0
               ) -> torch.Tensor:
    """Every rank's ``x`` of ``axes`` concatenated along ``dim`` in rank
    order (``lax.all_gather(..., tiled=True)``)."""
    def run(t):
        for a in reversed(_axes(axes)):
            parts = [torch.empty_like(t) for _ in range(mesh.shape[a])]
            dist.all_gather(parts, t, group=mesh.device_mesh.get_group(a))
            t = torch.cat(parts, dim)
        return t
    return _run(mesh, "all_gather", x, run, axes)


def unshard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from this rank's shard ``x`` of a leaf laid out by
    ``spec`` (one entry a dim: ``None``, an axis or a tuple of axes): an
    :func:`all_gather` along each sharded dim. ``x`` itself where nothing
    is sharded."""
    for d, entry in enumerate(spec):
        if entry is not None:
            x = all_gather(x, mesh, entry, d)
    return x
