"""Device meshes: named axes of ranks, or of logical shards on one device.

One type, :class:`Mesh`, stands for both kinds; ``mesh.shape[axis]`` is an
axis's size in either, as on a JAX mesh.

* **A mesh of ranks** (:func:`make_rank_mesh`, and the reference's
  :func:`make_host_mesh` and :func:`make_production_mesh`): one process a
  rank, all of them in the default ``torch.distributed`` process group,
  laid out as a ``torch.distributed.device_mesh.DeviceMesh`` whose named
  dimensions are the mesh's axes. The mesh carries that ``DeviceMesh``,
  this rank's coordinate on each axis and this rank's device.
  :mod:`repro_torch.distributed.collectives` runs the reference's named-axis
  collectives over it, parameters are stored by the reference's
  logical-axis rules (:func:`repro_torch.models.params.init_tree` with
  ``mesh=``) and ``ServeEngine(mesh=)`` serves on it.
* **A logical mesh** (:func:`make_mesh`): axes of logical shards that one
  device serves, the bookkeeping ``ShardedDeployment`` reads (each axis's
  size and the one device). It makes no process group.

Transport. NCCL carries CUDA tensors and gloo CPU tensors. A gloo group
whose ranks hold CUDA tensors (several ranks on one card, which NCCL
refuses) is taken only where the caller made that group: each collective
then copies its tensor to the host, runs there and copies the result back
(gloo's CUDA collectives are only ``all_reduce`` and ``broadcast``), and
the bytes copied each way are counted in ``mesh.counts["staged_bytes"]``.
The ``fake`` backend (``torch.distributed``'s ``FakeProcessGroup``, which
moves nothing) carries CPU tensors: the dry-run tools
(:mod:`repro_torch.launch.dryrun`) join it to lay the production meshes out
over 256 or 512 ranks in one process, on fake tensors. Any other pairing
raises (:meth:`Mesh.transport`): no backend or device is swapped silently.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

import torch

from ..core.engine import resolve_device

# (backend, device type) -> how a collective moves a tensor of that device
TRANSPORT = {("nccl", "cuda"): "direct", ("gloo", "cpu"): "direct",
             ("gloo", "cuda"): "host", ("fake", "cpu"): "direct"}


def transport(backend: str, device) -> str:
    """``"direct"`` or ``"host"`` (:data:`TRANSPORT`); ``RuntimeError``
    where ``backend`` has no collectives for ``device``'s tensors."""
    how = TRANSPORT.get((backend, torch.device(device).type))
    if how is None:
        raise RuntimeError(f"the {backend} backend has no collectives for "
                           f"{torch.device(device)} tensors")
    return how


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape``: axis name -> size; ``device``: this rank's device (a
    logical mesh: the one device that holds every shard).

    A mesh of ranks also has ``device_mesh`` (the ``DeviceMesh``),
    ``coord`` (axis name -> this rank's index on it) and ``backend`` (the
    process group's); a logical mesh has ``None`` there. ``counts``
    tallies what ran on the mesh: each collective's calls, the bytes staged
    through the host and the MoE path each call took. ``records`` counts
    the calls of each (op, result bytes, group size) that a collective ran
    over one axis (:mod:`repro_torch.distributed.collectives`), what
    :func:`repro_torch.launch.dryrun.collective_bytes` reads."""

    shape: Dict[str, int]
    device: torch.device
    device_mesh: Any = None
    coord: Optional[Dict[str, int]] = None
    backend: Optional[str] = None
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter, compare=False)
    records: collections.Counter = dataclasses.field(
        default_factory=collections.Counter, compare=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def transport(self, device) -> str:
        """``"direct"`` or ``"host"`` for a tensor on ``device``; raises
        ``ValueError`` on a logical mesh and ``RuntimeError`` where the
        backend has no collectives for that device."""
        if self.device_mesh is None:
            raise ValueError("a logical mesh has no ranks to run a "
                             "collective over; make one with "
                             "make_rank_mesh")
        return transport(self.backend, device)


def pick_device(device, mesh) -> torch.device:
    """``device`` if given, else the mesh's, else ``"cuda"``. A mesh's
    tensors live on its device, so a different ``device`` is refused (a
    bare ``"cuda"`` reads as the current card)."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and _index(resolve_device(device)) != \
            _index(mesh.device):
        raise ValueError(f"device {device!r} differs from the mesh's "
                         f"device {mesh.device}")
    return mesh.device


def _index(dev: torch.device):
    if dev.type == "cuda" and dev.index is None:
        return dev.type, torch.cuda.current_device()
    return dev.type, dev.index


def _checked(shape: Sequence[int], axes: Sequence[str]):
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if len(set(axes)) != len(axes):
        raise ValueError(f"axis names repeat: {axes}")
    if any(s < 1 for s in shape):
        raise ValueError(f"every axis needs >= 1 shard, got {shape}")
    return shape, axes


def _world_size() -> int:
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh of ranks needs the default process "
                           "group: call torch.distributed."
                           "init_process_group first")
    return dist.get_world_size()


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device=None) -> Mesh:
    """A logical mesh of ``shape`` shards named by ``axes``, all on
    ``device`` (``None`` means ``"cuda"`` and raises without a card)."""
    shape, axes = _checked(shape, axes)
    return Mesh(dict(zip(axes, shape)), resolve_device(device))


def make_rank_mesh(shape: Sequence[int], axes: Sequence[str], *,
                   device=None) -> Mesh:
    """A mesh of ranks over the default process group, which the caller
    has joined (``torch.distributed.init_process_group``): ``shape`` must
    multiply to its world size. Rank r sits at the row-major coordinate of
    r, so the last axis varies fastest. ``device`` is this rank's (``None``
    means ``"cuda"`` and raises without a card); the group's backend must
    carry its tensors (:meth:`Mesh.transport`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = _checked(shape, axes)
    world = _world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} has "
                         f"{math.prod(shape)} ranks, the process group "
                         f"{world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    backend = dist.get_backend()
    transport(backend, dev)                  # raises before any group exists
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    return Mesh(dict(zip(axes, shape)), dev, dm,
                dict(zip(axes, dm.get_coordinate())), backend)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    """The reference's small ``(data, model)`` mesh: each axis clamped to
    the world size (``model`` to what ``data`` leaves), over every rank."""
    n = _world_size()
    data = min(data, n)
    model = max(1, min(model, n // max(data, 1)))
    return make_rank_mesh((data, model), ("data", "model"), device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production mesh, (data 16, model 16) or (pod 2,
    data 16, model 16); raises ``ValueError`` unless the world size is
    256 or 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_rank_mesh(shape, axes, device=device)
