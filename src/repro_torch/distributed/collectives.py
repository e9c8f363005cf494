"""The reference's named-axis collectives over a mesh of ranks
(:func:`repro_torch.launch.mesh.make_rank_mesh`): ``lax.psum``,
``lax.pmean``, ``lax.pmax``, ``lax.all_gather(..., tiled=True)``,
``lax.psum_scatter`` and ``lax.axis_index``, each over one axis or a tuple
of axes;
``lax.ppermute`` over one axis; :func:`unshard`, a whole leaf from this
rank's shard of it; :func:`pvary`, the identity whose gradient is
summed; and :func:`broadcast`, one rank's tensor on every rank of the
axes (the async server's per-step agreement; no ``lax`` op does this).

A tuple of axes is one axis of their product with the last axis varying
fastest, as in an entry of a ``PartitionSpec``. A collective runs over the
axes one after another, each on ``DeviceMesh.get_group(axis)``, whose group
ranks follow the coordinate on that axis. Each call adds one to
``mesh.counts[name]`` (``psum``, ``pmax``, ``all_gather``,
``psum_scatter``, ``ppermute``, ``broadcast``), and each axis it runs over
adds one to ``mesh.records[(op, result bytes, group size)]``, op the
collective that axis ran (``all-gather``, ``collective-permute``, or
``all-reduce`` for ``psum``, ``pmax`` and ``psum_scatter``), named as in
XLA's HLO, or ``broadcast``, which HLO lacks.

Transport (:meth:`repro_torch.launch.mesh.Mesh.transport`): NCCL with CUDA
tensors and gloo with CPU tensors run on the tensor's own device. Gloo with
CUDA tensors copies the tensor to the host once, runs every axis's
collective there and copies the result back once, adding the bytes of both
copies to ``mesh.counts["staged_bytes"]``. Any other pairing raises.

Gradients. Training on a mesh splits the batch over ``batch_axes``; every
other axis is one on which each rank computes the same thing (activations
are whole and replicated along ``model``). Every rank differentiates the
same global loss, so the backward of each collective is:

* :func:`psum` / :func:`pmean`: the output feeds work that is replicated
  over the axes, so the cotangent passes through unchanged (divided by the
  rank count for ``pmean``);
* :func:`all_gather`: over an axis in ``batch_axes`` each rank's cotangent
  is its own rows' part, so it is summed and scattered
  (:func:`psum_scatter`); over any other axis every rank holds the whole
  cotangent, so it is this rank's slice (a sum would scale it by the
  axis's size);
* :func:`pvary`: a replicated input that feeds a partial result later
  summed over ``axes`` (the MoE's tokens and router ahead of the experts'
  ``psum`` over ``model``) gets its cotangent summed over ``axes``;
* :func:`psum_scatter`: the :func:`all_gather` of the cotangent;
* :func:`pmax` and :func:`broadcast` have none: serving alone takes them
  (under ``inference_mode``, or on host data), and a backward through
  either raises.

These are the transposes ``shard_map`` gives the reference with
``check_rep=False``. A leaf that no collective gathers and that is
replicated over a batch axis gets its gradient summed over that axis by
the train step (:func:`repro_torch.training.train_loop.sync_grads`).
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
    axes); 0 over no axes, on any mesh."""
    if not _axes(axes):
        return 0
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


def _all_reduce(t, mesh, axes, op=dist.ReduceOp.SUM):
    """``t`` reduced by ``op`` in place over each of ``axes``, one after
    another."""
    for a in _axes(axes):
        dist.all_reduce(t, op=op, group=mesh.device_mesh.get_group(a))
        mesh.records["all-reduce", _nbytes(t), mesh.shape[a]] += 1
    return t


def _psum(x, mesh, axes):
    return _run(mesh, "psum", x,
                lambda t: _all_reduce(t.clone(), mesh, axes), axes)


def _pmax(x, mesh, axes):
    return _run(mesh, "pmax", x, lambda t: _all_reduce(
        t.clone(), mesh, axes, dist.ReduceOp.MAX), axes)


def _all_gather(x, mesh, axes, dim):
    def run(t):
        for a in reversed(_axes(axes)):
            parts = [torch.empty_like(t) for _ in range(mesh.shape[a])]
            dist.all_gather(parts, t, group=mesh.device_mesh.get_group(a))
            t = torch.cat(parts, dim)
            mesh.records["all-gather", _nbytes(t), mesh.shape[a]] += 1
        return t
    return _run(mesh, "all_gather", x, run, axes)


def _ppermute(x, mesh, axis, perm):
    def run(t):
        group = mesh.device_mesh.get_group(axis)
        me = mesh.coord[axis]
        out = torch.zeros_like(t)
        ops = []
        for src, dst in perm:
            if src == me and dst == me:
                out.copy_(t)
            elif src == me:
                ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(
                    group, dst), group))
            elif dst == me:
                ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(
                    group, src), group))
        # both directions posted at once: neither side waits on the other
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        mesh.records["collective-permute", _nbytes(out), mesh.shape[axis]] \
            += 1
        return out
    return _run(mesh, "ppermute", x, run, axis)


def _broadcast(x, mesh, axes, src):
    # the source's coordinate on each axis; along the last axis first, so
    # that the ranks sharing the source's coordinates on the earlier axes
    # hold its tensor before those axes carry it on
    coords = []
    for a in reversed(_axes(axes)):
        coords.append((a, src % mesh.shape[a]))
        src //= mesh.shape[a]

    def run(t):
        t = t.clone()
        for a, c in coords:
            group = mesh.device_mesh.get_group(a)
            dist.broadcast(t, dist.get_global_rank(group, c), group=group)
            mesh.records["broadcast", _nbytes(t), mesh.shape[a]] += 1
        return t
    return _run(mesh, "broadcast", x, run, axes)


def _psum_scatter(x, mesh, axes, dim):
    # an all-reduce, then this rank's block: gloo has no reduce-scatter,
    # and one path serves every backend
    def run(t):
        t = _all_reduce(t.clone(), mesh, axes)
        return _block(t, mesh, axes, dim).contiguous()
    return _run(mesh, "psum_scatter", x, run, axes)


def block_slice(n: int, mesh, axes: Axes) -> slice:
    """This rank's block of ``n`` entries split over ``axes`` (all of
    them over no axes)."""
    w = n // axis_size(mesh, axes)
    i = axis_index(mesh, axes)
    return slice(i * w, (i + 1) * w)


def _block(x, mesh, axes, dim):
    """This rank's block of ``x`` along ``dim`` split over ``axes``."""
    b = block_slice(x.shape[dim], mesh, axes)
    return x.narrow(dim, b.start, b.stop - b.start)


def _gather_grad(g, mesh, axes, dim, batch_axes):
    """The cotangent of a tiled all-gather over ``axes``: summed over those
    in ``batch_axes`` and scattered, sliced over the rest."""
    axes = _axes(axes)
    summed = tuple(a for a in axes if a in _axes(batch_axes))
    if not summed:
        return _block(g, mesh, axes, dim).contiguous()
    if summed != axes:
        # select this rank's coordinate on the replicated axes; what is
        # left is the blocks of the summed axes, in their order
        sizes = [mesh.shape[a] for a in axes]
        shape = list(g.shape)
        g = g.reshape(shape[:dim] + sizes + [shape[dim] // math.prod(sizes)]
                      + shape[dim + 1:])
        for i, a in reversed(list(enumerate(axes))):
            if a not in summed:
                g = g.select(dim + i, mesh.coord[a])
        g = g.flatten(dim, dim + len(summed))
    return _psum_scatter(g, mesh, summed, dim)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _pmax(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("pmax has no backward: it serves the decode "
                           "step's softmax, which runs under inference_mode")


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, src):
        return _broadcast(x, mesh, axes, src)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("broadcast has no backward: it carries the async "
                           "server's decisions, which nothing differentiates")


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, batch_axes):
        ctx.args = (mesh, axes, dim, batch_axes)
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_grad(g, *ctx.args), None, None, None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _psum_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (``lax.psum``), the
    same on every one of them; the gradient passes through."""
    if not _axes(axes):
        return x
    return _PSum.apply(x, mesh, axes)


def pmean(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """:func:`psum` over the number of ranks of ``axes`` (``lax.pmean``)."""
    return psum(x, mesh, axes) / axis_size(mesh, axes)


def pmax(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``axes``
    (``lax.pmax``), the same on every one of them. Forward only: it serves
    the decode step's softmax under ``inference_mode``, and a backward
    through it raises ``RuntimeError``."""
    if not _axes(axes):
        return x
    return _PMax.apply(x, mesh, axes)


def broadcast(x: torch.Tensor, mesh, axes: Axes, src: int = 0
              ) -> torch.Tensor:
    """The ``x`` of the rank whose index on ``axes`` (as one axis, the last
    varying fastest) is ``src``, on every rank of ``axes``; every rank
    passes a tensor of the same shape and dtype. ``x`` itself over no
    axes. Forward only: a backward through it raises ``RuntimeError``."""
    if not _axes(axes):
        return x
    if not 0 <= src < axis_size(mesh, axes):
        raise ValueError(f"src {src} is not an index on {axes!r}")
    return _Broadcast.apply(x, mesh, axes, int(src))


def pvary(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``axes``: a value that
    is the same on every rank of ``axes`` and feeds a partial result that
    a :func:`psum` over them completes."""
    if not _axes(axes):
        return x
    return _PVary.apply(x, mesh, axes)


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int = 0, *,
               batch_axes: Axes = ()) -> torch.Tensor:
    """Every rank's ``x`` of ``axes`` concatenated along ``dim`` in rank
    order (``lax.all_gather(..., tiled=True)``). ``batch_axes`` are read
    by the gradient only: summed and scattered over those of ``axes``,
    this rank's slice over the rest."""
    if not _axes(axes):
        return x
    return _AllGather.apply(x, mesh, axes, dim % x.dim(), batch_axes)


def psum_scatter(x: torch.Tensor, mesh, axes: Axes, dim: int = 0
                 ) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, of which each rank
    keeps its block along ``dim`` (``lax.psum_scatter(..., tiled=True)``):
    an all-reduce and this rank's block, on every backend."""
    if not _axes(axes):
        return x
    return _PSumScatter.apply(x, mesh, axes, dim % x.dim())


def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """``lax.ppermute`` over the ranks of one ``axis``: ``perm`` is (source,
    destination) pairs of indices on ``axis``, each index at most once a
    source and once a destination. This rank sends ``x`` to its
    destination and returns what its source sent, zeros where none does.
    The sends and receives of the call are posted together
    (``batch_isend_irecv``). No gradient: nothing differentiates through
    it."""
    if not isinstance(axis, str):
        raise ValueError(f"ppermute runs over one axis, got {axis!r}")
    perm = [(int(s), int(d)) for s, d in perm]
    for side in zip(*perm):
        if len(set(side)) != len(side):
            raise ValueError(f"a rank sends or receives twice in {perm}")
    return _ppermute(x.detach(), mesh, axis, perm)


def unshard(x: torch.Tensor, spec, mesh, *, batch_axes: Axes = ()
            ) -> torch.Tensor:
    """The whole leaf from this rank's shard ``x`` of a leaf laid out by
    ``spec`` (one entry a dim: ``None``, an axis or a tuple of axes): an
    :func:`all_gather` along each sharded dim. ``x`` itself where nothing
    is sharded."""
    for d, entry in enumerate(spec):
        if entry is not None:
            x = all_gather(x, mesh, entry, d, batch_axes=batch_axes)
    return x
