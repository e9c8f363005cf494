"""A logical device mesh: named axes of logical shards on one device.

The reference builds a ``jax.sharding.Mesh`` over real devices and runs its
collectives across them. The port serves every shard from one card, so its
mesh is only the bookkeeping the distributed layer reads: each axis's name
and size (``mesh.shape[axis]``, as on a JAX mesh) and the device every
shard's tensors live on. No ``torch.distributed`` process group is made.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from ..core.engine import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape``: axis name -> number of logical shards on that axis;
    ``device``: the one device that holds them all."""

    shape: Dict[str, int]
    device: torch.device


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device=None) -> Mesh:
    """A mesh of ``shape`` logical shards named by ``axes``, all on
    ``device`` (``None`` means ``"cuda"`` and raises without a card)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if len(set(axes)) != len(axes):
        raise ValueError(f"axis names repeat: {axes}")
    if any(s < 1 for s in shape):
        raise ValueError(f"every axis needs >= 1 shard, got {shape}")
    return Mesh(dict(zip(axes, shape)), resolve_device(device))
