"""Typed serving operations, shared by the sync :class:`RetrievalServer`
queue and the async :class:`~repro_torch.serving.scheduler.Scheduler`
(the reference's ``repro.serving.ops``). One dataclass per op kind; both
servers dispatch on type.

``deadline_ms`` / ``priority`` are SLO metadata read only by the async
scheduler (earliest-deadline-first ordering, deadline shedding); the sync
server ignores them: its ``tick()`` runs everything, deterministically.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["QueryOp", "UpsertOp", "DeleteOp"]


@dataclasses.dataclass(frozen=True)
class QueryOp:
    """One retrieval request: ``item`` is embedded by the server's
    ``embed_fn``; ``mask`` is the resolved predicate bitmask (call
    :func:`repro_torch.core.as_mask` before constructing)."""
    item: Any
    qlo: float
    qhi: float
    mask: int
    deadline_ms: Optional[float] = None
    priority: int = 0

    def __post_init__(self):
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0 (or None: no deadline)")


@dataclasses.dataclass(frozen=True)
class UpsertOp:
    """Corpus upsert: ``item`` is embedded in the tick's batched call and
    inserted under stable ``ext_id`` with object range ``[lo, hi]``."""
    ext_id: int
    item: Any
    lo: float
    hi: float
    deadline_ms: Optional[float] = None
    priority: int = 0


@dataclasses.dataclass(frozen=True)
class DeleteOp:
    """Corpus delete (tombstone) of ``ext_id``."""
    ext_id: int
    deadline_ms: Optional[float] = None
    priority: int = 0
