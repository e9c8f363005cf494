"""Serving front ends of the port (the reference's ``repro.serving``
without ``ServeEngine`` and ``seed_caches``, which need its LM).

* :class:`RetrievalServer` — sync: a tick embeds and answers its whole
  queue, mutations first, grouped by predicate mask.
* :class:`AsyncRetrievalServer` — continuous batching behind an SLO
  :class:`Scheduler`: graph-routed queries on a ``QueryEngine`` run on
  :class:`repro_torch.core.WavefrontStream`, bit-identical to solo
  execution; every other route and backend runs as micro-batches.
"""
from .engine import RetrievalServer
from .ops import QueryOp, UpsertOp, DeleteOp
from .scheduler import SLOPolicy, Scheduler, ServerMetrics, StreamingHistogram
from .async_engine import AsyncRetrievalServer

__all__ = [
    "RetrievalServer",
    "QueryOp", "UpsertOp", "DeleteOp",
    "SLOPolicy", "Scheduler", "ServerMetrics", "StreamingHistogram",
    "AsyncRetrievalServer",
]
