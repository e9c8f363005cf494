"""Serving layer of the port (the reference's ``repro.serving``).

* :class:`ServeEngine` — greedy decoding over a
  :class:`repro_torch.models.LM`; :func:`seed_caches` moves prefill caches
  into the decode layout.
* :class:`RetrievalServer` — sync: a tick embeds and answers its whole
  queue, mutations first, grouped by predicate mask.
* :class:`AsyncRetrievalServer` — continuous batching behind an SLO
  :class:`Scheduler`: graph-routed queries on a ``QueryEngine`` run on
  :class:`repro_torch.core.WavefrontStream`, bit-identical to solo
  execution; every other route and backend runs as micro-batches.
"""
from .engine import GenerationResult, RetrievalServer, ServeEngine, seed_caches
from .ops import QueryOp, UpsertOp, DeleteOp
from .scheduler import SLOPolicy, Scheduler, ServerMetrics, StreamingHistogram
from .async_engine import AsyncRetrievalServer

__all__ = [
    "ServeEngine", "GenerationResult", "RetrievalServer", "seed_caches",
    "QueryOp", "UpsertOp", "DeleteOp",
    "SLOPolicy", "Scheduler", "ServerMetrics", "StreamingHistogram",
    "AsyncRetrievalServer",
]
