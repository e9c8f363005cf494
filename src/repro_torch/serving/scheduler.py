"""SLO-aware admission control for the async serving front end (the
reference's ``repro.serving.scheduler``).

Three pieces, all host-side and device-free:

* :class:`SLOPolicy` — the operator's knobs: bounded queue depth, micro-batch
  dispatch triggers (max-wait / max-batch), earliest-deadline-first ordering,
  and shed-on-overload behavior. Overload NEVER raises: a request that cannot
  be admitted or served in time comes back as a typed
  :class:`repro_torch.core.Rejected` outcome.
* :class:`Scheduler` — a bounded FIFO admission queue over the typed ops of
  :mod:`repro_torch.serving.ops`. Mutations are **barriers**: queries may be
  EDF-reordered among themselves but never across a mutation, which keeps
  the sync server's submit-order semantics ("a query sees exactly the
  mutations submitted before it") while still letting the wavefront refill
  slots mid-flight.
* :class:`ServerMetrics` / :class:`StreamingHistogram` — latency
  observability without storing samples: log-spaced histograms give
  p50/p95/p99 queue-wait and end-to-end latency; counters track
  admitted/shed/deadline-missed and batch occupancy / slot-refill efficiency
  (fed by :class:`repro_torch.core.WavefrontStream` counters).

Time comes from an injected ``clock`` (seconds; ``time.perf_counter`` by
default), so deadlines and waits can be driven by a fake clock.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.api import Rejected
from ..obs.metrics import StreamingHistogram

from .ops import DeleteOp, QueryOp, UpsertOp

__all__ = ["SLOPolicy", "Scheduler", "ServerMetrics", "StreamingHistogram",
           "Round"]


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Operator knobs for the admission queue and micro-batch former.

    * ``max_queue`` — bounded admission queue depth; an ``offer()`` beyond it
      returns ``Rejected("queue_full")`` (explicit shed, no exception).
    * ``max_wait_ms`` — dispatch trigger: a round is due once the oldest
      queued op has waited this long (latency bound under light load).
    * ``max_batch`` — cap on queries dispatched per round (bounds tail
      latency added by giant batches under burst).
    * ``edf`` — order the round's queries earliest-deadline-first (ties:
      higher ``priority`` first, then FIFO). Off = pure FIFO.
    * ``shed_expired`` — drop queued ops whose deadline has already passed at
      dispatch time as ``Rejected("deadline_expired")`` instead of running
      work the client has given up on. A request that *finishes* late is
      still served, flagged ``deadline_missed=True``.
    """
    max_queue: int = 1024
    max_wait_ms: float = 2.0
    max_batch: int = 64
    edf: bool = True
    shed_expired: bool = True

    def __post_init__(self):
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")


_SHED_REASONS = ("queue_full", "deadline_expired", "shutdown", "not_mutable")


class ServerMetrics:
    """Cumulative serving observability. The async server records into this
    as outcomes resolve; :meth:`snapshot` renders the operator view
    (percentiles, counters, occupancy). Per-step deltas live in the server's
    ``step_stats`` (the async analog of the sync server's ``tick_stats``)."""

    def __init__(self):
        self.queue_wait = StreamingHistogram()
        self.e2e = StreamingHistogram()
        self.submitted = 0
        self.admitted = 0
        self.served = 0
        self.mutations = 0
        self.deadline_missed = 0
        self.degraded = 0
        self.shed: Dict[str, int] = {r: 0 for r in _SHED_REASONS}
        self.steps = 0

    def record_admitted(self) -> None:
        self.submitted += 1
        self.admitted += 1

    def record_shed(self, reason: str) -> None:
        if reason not in self.shed:
            self.shed[reason] = 0
        # queue_full sheds happen at offer() (already counted submitted);
        # later sheds (deadline/shutdown) were admitted earlier
        if reason == "queue_full":
            self.submitted += 1
        self.shed[reason] += 1

    def record_served(self, queue_ms: float, e2e_ms: float,
                      degraded: bool = False,
                      deadline_missed: bool = False,
                      mutation: bool = False) -> None:
        self.queue_wait.record(queue_ms)
        self.e2e.record(e2e_ms)
        if mutation:
            self.mutations += 1
        else:
            self.served += 1
        self.degraded += bool(degraded)
        self.deadline_missed += bool(deadline_missed)

    def snapshot(self, streams: Optional[List[Any]] = None) -> Dict[str, Any]:
        """Operator view; pass the server's live WavefrontStreams to include
        batch-occupancy and slot-refill efficiency."""
        out = {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "served": self.served,
            "mutations": self.mutations,
            "shed": dict(self.shed),
            "shed_total": sum(self.shed.values()),
            "deadline_missed": self.deadline_missed,
            "degraded": self.degraded,
            "steps": self.steps,
            "queue_wait_ms": {
                "p50": self.queue_wait.percentile(50),
                "p95": self.queue_wait.percentile(95),
                "p99": self.queue_wait.percentile(99),
                "mean": self.queue_wait.mean,
                "max": self.queue_wait.max_ms,
            },
            "e2e_ms": {
                "p50": self.e2e.percentile(50),
                "p95": self.e2e.percentile(95),
                "p99": self.e2e.percentile(99),
                "mean": self.e2e.mean,
                "max": self.e2e.max_ms,
            },
        }
        if streams:
            occ_rows = sum(s.occupancy_rows for s in streams)
            occ_cap = sum(s.occupancy_capacity for s in streams)
            exe = sum(s.executed_row_steps for s in streams)
            use = sum(s.useful_row_steps for s in streams)
            out["batch_occupancy"] = occ_rows / occ_cap if occ_cap else 1.0
            out["refill_efficiency"] = use / exe if exe else 1.0
            out["refills"] = sum(s.refills for s in streams)
            out["refilled_rows"] = sum(s.refilled_rows for s in streams)
            out["chunks"] = sum(s.chunks for s in streams)
        return out


@dataclasses.dataclass
class _Entry:
    ticket: int
    op: Any
    t_submit: float            # clock() at offer
    deadline_abs: Optional[float]  # clock()-based absolute deadline, or None


@dataclasses.dataclass
class Round:
    """One scheduling round: mutations strictly in submit order, then the
    queries queued before the next mutation barrier (EDF-ordered when the
    policy says so), plus entries shed at dispatch."""
    mutations: List[_Entry]
    queries: List[_Entry]
    shed: List[Tuple[_Entry, Rejected]]

    def __bool__(self) -> bool:
        return bool(self.mutations or self.queries or self.shed)


class Scheduler:
    """Bounded admission queue + micro-batch former. Host-only: it never
    touches the engine; the async server drives it and executes rounds.
    :meth:`next_round` decides a round on this scheduler's clock;
    :meth:`take` pops one decided elsewhere."""

    def __init__(self, policy: Optional[SLOPolicy] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.policy = policy or SLOPolicy()
        self.clock = clock
        self._queue: List[_Entry] = []
        self._next_ticket = 0
        self.closed = False

    # ---- admission ----
    def offer(self, op, now: Optional[float] = None):
        """Admit an op. Returns a ticket (int) or ``Rejected`` (queue full /
        scheduler closed). Never raises on overload."""
        now = self.clock() if now is None else now
        if self.closed:
            return Rejected("shutdown", op=_kind(op), queue_depth=self.depth)
        if len(self._queue) >= self.policy.max_queue:
            return Rejected("queue_full", op=_kind(op),
                            queue_depth=self.depth)
        deadline = None
        if op.deadline_ms is not None:
            deadline = now + op.deadline_ms / 1e3
        t = self._next_ticket
        self._next_ticket += 1
        self._queue.append(_Entry(t, op, now, deadline))
        return t

    @property
    def depth(self) -> int:
        return len(self._queue)

    def oldest_wait_ms(self, now: Optional[float] = None) -> float:
        if not self._queue:
            return 0.0
        now = self.clock() if now is None else now
        return (now - self._queue[0].t_submit) * 1e3

    def due(self, now: Optional[float] = None) -> bool:
        """Is a round worth dispatching? True when the oldest op has waited
        ``max_wait_ms``, the queue can fill a ``max_batch``, or a mutation is
        queued (mutations never wait on batch formation)."""
        if not self._queue:
            return False
        if len(self._queue) >= self.policy.max_batch:
            return True
        if any(not isinstance(e.op, QueryOp) for e in self._queue):
            return True
        return self.oldest_wait_ms(now) >= self.policy.max_wait_ms

    # ---- dispatch ----
    def next_round(self, now: Optional[float] = None,
                   capacity: Optional[int] = None) -> Round:
        """Pop one round: leading mutations (submit order), then up to
        ``min(max_batch, capacity)`` queries queued before the next mutation
        barrier. Expired entries shed here (policy.shed_expired)."""
        now = self.clock() if now is None else now
        pol = self.policy
        shed: List[Tuple[_Entry, Rejected]] = []
        if pol.shed_expired:
            live: List[_Entry] = []
            for e in self._queue:
                if e.deadline_abs is not None and now > e.deadline_abs:
                    shed.append((e, Rejected("deadline_expired",
                                             op=_kind(e.op),
                                             queue_depth=len(self._queue))))
                else:
                    live.append(e)
            self._queue = live
        mutations: List[_Entry] = []
        while self._queue and not isinstance(self._queue[0].op, QueryOp):
            mutations.append(self._queue.pop(0))
        n = 0
        while n < len(self._queue) and isinstance(self._queue[n].op, QueryOp):
            n += 1
        budget = pol.max_batch if capacity is None \
            else min(pol.max_batch, max(0, capacity))
        take = self._queue[:n]
        if pol.edf:
            take = sorted(take, key=_edf_key)
        take = take[:budget]
        taken = {e.ticket for e in take}
        self._queue = [e for e in self._queue if e.ticket not in taken]
        return Round(mutations, take, shed)

    def take(self, tickets) -> List[_Entry]:
        """Pop the entries of ``tickets``, in that order: a round another
        scheduler decided (on a mesh of ranks, rank 0's). A ticket not in
        the queue raises ``RuntimeError`` naming it, and nothing is
        popped."""
        by_ticket = {e.ticket: e for e in self._queue}
        tickets = [int(t) for t in tickets]
        for t in tickets:
            if t not in by_ticket:
                raise RuntimeError(f"ticket {t} is not in this scheduler's "
                                   f"queue")
        gone = set(tickets)
        self._queue = [e for e in self._queue if e.ticket not in gone]
        return [by_ticket[t] for t in tickets]

    def close(self) -> List[Tuple[_Entry, Rejected]]:
        """Stop admitting; shed everything still queued as
        ``Rejected("shutdown")``."""
        self.closed = True
        shed = [(e, Rejected("shutdown", op=_kind(e.op),
                             queue_depth=len(self._queue)))
                for e in self._queue]
        self._queue = []
        return shed


def _kind(op) -> str:
    if isinstance(op, QueryOp):
        return "query"
    if isinstance(op, UpsertOp):
        return "upsert"
    if isinstance(op, DeleteOp):
        return "delete"
    return type(op).__name__


def _edf_key(e: _Entry):
    d = e.deadline_abs if e.deadline_abs is not None else float("inf")
    return (d, -e.op.priority, e.ticket)
