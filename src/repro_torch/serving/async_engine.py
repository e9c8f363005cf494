"""Async continuous-batching retrieval server (the reference's
``repro.serving.async_engine``).

The sync :class:`~repro_torch.serving.engine.RetrievalServer` runs its whole
queue to completion every ``tick()``: deterministic, but a straggler query
holds the batch and arriving queries wait a full tick. This module serves the
same ops through a :class:`~repro_torch.serving.scheduler.Scheduler`
(bounded admission, EDF, typed shedding) and, on a
:class:`repro_torch.core.QueryEngine` backend, runs graph-routed queries on
:class:`repro_torch.core.WavefrontStream`: converged rows are harvested and
their slots refilled with newly admitted queries mid-flight, so the
wavefront batch stays occupied instead of draining to a straggler.

Correctness: every served hit is bit-identical to running that query alone
through ``engine.execute`` with the same (k, ef, route, fanout, max_steps):
the stream keeps per-row trajectories, per-row plan slots are admitted
independently, and slot results merge in plan order with the same
``merge_topk``. Two reference semantics are kept as they are:

* **quantized engines** (``storage_dtype`` "int8" / "float16"): the
  continuous path serves the beam's dequantized distances without the
  engine's exact float32 re-rank, so its answer is the approximate one
  (solo ``execute`` re-ranks). See :meth:`AsyncRetrievalServer._stream`.
* **flat and pruned micro-batches** run through ``engine.execute`` on the
  group, not through per-row stream slots; each row's answer is that of
  solo execution, ties included (the flat route keeps ``lax.top_k``'s
  lowest-row order).

Backends other than ``QueryEngine`` (:class:`repro_torch.streaming.SegmentedIndex`,
:class:`repro_torch.distributed.ShardedDeployment`) execute each round as a
micro-batch through their ``execute()``: they still get admission control,
deadlines, shedding and metrics; a sharded backend that loses a shard
degrades per response (``Served.degraded``) without stalling the scheduler.

On a mesh of ranks (a :class:`repro_torch.distributed.ShardedDeployment`
whose ``rank`` is not None), where ``execute`` is an SPMD call, the server
is one too: every rank makes the same ``submit*``, :meth:`step`,
:meth:`run_until_idle`, :meth:`collect` and :meth:`close` calls in the same
order. Rank 0 (coordinate 0 of the deployment's ``corpus_axis``) decides
every round on its own scheduler and clock as one process would, embeds
it, and broadcasts the decision (:class:`_Lockstep`); the other ranks take
exactly the named tickets from their queues (:meth:`Scheduler.take`) and
never call ``embed_fn``. Queue waits, finish times and deadline flags are
rank 0's, so every rank's outcomes, ``snapshot()`` and ``step_stats`` (but
``step_s``) are rank 0's; under ``tournament`` each rank's hit is its own
lane's, as ``execute`` returns it.

Mutation semantics match the sync server: a round applies its mutations in
submit order *before* its queries, and the scheduler never reorders a query
across a mutation barrier, so a query sees exactly the mutations submitted
before it. Queries already in flight on a stream keep their admission-time
snapshot.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from .. import obs
from ..core import QueryEngine, QueryHit, Rejected, SearchRequest, Served
from ..core import as_mask
from ..core.engine import _empty_result
from ..core.search import WavefrontStream, merge_topk
from ..distributed import collectives as coll
from ..distributed.deployment import ShardedDeployment

from .engine import _Embedder
from .ops import DeleteOp, QueryOp, UpsertOp
from .scheduler import (_SHED_REASONS, Round, Scheduler, ServerMetrics,
                        SLOPolicy, _kind)

__all__ = ["AsyncRetrievalServer"]


class _Pending:
    """One in-flight query on the continuous path: its outstanding stream
    rows and the per-slot results harvested so far."""
    __slots__ = ("entry", "remaining", "parts", "degraded", "queue_ms")

    def __init__(self, entry, remaining: int, queue_ms: float):
        self.entry = entry
        self.remaining = remaining
        self.parts: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self.degraded = False
        self.queue_ms = queue_ms


class AsyncRetrievalServer:
    """Continuous-batching front end over any ``execute()`` backend.

    ``submit*`` returns a ticket (int) or a typed
    :class:`repro_torch.core.Rejected` — overload and shutdown shed, they never
    raise. :meth:`step` advances the server by one scheduling round + one
    wavefront chunk and returns ``{ticket: Served | Rejected}`` for every op
    that resolved during the step. :meth:`run_until_idle` drains everything.

    SLO knobs live on :class:`repro_torch.serving.scheduler.SLOPolicy`;
    observability on :attr:`metrics` (cumulative) and :attr:`step_stats`
    (last step, the async analog of the sync server's ``tick_stats``).

    ``max_inflight`` caps rows across the wavefront streams (admission
    backpressure on the continuous path); ``chunk`` is the stream's
    steps-per-slice between refill points.

    ``bucket`` caps every wavefront stream at that many row slots (rounded
    up to a power of two) instead of the default cap derived from
    ``max_inflight``; sparse streams still shrink below it rather than
    padding every chunk to full width.

    ``clock`` (seconds) times queue waits, deadlines and latencies; tests
    inject a fake one. On a mesh of ranks rank 0's decides (see the module
    docstring).
    """

    def __init__(self, engine, embed_fn, k: int = 10, ef: int = 64,
                 policy: Optional[SLOPolicy] = None, route: Optional[str] = None,
                 max_steps: Optional[int] = None, auto_compact: bool = True,
                 max_inflight: int = 256, chunk: int = 16,
                 bucket: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.engine = engine
        self.k = int(k)
        self.ef = int(ef)
        self.route = route
        self.max_steps = max_steps
        self.auto_compact = auto_compact
        self.max_inflight = int(max_inflight)
        self.chunk = int(chunk)
        self.bucket = None if bucket is None else _pow2_at_least(int(bucket))
        self.clock = clock
        self.scheduler = Scheduler(policy, clock=clock)
        self.metrics = ServerMetrics()
        self.step_stats: Dict[str, Any] = {}
        self._embed = _Embedder(embed_fn)
        self._continuous = isinstance(engine, QueryEngine)
        self._streams: Dict[str, WavefrontStream] = {}
        self._pending: Dict[int, _Pending] = {}   # ticket -> in-flight query
        self._tags: Dict[int, Tuple[int, int]] = {}  # row tag -> (ticket, slot)
        self._next_tag = 0
        self._outcomes: Dict[int, Any] = {}       # resolved, not yet collected
        self._lockstep = (_Lockstep(engine.mesh, engine.spec.corpus_axis)
                          if isinstance(engine, ShardedDeployment)
                          and engine.rank is not None else None)

    @classmethod
    def from_index(cls, index, embed_fn, k: int = 10, ef: int = 64,
                   config=None, *, device=None, **kw):
        """A server over a new :class:`QueryEngine` on ``device`` (None:
        ``"cuda"``)."""
        return cls(QueryEngine(index, config=config, device=device),
                   embed_fn, k=k, ef=ef, **kw)

    # ---- submission ----
    @property
    def mutable(self) -> bool:
        return hasattr(self.engine, "add") and hasattr(self.engine, "delete")

    def submit(self, item, qlo: float, qhi: float, predicate,
               deadline_ms: Optional[float] = None, priority: int = 0):
        """Queue one query; returns a ticket or ``Rejected("queue_full")``."""
        op = QueryOp(item, float(qlo), float(qhi), as_mask(predicate),
                     deadline_ms=deadline_ms, priority=priority)
        return self._offer(op)

    def submit_upsert(self, ext_id: int, item, lo: float, hi: float,
                      deadline_ms: Optional[float] = None, priority: int = 0):
        if not self.mutable:
            r = Rejected("not_mutable", op="upsert",
                         queue_depth=self.scheduler.depth)
            self.metrics.record_shed(r.reason)
            return r
        return self._offer(UpsertOp(int(ext_id), item, float(lo), float(hi),
                                    deadline_ms=deadline_ms,
                                    priority=priority))

    def submit_delete(self, ext_id: int, deadline_ms: Optional[float] = None,
                      priority: int = 0):
        if not self.mutable:
            r = Rejected("not_mutable", op="delete",
                         queue_depth=self.scheduler.depth)
            self.metrics.record_shed(r.reason)
            return r
        return self._offer(DeleteOp(int(ext_id), deadline_ms=deadline_ms,
                                    priority=priority))

    def _offer(self, op):
        out = self.scheduler.offer(op)
        if isinstance(out, Rejected):
            self.metrics.record_shed(out.reason)
        else:
            self.metrics.record_admitted()
        return out

    # ---- serving loop ----
    @property
    def inflight(self) -> int:
        return len(self._pending)

    @property
    def idle(self) -> bool:
        return (self.scheduler.depth == 0 and not self._pending
                and all(s.idle for s in self._streams.values()))

    def step(self) -> Dict[str, Any]:
        """One scheduling round + one wavefront chunk. Returns every outcome
        that resolved during this step, keyed by ticket. The step records a
        ``round`` span only when it has a round to run or a stream to
        advance, so an empty poll leaves a trace as it found it."""
        t0 = self.clock()
        stats = {"dispatched": 0, "mutations": 0, "served": 0, "shed": 0,
                 "admitted_rows": 0, "harvested_rows": 0}
        resolved: Dict[int, Any] = {}
        rows_inflight = sum(s.inflight + s.n_pending
                            for s in self._streams.values())
        ready = self._round_ready(rows_inflight)
        busy = (ready or self._lockstep is not None
                or any(not s.idle for s in self._streams.values()))
        with (obs.span("round") if busy else obs.NULL_SPAN) as rsp:
            got = self._next_round(ready, rows_inflight)
            if got is not None:
                with obs.span("admission") as asp:
                    self._run_round(*got, resolved, stats)
                    asp.set("dispatched", stats["dispatched"])
                    asp.set("mutations", stats["mutations"])
                    asp.set("shed", stats["shed"])
            # advance every stream one chunk; harvest completions (each
            # stream.step() records its own "chunk" span: occupancy, refill,
            # harvested rows)
            for variant, stream in self._streams.items():
                if stream.idle:
                    continue
                for tag, ids, dists, steps in stream.step():
                    stats["harvested_rows"] += 1
                    self._absorb_row(tag, ids, dists, resolved, stats)
            if obs.tracing():
                rsp.set("served", stats["served"])
                rsp.set("harvested_rows", stats["harvested_rows"])
        self.metrics.steps += 1
        stats["queue_depth"] = self.scheduler.depth
        stats["inflight"] = self.inflight
        stats["step_s"] = self.clock() - t0
        self.step_stats = stats
        self._outcomes.update(resolved)
        return resolved

    def run_until_idle(self, max_steps: int = 100000) -> Dict[int, Any]:
        """Drain queue + streams; returns all outcomes resolved since the
        last collection (including ones from earlier ``step()`` calls)."""
        for _ in range(max_steps):
            if self.idle:
                break
            self.step()
        else:
            raise RuntimeError("run_until_idle: no convergence "
                               f"(queue={self.scheduler.depth}, "
                               f"inflight={self.inflight})")
        out = self._outcomes
        self._outcomes = {}
        return out

    def collect(self) -> Dict[int, Any]:
        """Pop every outcome resolved so far (non-blocking)."""
        out = self._outcomes
        self._outcomes = {}
        return out

    def close(self) -> Dict[int, Any]:
        """Stop admissions; shed the queue as ``Rejected("shutdown")``.
        In-flight work is NOT cancelled — keep stepping to drain it."""
        resolved = {}
        for e, rej in self.scheduler.close():
            self.metrics.record_shed(rej.reason)
            resolved[e.ticket] = rej
        self._outcomes.update(resolved)
        return resolved

    def snapshot(self) -> Dict[str, Any]:
        """Cumulative metrics view (includes stream occupancy/refill)."""
        return self.metrics.snapshot(list(self._streams.values()))

    # ---- round execution ----
    def _round_ready(self, rows_inflight: int) -> bool:
        """Is a round to run now: due by the scheduler's clock, or queued
        with nothing in flight?"""
        return self.scheduler.due() or (self.scheduler.depth > 0
                                        and rows_inflight == 0)

    def _next_round(self, ready: bool, rows_inflight: int):
        """This step's round, its start time and its vectors by ticket, or
        None: ``ready`` (:meth:`_round_ready`), or on a mesh of ranks rank
        0's decision, which every other rank receives."""
        lock = self._lockstep
        if lock is not None and not lock.leader:
            return lock.follow(self.scheduler)
        got = None
        if ready:
            capacity = (self.max_inflight - rows_inflight
                        if self._continuous else None)
            rnd = self.scheduler.next_round(capacity=capacity)
            now = self.clock()
            # one batched embed for the round: upsert items + queries
            need = _needs_vector(rnd)
            vec_of: Dict[int, np.ndarray] = {}
            if need:
                vecs = self._embed([e.op.item for e in need])
                vec_of = {e.ticket: vecs[i] for i, e in enumerate(need)}
            got = (rnd, now, vec_of)
        if lock is not None:
            lock.lead(got)
        return got

    def _now(self) -> float:
        """The clock's reading; on a mesh of ranks rank 0's."""
        if self._lockstep is None:
            return self.clock()
        return self._lockstep.now(self.clock)

    def _run_round(self, rnd: Round, now: float, vec_of: Dict[int, Any],
                   resolved: Dict[int, Any], stats: Dict[str, Any]) -> None:
        for e, rej in rnd.shed:
            self.metrics.record_shed(rej.reason)
            resolved[e.ticket] = rej
            stats["shed"] += 1
        if not (rnd.mutations or rnd.queries):
            return
        # mutations first, strictly in submit order (the scheduler already
        # guarantees no query in this round was submitted after them)
        mutated = 0
        for e in rnd.mutations:
            op = e.op
            if isinstance(op, UpsertOp):
                self.engine.add(np.array([op.ext_id], np.int64),
                                vec_of[e.ticket][None, :],
                                np.array([op.lo]), np.array([op.hi]))
            else:
                self.engine.delete(np.array([op.ext_id], np.int64),
                                   strict=False)
            mutated += 1
            done = self._now()
            self.metrics.record_served((now - e.t_submit) * 1e3,
                                       (done - e.t_submit) * 1e3,
                                       deadline_missed=_missed(e, done),
                                       mutation=True)
            resolved[e.ticket] = Served(
                hit=None, queue_ms=(now - e.t_submit) * 1e3,
                e2e_ms=(done - e.t_submit) * 1e3,
                deadline_missed=_missed(e, done))
        if (self.auto_compact and mutated
                and hasattr(self.engine, "compact")):
            self.engine.compact()
        stats["mutations"] += mutated
        if not rnd.queries:
            return
        stats["dispatched"] += len(rnd.queries)
        # group queries by (mask, resolved route)
        groups: Dict[Tuple[int, str], List[Any]] = {}
        for e in rnd.queries:
            if self._continuous:
                route = self.engine.route_for(
                    e.op.mask, np.array([e.op.qlo]), np.array([e.op.qhi]),
                    route=self.route, ef=self.ef)
            else:
                route = "backend"
            groups.setdefault((e.op.mask, route), []).append(e)
        for (mask, route), entries in groups.items():
            if self._continuous and route == "graph":
                self._admit_graph(mask, entries, vec_of, now, resolved, stats)
            else:
                self._run_microbatch(mask, route, entries, vec_of, now,
                                     resolved, stats)

    def _admit_graph(self, mask: int, entries, vec_of, now: float,
                     resolved: Dict[int, Any], stats: Dict[str, Any]) -> None:
        """Continuous path: per-row plan slots become wavefront stream rows;
        freed slots refill from later rounds mid-flight."""
        eng = self.engine
        qlo = np.array([e.op.qlo for e in entries])
        qhi = np.array([e.op.qhi for e in entries])
        slots = eng.plan(mask, qlo, qhi)
        F = eng._resolve_fanout(None)
        steps = self.max_steps or ((4 * self.ef + 64) // F + 8)
        live_slots = 0
        counts = np.zeros(len(entries), np.int64)
        admit: Dict[str, List[Tuple[int, int, int]]] = {}  # variant -> rows
        for si, s in enumerate(slots):
            nonempty = (np.asarray(s.version) >= 0) & \
                       (np.asarray(s.key_lo) <= np.asarray(s.key_hi))
            for qi in np.flatnonzero(nonempty):
                admit.setdefault(s.variant, []).append((int(qi), si, 0))
                counts[qi] += 1
        for qi, e in enumerate(entries):
            wait_ms = (now - e.t_submit) * 1e3
            self._pending[e.ticket] = _Pending(e, int(counts[qi]), wait_ms)
            self.metrics.queue_wait.record(wait_ms)
        for variant, rows in admit.items():
            stream = self._stream(variant, F)
            s_by_idx = {si: slots[si] for si in {r[1] for r in rows}}
            tags, qv, ver, klo, khi = [], [], [], [], []
            for qi, si, _ in rows:
                tag = self._next_tag
                self._next_tag += 1
                self._tags[tag] = (entries[qi].ticket, si)
                s = s_by_idx[si]
                tags.append(tag)
                qv.append(vec_of[entries[qi].ticket])
                ver.append(int(np.asarray(s.version)[qi]))
                klo.append(int(np.asarray(s.key_lo)[qi]))
                khi.append(int(np.asarray(s.key_hi)[qi]))
            stream.admit(np.array(tags), np.stack(qv), np.array(ver),
                         np.array(klo), np.array(khi), steps)
            live_slots += len(rows)
        stats["admitted_rows"] += live_slots
        # queries whose whole plan is empty complete immediately (solo
        # execute returns the all-NO_EDGE empty result for them)
        for qi, e in enumerate(entries):
            if counts[qi] == 0:
                resolved[e.ticket] = self._finish_query(e.ticket, stats)

    def _run_microbatch(self, mask: int, route: str, entries, vec_of,
                        now: float, resolved: Dict[int, Any],
                        stats: Dict[str, Any]) -> None:
        """Fallback path: one engine.execute per (mask, route) group. Used
        for pruned/flat routes and for non-QueryEngine backends (segmented /
        sharded); still scheduled, shed, and measured."""
        qlo = np.array([e.op.qlo for e in entries])
        qhi = np.array([e.op.qhi for e in entries])
        qvecs = np.stack([vec_of[e.ticket] for e in entries])
        req = SearchRequest(qvecs, (qlo, qhi), mask, k=self.k, ef=self.ef,
                            route=None if route == "backend" else route,
                            max_steps=self.max_steps)
        res = self.engine.execute(req)
        degraded = bool(getattr(res, "degraded", False))
        done = self._now()
        for j, e in enumerate(entries):
            self.metrics.record_served(
                (now - e.t_submit) * 1e3, (done - e.t_submit) * 1e3,
                degraded=degraded, deadline_missed=_missed(e, done))
            resolved[e.ticket] = Served(
                hit=QueryHit(res.ids[j], res.dists[j]),
                queue_ms=(now - e.t_submit) * 1e3,
                e2e_ms=(done - e.t_submit) * 1e3,
                degraded=degraded, deadline_missed=_missed(e, done))
            stats["served"] += 1

    # ---- continuous-path plumbing ----
    def _stream(self, variant: str, fanout: int) -> WavefrontStream:
        """The variant's stream, created on first use.

        Quantized engines (kept from the reference): the continuous path
        harvests beam rows straight from the wavefront and merges them in
        ``_finish_query`` without the engine's exact float32 re-rank, so
        with ``storage_dtype`` "int8" / "float16" the served top-k
        distances are the approximate dequantized ones. Solo
        ``QueryEngine.execute`` re-ranks; route quantized traffic there
        when exact distances matter."""
        if variant not in self._streams:
            eng = self.engine
            min_b, max_b = ((min(8, self.bucket), self.bucket) if self.bucket
                            else (8, _pow2_at_least(self.max_inflight)))
            self._streams[variant] = WavefrontStream(
                eng.graph_dev(variant), ef=self.ef,
                Kpad=eng.index.variants[variant].Kpad, fanout=fanout,
                chunk=self.chunk, min_bucket=min_b, max_bucket=max_b,
                packed=eng.packed_visited)
        return self._streams[variant]

    def _absorb_row(self, tag: int, ids: np.ndarray, dists: np.ndarray,
                    resolved: Dict[int, Any], stats: Dict[str, Any]) -> None:
        ticket, slot_idx = self._tags.pop(tag)
        pend = self._pending[ticket]
        k = min(self.k, self.ef)
        pend.parts.append((slot_idx, ids[:k], dists[:k]))
        pend.remaining -= 1
        if pend.remaining == 0:
            out = self._finish_query(ticket, stats)
            resolved[ticket] = out

    def _finish_query(self, ticket: int, stats: Dict[str, Any]):
        """Merge a completed query's slot results in plan order (identical
        merge chain to solo execute) and emit its Served outcome."""
        pend = self._pending.pop(ticket)
        k = min(self.k, self.ef)
        if pend.parts:
            # the merge only compares and moves entries, so running it on
            # host tensors gives the device merge's result
            parts = sorted(pend.parts, key=lambda p: p[0])
            ids = torch.as_tensor(parts[0][1][None, :])
            d = torch.as_tensor(parts[0][2][None, :])
            for _, pi, pd in parts[1:]:
                ids, d = merge_topk(ids, d, torch.as_tensor(pi[None, :]),
                                    torch.as_tensor(pd[None, :]), k)
            ids = ids[0].numpy()
            d = d[0].numpy()
        else:
            e_ids, e_d = _empty_result(1, k)
            ids, d = e_ids[0], e_d[0]
        e = pend.entry
        done = self.clock()
        # queue wait was recorded into the histogram at dispatch time
        out = Served(hit=QueryHit(ids, d), queue_ms=pend.queue_ms,
                     e2e_ms=(done - e.t_submit) * 1e3,
                     degraded=pend.degraded,
                     deadline_missed=_missed(e, done))
        self.metrics.e2e.record(out.e2e_ms)
        self.metrics.served += 1
        self.metrics.degraded += bool(out.degraded)
        self.metrics.deadline_missed += bool(out.deadline_missed)
        stats["served"] += 1
        self._outcomes[ticket] = out
        return out


# a round's entries as the broadcast codes them: the role, the op's kind
_ROLES = ("shed", "mutation", "query")
_KINDS = ("query", "upsert", "delete")


def _needs_vector(rnd: Round) -> List[Any]:
    """The entries of ``rnd`` that need an embedding, in the order of the
    round's one embed call: upserts, then queries."""
    return [e for e in rnd.mutations if isinstance(e.op, UpsertOp)] + \
        list(rnd.queries)


def _bits(x: float) -> int:
    return int(np.float64(x).view(np.int64))


def _unbits(b) -> float:
    return float(np.int64(b).view(np.float64))


class _Lockstep:
    """The async server's agreement on a mesh of ranks: rank 0 (index 0 on
    ``axis``) decides, the others follow. Every message is a
    :func:`repro_torch.distributed.collectives.broadcast` from rank 0 on
    the mesh's device.

    Each step sends a fixed-width int64 header, (run, entries, vectors,
    d, the round's start time as float64 bits); a step that dispatches
    nothing sends it with run 0. A round then sends its entries, one int64
    row each in the order shed, mutations, queries: (ticket, role in
    :data:`_ROLES`, kind in :data:`_KINDS`, reason code in the scheduler's
    shed reasons or -1, the queue depth its ``Rejected`` saw, rank 0's
    submit time and absolute deadline as float64 bits, NaN for none); then
    the round's float32 (vectors, d) embeddings, upserts first, as rank 0
    embedded them; and, once for each mutation applied and each
    micro-batch executed, rank 0's clock reading after it (:meth:`now`).
    A follower sets its entries' submit times and deadlines to rank 0's,
    so queue waits, latencies and deadline flags are rank 0's floats."""

    _HEADER = 5

    def __init__(self, mesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.leader = coll.axis_index(mesh, axis) == 0

    def _send(self, x: np.ndarray) -> np.ndarray:
        """Rank 0's ``x`` (every other rank passes a buffer of its shape
        and dtype)."""
        t = torch.from_numpy(np.ascontiguousarray(x)).to(self.mesh.device)
        return coll.broadcast(t, self.mesh, self.axis).cpu().numpy()

    def lead(self, got) -> None:
        """Rank 0: send this step's decision, ``(round, start time,
        vectors by ticket)`` or None."""
        if got is None:
            self._send(np.zeros(self._HEADER, np.int64))
            return
        rnd, now, vec_of = got
        rows = ([(e, "shed", rej) for e, rej in rnd.shed]
                + [(e, "mutation", None) for e in rnd.mutations]
                + [(e, "query", None) for e in rnd.queries])
        need = _needs_vector(rnd)
        d = len(vec_of[need[0].ticket]) if need else 0
        self._send(np.array([1, len(rows), len(need), d, _bits(now)],
                            np.int64))
        if rows:
            self._send(np.array(
                [(e.ticket, _ROLES.index(role), _KINDS.index(_kind(e.op)),
                  -1 if rej is None else _SHED_REASONS.index(rej.reason),
                  0 if rej is None else rej.queue_depth, _bits(e.t_submit),
                  _bits(float("nan") if e.deadline_abs is None
                        else e.deadline_abs))
                 for e, role, rej in rows], np.int64))
        if need:
            self._send(np.stack([vec_of[e.ticket] for e in need]))

    def follow(self, scheduler: Scheduler):
        """A follower: rank 0's decision for this step, its entries taken
        from ``scheduler``'s queue; ``RuntimeError`` where one is missing
        or is of another kind than rank 0's."""
        run, n, n_vec, d, now = self._send(np.zeros(self._HEADER, np.int64))
        if not run:
            return None
        rows = (self._send(np.zeros((n, 7), np.int64)) if n
                else np.zeros((0, 7), np.int64))
        rnd = Round([], [], [])
        for e, (ticket, role, kind, reason, depth, t_submit, deadline) in \
                zip(scheduler.take(rows[:, 0]), rows):
            if _kind(e.op) != _KINDS[kind]:
                raise RuntimeError(f"ticket {ticket} is a {_kind(e.op)} "
                                   f"here and a {_KINDS[kind]} on rank 0")
            e.t_submit = _unbits(t_submit)
            e.deadline_abs = _unbits(deadline)
            if np.isnan(e.deadline_abs):
                e.deadline_abs = None
            if _ROLES[role] == "shed":
                rnd.shed.append((e, Rejected(_SHED_REASONS[reason],
                                             op=_KINDS[kind],
                                             queue_depth=int(depth))))
            elif _ROLES[role] == "mutation":
                rnd.mutations.append(e)
            else:
                rnd.queries.append(e)
        need = _needs_vector(rnd)
        vec_of = {}
        if n_vec:
            vecs = self._send(np.zeros((n_vec, d), np.float32))
            vec_of = {e.ticket: vecs[i] for i, e in enumerate(need)}
        return rnd, _unbits(now), vec_of

    def now(self, clock) -> float:
        """Rank 0's ``clock()``, read there alone, on every rank."""
        t = clock() if self.leader else 0.0
        return float(self._send(np.array([t], np.float64))[0])


def _missed(entry, now: float) -> bool:
    return entry.deadline_abs is not None and now > entry.deadline_abs


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p
