"""Typed request/result surface for RRANN search (the declarative API layer).

``SearchRequest`` bundles everything one filtered top-k batch needs — query
vectors, query ranges, a :class:`repro_torch.core.predicates.Predicate` — and
normalizes shapes/dtypes once at the boundary so engines never re-validate.
``SearchResult`` replaces the bare ``(ids, dists)`` tuple: it knows which
slots are real hits (``valid_mask``), iterates per query as
:class:`QueryHit` records, computes recall against a reference, and carries a
:class:`RouteReport` describing what the engine actually did (chosen route,
estimated selectivity, plan slots, selectivity-cache traffic).

``IndexSpec`` is the build-time counterpart: a frozen config a process can
hand to :meth:`repro_torch.core.mstg.MSTGIndex.build` and that travels inside the
saved ``.npz`` so a loaded index knows how it was made.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple, Optional, Tuple, Union

import numpy as np

from .predicates import Predicate, as_predicate


class QueryHit(NamedTuple):
    """One query's top-k: ids padded with ``NO_EDGE`` (< 0), dists with +inf.

    A NamedTuple, so it unpacks as the legacy ``(ids, dists)`` pair; use
    ``n_valid`` for the real-hit count (``len()`` keeps tuple semantics)."""

    ids: np.ndarray
    dists: np.ndarray

    @property
    def valid(self) -> np.ndarray:
        return self.ids >= 0

    @property
    def n_valid(self) -> int:
        return int((self.ids >= 0).sum())


@dataclasses.dataclass(frozen=True)
class Rejected:
    """A typed shed outcome: the serving layer declined an operation instead
    of raising (admission control is flow control, not an error).

    reason : why the op was shed — ``"queue_full"`` (bounded admission queue
             at capacity), ``"deadline_expired"`` (the request's
             ``deadline_ms`` passed before dispatch), ``"shutdown"`` (the
             server is draining), or ``"not_mutable"`` (a mutation submitted
             against a frozen index).
    op     : operation kind (``"query"`` | ``"upsert"`` | ``"delete"``).
    queue_depth : admission-queue depth observed at the shed decision.
    """

    reason: str
    op: str = "query"
    queue_depth: int = 0

    def __bool__(self) -> bool:          # `if outcome:` reads as "served?"
        return False


@dataclasses.dataclass(frozen=True)
class Served:
    """A completed serving outcome: the answer plus its latency breakdown.

    hit       : the :class:`QueryHit` (None for completed mutations).
    queue_ms  : submission -> dispatch wait (admission-queue time).
    e2e_ms    : submission -> completion, end to end.
    degraded  : sharded execution lost one or more shards for this answer
                (see :attr:`SearchResult.degraded`).
    deadline_missed : the request carried a ``deadline_ms`` and completed
                past it (served anyway — the scheduler only *sheds* requests
                whose deadline expires before dispatch).
    """

    hit: Optional[QueryHit]
    queue_ms: float = 0.0
    e2e_ms: float = 0.0
    degraded: bool = False
    deadline_missed: bool = False

    def __bool__(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True, eq=False)
class SearchRequest:
    """A filtered top-k batch: vectors + query ranges + a predicate.

    ``ranges`` accepts either a ``(Q, 2)`` array (or nested list) of
    ``[qlo, qhi]`` rows, or a 2-**tuple** ``(qlo, qhi)`` of ``(Q,)`` arrays —
    the pair form must be a tuple so a two-row list of ranges is never
    misread as a pair. ``predicate`` accepts a :class:`Predicate`, a raw int
    mask, or a parseable string. Everything is normalized (float32 vectors,
    float64 ranges) at construction.

    ``fanout`` (frontier vertices expanded per wavefront step) and ``chunk``
    (steps per compaction slice of the chunked graph driver) default to
    ``None`` — *the engine picks*; pass an explicit int to pin either.
    ``chunk=0`` pins the single-``lax.while_loop`` driver (``fanout=1,
    chunk=0`` reproduces the seed's one-expansion single-loop behavior bit
    for bit).

    ``deadline_ms`` and ``priority`` are serving-level SLO metadata: the
    engine itself never reads them (an expired request still executes if
    handed to :meth:`repro_torch.core.QueryEngine.execute` directly), but the
    async serving scheduler (:mod:`repro.serving.scheduler`) uses them for
    earliest-deadline-first micro-batch ordering and shed-on-overload
    decisions. ``deadline_ms`` is relative to submission; ``priority``
    breaks ties (higher first).

    ``trace=True`` records a :class:`repro_torch.obs.Trace` of this one request —
    plan, route decision, per-slot/per-shard execution, merge — returned on
    :attr:`SearchResult.trace` (``result.explain()`` renders it;
    ``result.trace.save(path)`` writes Chrome-trace JSON). The default is
    the no-op fast path; see also ``EngineConfig.trace_sample`` for
    engine-level sampling.
    """

    vectors: np.ndarray
    ranges: np.ndarray
    predicate: Predicate
    k: int = 10
    ef: int = 64
    route: Optional[str] = None
    max_steps: Optional[int] = None
    fanout: Optional[int] = None
    chunk: Optional[int] = None
    deadline_ms: Optional[float] = None
    priority: int = 0
    trace: bool = False

    def __post_init__(self):
        vecs = np.ascontiguousarray(self.vectors, dtype=np.float32)
        if vecs.ndim != 2:
            raise ValueError(f"vectors must be (Q, d), got shape {vecs.shape}")
        rng = self.ranges
        if isinstance(rng, tuple) and len(rng) == 2:
            rng = np.stack([np.asarray(rng[0], np.float64).ravel(),
                            np.asarray(rng[1], np.float64).ravel()], axis=1)
        else:
            rng = np.asarray(rng, dtype=np.float64)
        if rng.ndim != 2 or rng.shape[1] != 2:
            raise ValueError(f"ranges must be (Q, 2), got shape {rng.shape}")
        if rng.shape[0] != vecs.shape[0]:
            raise ValueError(f"{vecs.shape[0]} vectors but {rng.shape[0]} ranges")
        if np.any(rng[:, 0] > rng[:, 1]):
            raise ValueError("query ranges must satisfy qlo <= qhi")
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if self.ef < 1:
            raise ValueError("ef must be >= 1")
        if self.fanout is not None and self.fanout < 1:
            raise ValueError("fanout must be >= 1 (or None: engine decides)")
        if self.chunk is not None and self.chunk < 0:
            raise ValueError("chunk must be >= 1, 0 (pin the single-loop "
                             "driver), or None (engine decides)")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0 (or None: no deadline)")
        object.__setattr__(self, "vectors", vecs)
        object.__setattr__(self, "ranges", rng)
        object.__setattr__(self, "predicate", as_predicate(self.predicate))

    def __len__(self) -> int:
        return self.vectors.shape[0]

    @property
    def qlo(self) -> np.ndarray:
        return self.ranges[:, 0]

    @property
    def qhi(self) -> np.ndarray:
        return self.ranges[:, 1]

    @property
    def mask(self) -> int:
        return self.predicate.mask


@dataclasses.dataclass(frozen=True)
class SegmentReport:
    """How one live segment (or the mutable delta) served its share of a
    fanned-out :class:`repro.streaming.SegmentedIndex` request.

    segment    : segment id (``"seg-000003"``) or ``"delta"``
    n          : rows the segment holds (including tombstoned rows)
    route      : route that segment executed ("graph"|"pruned"|"flat"|"delta")
    k_fetched  : per-segment top-k width (k + live tombstones, clamped to n,
                 so tombstone filtering can never push a true neighbor out)
    tombstones : tombstoned rows in this segment at execution time
    slot_count : Theorem 4.1 plan slots that segment executed
    """

    segment: str
    n: int
    route: str
    k_fetched: int
    tombstones: int = 0
    slot_count: int = 0


@dataclasses.dataclass(frozen=True)
class ShardReport:
    """How one shard of a :class:`repro.distributed.ShardedDeployment` served
    its share of a fanned-out request — the sharded-execution counterpart of
    :class:`SegmentReport`, so :class:`RouteReport` stays uniform across
    local, streaming, and sharded execution.

    shard      : shard index on the deployment's corpus axis
    n          : corpus rows assigned to this shard
    route      : route the shard's local engine executed ("graph" | "pruned"
                 | "flat" | "segmented"), or why it contributed nothing
                 ("lost" = marked down before the request, "error" = its
                 local search raised and was converted to a miss)
    alive      : False when the shard contributed no results (lost/error);
                 such shards also appear in ``RouteReport.missing_shards``
    k_fetched  : per-shard top-k width fanned in to the merge (the
                 deployment's ``per_shard_k``, clamped to the request's k)
    latency_s  : wall-clock seconds of the shard's local search (0.0 when the
                 whole fan-out ran as one fused ``shard_map`` call — the
                 device path has no per-shard host timing)
    slot_count : Theorem 4.1 plan slots the shard's local engine executed
    """

    shard: int
    n: int
    route: str
    alive: bool = True
    k_fetched: int = 0
    latency_s: float = 0.0
    slot_count: int = 0


@dataclasses.dataclass(frozen=True, eq=False)
class RouteReport:
    """What the engine did with one request (diagnostics, not results).

    route            : executed route ("graph" | "pruned" | "flat"); an
                       empty (Q=0) request executes nothing and mirrors the
                       requested value here (possibly "auto"); a streaming
                       :class:`repro.streaming.SegmentedIndex` fan-out reports
                       "segmented" here and per-segment routes in ``segments``;
                       a :class:`repro.distributed.ShardedDeployment` fan-out
                       reports "sharded" here and per-shard routes in
                       ``shards``
    requested        : what the caller asked for (may be "auto")
    est_selectivity  : (Q,) estimated predicate selectivity, when the auto
                       router evaluated it (None for pinned routes)
    slot_count       : number of Theorem 4.1 plan slots executed
    variants         : MSTG variant of each slot, in execution order
    cache_hits/misses: selectivity-cache traffic caused by this request
    segments         : per-segment :class:`SegmentReport` records when the
                       request fanned out over a segmented index (else empty)
    shards           : per-shard :class:`ShardReport` records when the request
                       fanned out over a sharded deployment (else empty)
    missing_shards   : shard indices that contributed nothing (lost or
                       errored); non-empty means the answer is ``degraded``
                       (complete over the surviving shards, possibly missing
                       true neighbors that lived on the lost ones)
    merge            : distributed top-k merge schedule that combined shard
                       results ("all_gather" | "tournament" | "host"; None
                       for non-sharded execution)
    """

    route: str
    requested: str
    est_selectivity: Optional[np.ndarray]
    slot_count: int
    variants: Tuple[str, ...]
    cache_hits: int = 0
    cache_misses: int = 0
    segments: Tuple[SegmentReport, ...] = ()
    shards: Tuple[ShardReport, ...] = ()
    missing_shards: Tuple[int, ...] = ()
    merge: Optional[str] = None

    @property
    def degraded(self) -> bool:
        """True when one or more shards contributed nothing — the results are
        complete over the surviving shards only (degraded recall, not an
        error)."""
        return len(self.missing_shards) > 0

    @property
    def mean_selectivity(self) -> Optional[float]:
        if self.est_selectivity is None or self.est_selectivity.size == 0:
            return None
        return float(np.mean(self.est_selectivity))


@dataclasses.dataclass(frozen=True, eq=False)
class SearchResult:
    """Filtered top-k results: ``(Q, k)`` ids (< 0 = empty slot) and squared
    distances (+inf = empty slot), plus the engine's :class:`RouteReport`.
    ``trace`` carries the request's :class:`repro_torch.obs.Trace` when it ran
    with ``SearchRequest(trace=True)`` (or was sampled by the engine) —
    render with :meth:`explain`, export with ``result.trace.save(path)``."""

    ids: np.ndarray
    dists: np.ndarray
    report: Optional[RouteReport] = None
    trace: Optional[object] = None

    def __post_init__(self):
        ids = np.asarray(self.ids)
        dists = np.asarray(self.dists)
        if ids.shape != dists.shape or ids.ndim != 2:
            raise ValueError(f"ids {ids.shape} and dists {dists.shape} must be "
                             "equal (Q, k) shapes")
        object.__setattr__(self, "ids", ids)
        object.__setattr__(self, "dists", dists)

    # ---- shape / iteration ----
    def __len__(self) -> int:
        return self.ids.shape[0]

    @property
    def k(self) -> int:
        return self.ids.shape[1]

    def __iter__(self) -> Iterator[QueryHit]:
        for qi in range(self.ids.shape[0]):
            yield QueryHit(self.ids[qi], self.dists[qi])

    def __getitem__(self, qi) -> Union[QueryHit, "SearchResult"]:
        if isinstance(qi, (int, np.integer)):
            return QueryHit(self.ids[qi], self.dists[qi])
        return SearchResult(self.ids[qi], self.dists[qi], self.report)

    # ---- invariants / interop ----
    @property
    def valid_mask(self) -> np.ndarray:
        """(Q, k) bool: which result slots hold a real neighbor."""
        return self.ids >= 0

    @property
    def degraded(self) -> bool:
        """True when sharded execution lost one or more shards — the answer
        is complete over the surviving shards only (see
        ``report.missing_shards``). Always False for non-sharded execution."""
        return self.report is not None and self.report.degraded

    def astuple(self) -> Tuple[np.ndarray, np.ndarray]:
        """The legacy ``(ids, dists)`` pair (for tuple-era call sites)."""
        return self.ids, self.dists

    def explain(self) -> str:
        """One-query execution report: the :class:`RouteReport` breakdown
        (route decision, selectivity estimate, plan slots, per-shard /
        per-segment rows, merge schedule, degraded status) followed by the
        span tree when the request ran with ``trace=True``. Returns the
        rendered text (also handy under ``print``)."""
        lines = [f"SearchResult: {self.ids.shape[0]} queries x k={self.k}"]
        r = self.report
        if r is None:
            lines.append("  (no route report attached)")
        else:
            routed = r.route if r.route == r.requested \
                else f"{r.route} (requested {r.requested})"
            lines.append(f"  route: {routed}")
            sel = r.mean_selectivity
            if sel is not None:
                lines.append(f"  est_selectivity: mean={sel:.4f}")
            if r.slot_count or r.variants:
                lines.append(f"  plan: {r.slot_count} slots over "
                             f"variants={list(r.variants)}")
            if r.cache_hits or r.cache_misses:
                lines.append(f"  selectivity cache: {r.cache_hits} hits / "
                             f"{r.cache_misses} misses")
            for s in r.shards:
                status = "" if s.alive else "  [DEGRADED]"
                lines.append(
                    f"  shard[{s.shard}]: route={s.route} n={s.n} "
                    f"k_fetched={s.k_fetched} "
                    f"latency={s.latency_s * 1e3:.2f}ms{status}")
            if r.missing_shards:
                lines.append("  missing shards: "
                             f"{list(r.missing_shards)} (degraded)")
            for g in r.segments:
                lines.append(f"  segment[{g.segment}]: route={g.route} "
                             f"n={g.n} k_fetched={g.k_fetched} "
                             f"tombstones={g.tombstones}")
            if r.merge:
                lines.append(f"  merge: {r.merge}")
        if self.trace is not None:
            lines.append("  trace:")
            lines.extend("    " + ln
                         for ln in self.trace.render().splitlines())
        else:
            lines.append("  trace: (none — pass SearchRequest(trace=True))")
        return "\n".join(lines)

    def recall_vs(self, reference) -> float:
        """Recall@k against ``reference`` — a :class:`SearchResult` or a
        ``(Q, k')`` id array (e.g. brute-force ground truth): |found ∩ true|
        / |true| over queries with non-empty truth (the
        :func:`repro_torch.data.recall_at_k` metric, to which this delegates)."""
        # deferred: repro_torch.data imports repro_torch.core at module import time
        from repro_torch.data.datasets import recall_at_k
        true_ids = reference.ids if isinstance(reference, SearchResult) \
            else np.asarray(reference)
        if true_ids.shape[0] != self.ids.shape[0]:
            raise ValueError("reference has a different number of queries")
        return recall_at_k(self.ids, true_ids)


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Build configuration for :class:`repro_torch.core.mstg.MSTGIndex`.

    ``predicate`` decides which MSTG variants get built when ``variants`` is
    None (via ``Predicate.variants_required``); the graph hyper-parameters
    mirror the paper's (M, efConstruction, entry count). ``builder`` picks
    the construction path — ``"bulk"`` (batched, the default) or
    ``"incremental"`` (the paper-exact reference oracle) — and
    ``batch_size`` tunes the bulk path's batch width (None = its default).
    ``storage_dtype`` selects the vector storage tier ("float32" exact,
    "float16"/"int8" scalar-quantized codes + exact re-rank at query time
    — :mod:`repro_torch.core.quant`); because it lives on the spec it travels
    through persistence *and* through streaming flush/compact, so
    segments quantize in the background automatically.

    ``candidate_stage`` picks the bulk builder's candidate generator:
    ``"exact"`` (all-pairs matmul per batch, O(n^2) total) or ``"coarse"``
    (IVF-style k-means quantizer — candidates from the ``n_probe`` nearest
    of ``n_clusters`` centroids' buckets, sub-quadratic; see
    :mod:`repro_torch.core.build`). ``n_clusters=None`` sizes the quantizer
    automatically (~``16*sqrt(n)``); ``coarse_threshold`` is the inserted-
    prefix size below which batches keep the exact path bit-identically
    (None = the builder default, 4096). Like ``storage_dtype``, these ride
    the spec through persistence and streaming flush/compact.
    The spec is stored on the index and persisted by ``save()``; artifacts
    written before the ``builder`` / ``storage_dtype`` /
    ``candidate_stage`` fields existed load as ``"bulk"`` / ``"float32"``
    / ``"exact"``.
    """

    predicate: Predicate = None
    variants: Optional[Tuple[str, ...]] = None
    m: int = 16
    ef_con: int = 100
    m_max: Optional[int] = None
    n_entries: int = 4
    builder: str = "bulk"
    batch_size: Optional[int] = None
    storage_dtype: str = "float32"
    candidate_stage: str = "exact"
    n_clusters: Optional[int] = None
    n_probe: int = 8
    coarse_threshold: Optional[int] = None

    def __post_init__(self):
        from . import intervals as iv
        pred = self.predicate if self.predicate is not None else iv.ANY_OVERLAP
        object.__setattr__(self, "predicate", as_predicate(pred))
        if self.variants is not None:
            object.__setattr__(self, "variants", tuple(self.variants))
        from .build import BUILDERS, CANDIDATE_STAGES  # deferred: import-light
        if self.builder not in BUILDERS:
            raise ValueError(f"unknown builder {self.builder!r}; expected "
                             f"one of {BUILDERS}")
        if self.batch_size is not None and self.batch_size < 1:
            raise ValueError("batch_size must be >= 1 (or None for the "
                             "builder default)")
        if self.candidate_stage not in CANDIDATE_STAGES:
            raise ValueError(f"unknown candidate_stage "
                             f"{self.candidate_stage!r}; expected one of "
                             f"{CANDIDATE_STAGES}")
        if self.n_clusters is not None and self.n_clusters < 1:
            raise ValueError("n_clusters must be >= 1 (or None for the "
                             "automatic size)")
        if self.n_probe < 1:
            raise ValueError("n_probe must be >= 1")
        if self.coarse_threshold is not None and self.coarse_threshold < 1:
            raise ValueError("coarse_threshold must be >= 1 (or None for "
                             "the builder default)")
        from .quant import check_storage_dtype  # deferred, like BUILDERS
        object.__setattr__(self, "storage_dtype",
                           check_storage_dtype(self.storage_dtype))

    def to_dict(self) -> dict:
        return {"predicate": self.predicate.mask,
                "variants": list(self.variants) if self.variants else None,
                "m": self.m, "ef_con": self.ef_con, "m_max": self.m_max,
                "n_entries": self.n_entries, "builder": self.builder,
                "batch_size": self.batch_size,
                "storage_dtype": self.storage_dtype,
                "candidate_stage": self.candidate_stage,
                "n_clusters": self.n_clusters, "n_probe": self.n_probe,
                "coarse_threshold": self.coarse_threshold}

    @classmethod
    def from_dict(cls, d: dict) -> "IndexSpec":
        variants = d.get("variants")
        return cls(predicate=Predicate(d["predicate"]),
                   variants=tuple(variants) if variants else None,
                   m=d["m"], ef_con=d["ef_con"], m_max=d["m_max"],
                   n_entries=d["n_entries"],
                   builder=d.get("builder", "bulk"),
                   batch_size=d.get("batch_size"),
                   storage_dtype=d.get("storage_dtype", "float32"),
                   candidate_stage=d.get("candidate_stage", "exact"),
                   n_clusters=d.get("n_clusters"),
                   n_probe=d.get("n_probe", 8),
                   coarse_threshold=d.get("coarse_threshold"))
