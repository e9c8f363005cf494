"""QueryEngine — the execution facade over a built MSTG index.

The counterpart of the JAX reference's ``repro.core.engine``::

    engine = QueryEngine(index)                 # stages on "cuda"
    result = engine.execute(SearchRequest(vectors, (qlo, qhi),
                                          Overlaps() | Before(), k=10))
    result.ids, result.dists, result.report

One object owns everything a request needs:

* **device staging** — the float32 corpus, the graph arrays of each variant
  and the pruned-scan member arrays are staged on the engine's device once,
  on first use, and shared by every route;
* **plan execution** — a batch is planned with the vectorized Theorem 4.1
  planner (:func:`repro_torch.core.intervals.plan_batch_ranked`), every task
  slot runs on its variant, and slot results are merged with
  :func:`repro_torch.core.search.merge_topk`;
* **routing** — ``route="auto"`` estimates predicate selectivity before any
  device work from an exact rank-prefix table over a corpus sample
  (:class:`repro_torch.core.intervals.SelectivityIndex`, memoized per
  rank signature) and sends batches whose scan work is below the beam's to
  the exact pruned scan, everything else to the wavefront beam search;
* **wavefront execution** — the graph route resolves ``fanout``, skips plan
  slots whose tasks are all empty, and chunks wide batches through
  :func:`repro_torch.core.search.mstg_graph_search_chunked`;
* **padding** — query batches are padded to power-of-two sizes; padded
  queries carry empty tasks and cost no search steps;
* **storage tier** — with ``storage_dtype="int8"`` or ``"float16"`` every
  route scans or walks the code table (staged once, shared by the routes),
  carries the top ``rerank_k`` approximate candidates through the slot
  merge and re-ranks them exactly against the float32 rows, which stay on
  the host: the float32 corpus is never staged on the device.

Precedence of knobs, as in the reference: request wins over config wins
over the device default. Every entry point runs on an explicit device:
``device=None`` means ``"cuda"`` and raises when no card is present; it
never falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..kernels import ops
from . import intervals as iv
from .api import RouteReport, SearchRequest, SearchResult
from .compressed import exact_rerank, topr_from_dists
from .flat import _pruned_search_variant, flat_search
from .hnsw import NO_EDGE
from .mstg import MSTGIndex
from .predicates import as_mask
from .quant import QuantizedStore, check_storage_dtype
from .search import (as_tensor, device_variant, merge_topk, mstg_graph_search,
                     mstg_graph_search_chunked)

ROUTE_AUTO = "auto"
ROUTE_GRAPH = "graph"
ROUTE_PRUNED = "pruned"
ROUTE_FLAT = "flat"
_ROUTES = (ROUTE_AUTO, ROUTE_GRAPH, ROUTE_PRUNED, ROUTE_FLAT)

# Wavefront width on a CUDA device when neither the request nor the config
# pins it: the fastest of fanout in {1, 2, 4, 8} in chip_smoke.py's sweep at
# its graph shapes (n = 50k, d = 128, Q = 256, ef = 64) on an H100 (PERF.md,
# "Fanout sweep").
CUDA_DEFAULT_FANOUT = 4


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``"cuda"``; a CUDA device raises ``RuntimeError`` when no
    card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions on the "
            "CPU")
    return dev


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _empty_result(Q: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    return (np.full((Q, k), NO_EDGE, np.int32),
            np.full((Q, k), np.inf, np.float32))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-lifetime tuning for :class:`QueryEngine`.

    Fields mean what they mean in the reference's ``EngineConfig``. The
    reference's ``use_kernel`` switch is gone: the port always runs its
    kernels (the plain versions on the CPU). ``graph_fanout`` ``None`` means
    :data:`CUDA_DEFAULT_FANOUT` on a CUDA device and 1 on the CPU, as the
    reference uses 1 off the TPU.

    ``storage_dtype`` is the tier the engine scans: ``"float32"`` (exact),
    ``"float16"`` or ``"int8"``; ``None`` inherits the index's own tier, and
    an explicit value overrides it, quantizing on the fly when the index
    holds no store of that type. ``rerank_k`` is how many approximate
    candidates per query reach the exact float32 re-rank on a compressed
    tier: ``None`` means ``max(4k, 32)``, always clamped to [k, n] and, on
    the graph route, to ``ef``.
    """

    route: str = ROUTE_AUTO
    flat_threshold: Optional[float] = None
    route_work_ratio: float = 1.0
    selectivity_sample: int = 2048
    pad_queries: bool = True
    sel_cache_max: int = 65536
    graph_fanout: Optional[int] = None
    graph_chunk: Union[int, str, None] = "auto"
    packed_visited: bool = True
    trace_sample: float = 0.0
    storage_dtype: Optional[str] = None
    rerank_k: Optional[int] = None

    def __post_init__(self):
        if self.route not in _ROUTES:
            raise ValueError(f"route must be one of {_ROUTES}, got "
                             f"{self.route!r}")
        if self.graph_fanout is not None and self.graph_fanout < 1:
            raise ValueError("graph_fanout must be >= 1 (or None: device "
                             f"default), got {self.graph_fanout!r}")
        if not (self.graph_chunk is None or self.graph_chunk == "auto"
                or (isinstance(self.graph_chunk, int)
                    and self.graph_chunk >= 0)):
            raise ValueError("graph_chunk must be an int >= 1, 0/None "
                             "(single-loop driver), or \"auto\", got "
                             f"{self.graph_chunk!r}")
        if self.selectivity_sample < 1:
            raise ValueError("selectivity_sample must be >= 1")
        if self.sel_cache_max < 1:
            raise ValueError("sel_cache_max must be >= 1")
        if not (0.0 <= self.trace_sample <= 1.0):
            raise ValueError("trace_sample must be in [0, 1], got "
                             f"{self.trace_sample!r}")
        if self.storage_dtype is not None:
            check_storage_dtype(self.storage_dtype)
        if self.rerank_k is not None and self.rerank_k < 1:
            raise ValueError("rerank_k must be >= 1 (or None: max(4k, 32)), "
                             f"got {self.rerank_k!r}")

    def replace(self, **overrides) -> "EngineConfig":
        """A copy with ``overrides`` applied (re-validated)."""
        return dataclasses.replace(self, **overrides)


class QueryEngine:
    """Plan once, execute on the best route, on one device.

    Parameters
    ----------
    index : MSTGIndex
        Built or loaded index, at any storage tier.
    config : EngineConfig, optional
        Engine-lifetime tuning; defaults to ``EngineConfig()``.
    device : str | torch.device, optional
        Where the index is staged and searched. ``None`` means ``"cuda"``
        and raises ``RuntimeError`` when no card is present.
    """

    def __init__(self, index: MSTGIndex,
                 config: Optional[EngineConfig] = None, *, device=None):
        config = config if config is not None else EngineConfig()
        if not isinstance(config, EngineConfig):
            raise TypeError("config must be an EngineConfig, got "
                            f"{type(config).__name__}")
        self.device = resolve_device(device)
        self.config = config
        self.index = index
        self.default_route = config.route
        self.flat_threshold = (None if config.flat_threshold is None
                               else float(config.flat_threshold))
        self.route_work_ratio = float(config.route_work_ratio)
        self._max_slots = max((fv.nbr.shape[2]
                               for fv in index.variants.values()), default=16)
        self.pad_queries = config.pad_queries
        self.graph_fanout = config.graph_fanout
        self.graph_chunk = config.graph_chunk
        self.packed_visited = bool(config.packed_visited)

        # storage tier: an explicit config value wins over the index's own
        sd = check_storage_dtype(config.storage_dtype
                                 or getattr(index.spec, "storage_dtype",
                                            "float32"))
        self.storage_dtype = sd
        store = getattr(index, "storage", None)
        if sd == "float32":
            store = None
        elif store is None or store.dtype != sd:
            store = QuantizedStore.from_vectors(index.vectors, sd)
        self._store: Optional[QuantizedStore] = store
        self._store_dev: Optional[dict] = None
        # router work model: scanning 1-byte codes streams 1/4 the bytes of
        # a float32 scan, so scan work is weighed by the tier's itemsize
        self._scan_cost_ratio = (store.itemsize / 4.0) if store else 1.0
        self._corpus_dev = None
        # the predicate runs on float32 endpoints, as in the reference
        self.lo = as_tensor(index.lo, self.device, torch.float32)
        self.hi = as_tensor(index.hi, self.device, torch.float32)
        self._graph_dev: Dict[str, dict] = {}
        self._pruned_dev: Dict[str, dict] = {}
        self._sorted_rank: Dict[str, np.ndarray] = {}

        n = index.vectors.shape[0]
        m = min(n, int(config.selectivity_sample))
        sel = (np.arange(n) if m == n
               else np.random.default_rng(0).choice(n, size=m, replace=False))
        self._sample_lo = np.asarray(index.lo)[sel]
        self._sample_hi = np.asarray(index.hi)[sel]
        dom = index.domain
        self._sel_index: Optional[iv.SelectivityIndex] = None
        if dom.K <= 2048:
            self._sel_index = iv.SelectivityIndex(
                dom.rank(self._sample_lo), dom.rank(self._sample_hi), dom.K)
        self.route_counts: Dict[str, int] = {ROUTE_GRAPH: 0, ROUTE_PRUNED: 0,
                                             ROUTE_FLAT: 0}
        self._sel_cache: Dict[tuple, float] = {}
        self._sel_cache_max = int(config.sel_cache_max)
        self.sel_cache_hits = 0
        self.sel_cache_misses = 0
        self.sel_cache_evictions = 0

        ts = float(config.trace_sample)
        self._trace_every = int(round(1.0 / ts)) if ts > 0 else 0
        self._trace_seq = 0
        reg = obs.get_registry()
        req_c = reg.counter("engine_requests_total",
                            "Batch requests executed, by resolved route",
                            labels=("route",))
        qry_c = reg.counter("engine_queries_total",
                            "Individual queries executed, by resolved route",
                            labels=("route",))
        lat_h = reg.histogram("engine_search_ms",
                              "QueryEngine.execute wall time (ms), by route",
                              labels=("route",))
        self._route_metrics = {
            r: (req_c.labels(route=r), qry_c.labels(route=r),
                lat_h.labels(route=r))
            for r in (ROUTE_GRAPH, ROUTE_PRUNED, ROUTE_FLAT)}
        sel_c = reg.counter("engine_sel_cache_total",
                            "Selectivity-memo lookups, by outcome",
                            labels=("outcome",))
        self._m_sel_hit = sel_c.labels(outcome="hit")
        self._m_sel_miss = sel_c.labels(outcome="miss")

    # ---- device staging (lazy, cached per variant) ----
    @property
    def corpus(self) -> torch.Tensor:
        """The float32 corpus on the engine's device, staged on first use.
        A compressed tier never touches it: its exact rows stay on the host
        for the re-rank gather."""
        if self._corpus_dev is None:
            self._corpus_dev = as_tensor(self.index.vectors, self.device,
                                         torch.float32).contiguous()
        return self._corpus_dev

    def store_dev(self) -> dict:
        """The quantized store on the engine's device, staged on first use:
        the row-major (n, d) ``codes`` every route reads, the (d,)
        ``scale`` and ``offset``, and the (n,) ``sq_norm``."""
        if self._store_dev is None:
            st = self._store
            self._store_dev = {
                "codes": as_tensor(st.codes, self.device),
                "scale": as_tensor(st.scale, self.device, torch.float32),
                "offset": as_tensor(st.offset, self.device, torch.float32),
                "sq_norm": as_tensor(st.sq_norm, self.device, torch.float32)}
        return self._store_dev

    def graph_dev(self, variant: str) -> dict:
        if variant not in self._graph_dev:
            fv = self.index.variants[variant]
            self._graph_dev[variant] = (
                device_variant(fv, None, self.device, store=self.store_dev())
                if self._store is not None
                else device_variant(fv, self.corpus, self.device))
        return self._graph_dev[variant]

    def pruned_dev(self, variant: str) -> dict:
        if variant not in self._pruned_dev:
            fv = self.index.variants[variant]
            dev = {f: as_tensor(getattr(fv, f), self.device)
                   for f in ("members", "member_ver", "node_off")}
            if self._store is not None:
                sd = self.store_dev()
                dev.update(codes=sd["codes"], code_scale=sd["scale"],
                           code_offset=sd["offset"],
                           code_sq_norm=sd["sq_norm"])
            else:
                dev["vectors"] = self.corpus
            self._pruned_dev[variant] = dev
        return self._pruned_dev[variant]

    def _sorted_sort_rank(self, variant: str) -> np.ndarray:
        if variant not in self._sorted_rank:
            self._sorted_rank[variant] = np.sort(
                self.index.variants[variant].sort_rank)
        return self._sorted_rank[variant]

    # ---- planning / routing ----
    def plan(self, mask: int, qlo: np.ndarray, qhi: np.ndarray) -> List[iv.PlanSlot]:
        return self.index.plan_batch(as_mask(mask), qlo, qhi)

    def estimate_selectivity(self, mask, qlo, qhi) -> np.ndarray:
        """(Q,) estimated fraction of the corpus each query's predicate keeps
        (exact when the sample covers the corpus)."""
        return self._estimate_cached(as_mask(mask), qlo, qhi)[0]

    def _estimate_cached(self, mask: int, qlo, qhi) -> Tuple[np.ndarray, int, int]:
        """Memoized selectivity estimate -> (est (Q,), hits, misses), keyed
        by each query's exact rank signature."""
        ql = np.asarray(qlo, np.float64)
        qh = np.asarray(qhi, np.float64)
        dom = self.index.domain
        fl, cl = dom.floor_rank(ql), dom.ceil_rank(ql)
        fr, cr = dom.floor_rank(qh), dom.ceil_rank(qh)
        Q = ql.shape[0]
        out = np.empty(Q, np.float64)
        miss: List[int] = []
        hits = 0
        for i in range(Q):
            v = self._sel_cache.get((mask, fl[i], cl[i], fr[i], cr[i]))
            if v is None:
                miss.append(i)
            else:
                out[i] = v
                hits += 1
        if miss:
            mi = np.asarray(miss)
            if self._sel_index is not None:
                est = self._sel_index.fraction(mask, fl[mi], cl[mi],
                                               fr[mi], cr[mi])
            else:
                hit = iv.eval_predicate(mask, self._sample_lo[None, :],
                                        self._sample_hi[None, :],
                                        ql[mi][:, None], qh[mi][:, None])
                est = np.asarray(hit, np.float64).mean(axis=1)
            for j, i in enumerate(miss):
                v = float(est[j])
                self._sel_cache[(mask, fl[i], cl[i], fr[i], cr[i])] = v
                out[i] = v
            overflow = len(self._sel_cache) - self._sel_cache_max
            if overflow > 0:  # FIFO: drop the oldest entries only
                for key in list(itertools.islice(iter(self._sel_cache),
                                                 overflow)):
                    del self._sel_cache[key]
                self.sel_cache_evictions += overflow
        self.sel_cache_hits += hits
        self.sel_cache_misses += len(miss)
        if hits:
            self._m_sel_hit.inc(hits)
        if miss:
            self._m_sel_miss.inc(len(miss))
        return out, hits, len(miss)

    def _auto_route(self, est: np.ndarray, ef: int = 64) -> str:
        """The work-model router: the pruned scan evaluates ~``est * n``
        candidate distances per query, the beam search ~``ef * S``; route to
        the exact scan while its work is below ``route_work_ratio`` times
        the beam's. Scan work is weighed by the storage tier's bytes per
        component (``_scan_cost_ratio``: 1/4 for int8 codes). An explicit
        ``flat_threshold`` is the fixed-fraction rule instead."""
        if self.flat_threshold is not None:
            return (ROUTE_PRUNED if float(est.mean()) <= self.flat_threshold
                    else ROUTE_GRAPH)
        scan_work = (float(est.mean()) * self.index.vectors.shape[0]
                     * self._scan_cost_ratio)
        beam_work = float(ef) * self._max_slots
        return (ROUTE_PRUNED if scan_work <= self.route_work_ratio * beam_work
                else ROUTE_GRAPH)

    def route_for(self, mask, qlo, qhi, route: Optional[str] = None,
                  ef: int = 64) -> str:
        """Advisory routing answer for a request with this ``ef``."""
        route = route or self.default_route
        if route != ROUTE_AUTO:
            return route
        return self._auto_route(self.estimate_selectivity(mask, qlo, qhi), ef)

    # ---- execution ----
    def search(self, request: SearchRequest) -> SearchResult:
        if not isinstance(request, SearchRequest):
            raise TypeError("QueryEngine.search takes a "
                            "repro_torch.core.SearchRequest")
        return self.execute(request)

    def execute(self, request: SearchRequest) -> SearchResult:
        """Plan, route, and run one request; always returns a SearchResult
        (numpy ids and dists). ``request.trace=True`` (or a hit of
        ``EngineConfig.trace_sample``) records the span tree onto
        ``SearchResult.trace``."""
        requested = request.route or self.default_route
        if requested not in _ROUTES:
            raise ValueError(f"route must be one of {_ROUTES}, got {requested!r}")
        wants_trace = request.trace
        if not wants_trace and self._trace_every:
            self._trace_seq += 1
            wants_trace = (self._trace_seq % self._trace_every) == 0
        tracer = obs.begin_request_trace() if wants_trace else None
        t_exec = time.perf_counter()
        try:
            with obs.span("search") as root:
                root.set("Q", len(request)).set("k", request.k)
                root.set("mask", request.mask).set("requested", requested)
                root.set("device", str(self.device))
                result = self._execute_routed(request, requested)
        finally:
            trace = obs.end_request_trace(tracer)
        route = result.report.route if result.report is not None else requested
        rm = self._route_metrics.get(route)
        if rm is not None:
            rm[0].inc()
            rm[1].inc(float(len(request)))
            rm[2].record((time.perf_counter() - t_exec) * 1e3)
        if trace is not None:
            result = dataclasses.replace(result, trace=trace)
        return result

    def _execute_routed(self, request: SearchRequest,
                        requested: str) -> SearchResult:
        queries, qlo, qhi = request.vectors, request.qlo, request.qhi
        mask, k = request.mask, request.k
        Q = len(request)
        est = None
        hits = misses = 0
        route = requested
        if requested == ROUTE_AUTO and Q:
            with obs.span("route") as rsp:
                est, hits, misses = self._estimate_cached(mask, qlo, qhi)
                route = self._auto_route(est, request.ef)
                if obs.tracing():
                    rsp.set("chosen", route)
                    rsp.set("est_mean", round(float(est.mean()), 6))
                    rsp.set("cache_hits", hits).set("cache_misses", misses)
        if Q == 0:
            ids, d = _empty_result(0, k)
            return SearchResult(ids, d, RouteReport(
                route=route, requested=requested, est_selectivity=est,
                slot_count=0, variants=()))
        self.route_counts[route] = self.route_counts.get(route, 0) + 1
        with obs.span("plan") as psp:
            slots = (self.plan(mask, qlo, qhi) if route in (ROUTE_GRAPH,
                                                            ROUTE_PRUNED)
                     else [])
            psp.set("slots", len(slots))
        with obs.span(route):
            if route == ROUTE_FLAT:
                ids, d = self._run_flat(queries, qlo, qhi, mask, k)
            elif route == ROUTE_PRUNED:
                ids, d = self._run_pruned(queries, qlo, qhi, mask, k,
                                          slots=slots)
            elif route == ROUTE_GRAPH:
                ids, d = self._run_graph(queries, qlo, qhi, mask, k,
                                         request.ef, request.max_steps,
                                         request.fanout, slots,
                                         chunk=request.chunk)
            else:
                raise ValueError(f"unknown route {route!r}")
            with obs.span("to_host"):
                ids, d = _host(ids)[:Q], _host(d)[:Q]
        report = RouteReport(route=route, requested=requested,
                             est_selectivity=est, slot_count=len(slots),
                             variants=tuple(s.variant for s in slots),
                             cache_hits=hits, cache_misses=misses)
        return SearchResult(ids, d, report)

    # Convenience fixed-route entry points (tuple returns, as the
    # reference's).
    def search_graph(self, queries, qlo, qhi, mask, k=10, ef=64,
                     max_steps=None, fanout=1):
        req = SearchRequest(queries, (qlo, qhi), mask, k=k, ef=ef,
                            max_steps=max_steps, fanout=fanout,
                            route=ROUTE_GRAPH)
        return self.execute(req).astuple()

    def search_pruned(self, queries, qlo, qhi, mask, k=10, block: int = 256,
                      max_candidates: Optional[int] = None):
        """The exact pruned scan without the request path; a
        ``max_candidates`` cap truncates each slot's candidate list (the
        default, the plan's exact bound, never does)."""
        queries = np.ascontiguousarray(queries, np.float32)
        qlo = np.asarray(qlo, np.float64)
        qhi = np.asarray(qhi, np.float64)
        mask = as_mask(mask)
        Q = queries.shape[0]
        if Q == 0:
            return _empty_result(0, k)
        self.route_counts[ROUTE_PRUNED] = self.route_counts.get(ROUTE_PRUNED,
                                                                0) + 1
        ids, d = self._run_pruned(queries, qlo, qhi, mask, k, block=block,
                                  max_candidates=max_candidates)
        return _host(ids)[:Q], _host(d)[:Q]

    def search_flat(self, queries, qlo, qhi, mask, k=10):
        req = SearchRequest(queries, (qlo, qhi), mask, k=k, route=ROUTE_FLAT)
        return self.execute(req).astuple()

    # ---- internals ----
    def _padded(self, queries: np.ndarray, qlo: np.ndarray, qhi: np.ndarray):
        """Pad the batch to a power-of-two bucket; padded rows use the
        impossible query range [0, -1] so no predicate bit can select them."""
        Q = queries.shape[0]
        if not self.pad_queries:
            return queries, qlo, qhi
        Qp = max(_next_pow2(Q), 8)
        if Qp == Q:
            return queries, qlo, qhi
        pad = Qp - Q
        queries = np.concatenate(
            [queries, np.zeros((pad, queries.shape[1]), np.float32)])
        qlo = np.concatenate([qlo, np.zeros(pad)])
        qhi = np.concatenate([qhi, np.full(pad, -1.0)])
        return queries, qlo, qhi

    def _padded_slots(self, slots: List[iv.PlanSlot], Qp: int) -> List[iv.PlanSlot]:
        """Extend each slot's per-query arrays with empty tasks (version=-1,
        key_lo>key_hi): padded queries start with an empty pool and never
        take a step."""
        out = []
        for s in slots:
            pad = Qp - s.version.shape[0]
            if pad <= 0:
                out.append(s)
                continue
            out.append(iv.PlanSlot(
                s.variant,
                np.concatenate([s.version, np.full(pad, -1, np.int64)]),
                np.concatenate([s.key_lo, np.ones(pad, np.int64)]),
                np.concatenate([s.key_hi, np.zeros(pad, np.int64)])))
        return out

    def _resolve_fanout(self, fanout: Optional[int]) -> int:
        """Wavefront width: the request's value, then the config's, then
        the device default."""
        if fanout:
            return max(1, int(fanout))
        if self.graph_fanout:
            return max(1, int(self.graph_fanout))
        return CUDA_DEFAULT_FANOUT if self.device.type == "cuda" else 1

    def _queries(self, queries: np.ndarray) -> torch.Tensor:
        return as_tensor(queries, self.device, torch.float32).contiguous()

    def _stage(self, queries: np.ndarray, qlo: np.ndarray, qhi: np.ndarray):
        """The batch's queries and query ranges on the device, under a
        ``stage`` span (each copy from pageable memory waits for it)."""
        with obs.span("stage"):
            return (self._queries(queries),
                    as_tensor(qlo, self.device, torch.float32),
                    as_tensor(qhi, self.device, torch.float32))

    def _rerank_width(self, k: int, upper: Optional[int] = None) -> int:
        """Approximate candidates per query that reach the exact re-rank:
        ``rerank_k`` (default ``max(4k, 32)``) clamped to [k, n] and to
        ``upper`` (the graph pool width ``ef``) when given."""
        n = self.index.vectors.shape[0]
        R = self.config.rerank_k or max(4 * k, 32)
        if upper is not None:
            R = min(R, upper)
        return max(k, min(R, n))

    def _rerank_exact(self, qdev, cand_ids, k: int):
        """Exact float32 re-rank of approximate top-R candidate ids: the
        (Q, R, d) rows are gathered on the host (a compressed tier never
        stages the float32 corpus) and re-ranked on the device."""
        cand = _host(cand_ids)
        rows = self.index.vectors[np.clip(cand, 0, None)]
        with obs.span("rerank") as rsp:
            if obs.tracing():
                rsp.set("R", int(cand.shape[1]))
            return exact_rerank(qdev, as_tensor(rows, self.device),
                                as_tensor(cand, self.device), k=k)

    def _run_graph(self, queries, qlo, qhi, mask, k, ef, max_steps, fanout,
                   slots: List[iv.PlanSlot], chunk=None):
        F = self._resolve_fanout(fanout)
        chunk = chunk if chunk is not None else self.graph_chunk
        queries_p, _, _ = self._padded(queries, qlo, qhi)
        if chunk == "auto":  # compaction pays once the batch is wide enough
            chunk = 16 if queries_p.shape[0] >= 64 else None
        slots = self._padded_slots(slots, queries_p.shape[0])
        steps = max_steps or ((4 * ef + 64) // F + 8)
        with obs.span("stage"):
            qdev = self._queries(queries_p)
        # compressed tier: the beam ranks approximate (dequantized) distances,
        # so carry the top R of the pool through the merge and re-rank once
        kq = k if self._store is None else self._rerank_width(k, upper=ef)
        res = None
        for s in slots:
            # skip slots where every query's task is empty (they would give
            # all-NO_EDGE rows, and merging those changes nothing)
            if not np.any((s.version >= 0) & (s.key_lo <= s.key_hi)):
                continue
            arrays = self.graph_dev(s.variant)
            Kpad = self.index.variants[s.variant].Kpad
            common = dict(k=kq, ef=ef, max_steps=steps, Kpad=Kpad, fanout=F,
                          packed=self.packed_visited)
            with obs.span("slot") as ssp:
                ssp.set("variant", s.variant).set("ef", ef).set("fanout", F)
                if chunk and chunk < steps:
                    ssp.set("chunk", int(chunk))
                    ids, d = mstg_graph_search_chunked(
                        arrays, qdev, s.version, s.key_lo, s.key_hi,
                        chunk=int(chunk), **common)
                    ids = torch.as_tensor(ids, device=self.device)
                    d = torch.as_tensor(d, device=self.device)
                else:
                    ids, d = mstg_graph_search(arrays, qdev, s.version,
                                               s.key_lo, s.key_hi, **common)
            res = (ids, d) if res is None else merge_topk(res[0], res[1], ids,
                                                          d, kq)
        if res is None:
            return _empty_result(queries_p.shape[0], k)
        if self._store is not None:
            return self._rerank_exact(qdev, res[0], k)
        return res

    def _run_pruned(self, queries, qlo, qhi, mask, k,
                    slots: Optional[List[iv.PlanSlot]] = None,
                    block: int = 256, max_candidates: Optional[int] = None):
        if slots is None:
            slots = self.plan(mask, qlo, qhi)
        n = self.index.vectors.shape[0]
        queries_p, qlo_p, qhi_p = self._padded(queries, qlo, qhi)
        slots = self._padded_slots(slots, queries_p.shape[0])
        qdev, qlo_t, qhi_t = self._stage(queries_p, qlo_p, qhi_p)
        # compressed tier: scan distances are approximate, so keep the top R
        # per slot and through the merge, then re-rank exactly once
        kq = k if self._store is None else self._rerank_width(k)
        res = None
        for s in slots:
            fv = self.index.variants[s.variant]
            # exact candidate upper bound for this slot: objects with
            # sort_rank <= max version, rounded to a power of two; never
            # truncates, so the pruned route stays recall-1.0 (a caller's
            # max_candidates replaces it, and may truncate)
            if max_candidates is not None:
                cap = min(n, int(max_candidates))
            else:
                hi_ver = int(s.version.max(initial=-1))
                cap = int(np.searchsorted(self._sorted_sort_rank(s.variant),
                                          hi_ver, side="right"))
                cap = min(n, _next_pow2(cap)) if cap else 0
            if cap == 0:
                continue  # every query's task in this slot is empty
            with obs.span("slot") as ssp:
                ssp.set("variant", s.variant).set("candidates", cap)
                with obs.span("stage"):
                    version = as_tensor(s.version, self.device)
                    key_lo = as_tensor(s.key_lo, self.device)
                    key_hi = as_tensor(s.key_hi, self.device)
                ids, d = _pruned_search_variant(
                    self.pruned_dev(s.variant), self.lo, self.hi, qdev,
                    qlo_t, qhi_t, version, key_lo, key_hi,
                    pred_mask_bits=mask, k=kq, Kpad=fv.Kpad, block=block,
                    max_blocks=-(-cap // block))
            res = (ids, d) if res is None else merge_topk(res[0], res[1], ids,
                                                          d, kq)
        if res is None:
            return _empty_result(queries_p.shape[0], k)
        if self._store is not None:
            return self._rerank_exact(qdev, res[0], k)
        return res

    def _run_flat(self, queries, qlo, qhi, mask, k):
        queries_p, qlo_p, qhi_p = self._padded(queries, qlo, qhi)
        qdev, qlo_t, qhi_t = self._stage(queries_p, qlo_p, qhi_p)
        if self._store is None:
            return flat_search(self.corpus, self.lo, self.hi, qdev, qlo_t,
                               qhi_t, mask=mask, k=k)
        sd = self.store_dev()
        if self._store.dtype == "int8":
            approx = ops.pairwise_l2_int8(qdev, sd["codes"], sd["scale"],
                                          sd["offset"], sd["sq_norm"],
                                          self.lo, self.hi, qlo_t, qhi_t,
                                          mask)
        else:
            # float16 codes are affine-trivial (scale 1, offset 0): the
            # scan's widening of each code is exactly the dequantization
            approx = ops.pairwise_l2_masked(qdev, sd["codes"], self.lo,
                                            self.hi, qlo_t, qhi_t, mask)
        cand_ids, _ = topr_from_dists(approx, rerank=self._rerank_width(k))
        return self._rerank_exact(qdev, cand_ids, k)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
