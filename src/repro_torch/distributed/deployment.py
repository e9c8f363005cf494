"""ShardedDeployment — sharded serving of RRANN search, one shard a rank
of a mesh of ranks, or every shard a logical partition of one device.

The corpus partitions across the shards of the mesh's ``corpus_axis``;
each :class:`repro_torch.core.SearchRequest` fans out to every shard, runs
the *existing* per-shard routes locally (the exact pruned scan, the
wavefront graph search, or a whole streaming
:class:`repro_torch.streaming.SegmentedIndex` per shard), and the per-shard
top-k lists are combined through the :mod:`repro_torch.distributed.topk`
merge schedules — ``all_gather`` for small meshes, ``tournament`` for
larger ones, or a host merge when no mesh is attached.

* **A mesh of ranks** (:func:`repro_torch.launch.make_rank_mesh`), the
  reference's device-mesh deployment: rank r serves shard r (its index on
  ``corpus_axis``) on its own device, ``mesh.device``. Every constructor
  takes the global arrays (numpy or ``np.memmap``) on every rank, and each
  rank stages, builds and scans only its own shard; the merges run as
  collectives. :meth:`ShardedDeployment.execute`, :meth:`fail` and
  :meth:`restore` are SPMD calls: every rank makes them with the same
  arguments, and every rank returns the merged result (its own lane's
  under ``tournament``; see :mod:`repro_torch.distributed.topk`).
* **A logical mesh** (:func:`repro_torch.launch.make_mesh`) or none: every
  shard runs on the deployment's one device (``device=``, else the
  mesh's, else ``"cuda"``).

Three shard layouts:

* :meth:`ShardedDeployment.build` — contiguous corpus slices, one
  :class:`repro_torch.core.MSTGIndex` + :class:`repro_torch.core.QueryEngine`
  per shard
  (every engine route available per shard; local ids are rebased to global
  row ids).
* :meth:`ShardedDeployment.from_segmented` — an existing
  :class:`repro_torch.streaming.SegmentedIndex`'s frozen segments dealt
  round-robin
  onto shards (the delta buffer rides on shard 0). A snapshot view: segments
  are shared, not copied, so mutate the source index and re-derive.
* :meth:`ShardedDeployment.flat` — raw corpus slices served by the exact
  flat scan. The corpus is staged on the device once, at construction; with
  a mesh and a device merge schedule one call
  (:func:`repro_torch.distributed.topk.sharded_flat_topk`) runs one scan
  per live shard and the merge without materializing per-shard results on
  the host.

Fan-in width: ``DeploymentSpec.per_shard_k`` caps how many candidates each
shard contributes to the merge. ``k' == k`` reproduces the single-device
answer exactly (every global top-k member lives in some shard's local
top-k); ``k' < k`` trades recall for merge traffic (bytes ∝ D·Q·k') — the
recall-QPS pareto knob the scale bench sweeps.

Fault handling (:mod:`repro_torch.distributed.fault`): shards ping a
:class:`HeartbeatRegistry` on every answer; a shard marked failed
(:meth:`fail`), timed out past ``shard_timeout_s``, or raising mid-search
contributes only sentinel rows. The request still answers — a
degraded-recall :class:`repro_torch.core.SearchResult` with the lost shards in
``report.missing_shards`` and ``result.degraded == True`` — never an error.
On ranks each rank reads its own shard's heartbeat on its own clock and
catches an exception of its own local search only; the ranks agree on the
alive mask by one small ``all_gather`` before any merge, and a lost rank
still enters every collective with sentinel rows, so its peers never wait
on it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

import torch

from .. import obs
from ..core.api import (IndexSpec, RouteReport, SearchRequest, SearchResult,
                        ShardReport)
from ..core.engine import EngineConfig, QueryEngine
from ..core.hnsw import NO_EDGE
from ..core.mstg import MSTGIndex
from ..core.parallel import pool_size, run_build_pool
from ..core.search import as_tensor
from ..streaming.segmented import SegmentedIndex, _merge_topk_host

from ..launch.mesh import pick_device
from . import collectives as coll
from .fault import HeartbeatRegistry
from .topk import (_pad_to_k, local_flat_topk, resolve_merge,
                   sharded_flat_topk, sharded_topk_merge)

_MERGES = ("auto", "all_gather", "tournament", "host")
# a shard report's route as the ranks agree on it: its index here
_REPORT_ROUTES = ("graph", "pruned", "flat", "segmented", "lost", "error")


@dataclasses.dataclass(frozen=True)
class DeploymentSpec:
    """How a corpus deploys across shards — the distributed counterpart of
    :class:`repro_torch.core.EngineConfig` (which it carries, one per-shard
    copy).

    Parameters
    ----------
    n_shards : int
        Shard count. Device merge schedules additionally need a mesh whose
        ``corpus_axis`` has exactly this size.
    corpus_axis : str
        Mesh axis the corpus partitions over.
    merge : str
        ``all_gather`` | ``tournament`` | ``host`` | ``auto``. ``auto``
        resolves to ``host`` without a mesh, ``all_gather`` for D <= 8, and
        ``tournament`` for power-of-two D > 8.
    per_shard_k : int
        Per-shard fan-in width k' (0 = the request's full k). ``k' == k`` is
        exact relative to single-device; smaller trades recall for merge
        bytes.
    engine : EngineConfig
        Config for every per-shard :class:`repro_torch.core.QueryEngine`. This
        includes the quantized storage tier: ``EngineConfig(
        storage_dtype="int8", ...)`` gives every shard its own compressed
        code layout (each shard quantizes its corpus slice with its own
        per-dimension scales) plus the exact per-shard re-rank; the fused
        :meth:`ShardedDeployment.flat` layout is separate and always
        float32.
    index : IndexSpec, optional
        Build spec for :meth:`ShardedDeployment.build` shards (default
        ``IndexSpec()``).
    build_workers : int
        Process-pool width for :meth:`ShardedDeployment.build` — shard
        builds are independent, so ``build_workers > 1`` constructs them
        concurrently in spawn workers (each streams its own rate-limited
        build progress; the parent aggregates one pool line per finished
        shard). ``0``/``1`` = serial. An execution resource, not index
        state: it never changes the built shards, only the wall clock, and
        the pool degrades to the serial loop on platforms without process
        support. Workers build on the host only and never touch the
        device. On a mesh of ranks each rank builds its own shard,
        serially.
    shard_timeout_s : float
        Heartbeat staleness beyond which a shard counts as lost.
    """

    n_shards: int = 1
    corpus_axis: str = "data"
    merge: str = "auto"
    per_shard_k: int = 0
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    index: Optional[IndexSpec] = None
    build_workers: int = 0
    shard_timeout_s: float = 30.0

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.build_workers < 0:
            raise ValueError("build_workers must be >= 0 (0 = serial)")
        if self.merge not in _MERGES:
            raise ValueError(f"merge must be one of {_MERGES}, got "
                             f"{self.merge!r}")
        if self.per_shard_k < 0:
            raise ValueError("per_shard_k must be >= 0 (0 = full k)")
        if not isinstance(self.engine, EngineConfig):
            raise TypeError("engine must be an EngineConfig")

    def replace(self, **overrides) -> "DeploymentSpec":
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass
class _Shard:
    """One shard's serving state: a local engine plus the id rebase."""

    name: str
    engine: object                 # QueryEngine | SegmentedIndex | None(flat)
    n: int
    id_offset: Optional[int]       # local row -> global id shift; None = the
    #                                engine already returns external ids


def _shard_build_task(args):
    """Module-level worker body for parallel shard builds (spawn-context
    pools need a picklable top-level callable). Ships the finished index
    back as its save payload — plain numpy arrays + a meta dict — rather
    than the live object, and reports the in-worker build seconds so the
    parent can attribute wall clock per shard. Host only: the worker never
    touches a CUDA device."""
    i, ispec, vectors, lo, hi = args
    t0 = time.perf_counter()
    idx = MSTGIndex.build(ispec, vectors, lo, hi)
    arrays, meta = idx.to_payload()
    return i, arrays, meta, time.perf_counter() - t0


def _host_merge(ids: np.ndarray, dists: np.ndarray, k: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge stacked (D, Q, k') lists on host, shard-major like all_gather."""
    return _merge_topk_host(list(ids), list(dists), ids.shape[1], k)


def _host_rows(vectors, lo, hi, a: int, b: int):
    """Rows ``[a, b)`` as writable host arrays: float32 vectors, float64
    endpoints. Of an ``np.memmap`` only those rows are read (and copied);
    an in-memory array of the right type is sliced, not copied."""
    return (np.require(vectors[a:b], np.float32, ["C", "W"]),
            np.require(lo[a:b], np.float64, ["C", "W"]),
            np.require(hi[a:b], np.float64, ["C", "W"]))


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else t


def _rank_of(mesh, spec: DeploymentSpec) -> Optional[int]:
    """This rank's shard on a mesh of ranks; None on a logical mesh or
    without one."""
    if mesh is None or mesh.device_mesh is None:
        return None
    return coll.axis_index(mesh, spec.corpus_axis)


class ShardedDeployment:
    """Serve one logical corpus from many shards (see module docstring).

    The declarative surface matches :class:`repro_torch.core.QueryEngine`:
    ``execute(SearchRequest) -> SearchResult`` (and ``search`` as an alias),
    so a deployment can stand where an engine does.
    ``result.report.route == "sharded"`` with one
    :class:`repro_torch.core.ShardReport` per shard.

    On a mesh of ranks ``rank`` is this rank's shard and only
    ``shards[rank]`` has an engine (or, in the flat layout, rows staged);
    elsewhere ``rank`` is None and every shard runs on one device:
    ``device``, else the mesh's, else ``"cuda"`` (which raises without a
    card). A ``device`` other than the mesh's raises ``ValueError``.
    """

    def __init__(self, shards: Sequence[_Shard], spec: DeploymentSpec,
                 mesh=None, *, device=None, _flat_arrays=None):
        if len(shards) != spec.n_shards:
            raise ValueError(f"{len(shards)} shards built but spec.n_shards "
                             f"= {spec.n_shards}")
        if mesh is not None and mesh.shape[spec.corpus_axis] != spec.n_shards:
            raise ValueError(
                f"mesh axis {spec.corpus_axis!r} has size "
                f"{mesh.shape[spec.corpus_axis]} but the deployment has "
                f"{spec.n_shards} shards")
        self.shards = list(shards)
        self.spec = spec
        self.mesh = mesh
        self.rank = _rank_of(mesh, spec)
        self.device = pick_device(device, mesh)
        self._flat = None              # (corpus, lo, hi) on the device: all
        if _flat_arrays is not None:   # rows, or on a rank its shard's
            corpus, lo, hi = _flat_arrays
            self._flat = (as_tensor(corpus, self.device,
                                    torch.float32).contiguous(),
                          as_tensor(lo, self.device, torch.float32),
                          as_tensor(hi, self.device, torch.float32))
        self._failed: set = set()
        self.build_report: Optional[dict] = None
        self.heartbeats = HeartbeatRegistry(timeout_s=spec.shard_timeout_s)
        now = time.time()
        for i in self._served():
            self.heartbeats.ping(self.shards[i].name, 0, now=now)
        self._step = 0

    def _served(self) -> List[int]:
        """The shards this process serves: its own on a rank, else all."""
        return list(range(len(self.shards))) if self.rank is None \
            else [self.rank]

    # ---- constructors ----
    @classmethod
    def build(cls, vectors, lo, hi, *, spec: Optional[DeploymentSpec] = None,
              mesh=None, device=None) -> "ShardedDeployment":
        """Partition rows into ``n_shards`` contiguous slices and build one
        MSTG index + engine per slice. Result ids are global row indices.

        ``spec.build_workers > 1`` builds the shards in a spawn process
        pool (shard builds share nothing); the pool degrades to the serial
        loop when process pools are unavailable. Either way the deployment
        carries a ``build_report`` dict — pool size, wall seconds, per-shard
        build seconds, rows/sec — for bench attribution. On a mesh of ranks
        a rank builds only its own slice, serially, and reports its own
        seconds and rows."""
        spec = spec or DeploymentSpec()
        device = pick_device(device, mesh)
        rank = _rank_of(mesh, spec)
        ispec = spec.index or IndexSpec()
        n = vectors.shape[0]
        bounds = np.linspace(0, n, spec.n_shards + 1, dtype=np.int64)
        slices = [(int(bounds[i]), int(bounds[i + 1]))
                  for i in range(spec.n_shards)]

        def rows(a, b):
            return _host_rows(vectors, lo, hi, a, b)

        t_wall = time.perf_counter()
        shard_secs: List[float] = []
        indexes = {}
        results = None if rank is not None else run_build_pool(
            _shard_build_task,
            [(i, ispec, *rows(a, b)) for i, (a, b) in enumerate(slices)],
            workers=spec.build_workers, label="shard")
        if results is not None:
            for i, arrays, meta, secs in results:
                indexes[i] = MSTGIndex.from_payload(arrays, meta)
                shard_secs.append(float(secs))
        else:
            for i in (range(spec.n_shards) if rank is None else [rank]):
                t0 = time.perf_counter()
                indexes[i] = MSTGIndex.build(ispec, *rows(*slices[i]))
                shard_secs.append(time.perf_counter() - t0)
        shards = [_Shard(f"shard-{i}",
                         QueryEngine(indexes[i], config=spec.engine,
                                     device=device) if i in indexes else None,
                         b - a, a)
                  for i, (a, b) in enumerate(slices)]
        wall = time.perf_counter() - t_wall
        self = cls(shards, spec, mesh, device=device)
        built = n if rank is None else shards[rank].n
        self.build_report = {
            "pool_size": (pool_size(spec.build_workers, spec.n_shards)
                          if rank is None else 0),
            "wall_s": wall,
            "shard_seconds": shard_secs,
            "rows_per_sec": built / wall if wall > 0 else 0.0,
        }
        return self

    @classmethod
    def from_segmented(cls, segmented, *,
                       spec: Optional[DeploymentSpec] = None,
                       mesh=None, device=None) -> "ShardedDeployment":
        """Deal an existing SegmentedIndex's frozen segments round-robin onto
        shards (delta buffer on shard 0). Segments are shared with the
        source, not copied — a snapshot view; re-derive after mutations.
        When the views serve with the source's engine config on its device
        they also share its segment engines, so no segment is staged on the
        device twice. On a mesh of ranks each rank keeps only its own view
        (segments ``j % D == rank``)."""
        spec = spec or DeploymentSpec()
        device = pick_device(device, mesh)
        rank = _rank_of(mesh, spec)
        share = (spec.engine == segmented.engine_config
                 and device == segmented.device)
        shards = []
        for i in range(spec.n_shards):
            view = SegmentedIndex(segmented.spec, policy=segmented.policy,
                                  engine_config=spec.engine, device=device)
            if share:
                view._engines = segmented._engines
            shards.append(_Shard(f"shard-{i}", view, 0, None))
        for j, seg in enumerate(segmented.segments):
            shards[j % spec.n_shards].engine.segments.append(seg)
        shards[0].engine.delta = segmented.delta
        for i, s in enumerate(shards):
            s.n = len(s.engine)        # live rows: tombstones excluded
            if rank is not None and i != rank:
                s.engine = None
        return cls(shards, spec, mesh, device=device)

    @classmethod
    def flat(cls, vectors, lo, hi, *, spec: Optional[DeploymentSpec] = None,
             mesh=None, device=None) -> "ShardedDeployment":
        """Exact-scan shards over raw corpus slices, staged on the device
        once (on a mesh of ranks, each rank its own rows: of an
        ``np.memmap`` it reads only those). With a mesh and a device merge
        schedule the whole fan-out is one :func:`sharded_flat_topk` call
        (one scan per live shard and the merge, nothing per-shard on the
        host)."""
        spec = spec or DeploymentSpec()
        rank = _rank_of(mesh, spec)
        n = vectors.shape[0]
        if n % spec.n_shards:
            raise ValueError(f"flat deployment needs corpus size ({n}) "
                             f"divisible by n_shards ({spec.n_shards})")
        nloc = n // spec.n_shards
        a, b = (0, n) if rank is None else (rank * nloc, (rank + 1) * nloc)
        shards = [_Shard(f"shard-{i}", None, nloc, i * nloc)
                  for i in range(spec.n_shards)]
        return cls(shards, spec, mesh, device=device,
                   _flat_arrays=_host_rows(vectors, lo, hi, a, b))

    # ---- fault injection / liveness ----
    def fail(self, shard: int) -> None:
        """Mark a shard down (fleet-controller stand-in). Requests keep
        answering, degraded."""
        self._failed.add(int(shard))

    def restore(self, shard: int) -> None:
        self._failed.discard(int(shard))
        if int(shard) in self._served():
            self.heartbeats.ping(self.shards[shard].name, self._step)

    def _alive(self) -> np.ndarray:
        """(D,) bool — failed or heartbeat-timed-out shards are down. A
        rank reads only its own shard's heartbeat."""
        dead = set(self.heartbeats.dead_workers())
        served = self._served()
        return np.array([(i not in self._failed
                          and not (i in served and s.name in dead))
                         for i, s in enumerate(self.shards)], bool)

    # ---- execution ----
    def execute(self, request: SearchRequest) -> SearchResult:
        """Fan one request out over the shards and merge. With
        ``request.trace=True`` the deployment owns the root trace — per-shard
        engine spans nest under ``shard-i`` — and the finished
        :class:`repro_torch.obs.Trace` rides back on ``SearchResult.trace``.
        On a mesh of ranks every rank calls it with the same request."""
        if not isinstance(request, SearchRequest):
            raise TypeError("ShardedDeployment serves the declarative API "
                            "only; pass a repro_torch.core.SearchRequest")
        tracer = obs.begin_request_trace() if request.trace else None
        try:
            with obs.span("sharded_search") as root:
                root.set("Q", len(request)).set("k", request.k)
                root.set("shards", self.spec.n_shards)
                result = self._execute_sharded(request)
        finally:
            trace = obs.end_request_trace(tracer)
        if trace is not None:
            result = dataclasses.replace(result, trace=trace)
        return result

    def _execute_sharded(self, request: SearchRequest) -> SearchResult:
        D, Q, k = self.spec.n_shards, len(request), request.k
        with obs.span("plan") as psp:
            k_loc = min(self.spec.per_shard_k, k) if self.spec.per_shard_k \
                else k
            merge = resolve_merge(self.spec.merge, D) \
                if (self.mesh is not None and self.spec.merge != "host") \
                else "host"
            alive = self._alive()
            psp.set("merge", merge).set("k_loc", k_loc)
            psp.set("alive", int(alive.sum()))
        self._step += 1
        if self.rank is not None:
            return self._execute_rank(request, k_loc, merge, alive)
        if self._flat is not None and merge != "host":
            return self._execute_flat_fused(request, k_loc, merge, alive)

        ids = np.full((D, Q, k_loc), NO_EDGE, np.int64)
        dists = np.full((D, Q, k_loc), np.inf, np.float32)
        reports: List[ShardReport] = []
        variants: List[str] = []
        for i, shard in enumerate(self.shards):
            row = self._search_shard(i, request, k_loc, alive[i])
            if "ids" in row:
                ids[i], dists[i] = (_host(row.pop("ids")),
                                    _host(row.pop("dists")))
            variants.extend(row.pop("variants"))
            reports.append(ShardReport(shard=i, **row))
        with obs.span("merge") as msp:
            msp.set("schedule", merge)
            if merge == "host":
                gi, gd = _host_merge(ids, dists, k)
            else:
                gi, gd = sharded_topk_merge(self.mesh, ids, dists, k,
                                            axis=self.spec.corpus_axis,
                                            merge=merge, alive=alive)
            gi, gd = np.asarray(gi), np.asarray(gd)
        return self._result(request, gi, gd, reports, variants, merge)

    def _search_shard(self, i: int, request: SearchRequest, k_loc: int,
                      up: bool) -> dict:
        """Shard ``i``'s local answer: a dict of :class:`ShardReport`'s
        fields beside ``variants`` and, when it answered, ``ids`` /
        ``dists`` ((Q, k_loc) global ids). A lost shard is not searched; a
        shard whose search raises is an ``error``, never re-raised."""
        shard = self.shards[i]
        if not up:
            return dict(n=shard.n, route="lost", alive=False, k_fetched=0,
                        variants=[])
        t0 = time.perf_counter()
        ssp = obs.span(f"shard-{i}")
        try:
            li, ld, rep = self._run_shard(shard, request, k_loc)
        except Exception:
            # a shard raising mid-search is a lost shard, not a lost
            # request: sentinel rows, flagged, never re-raised
            ssp.set("alive", False).stop()
            return dict(n=shard.n, route="error", alive=False, k_fetched=0,
                        variants=[])
        route = rep.route if rep else "flat"
        ssp.set("n", shard.n).set("route", route)
        ssp.stop()
        self.heartbeats.ping(shard.name, self._step)
        return dict(n=shard.n, route=route, k_fetched=k_loc,
                    latency_s=time.perf_counter() - t0,
                    slot_count=rep.slot_count if rep else 0,
                    variants=list(rep.variants) if rep else [],
                    ids=li, dists=ld)

    def _result(self, request, gi, gd, reports, variants, merge):
        report = RouteReport(
            route="sharded", requested=request.route or "auto",
            est_selectivity=None,
            slot_count=sum(r.slot_count for r in reports),
            variants=tuple(variants), shards=tuple(reports),
            missing_shards=tuple(r.shard for r in reports if not r.alive),
            merge=merge)
        return SearchResult(gi, gd, report)

    def _execute_rank(self, request: SearchRequest, k_loc: int, merge: str,
                      alive: np.ndarray) -> SearchResult:
        """One rank's part of a request on a mesh of ranks: its own shard's
        search, the agreed alive mask and report rows, then the merge as
        collectives over ``corpus_axis``. The report's ``variants`` are
        this rank's own shard's."""
        r, Q, k = self.rank, len(request), request.k
        dev = self.device
        row = self._search_shard(r, request, k_loc, alive[r])
        li = torch.as_tensor(row.pop("ids", np.full((Q, k_loc), NO_EDGE,
                                                    np.int64)), device=dev)
        ld = torch.as_tensor(row.pop("dists", np.full((Q, k_loc), np.inf,
                                                      np.float32)),
                             device=dev)
        variants = row.pop("variants")
        rows = self._agree(row)
        live = np.array([x["alive"] for x in rows], bool)
        with obs.span("merge") as msp:
            msp.set("schedule", merge)
            if merge == "host":
                ax = self.spec.corpus_axis
                gi, gd = _host_merge(
                    coll.all_gather(li[None], self.mesh, ax, 0).cpu().numpy(),
                    coll.all_gather(ld[None], self.mesh, ax, 0).cpu().numpy(),
                    k)
            else:
                gi, gd = sharded_topk_merge(self.mesh, li, ld, k,
                                            axis=self.spec.corpus_axis,
                                            merge=merge, alive=live)
        reports = [ShardReport(shard=i, **x) for i, x in enumerate(rows)]
        return self._result(request, gi, gd, reports, variants, merge)

    def _agree(self, row: dict) -> List[dict]:
        """Every rank's report row, in shard order, on every rank: one
        ``all_gather`` of a fixed-width int64 row a rank (alive, n, route
        code in :data:`_REPORT_ROUTES`, k_fetched, slot_count, latency in
        microseconds)."""
        mine = torch.tensor([[int(row.get("alive", True)), row["n"],
                              _REPORT_ROUTES.index(row["route"]),
                              row["k_fetched"], row.get("slot_count", 0),
                              round(row.get("latency_s", 0.0) * 1e6)]],
                            dtype=torch.int64, device=self.device)
        got = coll.all_gather(mine, self.mesh, self.spec.corpus_axis, 0)
        return [dict(alive=bool(up), n=n, route=_REPORT_ROUTES[code],
                     k_fetched=kf, slot_count=slots, latency_s=us * 1e-6)
                for up, n, code, kf, slots, us in got.cpu().tolist()]

    # QueryEngine-compatible alias (RetrievalServer & co).
    def search(self, request: SearchRequest) -> SearchResult:
        return self.execute(request)

    def _run_shard(self, shard: _Shard, request: SearchRequest, k_loc: int):
        """One shard's local answer as (Q, k_loc) global ids and dists:
        tensors on the device in the flat layout, host arrays from an
        engine."""
        if shard.engine is None:      # flat layout: every shard's rows
            a = shard.id_offset if self.rank is None else 0  # or the rank's
            li, ld = local_flat_topk(
                *(t[a:a + shard.n] for t in self._flat),
                *self._query_tensors(request), mask=request.mask, k=k_loc,
                offset=shard.id_offset)
            return (*_pad_to_k(li, ld, k_loc), None)
        # the graph route's beam pool is ef wide; keep ef >= k' so the
        # narrowed fan-in never truncates below the requested width
        res = shard.engine.execute(dataclasses.replace(
            request, k=min(k_loc, max(shard.n, 1)),
            ef=max(request.ef, k_loc)))
        li, ld, rep = (np.asarray(res.ids, np.int64),
                       np.asarray(res.dists), res.report)
        if li.shape[1] < k_loc:      # tiny shard: pad to the uniform width
            pad = [(0, 0), (0, k_loc - li.shape[1])]
            li = np.pad(li, pad, constant_values=NO_EDGE)
            ld = np.pad(ld, pad, constant_values=np.inf)
        if shard.id_offset is not None:
            li = np.where(li >= 0, li + shard.id_offset, np.int64(NO_EDGE))
        return li, ld.astype(np.float32), rep

    def _query_tensors(self, request: SearchRequest):
        """The request's queries and float32 query endpoints on the
        device."""
        return (as_tensor(request.vectors, self.device,
                          torch.float32).contiguous(),
                as_tensor(request.qlo, self.device, torch.float32),
                as_tensor(request.qhi, self.device, torch.float32))

    def _execute_flat_fused(self, request: SearchRequest, k_loc: int,
                            merge: str, alive: np.ndarray) -> SearchResult:
        """The flat layout's one-call device path: shard-local exact scans
        and the merge in one :func:`sharded_flat_topk` call."""
        corpus, lo, hi = self._flat
        t0 = time.perf_counter()
        with obs.span("fused_scan") as fsp:
            fsp.set("merge", merge).set("shards", len(self.shards))
            gi, gd = sharded_flat_topk(
                self.mesh, corpus, lo, hi, *self._query_tensors(request),
                mask=request.mask, k=request.k,
                corpus_axis=self.spec.corpus_axis, merge=merge,
                per_shard_k=k_loc if k_loc < request.k else 0, alive=alive)
            gi = gi.cpu().numpy()
            gd = gd.cpu().numpy()
        lat = time.perf_counter() - t0
        now = time.time()
        for i, s in enumerate(self.shards):
            if alive[i]:
                self.heartbeats.ping(s.name, self._step, now=now)
        reports = tuple(
            ShardReport(shard=i, n=s.n,
                        route="flat" if alive[i] else "lost",
                        alive=bool(alive[i]),
                        k_fetched=k_loc if alive[i] else 0,
                        latency_s=lat / len(self.shards))
            for i, s in enumerate(self.shards))
        missing = tuple(int(i) for i in np.flatnonzero(~alive))
        report = RouteReport(
            route="sharded", requested=request.route or "auto",
            est_selectivity=None, slot_count=0, variants=(),
            shards=reports, missing_shards=missing, merge=merge)
        return SearchResult(gi, gd, report)
