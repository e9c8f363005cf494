"""SegmentedIndex — LSM-style streaming MSTG with upserts, deletes, flush,
and background-style compaction, on one device.

Layout (classic log-structured merge, specialized to the paper's index):

* **delta** (L0) — a mutable :class:`repro_torch.streaming.delta.DeltaBuffer`;
  upserts land here and are served by an exact predicate-masked brute scan.
* **segments** — immutable :class:`repro_torch.core.MSTGIndex` instances, each with
  a sorted ``ext_ids`` array mapping its internal rows to stable external
  ids, plus a per-segment *tombstone set* of external ids deleted after the
  segment froze. Frozen segments are bit-identical to a static build over
  the same rows — streaming never perturbs a frozen graph.
* ``flush()`` freezes the delta's live rows (canonically sorted by external
  id) into a new segment; ``compact()`` merges the smallest size tier
  (:class:`repro_torch.streaming.compaction.CompactionPolicy`), dropping tombstoned
  rows, into one rebuilt segment. After ``compact(full=True)`` with an empty
  delta, the single surviving segment **equals** ``MSTGIndex.build`` over the
  live corpus sorted by external id — bit-identical results on all routes.
  Segment construction honors the spec's ``builder`` knob: ``flush``/
  ``compact`` rebuilds run the bulk path by default (an order of magnitude
  cheaper, so compaction stalls shrink accordingly); pin
  ``IndexSpec(builder="incremental")`` to freeze with the paper-exact
  reference builder instead.

Search fans out: every live segment executes the request on its own cached
:class:`repro_torch.core.QueryEngine` (graph / pruned / flat / auto per segment),
over-fetching ``k + |segment tombstones|`` so tombstone filtering can never
evict a true neighbor, the delta is scanned exactly, and per-source top-k
lists are merged on host. Per-segment engines inherit the wavefront graph
loop — bit-packed visited bitmaps, chunked active-batch compaction, fanout
heuristics — and one :class:`repro_torch.core.EngineConfig` tunes it
fleet-wide (e.g. ``EngineConfig(graph_chunk=16, packed_visited=True)``); a
request's pinned ``fanout``/``chunk`` travel through the fan-out untouched.
The returned :class:`repro_torch.core.SearchResult` carries external ids
and a :class:`repro_torch.core.RouteReport` with one
:class:`repro_torch.core.SegmentReport` per source.

Every segment engine and the delta scan run on the index's one device
(``device=None`` means ``"cuda"`` and raises without a card). A segment's
engine stages its arrays on first use; :meth:`SegmentedIndex.compact` drops
the victims' engines, which frees their device tensors.

Persistence is a manifest directory (``manifest.json`` + immutable
per-segment ``.npz`` + ``delta.npz``): the manifest rename is the commit
point, so a crash mid-save never corrupts the previous artifact, and a
save/load round-trip (segments, tombstones, *and* the unflushed delta) is
bit-identical under search.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..checkpoint import index_io
from ..core.api import (IndexSpec, RouteReport, SearchRequest, SearchResult,
                        SegmentReport)
from ..core.engine import EngineConfig, QueryEngine, resolve_device
from ..core.hnsw import NO_EDGE
from ..core.mstg import MSTGIndex

from .compaction import CompactionPolicy
from .delta import DeltaBuffer

_MANIFEST_FORMAT = "mstg-segmented"
_MANIFEST_VERSION = 1
_SEGMENT_FORMAT = "mstg-segment"
DELTA = "delta"  # the _locate sentinel for "lives in the delta buffer"


@dataclasses.dataclass
class Segment:
    """One immutable MSTG segment plus its row->external-id map and the set
    of external ids tombstoned since it froze."""

    seg_id: str
    index: MSTGIndex
    ext_ids: np.ndarray            # (n,) int64, ascending
    tombs: set = dataclasses.field(default_factory=set)
    fingerprint: str = ""          # content digest, computed once on 1st save
    _tomb_arr: Optional[np.ndarray] = dataclasses.field(default=None,
                                                        repr=False)

    @property
    def n(self) -> int:
        return int(self.ext_ids.shape[0])

    @property
    def n_live(self) -> int:
        return self.n - len(self.tombs)

    def tomb_array(self) -> np.ndarray:
        """The tombstone set as an int64 array, cached between searches
        (tombs only ever grows, so a stale cache is detectable by length)."""
        if self._tomb_arr is None or self._tomb_arr.shape[0] != len(self.tombs):
            self._tomb_arr = np.fromiter(self.tombs, np.int64, len(self.tombs))
        return self._tomb_arr

    def live_rows(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(ext_ids, vectors, lo, hi) of non-tombstoned rows."""
        if self.tombs:
            alive = ~np.isin(self.ext_ids, self.tomb_array())
        else:
            alive = np.ones(self.n, bool)
        return (self.ext_ids[alive], self.index.vectors[alive],
                self.index.lo[alive], self.index.hi[alive])


def _fingerprint(index: MSTGIndex, ext_ids: np.ndarray) -> str:
    """Content digest of a segment (rows + ranges + ids + build spec). Part
    of the persisted filename, so two *different* segments that happen to
    share a counter-derived id (e.g. two SegmentedIndex instances saving
    into the same directory) can never silently reuse each other's file."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(ext_ids).tobytes())
    h.update(np.ascontiguousarray(index.vectors).tobytes())
    h.update(np.ascontiguousarray(index.lo).tobytes())
    h.update(np.ascontiguousarray(index.hi).tobytes())
    h.update(repr(sorted(index.spec.to_dict().items())).encode())
    return h.hexdigest()[:12]


def _merge_topk_host(ids_list: List[np.ndarray], d_list: List[np.ndarray],
                     Q: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-source ``(Q, k_i)`` top-k lists into ``(Q, k)``; stable in
    source order, so a single clean source passes through bit-identically."""
    widths = [i.shape[1] for i in ids_list]
    if not ids_list or sum(widths) == 0:
        return (np.full((Q, k), NO_EDGE, np.int64),
                np.full((Q, k), np.inf, np.float32))
    ids = np.concatenate([np.asarray(i, np.int64) for i in ids_list], axis=1)
    d = np.concatenate([np.asarray(x, np.float32) for x in d_list], axis=1)
    if ids.shape[1] < k:
        pad = k - ids.shape[1]
        ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=NO_EDGE)
        d = np.pad(d, ((0, 0), (0, pad)), constant_values=np.inf)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(ids, order, 1), np.take_along_axis(d, order, 1)


class SegmentedIndex:
    """Streaming MSTG: delta buffer + immutable segments + tombstones.

    Parameters
    ----------
    spec : IndexSpec
        Build configuration shared by every frozen segment (variants, m,
        ef_con, ...). Defaults to ``IndexSpec()`` (any-overlap variants).
    policy : CompactionPolicy
        Victim selection for :meth:`compact`.
    flush_threshold : int, optional
        Auto-flush the delta into a segment once its live size reaches this
        (None = flush only on explicit :meth:`flush` / :meth:`save`).
    engine_config : EngineConfig, optional
        Shared config for every per-segment :class:`QueryEngine` (route,
        flat_threshold, ...). Defaults to ``EngineConfig()``.
    build_workers : int
        Process-pool width for segment freezes (:meth:`flush` /
        :meth:`compact` — a freeze builds the spec's variants, which are
        independent). ``0``/``1`` = serial. An execution resource, not
        index state: it never changes the frozen segment.
    device : str | torch.device, optional
        Where every segment engine and the delta scan run. ``None`` means
        ``"cuda"`` and raises ``RuntimeError`` when no card is present.
    """

    def __init__(self, spec: Optional[IndexSpec] = None, *,
                 policy: Optional[CompactionPolicy] = None,
                 flush_threshold: Optional[int] = None,
                 engine_config: Optional[EngineConfig] = None,
                 build_workers: int = 0, device=None):
        self.device = resolve_device(device)
        self.spec = spec if spec is not None else IndexSpec()
        self.policy = policy or CompactionPolicy()
        self.flush_threshold = flush_threshold
        self.build_workers = int(build_workers)
        self.engine_config = (engine_config if engine_config is not None
                              else EngineConfig())
        self.delta = DeltaBuffer()
        self.segments: List[Segment] = []
        self.ops = {"adds": 0, "deletes": 0, "flushes": 0, "compactions": 0}
        self._seg_counter = 0
        self._locate: Dict[int, str] = {}      # live ext id -> seg_id | DELTA
        self._engines: Dict[str, QueryEngine] = {}

    # ---- sizes / lookup ----
    def __len__(self) -> int:
        """Live objects across segments + delta."""
        return sum(s.n_live for s in self.segments) + len(self.delta)

    def __contains__(self, ext_id: int) -> bool:
        return int(ext_id) in self._locate

    def _segment(self, seg_id: str) -> Segment:
        for s in self.segments:
            if s.seg_id == seg_id:
                return s
        raise KeyError(seg_id)

    def stats(self) -> dict:
        # per-tier bytes: frozen segments quantize at freeze time (they
        # inherit spec.storage_dtype); the delta buffer stays exact float32
        # until its rows reach a segment, so it reports codes=0
        seg_sb = [s.index.storage_bytes() for s in self.segments]
        delta_sb = self.delta.bytes_breakdown()
        scan = delta_sb["scan_bytes"] + sum(b["scan_bytes"] for b in seg_sb)
        full = delta_sb["float32_rerank"] + sum(b["float32_rerank"]
                                                for b in seg_sb)
        return {
            "n_live": len(self),
            "delta": len(self.delta),
            "delta_dead": self.delta.n_dead,
            "tombstones": sum(len(s.tombs) for s in self.segments),
            "segments": [{"id": s.seg_id, "n": s.n, "live": s.n_live,
                          "tombstones": len(s.tombs),
                          "storage_bytes": sb}
                         for s, sb in zip(self.segments, seg_sb)],
            "ops": dict(self.ops),
            "storage_dtype": self.spec.storage_dtype,
            "storage_bytes": {
                "codes": sum(b["codes"] for b in seg_sb),
                "scales": sum(b["scales"] for b in seg_sb),
                "sq_norm": sum(b["sq_norm"] for b in seg_sb),
                "float32_rerank": full,
                "scan_bytes": scan,
                "compression_ratio": full / max(scan, 1),
            },
        }

    # ---- mutation ----
    def _discard(self, ext_id: int) -> bool:
        """Drop the live copy of ``ext_id`` wherever it is; False if absent."""
        loc = self._locate.pop(ext_id, None)
        if loc is None:
            return False
        if loc == DELTA:
            self.delta.kill(ext_id)
        else:
            self._segment(loc).tombs.add(ext_id)
        return True

    def add(self, ext_ids, vectors, lo, hi) -> None:
        """Upsert a batch: ``(B,)`` stable external ids, ``(B, d)`` vectors,
        ``(B,)`` range endpoints. An id that is already live anywhere (delta
        or a frozen segment) is atomically replaced."""
        # validate BEFORE discarding old copies: a rejected batch must not
        # tombstone/kill the rows it failed to replace
        ext_ids, vectors, lo, hi = DeltaBuffer.validate(
            ext_ids, vectors, lo, hi, d=self.delta.d)
        for e in ext_ids:
            self._discard(int(e))
        self.delta._append(ext_ids, vectors, lo, hi)
        for e in ext_ids:
            self._locate[int(e)] = DELTA
        self.ops["adds"] += len(ext_ids)
        if (self.flush_threshold is not None
                and len(self.delta) >= self.flush_threshold):
            self.flush()

    upsert = add

    def delete(self, ext_ids, strict: bool = True) -> int:
        """Delete by external id (tombstone for frozen rows, in-place kill for
        delta rows). Unknown ids raise ``KeyError`` unless ``strict=False``.
        Returns the number of objects actually deleted."""
        ext_ids = np.atleast_1d(np.asarray(ext_ids, np.int64)).ravel()
        done = 0
        for e in ext_ids:
            if self._discard(int(e)):
                done += 1
            elif strict:
                raise KeyError(f"external id {int(e)} is not live in the index")
        self.ops["deletes"] += done
        return done

    # ---- lifecycle ----
    def _next_seg_id(self) -> str:
        self._seg_counter += 1
        return f"seg-{self._seg_counter:06d}"

    def _freeze(self, ext: np.ndarray, vecs: np.ndarray, lo: np.ndarray,
                hi: np.ndarray) -> Segment:
        """Build one immutable segment over rows *sorted by external id* (the
        canonical order, so a fully compacted index is bit-identical to a
        static ``MSTGIndex.build`` over the same corpus)."""
        order = np.argsort(ext, kind="stable")
        seg = Segment(self._next_seg_id(),
                      MSTGIndex.build(self.spec, vecs[order], lo[order],
                                      hi[order], workers=self.build_workers),
                      np.ascontiguousarray(ext[order], np.int64))
        self.segments.append(seg)
        for e in seg.ext_ids:
            self._locate[int(e)] = seg.seg_id
        return seg

    def flush(self) -> Optional[str]:
        """Freeze the delta's live rows into a new immutable segment.
        No-op (returns None) on an empty delta."""
        if len(self.delta) == 0:
            return None
        with obs.span("flush") as fsp:
            ext, vecs, lo, hi = self.delta.live()
            fsp.set("rows", int(ext.shape[0]))
            seg = self._freeze(ext, vecs, lo, hi)
            fsp.set("segment", seg.seg_id)
        self.delta.clear()
        self.ops["flushes"] += 1
        return seg.seg_id

    def compact(self, full: bool = False) -> dict:
        """Merge segments (dropping tombstoned rows) into one rebuilt segment.

        ``full=False`` asks the :class:`CompactionPolicy` for the smallest
        size tier; ``full=True`` merges everything. Idempotent: a single
        tombstone-free victim is left alone."""
        if full:
            victims = list(self.segments)
        else:
            victims = [self.segments[i]
                       for i in self.policy.pick([s.n_live
                                                  for s in self.segments])]
        if not victims or (len(victims) == 1 and not victims[0].tombs):
            return {"merged": [], "new_segment": None, "rows": 0, "dropped": 0}
        csp = obs.span("compact")
        csp.set("victims", len(victims))
        parts = [s.live_rows() for s in victims]
        ext = np.concatenate([p[0] for p in parts])
        dropped = sum(len(s.tombs) for s in victims)
        victim_ids = [s.seg_id for s in victims]
        pos = self.segments.index(victims[0])
        for s in victims:
            self.segments.remove(s)
            self._engines.pop(s.seg_id, None)
        new_id = None
        if ext.size:
            vecs = np.concatenate([p[1] for p in parts])
            lo = np.concatenate([p[2] for p in parts])
            hi = np.concatenate([p[3] for p in parts])
            seg = self._freeze(ext, vecs, lo, hi)
            # keep the merged segment at the first victim's position so
            # source order (merge tie-breaks) stays deterministic
            self.segments.remove(seg)
            self.segments.insert(pos, seg)
            new_id = seg.seg_id
        self.ops["compactions"] += 1
        csp.set("rows", int(ext.size)).set("dropped", dropped).stop()
        return {"merged": victim_ids, "new_segment": new_id,
                "rows": int(ext.size), "dropped": dropped}

    # ---- search ----
    def _engine(self, seg: Segment) -> QueryEngine:
        if seg.seg_id not in self._engines:
            self._engines[seg.seg_id] = QueryEngine(
                seg.index, config=self.engine_config, device=self.device)
        return self._engines[seg.seg_id]

    def execute(self, request: SearchRequest) -> SearchResult:
        """Fan the request out across live segments + delta, filter
        tombstones, merge per-source top-k. Result ids are EXTERNAL ids."""
        if not isinstance(request, SearchRequest):
            raise TypeError("SegmentedIndex serves the declarative API only; "
                            "pass a repro_torch.core.SearchRequest")
        tracer = obs.begin_request_trace() if request.trace else None
        try:
            with obs.span("segmented_search") as root:
                root.set("Q", len(request)).set("k", request.k)
                root.set("segments", len(self.segments))
                result = self._execute_fanout(request)
        finally:
            trace = obs.end_request_trace(tracer)
        if trace is not None:
            result = dataclasses.replace(result, trace=trace)
        return result

    def _execute_fanout(self, request: SearchRequest) -> SearchResult:
        Q, k = len(request), request.k
        ids_list: List[np.ndarray] = []
        d_list: List[np.ndarray] = []
        seg_reports: List[SegmentReport] = []
        slot_count = hits = misses = 0
        variants: List[str] = []
        for seg in self.segments:
            k_eff = min(k + len(seg.tombs), seg.n)
            # the graph route's beam pool is ef wide — raise ef with k_eff or
            # the over-fetch would silently truncate to ef columns and
            # tombstone filtering could evict true neighbors after all
            with obs.span(f"segment-{seg.seg_id}") as ssp:
                res = self._engine(seg).execute(dataclasses.replace(
                    request, k=k_eff, ef=max(request.ef, k_eff)))
                if obs.tracing():
                    ssp.set("n", seg.n).set("route", res.report.route)
                    ssp.set("tombstones", len(seg.tombs))
                ext = np.where(res.ids >= 0,
                               seg.ext_ids[np.clip(res.ids, 0, None)],
                               np.int64(NO_EDGE))
                dists = np.asarray(res.dists, np.float32)
                if seg.tombs:
                    dead = np.isin(ext, seg.tomb_array())
                    ext = np.where(dead, np.int64(NO_EDGE), ext)
                    dists = np.where(dead, np.float32(np.inf), dists)
            ids_list.append(ext)
            d_list.append(dists)
            rep = res.report
            slot_count += rep.slot_count
            hits += rep.cache_hits
            misses += rep.cache_misses
            variants.extend(rep.variants)
            seg_reports.append(SegmentReport(
                segment=seg.seg_id, n=seg.n, route=rep.route, k_fetched=k_eff,
                tombstones=len(seg.tombs), slot_count=rep.slot_count))
        if len(self.delta):
            with obs.span("delta") as dsp:
                dsp.set("n", len(self.delta))
                ext, dists = self.delta.search(
                    request.vectors, request.qlo, request.qhi, request.mask,
                    k, device=self.device)
            ids_list.append(ext)
            d_list.append(dists)
            seg_reports.append(SegmentReport(
                segment=DELTA, n=len(self.delta), route=DELTA,
                k_fetched=ext.shape[1]))
        with obs.span("merge"):
            ids, dists = _merge_topk_host(ids_list, d_list, Q, k)
        report = RouteReport(
            route="segmented", requested=request.route or "auto",
            est_selectivity=None, slot_count=slot_count,
            variants=tuple(variants), cache_hits=hits, cache_misses=misses,
            segments=tuple(seg_reports))
        return SearchResult(ids, dists, report)

    # QueryEngine-compatible declarative entry point (RetrievalServer & co).
    def search(self, request: SearchRequest) -> SearchResult:
        return self.execute(request)

    # ---- persistence (manifest directory) ----
    def save(self, root: str) -> str:
        """Persist segments + tombstones + the *unflushed* delta to a manifest
        directory. Per-segment files are immutable and written before the
        atomic ``manifest.json`` rename (the commit point); unreferenced
        files are garbage-collected afterwards. Returns the manifest path."""
        root = os.fspath(root)
        seg_dir = os.path.join(root, "segments")
        os.makedirs(seg_dir, exist_ok=True)
        seg_entries = []
        referenced = set()
        for seg in self.segments:
            if not seg.fingerprint:  # immutable content: hash at most once
                seg.fingerprint = _fingerprint(seg.index, seg.ext_ids)
            fname = f"{seg.seg_id}-{seg.fingerprint}.npz"
            fpath = os.path.join(seg_dir, fname)
            # content-named + immutable: an existing file with this exact
            # name is guaranteed to hold this segment's data, so repeated
            # saves skip the write; a same-id-different-content collision
            # (another index saving into this directory) gets its own file
            if not os.path.exists(fpath):
                arrays, meta = seg.index.to_payload()
                arrays["ext_ids"] = seg.ext_ids
                meta["segment"] = {"format": _SEGMENT_FORMAT, "id": seg.seg_id}
                index_io.save_npz_atomic(fpath, arrays, meta)
            referenced.add(fname)
            seg_entries.append({"id": seg.seg_id,
                                "file": f"segments/{fname}", "n": seg.n,
                                "tombstones": sorted(int(e)
                                                     for e in seg.tombs)})
        delta_entry = None
        if len(self.delta):
            ext, vecs, lo, hi = self.delta.live()
            h = hashlib.sha1()
            for a in (ext, vecs, lo, hi):
                h.update(np.ascontiguousarray(a).tobytes())
            # content-named like segment files: never overwrite a file the
            # previous manifest still references (crash between delta write
            # and manifest rename must leave the old artifact loadable)
            dname = f"delta-{h.hexdigest()[:12]}.npz"
            dpath = os.path.join(root, dname)
            if not os.path.exists(dpath):
                index_io.save_npz_atomic(
                    dpath, {"ext_ids": ext, "vectors": vecs,
                            "lo": lo, "hi": hi},
                    {"format": "mstg-delta", "n": int(len(ext))})
            delta_entry = {"file": dname, "n": int(len(ext))}
        manifest = {"format": _MANIFEST_FORMAT,
                    "format_version": _MANIFEST_VERSION,
                    "spec": self.spec.to_dict(),
                    "seg_counter": self._seg_counter,
                    "segments": seg_entries, "delta": delta_entry,
                    "ops": dict(self.ops)}
        path = index_io.save_manifest_atomic(root, manifest)
        index_io.gc_unreferenced(root, referenced)
        keep = delta_entry["file"] if delta_entry else None
        for name in os.listdir(root):  # stale delta files from prior saves
            if (name.startswith("delta") and name.endswith(".npz")
                    and name != keep):
                os.unlink(os.path.join(root, name))
        return path

    @classmethod
    def load(cls, root: str, *, policy: Optional[CompactionPolicy] = None,
             flush_threshold: Optional[int] = None,
             engine_config: Optional[EngineConfig] = None,
             device=None) -> "SegmentedIndex":
        """Restore a :meth:`save` directory — segments, tombstones, and the
        unflushed delta — with bit-identical search results, served on
        ``device``."""
        root = os.fspath(root)
        manifest = index_io.load_manifest(root)
        if manifest.get("format") != _MANIFEST_FORMAT:
            raise index_io.IndexIOError(
                f"{root}: not a {_MANIFEST_FORMAT} manifest")
        self = cls(IndexSpec.from_dict(manifest["spec"]), policy=policy,
                   flush_threshold=flush_threshold,
                   engine_config=engine_config, device=device)
        self._seg_counter = int(manifest.get("seg_counter", 0))
        self.ops.update(manifest.get("ops", {}))
        for entry in manifest["segments"]:
            fpath = os.path.join(root, entry["file"])
            arrays, meta = index_io.load_npz(fpath)
            index = MSTGIndex.from_payload(arrays, meta, path=fpath)
            ext_ids = np.asarray(index_io.take(arrays, "ext_ids", fpath),
                                 np.int64)
            if ext_ids.shape[0] != index.vectors.shape[0]:
                raise index_io.IndexIOError(
                    f"{fpath}: ext_ids rows != index rows")
            seg = Segment(entry["id"], index, ext_ids,
                          set(int(e) for e in entry.get("tombstones", ())))
            self.segments.append(seg)
            for e in seg.ext_ids:
                if int(e) not in seg.tombs:
                    self._locate[int(e)] = seg.seg_id
        if manifest.get("delta"):
            fpath = os.path.join(root, manifest["delta"]["file"])
            arrays, meta = index_io.load_npz(fpath)
            if meta.get("format") != "mstg-delta":
                raise index_io.IndexIOError(f"{fpath}: not a delta artifact")
            ext = np.asarray(index_io.take(arrays, "ext_ids", fpath), np.int64)
            self.delta.add(ext, index_io.take(arrays, "vectors", fpath),
                           index_io.take(arrays, "lo", fpath),
                           index_io.take(arrays, "hi", fpath))
            for e in ext:
                self._locate[int(e)] = DELTA
        return self
