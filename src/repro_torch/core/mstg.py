"""MSTG — multi-segment tree graph index (paper §4, Algorithms 1–3).

Build is host-side, in ascending order of the variant's sort key; each object
touches the O(log|A|) segment-tree nodes on the root->leaf path of its tree
key (Algorithm 1), each touched node's labeled HNSW absorbs the vector
(Algorithm 3). Path-copying/persistence (§4.2) and label compression (§4.3)
collapse into the per-level labeled graphs of :mod:`repro_torch.core.hnsw` — nothing
is ever duplicated, labels recover any version (Theorem D.1).

Two construction paths produce the same frozen schema (``builder`` knob):

* ``"bulk"`` (default) — :mod:`repro_torch.core.build`: sorted-order batches,
  candidate generation via batched distance matmuls shared across the
  ``Lv`` levels of each object's tree path, batched RNG pruning, deferred
  per-batch re-pruning. ~an order of magnitude faster; edge labels are a
  superset of the incremental ones (recall preserved at every version).
* ``"incremental"`` — the paper-exact reference oracle: one beam-search
  insertion per (object, level), per-insertion re-pruning, exact Theorem
  D.1 labels. Kept selectable for equivalence tests and faithfulness runs.

The frozen index is a set of dense arrays per variant (DESIGN.md §2):

    nbr/lab_b/lab_e : (Lv, n, S)   per-level labeled adjacency
    sort_rank       : (n,)         version rank of each object (variant space)
    tkey            : (n,)         tree-key rank of each object
    entry_ids/ver   : (Lv, Kpad, E) per-(level,node) entry points
    members/mem_ver : (Lv, n)      per-level ids grouped by node, insertion order
    node_off        : (Lv, Kpad+1) member offsets per (level, node)

Three variants (§4.4): T (asc-l, tree on r), Tp (desc-r, tree on l),
Tpp (desc-l, tree on r). ``MSTGIndex`` builds the variants a predicate mask
needs and plans queries via Theorem 4.1.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint import index_io

from . import intervals as iv
from . import segment_tree as st
from .api import IndexSpec
from .build import BUILDERS, bulk_insert_levels
from .parallel import pool_size, run_build_pool
from .hnsw import OPEN, NO_EDGE, LabeledLevelGraph
from .predicates import Predicate, as_mask
from .quant import QuantizedStore, check_storage_dtype, maybe_quantize

from repro_torch.obs.log import get_logger

logger = get_logger(__name__)

# FrozenVariant array fields, in the order they are persisted.
_FV_ARRAYS = ("sort_rank", "tkey", "nbr", "lab_b", "lab_e",
              "entry_ids", "entry_ver", "members", "member_ver", "node_off")
_INDEX_FORMAT = "mstg-index"
_INDEX_FORMAT_VERSION = 1


@dataclasses.dataclass
class FrozenVariant:
    variant: str
    K: int
    Kpad: int
    Lv: int
    n: int
    sort_rank: np.ndarray
    tkey: np.ndarray
    nbr: np.ndarray
    lab_b: np.ndarray
    lab_e: np.ndarray
    entry_ids: np.ndarray
    entry_ver: np.ndarray
    members: np.ndarray
    member_ver: np.ndarray
    node_off: np.ndarray

    def nbytes(self) -> int:
        return sum(getattr(self, f).nbytes for f in
                   ("sort_rank", "tkey", "nbr", "lab_b", "lab_e",
                    "entry_ids", "entry_ver", "members", "member_ver", "node_off"))

    def live_edges(self) -> int:
        return int((self.nbr != NO_EDGE).sum())


def _variant_ranks(variant: str, rl: np.ndarray, rr: np.ndarray, K: int):
    top = K - 1
    if variant == iv.VARIANT_T:
        return rl.astype(np.int32), rr.astype(np.int32)
    if variant == iv.VARIANT_TP:
        return (top - rr).astype(np.int32), rl.astype(np.int32)
    if variant == iv.VARIANT_TPP:
        return (top - rl).astype(np.int32), rr.astype(np.int32)
    raise ValueError(f"unknown variant {variant}")


def _insert_incremental(vectors: np.ndarray, order: np.ndarray,
                        sort_rank: np.ndarray, tkey: np.ndarray, Lv: int, *,
                        m: int, ef_con: int, m_max: Optional[int],
                        n_entries: int, progress: Optional[int],
                        variant: str) -> List[LabeledLevelGraph]:
    """The paper-exact oracle: one beam-search insertion per (object, level)
    (Algorithm 3 verbatim), per-insertion RNG re-pruning, exact labels."""
    n = int(order.shape[0])
    levels = [LabeledLevelGraph(vectors, m=m, ef_con=ef_con, m_max=m_max,
                                n_entries=n_entries) for _ in range(Lv)]
    t0 = time.perf_counter()
    for i, u in enumerate(order):
        u = int(u)
        ver = int(sort_rank[u])
        key = int(tkey[u])
        for lvl in range(Lv):
            node = key >> (Lv - 1 - lvl)
            levels[lvl].insert(u, node, ver)
        if progress and (i + 1) % progress == 0:
            logger.progress("insert", variant=variant, done=i + 1, total=n,
                            elapsed_s=time.perf_counter() - t0,
                            final=(i + 1 == n))
    return levels


def build_scan_variant(rl: np.ndarray, rr: np.ndarray, K: int, variant: str,
                       n_entries: int = 4) -> FrozenVariant:
    """Scan-only MSTG construction (``builder="scan"``): the segment-tree
    member structure — members grouped per node in ascending version order,
    node offsets, entry seeds — without building any level graphs.

    The pruned route only touches ``members``/``member_ver``/``node_off``/
    ``sort_rank`` (plus the planner's domain), so this is everything it
    needs, built in O(Lv * n log n) numpy instead of the superlinear graph
    insertion pipeline — which makes pruned scans at n >= 100k feasible
    (the full build is ~108 s at n=20k). Adjacency freezes as a single
    all-``NO_EDGE`` slot: the *graph* route degrades to ranking the entry
    seeds and is not meaningfully served by a scan-built variant.
    """
    n = int(rl.shape[0])
    Kpad = st.padded_domain(K)
    Lv = st.num_levels(Kpad)
    E = n_entries
    sort_rank, tkey = _variant_ranks(variant, rl, rr, K)
    order = np.argsort(sort_rank, kind="stable")
    nbr = np.full((Lv, n, 1), NO_EDGE, np.int32)
    lab_b = np.zeros((Lv, n, 1), np.int32)
    lab_e = np.zeros((Lv, n, 1), np.int32)
    entry_ids = np.full((Lv, Kpad, E), NO_EDGE, np.int32)
    entry_ver = np.full((Lv, Kpad, E), OPEN, np.int32)
    members = np.zeros((Lv, n), np.int32)
    member_ver = np.full((Lv, n), OPEN, np.int32)
    node_off = np.zeros((Lv, Kpad + 1), np.int32)
    tk = tkey.astype(np.int64)
    for lvl in range(Lv):
        node = tk >> (Lv - 1 - lvl)
        # stable sort of the version-ordered rows by node keeps each node's
        # slice in ascending version order — the prefix invariant the
        # pruned scan's binary search relies on
        mem = order[np.argsort(node[order], kind="stable")]
        members[lvl] = mem
        member_ver[lvl] = sort_rank[mem]
        counts = np.bincount(node, minlength=Kpad)[:Kpad]
        node_off[lvl, 1:] = np.cumsum(counts).astype(np.int32)
        starts = node_off[lvl, :Kpad].astype(np.int64)
        for e_i in range(E):
            hasm = counts > e_i
            entry_ids[lvl, hasm, e_i] = members[lvl][starts[hasm] + e_i]
            entry_ver[lvl, hasm, e_i] = member_ver[lvl][starts[hasm] + e_i]
    return FrozenVariant(variant=variant, K=K, Kpad=Kpad, Lv=Lv, n=n,
                         sort_rank=sort_rank, tkey=tkey, nbr=nbr, lab_b=lab_b,
                         lab_e=lab_e, entry_ids=entry_ids, entry_ver=entry_ver,
                         members=members, member_ver=member_ver,
                         node_off=node_off)


def build_variant(vectors: np.ndarray, rl: np.ndarray, rr: np.ndarray, K: int,
                  variant: str, m: int = 16, ef_con: int = 100,
                  m_max: Optional[int] = None, n_entries: int = 4,
                  progress: Optional[int] = None, builder: str = "bulk",
                  batch_size: Optional[int] = None,
                  candidate_stage: str = "exact",
                  n_clusters: Optional[int] = None, n_probe: int = 8,
                  coarse_threshold: Optional[int] = None,
                  stats: Optional[dict] = None) -> FrozenVariant:
    """Algorithms 1+2: MSTG construction for one variant.

    ``builder="bulk"`` (default) batches candidate generation and pruning
    (:mod:`repro_torch.core.build`); ``builder="incremental"`` is the paper-exact
    per-object reference path. Both freeze to the identical array schema.
    ``candidate_stage``/``n_clusters``/``n_probe``/``coarse_threshold``
    tune the bulk path's candidate generator (exact all-pairs vs coarse
    quantizer); ``stats`` (a dict) collects its wall-clock stage breakdown.
    """
    if builder == "scan":
        return build_scan_variant(rl, rr, K, variant, n_entries=n_entries)
    n = vectors.shape[0]
    Kpad = st.padded_domain(K)
    Lv = st.num_levels(Kpad)
    sort_rank, tkey = _variant_ranks(variant, rl, rr, K)
    order = np.argsort(sort_rank, kind="stable")

    if builder == "bulk":
        levels = bulk_insert_levels(vectors, order, sort_rank, tkey, Lv, m=m,
                                    ef_con=ef_con, m_max=m_max,
                                    n_entries=n_entries, batch_size=batch_size,
                                    progress=progress, variant=variant,
                                    candidate_stage=candidate_stage,
                                    n_clusters=n_clusters, n_probe=n_probe,
                                    coarse_threshold=coarse_threshold,
                                    stats=stats)
    elif builder == "incremental":
        levels = _insert_incremental(vectors, order, sort_rank, tkey, Lv, m=m,
                                     ef_con=ef_con, m_max=m_max,
                                     n_entries=n_entries, progress=progress,
                                     variant=variant)
    else:
        raise ValueError(f"unknown builder {builder!r}; expected one of "
                         f"{BUILDERS}")

    # freeze adjacency with a uniform slot count across levels
    t0 = time.perf_counter()
    S = max(max(g.max_slots(n) for g in levels), 1)
    nbr = np.empty((Lv, n, S), dtype=np.int32)
    lab_b = np.empty((Lv, n, S), dtype=np.int32)
    lab_e = np.empty((Lv, n, S), dtype=np.int32)
    for lvl, g in enumerate(levels):
        g.freeze(n, slots=S, out=(nbr[lvl], lab_b[lvl], lab_e[lvl]))
    if stats is not None:
        stats["freeze_s"] = (stats.get("freeze_s", 0.0)
                             + time.perf_counter() - t0)
        stats["slots"] = S

    t0 = time.perf_counter()
    E = n_entries
    entry_ids = np.full((Lv, Kpad, E), NO_EDGE, dtype=np.int32)
    entry_ver = np.full((Lv, Kpad, E), OPEN, dtype=np.int32)
    members = np.zeros((Lv, n), dtype=np.int32)
    member_ver = np.full((Lv, n), OPEN, dtype=np.int32)
    node_off = np.zeros((Lv, Kpad + 1), dtype=np.int32)
    for lvl, g in enumerate(levels):
        pos = 0
        counts = np.zeros(Kpad + 1, dtype=np.int64)
        for node in range(1 << lvl):
            mem = g.node_members.get(node, [])
            counts[node] = len(mem)
            if mem:
                vers = g.node_member_vers[node]
                members[lvl, pos:pos + len(mem)] = mem
                member_ver[lvl, pos:pos + len(mem)] = vers
                pos += len(mem)
                ent = mem[:E]
                entry_ids[lvl, node, :len(ent)] = ent
                entry_ver[lvl, node, :len(ent)] = vers[:len(ent)]
        node_off[lvl, 1:] = np.cumsum(counts[:-1])[:Kpad]
    if stats is not None:
        stats["pack_s"] = (stats.get("pack_s", 0.0)
                           + time.perf_counter() - t0)
    return FrozenVariant(variant=variant, K=K, Kpad=Kpad, Lv=Lv, n=n,
                         sort_rank=sort_rank, tkey=tkey, nbr=nbr, lab_b=lab_b,
                         lab_e=lab_e, entry_ids=entry_ids, entry_ver=entry_ver,
                         members=members, member_ver=member_ver, node_off=node_off)


def _variant_build_task(args):
    """Module-level worker body for parallel variant builds (spawn-context
    process pools need a picklable, importable callable)."""
    vectors, rl, rr, K, v, kwargs = args
    stats: dict = {}
    t0 = time.perf_counter()
    fv = build_variant(vectors, rl, rr, K, v, stats=stats, **kwargs)
    return v, fv, stats, time.perf_counter() - t0


class MSTGIndex:
    """The paper's index: builds the variants required by a predicate mask and
    plans queries per Theorem 4.1. Search execution lives in
    :mod:`repro_torch.core.search` (graph engine) and :mod:`repro_torch.core.flat` (exact
    block engine)."""

    def __init__(self, vectors: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                 mask: int = iv.ANY_OVERLAP, variants: Optional[Sequence[str]] = None,
                 m: int = 16, ef_con: int = 100, m_max: Optional[int] = None,
                 n_entries: int = 4, domain: Optional[iv.AttributeDomain] = None,
                 progress: Optional[int] = None, builder: str = "bulk",
                 batch_size: Optional[int] = None,
                 storage_dtype: str = "float32",
                 candidate_stage: str = "exact",
                 n_clusters: Optional[int] = None, n_probe: int = 8,
                 coarse_threshold: Optional[int] = None, workers: int = 0):
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        lo = np.asarray(lo, dtype=np.float64)
        hi = np.asarray(hi, dtype=np.float64)
        mask = as_mask(mask)  # Predicate | int | str, like every other entry
        if np.any(lo > hi):
            raise ValueError("object ranges must satisfy lo <= hi")
        self.vectors = vectors
        self.lo, self.hi = lo, hi
        self.domain = domain or iv.AttributeDomain.from_ranges(lo, hi)
        self.rl = self.domain.rank(lo)
        self.rr = self.domain.rank(hi)
        storage_dtype = check_storage_dtype(storage_dtype)
        self.params = dict(m=m, ef_con=ef_con, m_max=m_max, n_entries=n_entries,
                           builder=builder, batch_size=batch_size,
                           candidate_stage=candidate_stage,
                           n_clusters=n_clusters, n_probe=n_probe,
                           coarse_threshold=coarse_threshold)
        # quantize at build time (per index / per streaming segment — the
        # scales fit THIS corpus); None for float32
        self.storage = maybe_quantize(vectors, storage_dtype)
        if variants is None:
            variants = iv.variants_required(mask if mask else iv.ANY_OVERLAP)
        self.spec = IndexSpec(predicate=Predicate(mask), variants=tuple(variants),
                              m=m, ef_con=ef_con, m_max=m_max,
                              n_entries=n_entries, builder=builder,
                              batch_size=batch_size,
                              storage_dtype=storage_dtype,
                              candidate_stage=candidate_stage,
                              n_clusters=n_clusters, n_probe=n_probe,
                              coarse_threshold=coarse_threshold)
        self.build_seconds: Dict[str, float] = {}
        self.build_stats: Dict[str, dict] = {}
        self.build_workers = 0
        self.variants: Dict[str, FrozenVariant] = {}
        bv_kwargs = dict(m=m, ef_con=ef_con, m_max=m_max, n_entries=n_entries,
                         progress=progress, builder=builder,
                         batch_size=batch_size,
                         candidate_stage=candidate_stage,
                         n_clusters=n_clusters, n_probe=n_probe,
                         coarse_threshold=coarse_threshold)
        vlist = list(variants)
        results = run_build_pool(
            _variant_build_task,
            [(vectors, self.rl, self.rr, self.domain.K, v, bv_kwargs)
             for v in vlist],
            workers=int(workers or 0), label="variant")
        if results is not None:
            self.build_workers = pool_size(int(workers), len(vlist))
            for v, fv, stats, secs in results:
                self.variants[v] = fv
                self.build_stats[v] = stats
                self.build_seconds[v] = secs
        else:
            for v in vlist:
                stats: dict = {}
                t0 = time.perf_counter()
                self.variants[v] = build_variant(
                    vectors, self.rl, self.rr, self.domain.K, v, stats=stats,
                    **bv_kwargs)
                self.build_seconds[v] = time.perf_counter() - t0
                self.build_stats[v] = stats

    # ---- lifecycle ----
    @classmethod
    def build(cls, spec: IndexSpec, vectors: np.ndarray, lo: np.ndarray,
              hi: np.ndarray, domain: Optional[iv.AttributeDomain] = None,
              progress: Optional[int] = None, workers: int = 0) -> "MSTGIndex":
        """Declarative construction from an :class:`repro_torch.core.api.IndexSpec`:
        the spec's predicate decides which variants are built (unless pinned),
        and the spec travels with the index through ``save()``/``load()``.
        ``workers > 1`` builds independent variants in a spawn process pool
        (an execution resource, so it is an argument here — not spec state)."""
        return cls(vectors, lo, hi, mask=spec.predicate.mask,
                   variants=spec.variants, m=spec.m, ef_con=spec.ef_con,
                   m_max=spec.m_max, n_entries=spec.n_entries,
                   domain=domain, progress=progress, builder=spec.builder,
                   batch_size=spec.batch_size,
                   storage_dtype=spec.storage_dtype,
                   candidate_stage=spec.candidate_stage,
                   n_clusters=spec.n_clusters, n_probe=spec.n_probe,
                   coarse_threshold=spec.coarse_threshold, workers=workers)

    def to_payload(self) -> Tuple[Dict[str, np.ndarray], dict]:
        """The persisted form: (arrays, meta). Embedders (e.g. the streaming
        segment format) may add their own arrays/meta keys on top before
        handing the payload to :mod:`repro_torch.checkpoint.index_io`."""
        arrays = {"vectors": self.vectors,
                  "lo": self.lo, "hi": self.hi,
                  "domain_values": self.domain.values}
        if self.storage is not None:
            arrays.update(self.storage.to_arrays())
        meta = {"format": _INDEX_FORMAT, "format_version": _INDEX_FORMAT_VERSION,
                "storage_dtype": self.spec.storage_dtype,
                "spec": self.spec.to_dict(), "params": self.params,
                "build_seconds": {k: float(v) for k, v in
                                  self.build_seconds.items()},
                "build_stats": {k: {f: (float(x) if isinstance(x, float)
                                        else int(x))
                                    for f, x in v.items()}
                                for k, v in self.build_stats.items()},
                "variants": {}}
        for name, fv in self.variants.items():
            meta["variants"][name] = {"K": fv.K, "Kpad": fv.Kpad,
                                      "Lv": fv.Lv, "n": fv.n}
            for field in _FV_ARRAYS:
                arrays[f"{name}.{field}"] = getattr(fv, field)
        return arrays, meta

    @classmethod
    def from_payload(cls, arrays: Dict[str, np.ndarray], meta: dict,
                     path: str = "<payload>") -> "MSTGIndex":
        """Inverse of :meth:`to_payload`; missing arrays raise a clear
        :class:`repro_torch.checkpoint.index_io.IndexIOError` naming the key."""
        if meta.get("format") != _INDEX_FORMAT:
            raise ValueError(f"{path}: not a {_INDEX_FORMAT} artifact")
        self = cls.__new__(cls)
        self.vectors = np.ascontiguousarray(
            index_io.take(arrays, "vectors", path), np.float32)
        self.lo = np.asarray(index_io.take(arrays, "lo", path), np.float64)
        self.hi = np.asarray(index_io.take(arrays, "hi", path), np.float64)
        self.domain = iv.AttributeDomain(
            index_io.take(arrays, "domain_values", path))
        self.rl = self.domain.rank(self.lo)
        self.rr = self.domain.rank(self.hi)
        self.params = dict(meta["params"])
        self.spec = IndexSpec.from_dict(meta["spec"])
        # pre-storage-tier artifacts have neither the spec field nor the code
        # arrays -> spec defaults to "float32" and storage stays None (old
        # files keep loading, served exactly). A quantized spec whose code
        # arrays are missing is re-quantized deterministically from the
        # float32 corpus (same min/max -> same codes).
        self.storage = None
        if self.spec.storage_dtype != "float32":
            self.storage = (QuantizedStore.from_arrays(self.spec.storage_dtype,
                                                       arrays)
                            or maybe_quantize(self.vectors,
                                              self.spec.storage_dtype))
        self.build_seconds = dict(meta.get("build_seconds", {}))
        self.build_stats = {k: dict(v) for k, v in
                            meta.get("build_stats", {}).items()}
        self.build_workers = 0
        self.variants = {}
        for name, scal in meta["variants"].items():
            self.variants[name] = FrozenVariant(
                variant=name, K=int(scal["K"]), Kpad=int(scal["Kpad"]),
                Lv=int(scal["Lv"]), n=int(scal["n"]),
                **{f: index_io.take(arrays, f"{name}.{f}", path)
                   for f in _FV_ARRAYS})
        return self

    def save(self, path: str) -> str:
        """Persist the whole serving artifact — corpus, ranges, attribute
        domain, every :class:`FrozenVariant` array, spec — to one atomic
        ``.npz`` (conventions of :mod:`repro_torch.checkpoint.index_io`), so a
        serving process can :meth:`load` instead of rebuilding."""
        arrays, meta = self.to_payload()
        return index_io.save_npz_atomic(path, arrays, meta)

    @classmethod
    def load(cls, path: str) -> "MSTGIndex":
        """Reconstruct a saved index without rebuilding: search results are
        bit-identical to the freshly built index the file came from."""
        arrays, meta = index_io.load_npz(path)
        return cls.from_payload(arrays, meta, path=path)

    # ---- planning ----
    def plan(self, mask: int, ql: float, qh: float) -> List[iv.SearchTask]:
        tasks = iv.plan_searches(self.domain, mask, ql, qh)
        missing = {t.variant for t in tasks} - set(self.variants)
        if missing:
            raise ValueError(f"mask {iv.mask_name(mask)} needs variants {missing}; "
                             f"built: {sorted(self.variants)}")
        return tasks

    def plan_batch(self, mask: int, ql: np.ndarray, qh: np.ndarray) -> List[iv.PlanSlot]:
        """Vectorized planning: for a fixed mask the task *templates* (variant
        sequence) are query-independent; versions/key bounds vary per query.
        Returns a list of :class:`repro_torch.core.intervals.PlanSlot` — tuples of
        (variant, version(Q,), key_lo(Q,), key_hi(Q,)) with no per-query
        Python (all searchsorted + arithmetic on (Q,) arrays)."""
        ql = np.asarray(ql, dtype=np.float64)
        qh = np.asarray(qh, dtype=np.float64)
        if np.any(ql > qh):
            raise ValueError("query ranges must satisfy ql <= qh")
        slots = iv.plan_batch_ranked(mask, self.domain.floor_rank(ql),
                                     self.domain.ceil_rank(ql),
                                     self.domain.floor_rank(qh),
                                     self.domain.ceil_rank(qh), self.domain.K)
        missing = {s.variant for s in slots} - set(self.variants)
        if missing:
            raise ValueError(f"mask {iv.mask_name(mask)} needs variants {missing}; "
                             f"built: {sorted(self.variants)}")
        return slots

    def index_bytes(self) -> int:
        return sum(v.nbytes() for v in self.variants.values())

    def storage_bytes(self) -> dict:
        """Per-tier byte accounting of the vector storage.

        ``codes``/``scales``/``sq_norm`` are what a compressed scan streams;
        ``float32_rerank`` is the exact corpus retained (host-side) for the
        re-rank step; ``graph`` is the variant structure
        (:meth:`index_bytes`). ``compression_ratio`` is the *scan-stream*
        ratio — float32 corpus bytes over the bytes the scan actually reads
        per pass — i.e. the bandwidth lever, not a total-RSS ratio.
        """
        full = int(self.vectors.nbytes)
        out = {"storage_dtype": self.spec.storage_dtype,
               "float32_rerank": full, "graph": self.index_bytes()}
        if self.storage is None:
            out.update(codes=0, scales=0, sq_norm=0,
                       scan_bytes=full, compression_ratio=1.0)
        else:
            bb = self.storage.bytes_breakdown()
            out.update(codes=bb["codes"], scales=bb["scales"],
                       sq_norm=bb["sq_norm"], scan_bytes=bb["total"],
                       compression_ratio=full / max(bb["total"], 1))
        return out

    def predicate_select(self, mask: int, ql: float, qh: float) -> np.ndarray:
        return np.asarray(iv.eval_predicate(mask, self.lo, self.hi,
                                            float(ql), float(qh)))
