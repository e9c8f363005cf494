"""The paper's comparison methods (§3, §5), at laptop scale.

The port of the reference's ``repro.core.baselines``. Every baseline
exposes ``search(queries, qlo, qhi, mask, k, **knobs) -> (ids, dists)`` over
the same (vectors, lo, hi) corpus so a benchmark treats them uniformly.
Distance counts (``last_dist_evals``) approximate the paper's cost model:
"each vector verification requires an expensive distance computation".

* Prefiltering   — predicate scan then exact distances on qualifiers.
* Postfiltering  — plain HNSW k'-ANN then predicate filter; Milvus-style
                   progressive doubling of k' until k qualifiers survive.
* ACORN-like     — predicate-agnostic graph with enlarged degree (gamma),
                   filtered traversal at query time (ACORN-1 flavor).
* iRangeGraph    — segment tree on a point attribute with a PG per node; our
                   MSTG machinery with a degenerate (single-version) variant.
                   RFANN only. Its search runs on a device.
* TSGraphLike    — per-timestamp-bucket HNSWs + exact recheck (TSANN).
* HiPNGLike      — quadtree over (l, r) 2D points with a PG per quad node;
                   in-rect nodes searched directly, boundary nodes post-
                   filtered (IFANN).

All but iRangeGraph are host NumPy over :class:`PlainHNSW` and return what
the reference returns, ``last_dist_evals`` included.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import intervals as iv
from .engine import resolve_device
from .hnsw import PlainHNSW, l2sq
from .mstg import MSTGIndex
from .search import as_tensor, device_variant, mstg_graph_search


def _pad(ids: List[int], ds: List[float], k: int):
    out_i = np.full(k, -1, np.int64)
    out_d = np.full(k, np.inf)
    m = min(len(ids), k)
    out_i[:m] = ids[:m]
    out_d[:m] = ds[:m]
    return out_i, out_d


class BaseIndex:
    name = "base"

    def __init__(self, vectors: np.ndarray, lo: np.ndarray, hi: np.ndarray):
        self.vectors = np.ascontiguousarray(vectors, np.float32)
        self.lo = np.asarray(lo, np.float64)
        self.hi = np.asarray(hi, np.float64)
        self.last_dist_evals = 0

    def search(self, queries, qlo, qhi, mask: int, k: int = 10, **kw):
        raise NotImplementedError

    def index_bytes(self) -> int:
        return 0

    def storage_bytes(self) -> dict:
        """Per-tier byte accounting, same schema as
        :meth:`repro_torch.core.mstg.MSTGIndex.storage_bytes`. Baselines store only
        the exact float32 corpus (no compressed tier), so the scan stream is
        the full corpus and the ratio is 1."""
        full = int(self.vectors.nbytes)
        return {"storage_dtype": "float32", "float32_rerank": full,
                "graph": self.index_bytes(), "codes": 0, "scales": 0,
                "sq_norm": 0, "scan_bytes": full, "compression_ratio": 1.0}


class Prefiltering(BaseIndex):
    name = "prefilter"

    def search(self, queries, qlo, qhi, mask: int, k: int = 10, **kw):
        Q = queries.shape[0]
        ids = np.full((Q, k), -1, np.int64)
        ds = np.full((Q, k), np.inf)
        self.last_dist_evals = 0
        for qi in range(Q):
            sel = np.nonzero(np.asarray(iv.eval_predicate(
                mask, self.lo, self.hi, qlo[qi], qhi[qi])))[0]
            if sel.size == 0:
                continue
            self.last_dist_evals += sel.size
            d = l2sq(self.vectors[sel], queries[qi])
            o = np.argsort(d, kind="stable")[:k]
            ids[qi, :o.size] = sel[o]
            ds[qi, :o.size] = d[o]
        return ids, ds


class Postfiltering(BaseIndex):
    """HNSW + progressive k' doubling (Milvus strategy, paper Appendix C)."""
    name = "postfilter"

    def __init__(self, vectors, lo, hi, m: int = 16, ef_con: int = 100):
        super().__init__(vectors, lo, hi)
        self.h = PlainHNSW(self.vectors, m=m, ef_con=ef_con).build(
            range(len(vectors)))

    def index_bytes(self) -> int:
        return sum(len(v) for v in self.h.g.open_adj.values()) * 8

    def search(self, queries, qlo, qhi, mask: int, k: int = 10,
               ef: int = 64, max_kprime: int = 1024, **kw):
        Q = queries.shape[0]
        out_i = np.full((Q, k), -1, np.int64)
        out_d = np.full((Q, k), np.inf)
        self.last_dist_evals = 0
        for qi in range(Q):
            kp = k
            while True:
                coll: List[int] = []
                cand, cd = self.h.search(queries[qi], k=kp,
                                         ef=max(ef, kp), collect=coll)
                self.last_dist_evals += int(np.sum(coll))
                sel = np.asarray(iv.eval_predicate(
                    mask, self.lo[cand], self.hi[cand], qlo[qi], qhi[qi]))
                good = np.nonzero(sel)[0]
                if good.size >= k or kp >= max_kprime:
                    out_i[qi], out_d[qi] = _pad(
                        [int(cand[g]) for g in good],
                        [float(cd[g]) for g in good], k)
                    break
                kp *= 2
        return out_i, out_d


class AcornLike(BaseIndex):
    """Predicate-agnostic index, filtered traversal (ACORN-1 / VBASE style).
    ``gamma`` widens construction degree like ACORN-gamma's neighbor
    expansion."""
    name = "acorn"

    def __init__(self, vectors, lo, hi, m: int = 16, ef_con: int = 100,
                 gamma: int = 2):
        super().__init__(vectors, lo, hi)
        self.h = PlainHNSW(self.vectors, m=m * gamma, ef_con=ef_con,
                           m_max=2 * m * gamma).build(range(len(vectors)))

    def index_bytes(self) -> int:
        return sum(len(v) for v in self.h.g.open_adj.values()) * 8

    def search(self, queries, qlo, qhi, mask: int, k: int = 10, ef: int = 64, **kw):
        Q = queries.shape[0]
        out_i = np.full((Q, k), -1, np.int64)
        out_d = np.full((Q, k), np.inf)
        self.last_dist_evals = 0
        for qi in range(Q):
            coll: List[int] = []
            pred = lambda u: bool(iv.eval_predicate(
                mask, self.lo[u], self.hi[u], qlo[qi], qhi[qi]))
            ids, ds = self.h.search(queries[qi], k=k, ef=ef,
                                    predicate=pred, collect=coll)
            self.last_dist_evals += int(np.sum(coll))
            out_i[qi], out_d[qi] = _pad(list(ids), list(ds), k)
        return out_i, out_d


class IRangeGraphLike(BaseIndex):
    """RFANN baseline: segment tree over a *point* attribute with a PG per
    node (iRangeGraph). Reuses the MSTG builder with a degenerate single
    version (labels trivially [0, OPEN)) — exactly the ancestor structure.

    The build is host NumPy; :meth:`search` runs the wavefront beam search
    on ``device`` (``None`` means ``"cuda"``, which raises without a card),
    with the variant staged there on the first search."""
    name = "irangegraph"

    def __init__(self, vectors, attr, m: int = 16, ef_con: int = 100, *,
                 device=None):
        attr = np.asarray(attr, np.float64)
        super().__init__(vectors, attr, attr)
        self.device = resolve_device(device)
        # Point objects, single tree keyed on the attribute. Querying at
        # version = top ignores labels entirely: the induced graph is the
        # final live HNSW per node — exactly iRangeGraph's elemental graphs.
        self.idx = MSTGIndex(self.vectors, attr, attr, variants=("T",),
                             m=m, ef_con=ef_con)
        self._dev: Optional[Dict[str, torch.Tensor]] = None

    def to(self, device) -> "IRangeGraphLike":
        """A copy that shares this one's host index and searches on
        ``device``."""
        out = copy.copy(self)
        out.device = resolve_device(device)
        out._dev = None
        return out

    def index_bytes(self) -> int:
        return self.idx.index_bytes()

    def storage_bytes(self) -> dict:
        return self.idx.storage_bytes()

    def search(self, queries, qlo, qhi, mask: int = iv.RFANN_MASK, k: int = 10,
               ef: int = 64, **kw):
        fv = self.idx.variants["T"]
        if self._dev is None:
            self._dev = device_variant(
                fv, as_tensor(self.idx.vectors, self.device), self.device)
        Q = queries.shape[0]
        dom = self.idx.domain
        top = dom.K - 1
        version = np.full(Q, top, np.int64)
        klo = dom.ceil_rank(np.asarray(qlo))
        khi = dom.floor_rank(np.asarray(qhi))
        ids, d = mstg_graph_search(
            self._dev, np.asarray(queries, np.float32), version, klo, khi,
            k=k, ef=ef, max_steps=4 * ef + 64, Kpad=fv.Kpad)
        return ids.cpu().numpy(), d.cpu().numpy()


class TSGraphLike(BaseIndex):
    """TSANN baseline: bucketed timestamps, one HNSW per bucket over the
    objects whose range covers the bucket (TS-Graph's per-timestamp graphs,
    without its compression — honest at laptop scale)."""
    name = "tsgraph"

    def __init__(self, vectors, lo, hi, n_buckets: int = 16, m: int = 12,
                 ef_con: int = 60):
        super().__init__(vectors, lo, hi)
        self.edges = np.linspace(self.lo.min(), self.hi.max(), n_buckets + 1)
        self.buckets: List[Tuple[np.ndarray, PlainHNSW]] = []
        for b in range(n_buckets):
            a, c = self.edges[b], self.edges[b + 1]
            member = np.nonzero((self.lo <= c) & (self.hi >= a))[0]
            h = PlainHNSW(self.vectors, m=m, ef_con=ef_con)
            for u in member:
                h.add(int(u))
            self.buckets.append((member, h))

    def index_bytes(self) -> int:
        return sum(sum(len(v) for v in h.g.open_adj.values()) * 8
                   for _, h in self.buckets)

    def search(self, queries, qlo, qhi, mask: int = iv.TSANN_MASK, k: int = 10,
               ef: int = 64, **kw):
        Q = queries.shape[0]
        out_i = np.full((Q, k), -1, np.int64)
        out_d = np.full((Q, k), np.inf)
        self.last_dist_evals = 0
        nb = len(self.buckets)
        for qi in range(Q):
            t = qlo[qi]
            b = int(np.clip(np.searchsorted(self.edges, t, "right") - 1, 0, nb - 1))
            _, h = self.buckets[b]
            coll: List[int] = []
            pred = lambda u: bool(self.lo[u] <= t <= self.hi[u])
            ids, ds = h.search(queries[qi], k=k, ef=ef, predicate=pred,
                               collect=coll)
            self.last_dist_evals += int(np.sum(coll))
            out_i[qi], out_d[qi] = _pad(list(ids), list(ds), k)
        return out_i, out_d


@dataclasses.dataclass
class _QuadNode:
    x0: float
    x1: float
    y0: float
    y1: float
    members: np.ndarray
    children: Optional[List["_QuadNode"]]
    graph: Optional[PlainHNSW]


class HiPNGLike(BaseIndex):
    """IFANN baseline: quadtree over (l, r) points with a PG per node
    (Hi-PNG). Search: minimal node cover of the query rectangle
    [ql,qh]x[ql,qh]; fully-inside nodes searched directly, boundary nodes
    searched + post-filtered; merged."""
    name = "hipng"

    def __init__(self, vectors, lo, hi, leaf_size: int = 64, m: int = 12,
                 ef_con: int = 60, max_depth: int = 6):
        super().__init__(vectors, lo, hi)
        self.leaf_size = leaf_size
        self.max_depth = max_depth
        self.m, self.ef_con = m, ef_con
        ids = np.arange(len(vectors))
        self.root = self._build(ids, float(self.lo.min()), float(self.hi.max()),
                                float(self.lo.min()), float(self.hi.max()), 0)

    def _build(self, ids, x0, x1, y0, y1, depth) -> _QuadNode:
        g = PlainHNSW(self.vectors, m=self.m, ef_con=self.ef_con)
        for u in ids:
            g.add(int(u))
        node = _QuadNode(x0, x1, y0, y1, ids, None, g)
        if len(ids) > self.leaf_size and depth < self.max_depth:
            xm, ym = (x0 + x1) / 2, (y0 + y1) / 2
            quads = []
            for (a, b, c, d) in ((x0, xm, y0, ym), (xm, x1, y0, ym),
                                 (x0, xm, ym, y1), (xm, x1, ym, y1)):
                sub = ids[(self.lo[ids] >= a) & (self.lo[ids] <= b) &
                          (self.hi[ids] >= c) & (self.hi[ids] <= d)]
                quads.append(self._build(sub, a, b, c, d, depth + 1))
            node.children = quads
        return node

    def index_bytes(self) -> int:
        total = 0
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n.graph:
                total += sum(len(v) for v in n.graph.g.open_adj.values()) * 8
            if n.children:
                stack.extend(n.children)
        return total

    def _cover(self, node, ql, qh, out):
        if node.x1 < ql or node.x0 > qh or node.y1 < ql or node.y0 > qh:
            return
        inside = (node.x0 >= ql and node.x1 <= qh and
                  node.y0 >= ql and node.y1 <= qh)
        if inside or node.children is None:
            out.append((node, inside))
            return
        for c in node.children:
            self._cover(c, ql, qh, out)

    def search(self, queries, qlo, qhi, mask: int = iv.IFANN_MASK, k: int = 10,
               ef: int = 64, **kw):
        Q = queries.shape[0]
        out_i = np.full((Q, k), -1, np.int64)
        out_d = np.full((Q, k), np.inf)
        self.last_dist_evals = 0
        for qi in range(Q):
            nodes: List[Tuple[_QuadNode, bool]] = []
            self._cover(self.root, qlo[qi], qhi[qi], nodes)
            pool: Dict[int, float] = {}
            for node, inside in nodes:
                if node.members.size == 0:
                    continue
                coll: List[int] = []
                ids, ds = node.graph.search(queries[qi], k=k, ef=ef,
                                            collect=coll)
                self.last_dist_evals += int(np.sum(coll))
                for u, d in zip(ids, ds):
                    u = int(u)
                    if not inside and not (qlo[qi] <= self.lo[u] and
                                           self.hi[u] <= qhi[qi]):
                        continue
                    pool[u] = float(d)
            top = sorted(pool.items(), key=lambda t: t[1])[:k]
            out_i[qi], out_d[qi] = _pad([u for u, _ in top], [d for _, d in top], k)
        return out_i, out_d
