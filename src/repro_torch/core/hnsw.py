"""Labeled navigable-graph construction (paper §4.3, Algorithm 3).

Host-side (numpy) incremental builder. One :class:`LabeledLevelGraph` holds all
tree-node graphs of ONE segment-tree level — node graphs at a level are disjoint
in key space, so a single per-vertex adjacency dict per level suffices, and it
freezes into a dense ``(n, slots)`` array for the device search path.

Faithfulness notes (see DESIGN.md §2):
* single-layer navigable graphs with per-node entry points (layer-0 of HNSW;
  iRangeGraph does the same) — insertion = ef-search + RNG pruning, exactly
  Algorithm 3's three steps;
* every edge carries a validity label ``(b, e)``: born at version ``b`` when its
  source/target was inserted, closed at ``e = x - 1`` when RNG pruning during the
  version-``x`` insertion removes it (Algorithm 3 lines 5, 10). ``e = OPEN``
  means "still live". Theorem D.1: the label-induced subgraph at version x equals
  the graph an unshared MSTG would have stored.
"""
from __future__ import annotations

import heapq
from itertools import chain
from typing import Dict, List, Optional, Tuple

import numpy as np

OPEN = np.iinfo(np.int32).max
NO_EDGE = -1


def l2sq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a - b
    return np.einsum("...d,...d->...", d, d)


def rng_prune(vectors: np.ndarray, base: int, cand_ids: np.ndarray,
              cand_dists: np.ndarray, m: int) -> List[int]:
    """HNSW 'select neighbors heuristic' (RNG rule): scan candidates in
    ascending distance; keep c iff no kept k has dist(c, k) < dist(base, c)."""
    order = np.argsort(cand_dists, kind="stable")
    kept: List[int] = []
    for j in order:
        c = int(cand_ids[j])
        if c == base:
            continue
        dc = float(cand_dists[j])
        if kept:
            dk = l2sq(vectors[kept], vectors[c])
            if np.any(dk < dc):
                continue
        kept.append(c)
        if len(kept) >= m:
            break
    return kept


class LabeledLevelGraph:
    """All labeled tree-node graphs of one segment-tree level."""

    def __init__(self, vectors: np.ndarray, m: int, ef_con: int,
                 m_max: Optional[int] = None, n_entries: int = 4):
        self.vectors = vectors
        self.m = int(m)
        self.m_max = int(m_max if m_max is not None else m)
        self.ef_con = int(ef_con)
        self.n_entries = int(n_entries)
        self.open_adj: Dict[int, List[int]] = {}
        self.open_born: Dict[int, List[int]] = {}
        self.closed: Dict[int, List[Tuple[int, int, int]]] = {}
        self.node_members: Dict[int, List[int]] = {}
        self.node_member_vers: Dict[int, List[int]] = {}

    # ---- live-graph beam search (build-time only) ----
    def _search_live(self, q: np.ndarray, entries: List[int], ef: int):
        V = self.vectors
        visited = set(entries)
        dists = l2sq(V[entries], q)
        cand = [(float(d), e) for d, e in zip(np.atleast_1d(dists), entries)]
        heapq.heapify(cand)
        result = [(-d, e) for d, e in cand]
        heapq.heapify(result)
        while len(result) > ef:
            heapq.heappop(result)
        while cand:
            d, u = heapq.heappop(cand)
            if len(result) >= ef and d > -result[0][0]:
                break
            nbrs = [v for v in self.open_adj.get(u, ()) if v not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            nd = l2sq(V[nbrs], q)
            for dv, v in zip(np.atleast_1d(nd), nbrs):
                dv = float(dv)
                if len(result) < ef or dv < -result[0][0]:
                    heapq.heappush(cand, (dv, v))
                    heapq.heappush(result, (-dv, v))
                    if len(result) > ef:
                        heapq.heappop(result)
        out = sorted([(-d, u) for d, u in result])
        ids = np.array([u for _, u in out], dtype=np.int64)
        ds = np.array([d for d, _ in out], dtype=np.float64)
        return ids, ds

    def _add_edge(self, u: int, v: int, version: int) -> None:
        self.open_adj.setdefault(u, []).append(v)
        self.open_born.setdefault(u, []).append(version)

    def _reprune(self, u: int, version: int) -> None:
        """RNG-prune u's live out-edges down to m_max; close removed labels."""
        nbrs = self.open_adj[u]
        if len(nbrs) <= self.m_max:
            return
        ids = np.array(nbrs, dtype=np.int64)
        dists = l2sq(self.vectors[ids], self.vectors[u])
        kept = set(rng_prune(self.vectors, u, ids, dists, self.m_max))
        new_adj, new_born = [], []
        log = self.closed.setdefault(u, [])
        for v, b in zip(nbrs, self.open_born[u]):
            if v in kept:
                new_adj.append(v)
                new_born.append(b)
            else:
                e = version - 1
                if e >= b:  # an edge born and pruned at the same version never existed
                    log.append((v, b, e))
        self.open_adj[u] = new_adj
        self.open_born[u] = new_born

    def insert(self, u: int, node_idx: int, version: int) -> None:
        """Algorithm 3: insert object u into tree-node ``node_idx`` at ``version``."""
        members = self.node_members.setdefault(node_idx, [])
        vers = self.node_member_vers.setdefault(node_idx, [])
        self.open_adj.setdefault(u, [])
        self.open_born.setdefault(u, [])
        if members:
            entries = members[: self.n_entries]
            ids, dists = self._search_live(self.vectors[u], entries, self.ef_con)
            kept = rng_prune(self.vectors, u, ids, dists, self.m)
            for c in kept:
                self._add_edge(u, c, version)
                self._add_edge(c, u, version)
                self._reprune(c, version)
        members.append(u)
        vers.append(version)

    # ---- freeze to dense arrays ----
    def edge_log(self, u: int) -> List[Tuple[int, int, int]]:
        log = list(self.closed.get(u, ()))
        log.extend((v, b, OPEN) for v, b in
                   zip(self.open_adj.get(u, ()), self.open_born.get(u, ())))
        return log

    def max_slots(self, n: int) -> int:
        closed, open_adj = self.closed, self.open_adj
        s = 0
        for u in range(n):
            t = len(closed.get(u, ())) + len(open_adj.get(u, ()))
            if t > s:
                s = t
        return s

    def freeze(self, n: int, slots: Optional[int] = None, out=None):
        """Dense (n, S) arrays: targets / born / end labels. Vectorized
        scatter of the flat edge logs (closed triples first, then open
        edges — the :meth:`edge_log` order) instead of per-edge Python.
        ``out`` (a ``(tgt, lab_b, lab_e)`` triple of (n, S) int32 views)
        scatters in place instead of allocating."""
        closed, open_adj, open_born = self.closed, self.open_adj, self.open_born
        c_cnt = np.fromiter((len(closed.get(u, ())) for u in range(n)),
                            np.int64, count=n)
        o_cnt = np.fromiter((len(open_adj.get(u, ())) for u in range(n)),
                            np.int64, count=n)
        tot = c_cnt + o_cnt
        s_req = int(tot.max()) if n else 0
        S = int(slots if slots is not None else max(s_req, 1))
        if s_req > S:
            u = int(np.argmax(tot))
            raise ValueError(f"vertex {u} has {int(tot[u])} edges > {S} slots")
        if out is not None:
            tgt, lab_b, lab_e = out
            tgt[:] = NO_EDGE
            lab_b[:] = 0
            lab_e[:] = 0
        else:
            tgt = np.full((n, S), NO_EDGE, dtype=np.int32)
            lab_b = np.zeros((n, S), dtype=np.int32)
            lab_e = np.zeros((n, S), dtype=np.int32)
        ec = int(c_cnt.sum())
        if ec:
            rows = np.repeat(np.arange(n), c_cnt)
            within = np.arange(ec) - np.repeat(np.cumsum(c_cnt) - c_cnt, c_cnt)
            trip = np.fromiter(
                chain.from_iterable(chain.from_iterable(
                    closed.get(u, ()) for u in range(n))),
                np.int64, count=3 * ec).reshape(ec, 3)
            tgt[rows, within] = trip[:, 0]
            lab_b[rows, within] = trip[:, 1]
            lab_e[rows, within] = trip[:, 2]
        eo = int(o_cnt.sum())
        if eo:
            rows = np.repeat(np.arange(n), o_cnt)
            within = c_cnt[rows] + (np.arange(eo)
                                    - np.repeat(np.cumsum(o_cnt) - o_cnt,
                                                o_cnt))
            tgt[rows, within] = np.fromiter(
                chain.from_iterable(open_adj.get(u, ()) for u in range(n)),
                np.int64, count=eo)
            lab_b[rows, within] = np.fromiter(
                chain.from_iterable(open_born.get(u, ()) for u in range(n)),
                np.int64, count=eo)
            lab_e[rows, within] = OPEN
        return tgt, lab_b, lab_e

    def induced_adjacency(self, u: int, version: int) -> List[int]:
        """Neighbors of u valid at ``version`` (test oracle for Theorem D.1)."""
        return [v for (v, b, e) in self.edge_log(u) if b <= version <= e]


class PlainHNSW:
    """Unlabeled single-graph HNSW (layer-0) — substrate for the baselines
    (post-filtering, ACORN-style) and the oracle index."""

    def __init__(self, vectors: np.ndarray, m: int = 16, ef_con: int = 100,
                 m_max: Optional[int] = None, seed: int = 0):
        self.g = LabeledLevelGraph(vectors, m=m, ef_con=ef_con,
                                   m_max=m_max if m_max is not None else 2 * m)
        self.vectors = vectors
        self.ids: List[int] = []

    def add(self, u: int) -> None:
        self.g.insert(u, node_idx=0, version=0)
        self.ids.append(u)

    def build(self, ids) -> "PlainHNSW":
        for u in ids:
            self.add(int(u))
        return self

    @property
    def entry_points(self) -> List[int]:
        return self.g.node_members.get(0, [])[: self.g.n_entries]

    def adjacency(self, u: int) -> List[int]:
        return self.g.open_adj.get(u, [])

    def search(self, q: np.ndarray, k: int, ef: int,
               predicate=None, collect=None):
        """Greedy best-first search (paper Algorithm 4). ``predicate(id)->bool``
        makes this the ACORN-1/VBASE-style filtered traversal: all nodes
        navigate, only passing nodes enter the result. ``collect`` (optional
        list) records every distance evaluation for cost accounting."""
        entries = self.entry_points
        if not entries:
            return np.empty(0, np.int64), np.empty(0, np.float64)
        V = self.vectors
        visited = set(entries)
        d0 = np.atleast_1d(l2sq(V[entries], q))
        if collect is not None:
            collect.append(len(entries))
        cand = [(float(d), u) for d, u in zip(d0, entries)]
        heapq.heapify(cand)
        result = []  # max-heap of passing nodes
        nav = [(-float(d), u) for d, u in zip(d0, entries)]
        heapq.heapify(nav)
        while len(nav) > ef:
            heapq.heappop(nav)
        for d, u in cand:
            if predicate is None or predicate(u):
                heapq.heappush(result, (-d, u))
        while cand:
            d, u = heapq.heappop(cand)
            if len(nav) >= ef and d > -nav[0][0]:
                break
            nbrs = [v for v in self.adjacency(u) if v not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            nd = np.atleast_1d(l2sq(V[nbrs], q))
            if collect is not None:
                collect.append(len(nbrs))
            for dv, v in zip(nd, nbrs):
                dv = float(dv)
                if len(nav) < ef or dv < -nav[0][0]:
                    heapq.heappush(cand, (dv, v))
                    heapq.heappush(nav, (-dv, v))
                    if len(nav) > ef:
                        heapq.heappop(nav)
                    if predicate is None or predicate(v):
                        heapq.heappush(result, (-dv, v))
                        while len(result) > max(ef, k):
                            heapq.heappop(result)
        out = sorted([(-d, u) for d, u in result])[:k]
        ids = np.array([u for _, u in out], dtype=np.int64)
        ds = np.array([d for d, _ in out], dtype=np.float64)
        return ids, ds
