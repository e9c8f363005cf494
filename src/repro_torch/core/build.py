"""Bulk MSTG construction — batched Algorithms 1–3 (the default build path).

The incremental builder (:mod:`repro_torch.core.hnsw`) inserts one object at a
time: every insertion runs a Python ``heapq`` beam search over the live
graph per touched tree node, which costs ~ms per object and makes
construction ~3 orders of magnitude slower than the query side. The bulk
builder exploits the one structural fact the incremental path ignores: the
graph is never *searched* during construction if candidates can be produced
another way. So it

1. processes objects in sorted (version) order in fixed-size batches,
2. generates candidates with ONE batched distance matmul per batch — each
   batch object's distances to every earlier-inserted object are computed
   once and *shared across all* ``Lv`` *levels* of its root→leaf tree path
   (per level, candidates are just the nearest earlier members of the same
   tree node: a boolean mask over the shared distance rows),
3. applies the RNG "select neighbors" rule to all (object, level) rows at
   once (:func:`rng_prune_batch` — m rounds of (R, C) vector ops instead of
   R sequential Python scans), and
4. defers reverse-edge re-pruning: vertices far over quota are re-pruned
   at their own batch boundary (bounding hub degrees and the frozen slot
   axis), everything else in one shared sweep every ``REPRUNE_EVERY``
   batches — collapsing the per-batch prune/regrow churn.

Fidelity: candidate sets are *exact* nearest earlier same-node members
(the incremental beam search only approximates this), the pruning rule is
identical, and member / entry-point / version bookkeeping is bit-identical
to the incremental builder. Edge validity labels are a **superset** of the
incremental ones: an edge pruned at a boundary or sweep closes at that
batch's last version instead of the exact insertion version, so every
query version sees at least the edges the incremental graph would expose
(never fewer — recall is preserved; Theorem D.1 *exactness* is what the
``builder="incremental"`` oracle is kept for). The frozen array schema is
unchanged: both builders fill the same :class:`LabeledLevelGraph` adjacency
structures and go through the same freeze.

The batched distance matmuls run on the host through NumPy's BLAS matmul,
exactly as in the JAX reference package, so the frozen arrays match it
byte for byte.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.log import get_logger

from .hnsw import NO_EDGE, OPEN

logger = get_logger(__name__)

# "scan" builds only the segment-tree member structure (flat/pruned routes,
# no graphs — see repro_torch.core.mstg.build_scan_variant); the other two build
# the full labeled level graphs.
BUILDERS = ("bulk", "incremental", "scan")
DEFAULT_BATCH = 128

# Candidate generation for the bulk builder. "exact" is the PR-5 all-pairs
# matmul (per batch object, the true nearest earlier same-node members);
# "coarse" swaps in an IVF-style coarse quantizer once the inserted prefix
# passes ``coarse_threshold``: one k-means assignment matmul per batch, with
# candidates drawn from the object's ``n_probe`` nearest centroids' members
# plus the recent (not yet consolidated) insertion block. Batches whose
# prefix is still below the threshold run the exact path unchanged, so small
# builds stay bit-identical to the exact builder.
CANDIDATE_STAGES = ("exact", "coarse")
DEFAULT_N_PROBE = 8
DEFAULT_COARSE_THRESHOLD = 4096
# Deferred re-pruning cadence: vertices a little over quota wait up to this
# many batches for the shared sweep (labels close later — still a superset
# of the incremental builder's, so recall is preserved); vertices more than
# 2*m past quota are swept at their own batch boundary so hub degrees (and
# the frozen slot axis S) stay bounded.
REPRUNE_EVERY = 24
_KMEANS_ITERS = 4
_KMEANS_SAMPLE = 16384
_ASSIGN_CHUNK = 8192


def pairwise_sq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared L2 between row sets via one BLAS matmul, clamped at 0."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    d = np.einsum("id,id->i", a, a)[:, None] \
        + np.einsum("jd,jd->j", b, b)[None, :] - 2.0 * (a @ b.T)
    return np.maximum(d, 0.0, out=d)


def gathered_sq(base: np.ndarray, gathered: np.ndarray) -> np.ndarray:
    """Squared L2 between ``base[r]`` and every gathered row
    ``gathered[r, c]`` — the per-row dot-identity counterpart of
    :func:`pairwise_sq`, clamped at 0."""
    d = np.einsum("rcd,rcd->rc", gathered, gathered) \
        + np.einsum("rd,rd->r", base, base)[:, None] \
        - 2.0 * np.einsum("rd,rcd->rc", base, gathered)
    return np.maximum(d, 0.0, out=d)


def gathered_sq_ids(V: np.ndarray, sq_norm: np.ndarray,
                    base_ids: np.ndarray, gathered_ids: np.ndarray
                    ) -> np.ndarray:
    """:func:`gathered_sq` from ids plus precomputed global squared norms
    (``sq_norm[i] == ||V[i]||^2``): gathers norms instead of recomputing
    them, so each call is one batched matvec (BLAS) instead of three
    einsums. Negative ids are padding (clipped; caller masks them)."""
    gi = np.clip(gathered_ids, 0, None)
    d = sq_norm[gi] + sq_norm[base_ids][:, None] \
        - 2.0 * np.matmul(V[gi], V[base_ids][:, :, None])[:, :, 0]
    return np.maximum(d, 0.0, out=d)


def rng_prune_batch(vectors: np.ndarray, cand_ids: np.ndarray,
                    cand_d: np.ndarray, m: int,
                    sq_norm: Optional[np.ndarray] = None) -> np.ndarray:
    """Batched RNG rule ("select neighbors heuristic") over R rows at once.

    Per row, equivalent to :func:`repro_torch.core.hnsw.rng_prune`: scanning
    candidates in ascending base distance, keep c iff no already-kept k has
    ``d(k, c) < d(base, c)``. Reformulated as suppression so it vectorizes:
    keeping a candidate suppresses every candidate j with
    ``d(kept, j) < d(base, j)``; the next kept is the first unsuppressed
    survivor. That is ``m`` rounds of (R, C) vector ops — the kept-vs-rest
    distances come from one batched matvec per round instead of per-row
    Python.

    cand_ids : (R, C) int, sorted ascending by ``cand_d``; ``-1`` = padding
    cand_d   : (R, C) float, base→candidate squared distance (inf padding)
    Returns (R, m) int64 kept ids, ``-1``-padded.
    """
    cand_ids = np.asarray(cand_ids)
    R, C = cand_ids.shape
    kept = np.full((R, m), -1, np.int64)
    if R == 0 or C == 0:
        return kept
    # rows are sorted with padding last, so trailing all-padding columns
    # carry no information — trim them (deep tree levels pad heavily, and
    # every round below pays per retained column)
    w = int((cand_ids >= 0).sum(axis=1).max())
    if w < C:
        C = max(w, 1)
        cand_ids = cand_ids[:, :C]
        cand_d = cand_d[:, :C]
    alive = cand_ids >= 0
    rows = np.arange(R)
    ci = np.clip(cand_ids, 0, None)
    Vc = vectors[ci]                                    # (R, C, d)
    # candidate norms are round-invariant: hoist them (or gather the global
    # precompute) so each round is one batched matvec instead of a full
    # gathered_sq (3 einsums) per round
    cnorm = sq_norm[ci] if sq_norm is not None \
        else np.einsum("rcd,rcd->rc", Vc, Vc)
    for t in range(m):
        first = np.argmax(alive, axis=1)                # first survivor
        act = alive[rows, first]                        # False when row done
        if not act.any():
            break
        kept[act, t] = cand_ids[act, first[act]]
        kv = Vc[rows, first]
        # d(kept, j) for every candidate j: the kept norm is a cnorm column
        dkj = cnorm + cnorm[rows, first][:, None] \
            - 2.0 * np.matmul(Vc, kv[:, :, None])[:, :, 0]
        np.maximum(dkj, 0.0, out=dkj)   # same clamp as gathered_sq
        alive &= ~(act[:, None] & (dkj < cand_d))
        alive[rows, first] &= ~act
    return kept


class _BulkLevel:
    """Array-backed level-graph accumulator for the bulk builder.

    Same construction semantics and frozen schema as
    :class:`repro_torch.core.hnsw.LabeledLevelGraph` (which the incremental
    builder keeps using), but open adjacency lives in preallocated
    ``(n, W)`` arrays and the closed-edge log in flat chunks, so inserts
    and re-prunes are numpy scatters instead of per-edge Python appends —
    the linear stages shared by every candidate mode were the build-time
    ceiling once the candidate stage went sub-quadratic.
    """

    def __init__(self, vectors: np.ndarray, n: int, *, m: int, ef_con: int,
                 m_max: Optional[int] = None, n_entries: int = 4):
        self.vectors = vectors
        self.m = int(m)
        self.m_max = int(m_max if m_max is not None else m)
        self.ef_con = int(ef_con)
        self.n_entries = int(n_entries)
        W = max(4 * self.m_max + 2 * self.m, 32)
        self.adj = np.full((n, W), -1, np.int32)
        self.born = np.zeros((n, W), np.int32)
        self.cnt = np.zeros(n, np.int64)
        # (u, v, b, e) arrays per re-prune; chunk order is chronological,
        # so a stable per-u sort at freeze reproduces edge_log order
        self.closed_chunks: List[tuple] = []
        self._flat_cache: Optional[tuple] = None
        self.node_members: Dict[int, List[int]] = {}
        self.node_member_vers: Dict[int, List[int]] = {}

    def ensure_width(self, need: int) -> None:
        W = self.adj.shape[1]
        if need <= W:
            return
        new_w = W
        while new_w < need:
            new_w *= 2
        grow = np.full((self.adj.shape[0], new_w - W), -1, np.int32)
        self.adj = np.concatenate([self.adj, grow], axis=1)
        self.born = np.concatenate([self.born, np.zeros_like(grow)], axis=1)

    def _closed_flat(self, n: int):
        # cached on chunk count: max_slots + freeze both flatten, back to
        # back, and the log is append-only between them
        if not self.closed_chunks:
            return (np.zeros(0, np.int64),) * 4
        if (self._flat_cache is not None
                and self._flat_cache[0] == len(self.closed_chunks)):
            return self._flat_cache[1]
        cu = np.concatenate([c[0] for c in self.closed_chunks])
        cv = np.concatenate([c[1] for c in self.closed_chunks])
        cb = np.concatenate([c[2] for c in self.closed_chunks])
        ce = np.concatenate([np.full(c[0].shape[0], c[3], np.int64)
                             for c in self.closed_chunks])
        self._flat_cache = (len(self.closed_chunks), (cu, cv, cb, ce))
        return cu, cv, cb, ce

    def max_slots(self, n: int) -> int:
        cu = self._closed_flat(n)[0]
        tot = np.bincount(cu, minlength=n) + self.cnt[:n]
        return int(tot.max()) if n else 0

    def freeze(self, n: int, slots: Optional[int] = None, out=None):
        """Dense (n, S) arrays in :meth:`LabeledLevelGraph.edge_log` order:
        closed triples (chronological per vertex) then open edges. ``out``
        (a ``(tgt, lab_b, lab_e)`` triple of (n, S) int32 views) scatters
        in place instead of allocating — the caller's stacked slab slices
        skip one full (n, S)-sized copy per array."""
        cu, cv, cb, ce = self._closed_flat(n)
        ccnt = np.bincount(cu, minlength=n)
        tot = ccnt + self.cnt[:n]
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
        if cu.size:
            o = np.argsort(cu, kind="stable")
            off = np.cumsum(ccnt) - ccnt
            within = np.arange(cu.size) - off[cu[o]]
            tgt[cu[o], within] = cv[o]
            lab_b[cu[o], within] = cb[o]
            lab_e[cu[o], within] = ce[o]
        cnt = self.cnt[:n]
        eo = int(cnt.sum())
        if eo:
            rows = np.repeat(np.arange(n), cnt)
            within = np.arange(eo) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            cols = ccnt[rows] + within
            tgt[rows, cols] = self.adj[rows, within]
            lab_b[rows, cols] = self.born[rows, within]
            lab_e[rows, cols] = OPEN
        return tgt, lab_b, lab_e


def _reprune_vertices(g: _BulkLevel, vertices: np.ndarray,
                      close_version: int,
                      sq_norm: Optional[np.ndarray] = None) -> None:
    """Deferred, batched re-prune: RNG-prune every over-quota vertex of one
    level down to ``m_max`` in a single vectorized pass (the bulk analogue
    of ``LabeledLevelGraph._reprune``). Pruned edges close at
    ``close_version`` — the last version of the batch that caused the
    overflow — which keeps them valid for (at least) every version the
    incremental builder would have exposed them at."""
    vertices = np.asarray(vertices, np.int64)
    todo = vertices[g.cnt[vertices] > g.m_max]
    if todo.size == 0:
        return
    V = g.vectors
    deg = g.cnt[todo]
    R, Cmax = todo.size, int(deg.max())
    mask = np.arange(Cmax)[None, :] < deg[:, None]
    tgt = g.adj[todo, :Cmax].astype(np.int64)
    tgt[~mask] = -1
    if sq_norm is not None:
        d = gathered_sq_ids(V, sq_norm, todo, tgt)
    else:
        d = gathered_sq(V[todo], V[np.clip(tgt, 0, None)])
    d[~mask] = np.inf
    order = np.argsort(d, axis=1, kind="stable")
    kept = rng_prune_batch(V, np.take_along_axis(tgt, order, 1),
                           np.take_along_axis(d, order, 1), g.m_max,
                           sq_norm=sq_norm)
    # survivors-first compaction: adjacency rows are duplicate-free, so
    # flat (row, neighbor) keys identify edges; a stable argsort on the
    # keep mask rebuilds each row in original adjacency order
    stride = V.shape[0] + 1
    keys = np.arange(R, dtype=np.int64)[:, None] * stride \
        + np.where(mask, tgt, stride - 1)
    kkeys = (np.arange(R, dtype=np.int64)[:, None] * stride + kept)[kept >= 0]
    keep = np.isin(keys, kkeys).reshape(R, Cmax) & mask
    adj_rows = g.adj[todo, :Cmax].copy()
    born_rows = g.born[todo, :Cmax].copy()
    ordc = np.argsort(~keep, axis=1, kind="stable")
    g.adj[todo, :Cmax] = np.take_along_axis(adj_rows, ordc, 1)
    g.born[todo, :Cmax] = np.take_along_axis(born_rows, ordc, 1)
    g.cnt[todo] = keep.sum(axis=1)
    dropm = mask & ~keep
    if dropm.any():
        ri, _ = np.nonzero(dropm)
        g.closed_chunks.append((todo[ri], adj_rows[dropm].astype(np.int64),
                                born_rows[dropm].astype(np.int64),
                                int(close_version)))


def auto_n_clusters(n: int) -> int:
    """Default coarse-quantizer size for an ``n``-row training prefix:
    ``~16*sqrt(n)`` keeps probed-pool width ~``n_probe * sqrt(n)/16`` (the
    candidate matmul term, which dominates build time, shrinks linearly in
    the cluster count while the assignment matmul only grows ~n*K*d — cheap
    until K ~ 8192), clamped so tiny prefixes still get a few
    non-degenerate clusters and million-row builds stay under an
    8192-centroid assignment matmul."""
    return max(8, min(8192, int(round(16.0 * math.sqrt(n))), n // 8))


def _kmeans(X: np.ndarray, k: int, iters: int = _KMEANS_ITERS) -> np.ndarray:
    """Deterministic Lloyd k-means: evenly spaced init over the (already
    insertion-ordered) training rows, fixed iteration count, centroid
    updates as one scatter-add segment-sum per iteration (no per-cluster
    Python loop — the builder hot path stays array-native)."""
    n = int(X.shape[0])
    k = min(k, n)
    cent = np.ascontiguousarray(
        X[np.linspace(0, n - 1, k).astype(np.int64)], np.float32)
    for _ in range(iters):
        assign = np.empty(n, np.int64)
        for a in range(0, n, _ASSIGN_CHUNK):
            b = min(a + _ASSIGN_CHUNK, n)
            assign[a:b] = pairwise_sq(X[a:b], cent).argmin(axis=1)
        sums = np.zeros((k, X.shape[1]), np.float64)
        np.add.at(sums, assign, X)                  # segment-sum over rows
        counts = np.bincount(assign, minlength=k)
        nz = counts > 0
        cent[nz] = (sums[nz] / counts[nz, None]).astype(np.float32)
    return cent


class _CoarsePool:
    """IVF-style candidate pools over *insertion positions* of one variant.

    Trained lazily at the first batch whose inserted prefix reaches the
    coarse threshold: k-means centroids over (a sample of) the prefix, then
    every consolidated position lives in a CSR bucket per centroid. A batch
    row's pool is the members of its ``n_probe`` nearest centroids plus the
    *recent block* — positions inserted since the last consolidation, which
    are insertion-order (= attribute-order) neighbors and therefore carry
    most same-node candidates for the deep, narrow tree levels. Positions
    are merged into the CSR in O(new + total) per consolidation (stable
    within-cluster order), never re-sorted from scratch.
    """

    def __init__(self, V: np.ndarray, order: np.ndarray, *,
                 n_clusters: Optional[int], n_probe: int, ef_con: int,
                 batch: int, stats: Optional[Dict[str, float]] = None):
        self.V = V
        self.order = np.asarray(order, np.int64)
        self.n_clusters = n_clusters
        self.n_probe = max(1, int(n_probe))
        self.ef_con = ef_con
        self.consolidate_cap = max(batch, 512)
        self.stats = stats if stats is not None else {}
        self.trained = False
        self.centroids: Optional[np.ndarray] = None
        self.assign = np.full(self.order.shape[0], -1, np.int32)
        self.csr_until = 0
        self.K = 0
        self.csr_counts = np.zeros(0, np.int64)
        self.csr_indptr = np.zeros(1, np.int64)
        self.csr_idx = np.zeros(0, np.int64)

    def _assign_range(self, a: int, b: int) -> None:
        t0 = time.perf_counter()
        rows = self.V[self.order[a:b]]
        out = np.empty(b - a, np.int32)
        for c in range(0, b - a, _ASSIGN_CHUNK):
            e = min(c + _ASSIGN_CHUNK, b - a)
            out[c:e] = pairwise_sq(rows[c:e], self.centroids).argmin(axis=1)
        self.assign[a:b] = out
        self.stats["assign_s"] = (self.stats.get("assign_s", 0.0)
                                  + time.perf_counter() - t0)

    def _merge(self, upto: int) -> None:
        """Fold positions ``[csr_until, upto)`` into the CSR buckets."""
        a_new = self.assign[self.csr_until:upto].astype(np.int64)
        counts_new = np.bincount(a_new, minlength=self.K)
        counts = self.csr_counts + counts_new
        indptr = np.zeros(self.K + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        idx = np.empty(int(indptr[-1]), np.int64)
        if self.csr_idx.size:
            cl_old = np.repeat(np.arange(self.K), self.csr_counts)
            within = np.arange(self.csr_idx.size) - self.csr_indptr[cl_old]
            idx[indptr[cl_old] + within] = self.csr_idx
        if a_new.size:
            o = np.argsort(a_new, kind="stable")
            cl_new = a_new[o]
            grp = np.cumsum(counts_new) - counts_new
            within = np.arange(a_new.size) - grp[cl_new]
            idx[indptr[cl_new] + self.csr_counts[cl_new] + within] = \
                np.arange(self.csr_until, upto, dtype=np.int64)[o]
        self.csr_counts, self.csr_indptr, self.csr_idx = counts, indptr, idx
        self.csr_until = upto

    def train(self, start: int) -> None:
        """Fit centroids on the ``start``-row inserted prefix and bucket it."""
        t0 = time.perf_counter()
        sample = np.linspace(0, start - 1,
                             min(start, _KMEANS_SAMPLE)).astype(np.int64)
        # size the quantizer for the FULL build, not the training prefix:
        # buckets fill toward n/K as insertion proceeds, so a prefix-sized K
        # would let pool width grow linearly with n
        k = self.n_clusters or auto_n_clusters(self.order.shape[0])
        k = min(k, start)
        self.centroids = _kmeans(self.V[self.order[sample]], k)
        self.K = int(self.centroids.shape[0])
        self.csr_counts = np.zeros(self.K, np.int64)
        self.csr_indptr = np.zeros(self.K + 1, np.int64)
        self.stats["kmeans_s"] = (self.stats.get("kmeans_s", 0.0)
                                  + time.perf_counter() - t0)
        self._assign_range(0, start)
        self._merge(start)
        self.trained = True

    def maybe_consolidate(self, start: int) -> None:
        if start - self.csr_until >= self.consolidate_cap:
            self._assign_range(self.csr_until, start)
            self._merge(start)

    def pool(self, start: int, end: int):
        """Candidate *positions* for batch rows [start, end): ``(P, wb)``
        where ``P`` is (R, Cpool) — per-row probed-cluster members in
        columns ``[0, wb)`` (``-1``-padded) and the recent block, identical
        for every row, in the fixed tail ``[wb, Cpool)``. The caller masks
        positions at or after each row's own."""
        R = end - start
        q = self.V[self.order[start:end]]
        dq = pairwise_sq(q, self.centroids)
        p = min(self.n_probe, self.K)
        if p < self.K:
            top = np.argpartition(dq, p - 1, axis=1)[:, :p]
        else:
            top = np.tile(np.arange(self.K), (R, 1))
        # per-cluster contribution cap: generous vs the mean bucket size so
        # it only trims pathological skew, keeping pool width bounded
        cap = max(2 * self.ef_con, (4 * max(self.csr_until, 1)) // self.K)
        cnt_used = np.minimum(self.csr_counts[top], cap)
        rec = np.arange(self.csr_until, end, dtype=np.int64)
        wb = int(cnt_used.sum(axis=1).max()) if R else 0
        pool = np.full((R, max(wb + rec.size, 1)), -1, np.int64)
        cnt = cnt_used.ravel()
        tot = int(cnt.sum())
        if tot:
            seg = np.repeat(np.arange(R * p), cnt)
            within = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            src = self.csr_indptr[top.ravel()][seg] + within
            colbase = np.cumsum(cnt_used, axis=1) - cnt_used
            pool[seg // p, colbase.ravel()[seg] + within] = self.csr_idx[src]
        if rec.size:
            pool[:, wb:] = rec[None, :]
        return pool, wb


def _top_sorted(Dm: np.ndarray, C: int):
    """Per row: column indices + distances of the up-to-``C`` smallest
    entries of ``Dm``, sorted ascending (inf = masked-out)."""
    if Dm.shape[1] >= C:
        part = np.argpartition(Dm, C - 1, axis=1)[:, :C]
        pd = np.take_along_axis(Dm, part, axis=1)
    else:
        part = np.tile(np.arange(Dm.shape[1]), (Dm.shape[0], 1))
        pd = Dm
    o2 = np.argsort(pd, axis=1, kind="stable")
    return np.take_along_axis(part, o2, axis=1), \
        np.take_along_axis(pd, o2, axis=1)


def _apply_kept(g: _BulkLevel, batch: np.ndarray, kept: np.ndarray,
                rnode: np.ndarray, sort_rank: np.ndarray) -> np.ndarray:
    """Scatter pruned neighbor lists + member bookkeeping for one level's
    batch rows (in insertion order). Shared verbatim by the exact and
    coarse candidate stages — only the candidate sets feeding ``kept``
    differ. Returns every vertex whose degree changed; the caller checks
    quotas and schedules (deferred) re-pruning.

    Kept targets are always earlier than their row, so the forward scatter
    (batch rows start empty) followed by the grouped reverse scatter
    reproduces the per-edge append order of the incremental builder."""
    valid = kept >= 0                       # -1 padding is a suffix
    kcnt = valid.sum(axis=1)
    ver = sort_rank[batch]
    ri, ci = np.nonzero(valid)
    c_flat = kept[ri, ci]
    g.adj[batch[ri], ci] = c_flat
    g.born[batch[ri], ci] = ver[ri]
    g.cnt[batch] = kcnt
    uniq = np.zeros(0, np.int64)
    if ri.size:
        o = np.argsort(c_flat, kind="stable")
        cs = c_flat[o]
        uniq, counts = np.unique(cs, return_counts=True)
        g.ensure_width(int((g.cnt[uniq] + counts).max()))
        grp_off = np.cumsum(counts) - counts
        slot = np.repeat(g.cnt[uniq], counts) \
            + (np.arange(cs.size) - np.repeat(grp_off, counts))
        g.adj[cs, slot] = batch[ri[o]]
        g.born[cs, slot] = ver[ri[o]]
        g.cnt[uniq] += counts
    # membership bookkeeping stays per-row (one append per object-level)
    batch_l = batch.tolist()
    ver_l = ver.tolist()
    node_l = rnode.tolist()
    members, vers = g.node_members, g.node_member_vers
    for i, u in enumerate(batch_l):
        node = node_l[i]
        members.setdefault(node, []).append(u)
        vers.setdefault(node, []).append(ver_l[i])
    return np.concatenate([batch, uniq])


def bulk_insert_levels(vectors: np.ndarray, order: np.ndarray,
                       sort_rank: np.ndarray, tkey: np.ndarray, Lv: int, *,
                       m: int, ef_con: int, m_max: Optional[int] = None,
                       n_entries: int = 4, batch_size: Optional[int] = None,
                       progress: Optional[int] = None, variant: str = "?",
                       candidate_stage: str = "exact",
                       n_clusters: Optional[int] = None,
                       n_probe: int = DEFAULT_N_PROBE,
                       coarse_threshold: Optional[int] = None,
                       stats: Optional[Dict[str, float]] = None
                       ) -> "List[_BulkLevel]":
    """Build all ``Lv`` level graphs of one variant in sorted-order batches.

    Fills array-backed :class:`_BulkLevel` accumulators that freeze to the
    exact same dense schema as the incremental path's
    :class:`~repro_torch.core.hnsw.LabeledLevelGraph`, but produces candidates
    from batched distance matmuls instead of per-object beam searches and
    applies edges as numpy scatters. Returns the populated level graphs.

    ``candidate_stage="exact"`` computes each batch row's distances to
    *every* earlier object (one BLAS matmul per batch) — O(n^2) total.
    ``"coarse"`` switches, once the inserted prefix reaches
    ``coarse_threshold`` (default ``DEFAULT_COARSE_THRESHOLD``), to the
    :class:`_CoarsePool` quantizer: candidates come from the row's
    ``n_probe`` nearest of ``n_clusters`` k-means centroids' member buckets
    plus the recent insertion block, bounding per-batch work by the pool
    width instead of the prefix length. Per level, rows whose whole
    earlier same-node population fits in ``ef_con`` bypass the pool and
    gather that population exactly (the deep-level backstop), so small
    tree nodes see identical candidate sets in both stages; batches below
    the threshold run the exact code path, bit-identically.

    ``stats``, when given a dict, accumulates the wall-clock stage
    breakdown: ``candidate_s`` / ``prune_s`` / ``insert_s`` (+
    ``kmeans_s`` / ``assign_s`` and batch counters on the coarse path).
    """
    n = int(order.shape[0])
    B = DEFAULT_BATCH if batch_size is None else int(batch_size)
    if B < 1:
        raise ValueError("batch_size must be >= 1")
    if candidate_stage not in CANDIDATE_STAGES:
        raise ValueError(f"candidate_stage must be one of {CANDIDATE_STAGES}")
    threshold = (DEFAULT_COARSE_THRESHOLD if coarse_threshold is None
                 else max(1, int(coarse_threshold)))
    st = stats if stats is not None else {}
    V = np.ascontiguousarray(vectors, np.float32)
    # global squared norms, shared by every distance identity below — the
    # per-call norm einsums were a top-3 profile entry at n=50k
    Vn = np.einsum("nd,nd->n", V, V)
    levels = [_BulkLevel(V, n, m=m, ef_con=ef_con, m_max=m_max,
                         n_entries=n_entries) for _ in range(Lv)]
    if n == 0:
        return levels
    # tree node of every object at every level (Algorithm 1's root→leaf path)
    tkey_arr = np.asarray(tkey, np.int64)
    node_of = np.stack([tkey_arr >> (Lv - 1 - lvl) for lvl in range(Lv)])
    coarse: Optional[_CoarsePool] = None
    if candidate_stage == "coarse":
        coarse = _CoarsePool(V, order, n_clusters=n_clusters,
                             n_probe=n_probe, ef_con=ef_con, batch=B,
                             stats=st)
    pending = np.zeros((Lv, n), bool)       # per-level deferred-reprune sets
    hard_cap = levels[0].m_max + 2 * m
    batch_no = 0
    done = 0
    for start in range(0, n, B):
        batch = order[start:start + B]
        R = batch.shape[0]
        end = start + R
        use_coarse = coarse is not None and start >= threshold
        t0 = time.perf_counter()
        if use_coarse:
            if not coarse.trained:
                coarse.train(start)
            else:
                coarse.maybe_consolidate(start)
            t0 = time.perf_counter()   # train/consolidate timed separately
            P, wb = coarse.pool(start, end)          # (R, Cpool) positions
            row_pos = start + np.arange(R)
            p_earlier = (P >= 0) & (P < row_pos[:, None])
            pool_ids = order[np.clip(P, 0, None)]    # object ids
            # split distance computation: per-row bucket columns need the
            # gathered matvec form, but the recent-block tail is the same
            # positions for every row — one real GEMM covers it
            Dp = np.empty(P.shape, np.float32)
            Dp[:, :wb] = gathered_sq_ids(V, Vn, batch, pool_ids[:, :wb])
            if wb < P.shape[1]:
                Dp[:, wb:] = pairwise_sq(V[batch], V[pool_ids[0, wb:]])
            # gather pool tree keys once; per-level node ids are shifts
            pool_tkey = tkey_arr[pool_ids]
            Db = earlier = prev = None
            st["coarse_batches"] = st.get("coarse_batches", 0) + 1
        else:
            prev = order[:end]                # insertion order, incl. batch
            # one matmul: batch rows vs every earlier-or-in-batch object;
            # per-level candidate sets are masks over these shared rows
            Db = pairwise_sq(V[batch], V[prev])
            earlier = np.arange(end)[None, :] \
                < (start + np.arange(R))[:, None]
            st["exact_batches"] = st.get("exact_batches", 0) + 1
        shared_s = time.perf_counter() - t0
        C = min(ef_con, end)
        # candidate matrices for ALL levels of this batch, stacked so one
        # rng_prune_batch call prunes every (object, level) row at once —
        # rows are independent, so this is result-identical to per-level
        # calls but amortizes the per-call numpy overhead Lv-fold
        cand_ids_all = np.empty((Lv, R, C), np.int64)
        cand_d_all = np.empty((Lv, R, C), np.float32)
        t0 = time.perf_counter()
        for lvl in range(Lv):
            rnode = node_of[lvl][batch]
            if not use_coarse:
                Dm = np.where(earlier & (node_of[lvl][prev][None, :]
                                         == rnode[:, None]), Db, np.inf)
                # exact top-ef_con earlier same-node members per batch object
                # (the incremental beam search only approximates this set)
                cols, cand_d = _top_sorted(Dm, C)
                cand_ids = np.where(np.isfinite(cand_d), prev[cols], -1)
            else:
                cand_ids, cand_d = _coarse_level_candidates(
                    levels[lvl], V, Vn, batch, rnode, C, pool_ids, Dp,
                    p_earlier, pool_tkey >> (Lv - 1 - lvl))
            cand_ids_all[lvl] = cand_ids
            cand_d_all[lvl] = cand_d
        st["candidate_s"] = st.get("candidate_s", 0.0) \
            + time.perf_counter() - t0 + shared_s
        t0 = time.perf_counter()
        kept_all = rng_prune_batch(
            V, cand_ids_all.reshape(Lv * R, C),
            cand_d_all.reshape(Lv * R, C), m,
            sq_norm=Vn).reshape(Lv, R, m)
        st["prune_s"] = st.get("prune_s", 0.0) + time.perf_counter() - t0
        for lvl in range(Lv):
            g = levels[lvl]
            rnode = node_of[lvl][batch]
            t0 = time.perf_counter()
            touched = _apply_kept(g, batch, kept_all[lvl], rnode, sort_rank)
            deg = g.cnt[touched]
            pending[lvl][touched[deg > g.m_max]] = True
            urgent = np.unique(touched[deg > hard_cap])
            if urgent.size:
                _reprune_vertices(g, urgent,
                                  int(sort_rank[int(batch[-1])]),
                                  sq_norm=Vn)
                pending[lvl][urgent] = False
            st["insert_s"] = st.get("insert_s", 0.0) \
                + time.perf_counter() - t0
        batch_no += 1
        if batch_no % REPRUNE_EVERY == 0 or end == n:
            t0 = time.perf_counter()
            close_ver = int(sort_rank[int(batch[-1])])
            for lvl in range(Lv):
                todo = np.nonzero(pending[lvl])[0]
                if todo.size:
                    _reprune_vertices(levels[lvl], todo, close_ver,
                                      sq_norm=Vn)
                    pending[lvl][todo] = False
            st["insert_s"] = st.get("insert_s", 0.0) \
                + time.perf_counter() - t0
        done = end
        if progress and (done // progress) > ((done - R) // progress):
            logger.progress("bulk_insert", variant=variant, done=done,
                            total=n, final=(done == n))
    return levels


def _coarse_level_candidates(g: _BulkLevel, V: np.ndarray,
                             Vn: np.ndarray, batch: np.ndarray,
                             rnode: np.ndarray, C: int,
                             pool_ids: np.ndarray, Dp: np.ndarray,
                             p_earlier: np.ndarray,
                             pool_node: np.ndarray):
    """One level's sorted candidate matrix from the coarse pool.

    Big-node rows take the top-``C`` same-node entries of the pool; rows
    whose entire earlier same-node population fits in ``C`` instead gather
    that population exactly (pool misses on a nearly-empty deep node would
    otherwise starve its adjacency), making small nodes stage-invariant.
    """
    R = batch.shape[0]
    cand_ids = np.full((R, C), -1, np.int64)
    cand_d = np.full((R, C), np.inf, np.float32)
    # earlier same-node population = pre-batch members + in-batch earlier
    pre = np.fromiter((len(g.node_members.get(int(nd), ()))
                       for nd in rnode), np.int64, count=R)
    tri = np.tril(rnode[:, None] == rnode[None, :], -1).sum(axis=1)
    small = (pre + tri) <= C
    bigi = np.nonzero(~small)[0]
    if bigi.size:
        Dm = np.where(p_earlier[bigi]
                      & (pool_node[bigi] == rnode[bigi, None]),
                      Dp[bigi], np.inf)
        cols, sd = _top_sorted(Dm, C)
        sid = pool_ids[bigi[:, None], cols]
        w = sd.shape[1]
        cand_d[bigi, :w] = sd
        cand_ids[bigi, :w] = np.where(np.isfinite(sd), sid, -1)
    smalli = np.nonzero(small)[0]
    if smalli.size:
        acc: Dict[int, List[int]] = {}
        lists: List[List[int]] = []
        for i in range(R):
            nd = int(rnode[i])
            if small[i]:
                lists.append(list(g.node_members.get(nd, ()))
                             + acc.get(nd, []))
            acc.setdefault(nd, []).append(int(batch[i]))
        Cs = max(1, max(len(l) for l in lists))
        ids_s = np.full((len(lists), Cs), -1, np.int64)
        for r, l in enumerate(lists):
            ids_s[r, :len(l)] = l
        ds = gathered_sq_ids(V, Vn, batch[smalli], ids_s)
        ds[ids_s < 0] = np.inf
        o = np.argsort(ds, axis=1, kind="stable")
        w = min(Cs, C)
        cand_d[smalli, :w] = np.take_along_axis(ds, o, axis=1)[:, :w]
        cand_ids[smalli, :w] = np.take_along_axis(ids_s, o, axis=1)[:, :w]
    return cand_ids, cand_d
