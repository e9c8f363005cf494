"""Synthetic RRANN datasets (paper §5 protocol at laptop scale).

Vectors: mixture-of-Gaussians embeddings (clustered like real image/text
embeddings). Ranges: endpoints drawn over [0, span) from the paper's attribute
distributions (uniform / normal / poisson / longtail / zipf), Exp. 8. Queries:
vectors from held-out cluster samples; query ranges calibrated by bisection to
hit a target selectivity for a given RR mask (paper: "query ranges are randomly
determined according to the specified selectivity").
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import intervals as iv


@dataclasses.dataclass
class RangeDataset:
    vectors: np.ndarray   # (n, d) float32
    lo: np.ndarray        # (n,)
    hi: np.ndarray        # (n,)
    queries: np.ndarray   # (Q, d) float32
    span: float

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def d(self) -> int:
        return self.vectors.shape[1]


def _attr_values(n: int, dist: str, span: float, rng: np.random.Generator) -> np.ndarray:
    if dist == "uniform":
        v = rng.uniform(0, span, n)
    elif dist == "normal":
        v = np.clip(rng.normal(span / 2, span / 6, n), 0, span)
    elif dist == "poisson":
        v = np.minimum(rng.poisson(span / 3, n).astype(np.float64), span)
    elif dist == "longtail":
        v = np.minimum(rng.exponential(span / 5, n), span)
    elif dist == "zipf":
        z = rng.zipf(1.7, n).astype(np.float64)
        v = span * np.minimum(z, 1000.0) / 1000.0
    else:
        raise ValueError(f"unknown attribute distribution {dist}")
    return v


def make_range_dataset(n: int = 2000, d: int = 32, n_queries: int = 32,
                       clusters: int = 16, dist: str = "uniform",
                       span: float = 1000.0, max_width_frac: float = 0.25,
                       quantize: Optional[int] = None,
                       seed: int = 0) -> RangeDataset:
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1, (clusters, d))
    assign = rng.integers(0, clusters, n)
    vectors = (centers[assign] + 0.35 * rng.normal(0, 1, (n, d))).astype(np.float32)
    qassign = rng.integers(0, clusters, n_queries)
    queries = (centers[qassign] + 0.35 * rng.normal(0, 1, (n_queries, d))).astype(np.float32)

    a = _attr_values(n, dist, span, rng)
    w = rng.uniform(0, span * max_width_frac, n)
    lo = np.minimum(a, np.clip(a + w * rng.choice([-1, 1], n), 0, span))
    hi = np.maximum(a, np.clip(a + w * rng.choice([-1, 1], n), 0, span))
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    if quantize:
        # finite attribute domain |A| = quantize (paper Exp. 10 varies |A|)
        grid = np.linspace(0, span, quantize)
        lo = grid[np.clip(np.searchsorted(grid, lo), 0, quantize - 1)]
        hi = grid[np.clip(np.searchsorted(grid, hi), 0, quantize - 1)]
        lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    return RangeDataset(vectors=vectors, lo=lo, hi=hi, queries=queries, span=span)


def make_queries(ds: RangeDataset, mask: int, selectivity: float,
                 n_queries: Optional[int] = None, tol: float = 0.35,
                 seed: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Per-query (qlo, qhi) calibrated so that ~selectivity of objects satisfy
    ``mask``; bisection on the query width around a random center."""
    rng = np.random.default_rng(seed)
    Q = n_queries or ds.queries.shape[0]
    qlo = np.empty(Q)
    qhi = np.empty(Q)
    target = selectivity * ds.n
    # count(width) is not monotone for general masks (e.g. QUERY_CONTAINED
    # shrinks with width) -> probe a geometric width grid and keep the best.
    widths = np.concatenate([[0.0], np.geomspace(ds.span * 1e-4, ds.span, 28)])
    for qi in range(Q):
        best, best_err = (0.0, 0.0), np.inf
        for _ in range(8):  # retry centers until within tolerance
            c = rng.uniform(0, ds.span)
            for w in widths:
                a, b = max(0.0, c - w / 2), min(ds.span, c + w / 2)
                cnt = int(np.count_nonzero(iv.eval_predicate(mask, ds.lo, ds.hi, a, b)))
                err = abs(cnt - target)
                if err < best_err:
                    best, best_err = (a, b), err
            if best_err <= tol * target:
                break
        qlo[qi], qhi[qi] = best
    return qlo, qhi


def brute_force_topk(vectors: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                     queries: np.ndarray, qlo: np.ndarray, qhi: np.ndarray,
                     mask: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact numpy ground truth (independent of the JAX flat engine)."""
    Q = queries.shape[0]
    ids = np.full((Q, k), -1, np.int64)
    ds = np.full((Q, k), np.inf)
    for qi in range(Q):
        sel = np.asarray(iv.eval_predicate(mask, lo, hi, qlo[qi], qhi[qi]))
        idx = np.nonzero(sel)[0]
        if idx.size == 0:
            continue
        diff = vectors[idx] - queries[qi]
        dist = np.einsum("nd,nd->n", diff, diff)
        order = np.argsort(dist, kind="stable")[:k]
        ids[qi, :order.size] = idx[order]
        ds[qi, :order.size] = dist[order]
    return ids, ds


def recall_at_k(found_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Plain Recall@k: |found ∩ true| / |true| averaged over queries with
    non-empty ground truth."""
    hit = 0
    total = 0
    for qi in range(true_ids.shape[0]):
        t = set(int(x) for x in true_ids[qi] if x >= 0)
        if not t:
            continue
        total += len(t)
        f = set(int(x) for x in found_ids[qi] if x >= 0)
        hit += len(t & f)
    return hit / max(total, 1)


def relative_distance_error(found_dists: np.ndarray, true_dists: np.ndarray
                            ) -> float:
    """RDE (paper Exp. 1 / Fig. 11): mean over queries of
    (1/k) * sum_i (d(q, p_i)/d(q, p_i*) - 1), on squared-L2-consistent
    distances (monotone-equivalent ranking; we report sqrt for L2)."""
    out = []
    for qi in range(true_dists.shape[0]):
        t = np.sqrt(np.maximum(true_dists[qi][np.isfinite(true_dists[qi])], 0))
        f = np.sqrt(np.maximum(found_dists[qi][:len(t)], 0))
        if t.size == 0:
            continue
        f = np.where(np.isfinite(f), f, np.nanmax(t) * 4 + 1e-9)
        out.append(np.mean(f / np.maximum(t, 1e-12) - 1.0))
    return float(np.mean(out)) if out else 0.0
