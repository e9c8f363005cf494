"""The query generator: query vectors from the corpus's centres, one
predicate a request and query ranges of a chosen selectivity, all from the
seed, vectorised.

A (|A|, |A|) histogram of the corpus over (lo rank, hi rank) turns every RR
predicate of a query range [grid[i], grid[j]] into a rectangle sum over it,
so the selectivity of all |A| (|A| + 1) / 2 grid ranges is known at once
for each predicate; a query range is drawn among those whose selectivity
lies within ``tolerance`` (relative) of its target.

Every seed gets the same set of sizes in another order: each predicate
serves the same number of requests, and its queries' targets are the same
log-spaced (or evenly spaced) quantiles of the selectivity law, permuted.
Where a predicate cannot reach part of the law's range on this corpus (on
the configurations' ranges no atom passes ~12.6% and the disjunction
``Overlaps`` never falls below ~6.3%), its targets are drawn over the part
it can reach, and where it reaches none of it, at the reachable
selectivity nearest to the law.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from bench import corpus as corpus_mod
from bench.reference import PREDICATES


@dataclasses.dataclass
class Request:
    predicate: str
    vectors: np.ndarray     # (b, d) float32
    qlo: np.ndarray         # (b,) float64
    qhi: np.ndarray         # (b,) float64
    target: np.ndarray      # (b,) wanted selectivity
    achieved: np.ndarray    # (b,) selectivity of the drawn range


@dataclasses.dataclass
class Traffic:
    pool: List[Request]
    seed: int
    out_of_tolerance: int

    def rng(self, stream: int) -> np.random.Generator:
        """An independent generator for one use of the seed (``stream``)."""
        return np.random.default_rng([int(self.seed) % (1 << 63), stream])

    def arrivals(self, rate: float, seconds: float, stream: int):
        """Poisson arrivals at ``rate`` over ``seconds``: (due times in
        seconds, pool index of each). The gaps are the exponential law's
        evenly spaced quantiles in a seeded order, so every seed offers the
        same load."""
        m = max(1, int(np.ceil(rate * seconds)))
        u = (np.arange(m) + 0.5) / m
        rng = self.rng(stream)
        gaps = rng.permutation(-np.log1p(-u) / rate)
        due = np.cumsum(gaps)
        due = due[due < seconds]
        which = np.resize(rng.permutation(len(self.pool)), due.shape[0])
        return due, which


def rect_counts(hist: np.ndarray, predicate: str, i: np.ndarray,
                j: np.ndarray) -> np.ndarray:
    """Objects satisfying ``predicate`` against the ranges [grid[i],
    grid[j]] (i <= j), from the (lo rank, hi rank) histogram."""
    K = hist.shape[0]
    P = np.zeros((K + 1, K + 1), np.int64)
    P[1:, 1:] = hist.cumsum(0).cumsum(1)

    def rect(a0, a1, b0, b1):
        # objects with a0 <= lo rank <= a1 and b0 <= hi rank <= b1
        return (P[a1 + 1, b1 + 1] - P[a0, b1 + 1] - P[a1 + 1, b0]
                + P[a0, b0])

    last = np.full_like(i, K - 1)
    zero = np.zeros_like(i)
    if predicate == "LeftOverlap":          # lo <= ql <= hi <= qh
        return rect(zero, i, i, j)
    if predicate == "QueryContained":       # lo <= ql, qh <= hi
        return rect(zero, i, j, last)
    if predicate == "RightOverlap":         # ql <= lo <= qh <= hi
        return rect(i, j, j, last)
    if predicate == "QueryContaining":      # ql <= lo, hi <= qh
        return rect(i, last, zero, j)
    if predicate == "Overlaps":             # lo <= qh, ql <= hi
        return rect(zero, j, i, last)
    raise ValueError(f"unknown predicate {predicate!r}")


def selectivity_table(hist: np.ndarray, n: int, predicate: str):
    """Every grid range's selectivity under ``predicate``, ascending:
    (selectivity, i, j)."""
    K = hist.shape[0]
    i, j = np.triu_indices(K)
    sel = rect_counts(hist, predicate, i, j) / float(n)
    order = np.argsort(sel, kind="stable")
    return sel[order], i[order], j[order]


def targets(law: dict, lo: float, hi: float, count: int,
            rng: np.random.Generator) -> np.ndarray:
    """``count`` evenly spaced quantiles of the law over [lo, hi], in a
    seeded order."""
    u = (np.arange(count) + 0.5) / count
    if law["law"] == "log_uniform":
        t = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    elif law["law"] == "uniform":
        t = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown selectivity law {law['law']!r}")
    return rng.permutation(t)


def make(mix: dict, corpus, seed: int, device) -> Traffic:
    """The request pool of ``mix`` over ``corpus``, from ``seed``."""
    b = int(mix["batch"])
    P = int(mix["pool"])
    preds = list(mix["predicates"])
    for p in preds:
        if p not in PREDICATES:
            raise ValueError(f"unknown predicate {p!r}")
    if P % len(preds):
        raise ValueError("the pool must hold each predicate equally often")
    law = mix["selectivity"]
    tol = float(law["tolerance"])
    traffic = Traffic(pool=[], seed=seed, out_of_tolerance=0)
    rng = traffic.rng(0)
    hist = corpus_mod.rank_histogram(corpus)
    order = rng.permutation(np.repeat(np.arange(len(preds)), P // len(preds)))
    per_pred = P // len(preds) * b
    drawn: Dict[str, list] = {}
    for pi, p in enumerate(preds):
        sel, ii, jj = selectivity_table(hist, corpus.n, p)
        pos = sel[sel > 0]
        lo_t = max(float(law["low"]), float(pos[0]) * (1 + tol))
        hi_t = min(float(law["high"]), float(pos[-1]) / (1 + tol))
        if lo_t > hi_t:
            # the law lies wholly outside what p reaches: its requests take
            # the reachable selectivity nearest to the law
            lo_t = hi_t = (float(pos[0]) * (1 + tol)
                           if float(law["high"]) < float(pos[0])
                           else float(pos[-1]) / (1 + tol))
        t = targets(law, lo_t, hi_t, per_pred, rng)
        a = np.searchsorted(sel, t / (1 + tol), side="left")
        z = np.searchsorted(sel, t * (1 + tol), side="right")
        ok = z > a
        pick = a + (rng.random(per_pred) * np.maximum(z - a, 1)).astype(
            np.int64)
        nearest = np.clip(np.searchsorted(sel, t), 0, sel.shape[0] - 1)
        pick = np.where(ok, np.minimum(pick, z - 1), nearest)
        traffic.out_of_tolerance += int((~ok).sum())
        drawn[p] = [t, corpus.grid[ii[pick]], corpus.grid[jj[pick]],
                    sel[pick], 0]
    g = corpus_mod.generator(int(seed) % (1 << 63) ^ 0x5EED, device)
    vectors = corpus_mod.query_vectors(corpus, P * b, g, device)
    for r, pi in enumerate(order):
        d = drawn[preds[pi]]
        s = slice(d[4], d[4] + b)
        d[4] += b
        traffic.pool.append(Request(
            predicate=preds[pi], vectors=vectors[r * b:(r + 1) * b],
            qlo=d[1][s], qhi=d[2][s], target=d[0][s], achieved=d[3][s]))
    return traffic
