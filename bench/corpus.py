"""The corpus recipe, frozen here so that a change to the program cannot move
it: a copy of the port's ``make_range_dataset`` distributions (``uniform``
attributes, quantised), drawn with a ``torch.Generator`` on the device in a
few large calls.

* vectors: ``clusters`` Gaussian centres N(0, 1) in ``d`` dimensions, each
  row a random centre plus ``noise`` * N(0, 1);
* ranges: a centre ``a`` uniform over [0, span), a width ``w`` uniform over
  [0, span * max_width_frac), each endpoint ``a +- w`` (a random sign each),
  clipped to [0, span] and ordered; then both endpoints rounded up onto a
  grid of ``attribute_domain`` values over [0, span] (``|A|``).

Query vectors come from the same centres (:func:`query_vectors`). The
``(lo, hi)`` rank histogram (:func:`rank_histogram`) counts any RR predicate
over the corpus at once; the traffic generators read it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Corpus:
    vectors: np.ndarray     # (n, d) float32
    lo: np.ndarray          # (n,) float64 grid values
    hi: np.ndarray          # (n,) float64 grid values
    lo_rank: np.ndarray     # (n,) int64 index into ``grid``
    hi_rank: np.ndarray     # (n,) int64
    grid: np.ndarray        # (|A|,) float64 attribute values
    centers: np.ndarray     # (clusters, d) float32
    noise: float

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def d(self) -> int:
        return self.vectors.shape[1]


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make(recipe: dict, n: int, d: int, seed: int, device) -> Corpus:
    """The corpus of a configuration's ``corpus`` recipe, from ``seed``."""
    if recipe["recipe"] != "gaussian_ranges":
        raise ValueError(f"unknown corpus recipe {recipe['recipe']!r}")
    if recipe.get("attribute_dist", "uniform") != "uniform":
        raise ValueError("only uniform attribute centres are frozen here")
    dev = torch.device(device)
    g = generator(seed, dev)
    clusters = int(recipe["clusters"])
    noise = float(recipe["noise"])
    span = float(recipe["span"])
    K = int(recipe["attribute_domain"])
    centers = torch.randn(clusters, d, generator=g, device=dev)
    assign = torch.randint(0, clusters, (n,), generator=g, device=dev)
    vectors = torch.randn(n, d, generator=g, device=dev).mul_(noise)
    vectors += centers[assign]
    f64 = torch.float64
    a = torch.rand(n, generator=g, device=dev, dtype=f64) * span
    w = torch.rand(n, generator=g, device=dev, dtype=f64) * (
        span * float(recipe["max_width_frac"]))
    s1 = torch.randint(0, 2, (n,), generator=g, device=dev) * 2 - 1
    s2 = torch.randint(0, 2, (n,), generator=g, device=dev) * 2 - 1
    e1 = (a + w * s1).clamp(0.0, span)
    e2 = (a + w * s2).clamp(0.0, span)
    lo = torch.minimum(a, e1)
    hi = torch.maximum(a, e2)
    lo, hi = torch.minimum(lo, hi), torch.maximum(lo, hi)
    grid = torch.linspace(0.0, span, K, dtype=f64, device=dev)
    lo_r = torch.searchsorted(grid, lo).clamp(0, K - 1)
    hi_r = torch.searchsorted(grid, hi).clamp(0, K - 1)
    lo_r, hi_r = torch.minimum(lo_r, hi_r), torch.maximum(lo_r, hi_r)
    grid_np = grid.cpu().numpy()
    lo_r = lo_r.cpu().numpy().astype(np.int64)
    hi_r = hi_r.cpu().numpy().astype(np.int64)
    return Corpus(vectors=vectors.cpu().numpy(), lo=grid_np[lo_r],
                  hi=grid_np[hi_r], lo_rank=lo_r, hi_rank=hi_r,
                  grid=grid_np, centers=centers.cpu().numpy(), noise=noise)


def query_vectors(corpus: Corpus, count: int, g: torch.Generator,
                  device) -> np.ndarray:
    """(count, d) float32 queries: a random centre plus the corpus's noise."""
    dev = torch.device(device)
    centers = torch.as_tensor(corpus.centers, device=dev)
    pick = torch.randint(0, centers.shape[0], (count,), generator=g,
                         device=dev)
    q = torch.randn(count, corpus.d, generator=g, device=dev)
    q.mul_(corpus.noise).add_(centers[pick])
    return q.cpu().numpy()


def rank_histogram(corpus: Corpus) -> np.ndarray:
    """(|A|, |A|) int64: objects by (lo rank, hi rank)."""
    K = corpus.grid.shape[0]
    flat = corpus.lo_rank * K + corpus.hi_rank
    return np.bincount(flat, minlength=K * K).reshape(K, K)
