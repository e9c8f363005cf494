"""Inputs of the flat route's tie tests, shared by the CPU test against the
reference (``test_torch_flat_ties.py``) and the card's test of the route
(``test_torch_cuda.py``). Imports neither ``jax`` nor ``repro``."""
import numpy as np

N_DISTINCT, N, D, Q = 40, 3000, 8, 12


def tied_corpus(seed: int, q: int = Q):
    """Corpus rows drawn with repetition from N_DISTINCT (vector, lo, hi)
    rows; ``q`` queries near some of them with random ranges. Returns
    (corpus, lo, hi, queries, ql, qh), ``flat_search``'s order."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(N_DISTINCT, D)).astype(np.float32)
    blo = rng.uniform(0, 1, N_DISTINCT).astype(np.float32)
    bhi = (blo + rng.uniform(0, 0.5, N_DISTINCT)).astype(np.float32)
    pick = rng.integers(0, N_DISTINCT, N)
    qv = (base[rng.integers(0, N_DISTINCT, q)]
          + rng.normal(scale=0.05, size=(q, D))).astype(np.float32)
    ql = rng.uniform(0, 1, q).astype(np.float32)
    qh = (ql + rng.uniform(0, 0.6, q)).astype(np.float32)
    return base[pick], blo[pick], bhi[pick], qv, ql, qh
