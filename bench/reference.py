"""The plain reference: the paper's four RR atoms and their disjunction, and
exact filtered top-k over the corpus the harness made, in plain PyTorch.

It imports nothing of the program. It reads only what the harness made (the
corpus, the ranges, the queries) and, to judge them, the program's answers.

Between an object range [lo, hi] and a query range [ql, qh] (closed ends):

* ``LeftOverlap``      lo <= ql <= hi <= qh
* ``QueryContained``   lo <= ql and qh <= hi   (the object covers the query)
* ``RightOverlap``     ql <= lo <= qh <= hi
* ``QueryContaining``  ql <= lo and hi <= qh   (the query covers the object)
* ``Overlaps``         the disjunction of the four (any intersection)

Distances are squared L2. ``precision="float64"`` is the reference; the
control computes the same in TF32 (``precision="tf32"``), the nearest
precision below the float32 that the configurations state.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

ATOMS = ("LeftOverlap", "QueryContained", "RightOverlap", "QueryContaining")
PREDICATES = ATOMS + ("Overlaps",)


def holds(name: str, lo, hi, ql, qh):
    """Truth of predicate ``name``; numpy arrays or tensors that broadcast."""
    if name == "LeftOverlap":
        return (lo <= ql) & (ql <= hi) & (hi <= qh)
    if name == "QueryContained":
        return (lo <= ql) & (qh <= hi)
    if name == "RightOverlap":
        return (ql <= lo) & (lo <= qh) & (qh <= hi)
    if name == "QueryContaining":
        return (ql <= lo) & (hi <= qh)
    if name == "Overlaps":
        out = holds(ATOMS[0], lo, hi, ql, qh)
        for atom in ATOMS[1:]:
            out = out | holds(atom, lo, hi, ql, qh)
        return out
    raise ValueError(f"unknown predicate {name!r}")


def _dists(q, x, precision: str):
    """(Q, B) squared L2 between q (Q, d) and x (B, d)."""
    if precision == "float64":
        q = q.double()
        x = x.double()
        return ((q * q).sum(1)[:, None] - 2.0 * (q @ x.T)
                + (x * x).sum(1)[None, :]).clamp_min_(0.0)
    if precision == "tf32":
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            q = q.float()
            x = x.float()
            cross = _tf32_round(q) @ _tf32_round(x).T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        return ((q * q).sum(1)[:, None] - 2.0 * cross
                + (x * x).sum(1)[None, :]).clamp_min_(0.0).double()
    raise ValueError(f"unknown precision {precision!r}")


def _tf32_round(t):
    """``t`` rounded to TF32's 10 mantissa bits (round to nearest even), so
    the product is TF32's on the CPU too, where ``allow_tf32`` does nothing."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def exact_topk(vectors, lo, hi, queries, ql, qh, predicate: str, k: int,
               precision: str = "float64", block: int = 65536
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact filtered top-k of every query over the whole corpus.

    ``vectors`` (n, d), ``lo`` / ``hi`` (n,) and ``queries`` (Q, d),
    ``ql`` / ``qh`` (Q,) are tensors on one device. Returns numpy (Q, k)
    int64 ids (-1 where fewer than k qualify), (Q, k) float64 distances
    (+inf there) and (Q,) int64 counts of qualifying objects. Among equal
    distances the lower id comes first."""
    n = vectors.shape[0]
    Q = queries.shape[0]
    dev = queries.device
    best_d = torch.full((Q, 0), float("inf"), dtype=torch.float64, device=dev)
    best_i = torch.zeros((Q, 0), dtype=torch.int64, device=dev)
    counts = torch.zeros(Q, dtype=torch.int64, device=dev)
    for n0 in range(0, n, block):
        n1 = min(n, n0 + block)
        ok = holds(predicate, lo[None, n0:n1], hi[None, n0:n1],
                   ql[:, None], qh[:, None])
        counts += ok.sum(1)
        d = _dists(queries, vectors[n0:n1], precision)
        d = torch.where(ok, d, float("inf"))
        ids = torch.arange(n0, n1, device=dev).expand(Q, -1)
        cat_d = torch.cat([best_d, d], 1)
        cat_i = torch.cat([best_i, ids], 1)
        # ids ascend along each row, so a stable sort keeps the lowest id
        # first among equal distances
        order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
        best_d = cat_d.gather(1, order)
        best_i = cat_i.gather(1, order)
        o = torch.argsort(best_i, dim=1)
        best_i, best_d = best_i.gather(1, o), best_d.gather(1, o)
    if best_d.shape[1] < k:                  # a corpus of fewer than k rows
        pad = k - best_d.shape[1]
        best_d = torch.cat([best_d, best_d.new_full((Q, pad), float("inf"))],
                           1)
        best_i = torch.cat([best_i, best_i.new_full((Q, pad), n)], 1)
    order = torch.sort(best_d, dim=1, stable=True).indices
    best_d = best_d.gather(1, order)
    best_i = best_i.gather(1, order)
    best_i = torch.where(torch.isinf(best_d), -1, best_i)
    return best_i.cpu().numpy(), best_d.cpu().numpy(), counts.cpu().numpy()


def pair_dists(vectors, queries, ids: np.ndarray) -> np.ndarray:
    """(Q, k) float64 squared L2 between each query and the rows ``ids``
    names (+inf where an id is negative), summed from exact differences."""
    dev = queries.device
    idt = torch.as_tensor(ids, dtype=torch.int64, device=dev)
    rows = vectors[idt.clamp_min(0)].double()               # (Q, k, d)
    diff = rows - queries.double()[:, None, :]
    d = (diff * diff).sum(-1)
    return torch.where(idt >= 0, d, float("inf")).cpu().numpy()
