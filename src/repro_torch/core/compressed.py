"""Compressed-scan execution: approximate top-R over quantized codes, then
an exact float32 re-rank of those R candidates.

The counterpart of the JAX reference's ``repro.core.compressed``. A scan
over int8 or float16 codes gives approximate distances; the engine keeps
an over-fetched candidate list (``rerank_k >= k``) and :func:`exact_rerank`
recomputes the true float32 distances of just those R rows before the
final top-k, so end recall matches the exact scan whenever the candidate
list holds the true neighbours.

The flat route scans with the ``pairwise_l2_int8`` kernel (int8) or the
``pairwise_l2_masked`` kernel on the float16 codes, and
:func:`topr_from_dists` reduces the (Q, N) output to the candidate list.
The reference's ``compressed_flat_topr`` (its ``use_kernel=False`` path, a
blocked running top-R over the codes) is not ported: the port always takes
the kernel path.

The float32 corpus used by the re-rank stays host-side: the engine gathers
the R candidate rows with NumPy and ships only the (Q, R, d) slice to the
device. Ties follow ``lax.top_k``: the lowest position wins.
"""
from __future__ import annotations

import torch

NO_EDGE = -1
INF = float("inf")


def _smallest_stable(dists, R: int):
    """The R smallest entries of each row, ascending, ties to the lowest
    column (``lax.top_k(-dists, R)``'s order): (values, columns).

    ``torch.topk`` picks among equal values in no promised order, so it
    takes a wider set of W > R first and orders that set by (value,
    column). The set holds every entry equal to the R-th value once its
    W-th value is larger, or the R-th is +inf (then the tied entries are
    non-qualifying rows, which come out as NO_EDGE whatever their column).
    Rows where neither holds take a full stable sort."""
    N = dists.shape[1]
    W = min(N, 2 * R + 32)
    if W == N:
        vals, cols = torch.sort(dists, dim=1, stable=True)
        return vals[:, :R], cols[:, :R]
    vals, cols = torch.topk(dists, W, dim=1, largest=False, sorted=True)
    cols, by_col = torch.sort(cols, dim=1)
    vals, by_val = torch.sort(vals.gather(1, by_col), dim=1, stable=True)
    cols = cols.gather(1, by_val)
    sure = (vals[:, W - 1] > vals[:, R - 1]) | torch.isinf(vals[:, R - 1])
    if not bool(sure.all()):
        rows = torch.nonzero(~sure).flatten()
        v, c = torch.sort(dists[rows], dim=1, stable=True)
        vals[rows, :R], cols[rows, :R] = v[:, :R], c[:, :R]
    return vals[:, :R], cols[:, :R]


def topr_from_dists(dists, *, rerank: int):
    """Reduce a full (Q, N) approximate distance matrix to its top-R
    candidates: ((Q, R) int32 ids, (Q, R) float32 dists), ascending,
    NO_EDGE / +inf where fewer than R rows qualify."""
    R = min(int(rerank), dists.shape[1])
    vals, cols = _smallest_stable(dists, R)
    ids = torch.where(torch.isfinite(vals), cols, NO_EDGE).to(torch.int32)
    return ids, vals


def exact_rerank(queries, cand_vecs, cand_ids, *, k: int):
    """Exact float32 squared L2 over the gathered (Q, R, d) candidate rows,
    then the top k. NO_EDGE candidates rank +inf; ids whose re-ranked
    distance is +inf come back as NO_EDGE (fewer than k qualifiers)."""
    diff = cand_vecs.to(torch.float32) - queries.to(torch.float32)[:, None, :]
    dist = (diff * diff).sum(dim=-1)
    dist = torch.where(cand_ids >= 0, dist, INF)
    dist, pos = torch.sort(dist, dim=1, stable=True)
    dist, pos = dist[:, :k], pos[:, :k]
    ids = torch.where(torch.isfinite(dist), cand_ids.gather(1, pos), NO_EDGE)
    return ids.to(torch.int32), dist
