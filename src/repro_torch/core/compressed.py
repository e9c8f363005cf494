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

from .flat import _smallest_stable

NO_EDGE = -1
INF = float("inf")


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
