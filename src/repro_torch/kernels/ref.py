"""Plain PyTorch versions of the three hand-written CUDA kernels.

Each function computes exactly what its kernel in ``csrc/`` computes, on any
device. :mod:`repro_torch.kernels.ops` calls these only for tensors that lie
on the CPU; the tests hold them against the JAX reference package, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.

Tie-breaking follows the reference: where it picks with ``lax.top_k`` (ties
to the lowest position) these use a stable ascending sort.
"""
from __future__ import annotations

import torch

from ..core import intervals as iv

NO_EDGE = -1


def pairwise_l2_masked_ref(queries, corpus, lo, hi, ql, qh, mask: int):
    """(Q, d) x (N, d) -> (Q, N) float32 ``|q|^2 - 2 q.c + |c|^2``; +inf
    where the RR predicate ``mask`` fails (a NaN endpoint fails every
    comparison, so NaN-padded rows never qualify)."""
    q = queries.to(torch.float32)
    c = corpus.to(torch.float32)
    qn = (q * q).sum(dim=1, keepdim=True)
    cn = (c * c).sum(dim=1)
    d = qn - 2.0 * (q @ c.T) + cn[None, :]
    sel = iv.eval_predicate(mask, lo.to(torch.float32)[None, :],
                            hi.to(torch.float32)[None, :],
                            ql.to(torch.float32)[:, None],
                            qh.to(torch.float32)[:, None])
    return torch.where(sel, d, torch.inf)


def gathered_l2_ref(queries, cand_vecs):
    """(Q, d) x (Q, S, d) -> (Q, S) squared L2 as a diff-square-sum, fp32."""
    diff = cand_vecs.to(torch.float32) - queries.to(torch.float32)[:, None, :]
    return (diff * diff).sum(dim=-1)


def gathered_topk_ref(queries, vectors, ids, avail, b, e, version,
                      pool_ids, pool_d, pool_exp):
    """One fused wavefront step: gather the ``(Q, M)`` candidate rows by id,
    squared L2 to the query, label mask ``avail & b <= version <= e``, and
    merge into the sorted ``(Q, L)`` beam (ties to the lower position of
    ``[pool | candidates]``). A candidate whose id is ``NO_EDGE`` or not
    below the table's row count counts as masked. Empty slots come out as
    (NO_EDGE, +inf, False)."""
    L = pool_d.shape[1]
    ver = version.to(torch.int32)[:, None]
    ok = (avail.to(torch.bool) & (ids >= 0) & (ids < vectors.shape[0])
          & (b <= ver) & (ver <= e))
    idx = torch.where(ok, ids, 0).to(torch.int64)
    nd = gathered_l2_ref(queries, vectors[idx])
    nd = torch.where(ok, nd, torch.inf)
    nid = torch.where(ok, ids.to(torch.int32), NO_EDGE)
    cat_d = torch.cat([pool_d.to(torch.float32), nd], dim=1)
    cat_i = torch.cat([pool_ids.to(torch.int32), nid], dim=1)
    cat_e = torch.cat([pool_exp.to(torch.bool), torch.zeros_like(ok)], dim=1)
    out_d, order = torch.sort(cat_d, dim=1, stable=True)
    out_d, order = out_d[:, :L], order[:, :L]
    fin = torch.isfinite(out_d)
    out_i = torch.where(fin, cat_i.gather(1, order), NO_EDGE)
    out_e = cat_e.gather(1, order) & fin
    return out_i, out_d, out_e
