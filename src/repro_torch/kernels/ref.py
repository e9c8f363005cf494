"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function computes exactly what its kernel in ``csrc/`` computes, on any
device. :mod:`repro_torch.kernels.ops` calls these only for tensors that lie
on the CPU; the tests hold them against the JAX reference package, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.

Tie-breaking follows the reference: where it picks with ``lax.top_k`` (ties
to the lowest position) these use a stable ascending sort.

:func:`quantize_query_weights_ref` is no kernel's plain version: it is the
int8 scan's query-side prologue, which runs in plain torch on every device
(the reference, too, calls it outside its ``pallas_call``).
:func:`topk_mask_ref` is no kernel's either: the reference's top-k mask
oracle, kept beside its other oracles.
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


def gathered_l2_dot_ref(queries, cand_vecs):
    """(Q, d) x (Q, S, d) -> (Q, S) squared L2 in the contraction form
    ``|q|^2 - 2 q.c + |c|^2``, fp32 (the reference's MXU form)."""
    q = queries.to(torch.float32)
    c = cand_vecs.to(torch.float32)
    qn = (q * q).sum(dim=-1)
    cn = (c * c).sum(dim=-1)
    cross = torch.bmm(c, q[:, :, None])[..., 0]
    return qn[:, None] - 2.0 * cross + cn


def fused_topk_l2_ref(queries, corpus, lo, hi, ql, qh, mask: int, k: int,
                      block: int = 16384):
    """Exact filtered k-NN without the (Q, N) matrix: walk the corpus in
    blocks of ``block`` rows, score each with
    :func:`pairwise_l2_masked_ref`'s formula, and keep a running (Q, k)
    top-k ordered by (dist, id), ties to the lowest id. Entries that are
    not finite never qualify; missing ones (``k > N``, or fewer than k rows
    pass the predicate) come out as (NO_EDGE, +inf). Returns ((Q, k) int32
    ids, (Q, k) float32 dists)."""
    Q = queries.shape[0]
    N = corpus.shape[0]
    dev = queries.device
    run_d = torch.full((Q, k), torch.inf, dtype=torch.float32, device=dev)
    run_i = torch.full((Q, k), NO_EDGE, dtype=torch.int32, device=dev)
    for n0 in range(0, N, block):
        n1 = min(N, n0 + block)
        d = pairwise_l2_masked_ref(queries, corpus[n0:n1], lo[n0:n1],
                                   hi[n0:n1], ql, qh, mask)
        d = torch.where(torch.isfinite(d), d, torch.inf)
        ids = torch.arange(n0, n1, dtype=torch.int32,
                           device=dev).expand(Q, -1)
        # the running entries all have lower ids than the block's, and are
        # themselves in (dist, id) order: a stable sort keeps that order
        cat_d = torch.cat([run_d, d], dim=1)
        cat_i = torch.cat([run_i, ids], dim=1)
        run_d, order = torch.sort(cat_d, dim=1, stable=True)
        run_d, order = run_d[:, :k], order[:, :k]
        run_i = cat_i.gather(1, order)
    run_i = torch.where(torch.isfinite(run_d), run_i, NO_EDGE)
    return run_i, run_d


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


def quantize_query_weights_ref(queries, scale, offset):
    """Query-side prologue of the int8 scan: fold the per-dimension dequant
    scale into the query (``w = q * scale``), symmetric-quantize ``w`` to
    int8 with a per-query step ``alpha`` (round half to even, as
    ``jnp.round``), and precompute ``cq = |q|^2 - 2 q.offset``. Returns
    (wq int8 (Q, d), alpha (Q,), cq (Q,))."""
    q = queries.to(torch.float32)
    w = q * scale.to(torch.float32)[None, :]
    amax = w.abs().amax(dim=1)
    alpha = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    wq = torch.round(w / alpha[:, None]).clamp(-127, 127).to(torch.int8)
    cq = (q * q).sum(dim=1) - 2.0 * (q @ offset.to(torch.float32))
    return wq, alpha, cq


def pairwise_l2_int8_ref(queries, codes, scale, offset, sq_norm, lo, hi, ql,
                         qh, mask: int):
    """(Q, d) float32 queries x (N, d) int8 codes -> (Q, N) approximate
    masked squared L2 against the dequantized corpus,

        dist ~= (|q|^2 - 2 q.offset) - 2 alpha (wq . code) + sq_norm,

    which is ``|q - x_hat|^2`` up to the query-side rounding of
    ``w / alpha`` (the engine's exact float32 re-rank absorbs it). The
    integer dot products are taken in float64, which holds every int8 x
    int8 sum exactly (|acc| <= 127^2 d < 2^53; CUDA has no integer matmul),
    then rounded to float32 as an int32 -> float32 cast would be."""
    wq, alpha, cq = quantize_query_weights_ref(queries, scale, offset)
    acc = (wq.to(torch.float64) @ codes.to(torch.float64).T).to(torch.float32)
    d = (cq[:, None] - 2.0 * alpha[:, None] * acc
         + sq_norm.to(torch.float32)[None, :])
    sel = iv.eval_predicate(mask, lo.to(torch.float32)[None, :],
                            hi.to(torch.float32)[None, :],
                            ql.to(torch.float32)[:, None],
                            qh.to(torch.float32)[:, None])
    return torch.where(sel, d, torch.inf)


def gathered_topk_quant_ref(queries, codes, scale, offset, ids, avail, b, e,
                            version, pool_ids, pool_d, pool_exp):
    """:func:`gathered_topk_ref` against the dequantized table
    ``codes * scale + offset`` (int8 or float16 codes, (d,) float32 scale
    and offset): a multiply, then an add, each rounded to float32."""
    deq = (codes.to(torch.float32) * scale.to(torch.float32)[None, :]
           + offset.to(torch.float32)[None, :])
    return gathered_topk_ref(queries, deq, ids, avail, b, e, version,
                             pool_ids, pool_d, pool_exp)


def topk_mask_ref(dists, k: int):
    """(Q, N) -> bool mask of the k smallest per row, ties to the lowest
    index (a stable sort, as the reference's ``argsort``)."""
    idx = torch.sort(dists, dim=1, stable=True).indices[:, :k]
    out = torch.zeros_like(dists, dtype=torch.bool)
    return out.scatter_(1, idx, True)
