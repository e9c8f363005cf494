"""Exact predicate-filtered search engines.

* ``flat_search`` — the fused predicate + pairwise squared L2 kernel over
  the whole corpus, then a top-k (the ground truth of the other routes);
  on a card with k <= 32, one scan-and-top-k kernel that does both.
* ``flat_search_blocked`` — the same answer with a running (Q, k) top-k
  over blocks of the corpus, so the (Q, N) matrix never exists: one scan
  kernel a block.
* ``_pruned_search_variant`` — uses the MSTG segment-tree decomposition to
  touch only qualifying *member slices*: every decomposition node stores its
  members grouped contiguously in insertion (= version) order, so the valid
  candidates of a node at version x are a PREFIX of its slice. Work scales
  with selectivity instead of n. Exact (recall 1.0) by construction.

Both return squared-L2 top-k as ``(ids, dists)`` tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..kernels import ops
from . import intervals as iv
from . import segment_tree as st
from .hnsw import NO_EDGE

INF = float("inf")


def _smallest_stable(dists, R: int):
    """The R smallest entries of each row, ascending, ties to the lowest
    column (``lax.top_k(-dists, R)``'s order): (values, columns).

    ``torch.topk`` picks among equal values in no promised order, so it
    takes a wider set of W > R first and orders that set by (value,
    column). The set holds every entry equal to the R-th value once its
    W-th value is larger, or the R-th is +inf (then the tied entries are
    non-qualifying rows, which come out as NO_EDGE whatever their column).
    Rows where neither holds take a full stable sort
    (:func:`_resort_unsure`)."""
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
    _resort_unsure(dists, vals, cols, sure, R)
    return vals[:, :R], cols[:, :R]


def _resort_unsure(dists, vals, cols, sure, R: int) -> None:
    """The first R of ``vals`` / ``cols`` (in place) from a full stable
    sort of ``dists``'s rows where ``sure`` is false."""
    if not bool(sure.all()):
        rows = torch.nonzero(~sure).flatten()
        v, c = torch.sort(dists[rows], dim=1, stable=True)
        vals[rows, :R], cols[rows, :R] = v[:, :R], c[:, :R]


def flat_search(corpus, lo, hi, queries, ql, qh, *, mask: int, k: int):
    """Exact filtered k-NN: (Q, k) int32 ids + float32 squared distances
    (+inf / NO_EDGE pad when fewer than k objects qualify). Among equal
    distances the lower row comes first, as ``lax.top_k`` orders them.

    On a card, with 1 <= k <= min(:data:`ops.FUSED_TOPK_MAX_K`, N) and a
    float32 or float16 corpus, one pass of :func:`ops.fused_topk_l2` gives
    that answer without the (Q, N) matrix; its distances are the masked
    scan's bit for bit. Elsewhere the scan writes the matrix and
    :func:`_smallest_stable` selects from it."""
    if (queries.is_cuda and 1 <= k <= min(ops.FUSED_TOPK_MAX_K,
                                          corpus.shape[0])
            and corpus.dtype in (torch.float32, torch.float16)):
        return ops.fused_topk_l2(queries, corpus, lo, hi, ql, qh, mask, k)
    d = ops.pairwise_l2_masked(queries, corpus, lo, hi, ql, qh, mask)
    with obs.span("topk"):
        vals, idx = _smallest_stable(d, k)
    ids = torch.where(torch.isfinite(vals), idx, NO_EDGE).to(torch.int32)
    return ids, vals


def flat_search_blocked(corpus, lo, hi, queries, ql, qh, *, mask: int,
                        k: int, block: int = 4096):
    """:func:`flat_search` without the (Q, N) matrix: the corpus in blocks
    of ``min(block, N)`` rows (the last one ragged), each scored by the
    scan kernel over that block alone, merged into a running (Q, k) top-k.
    The merge keeps the reference's ``lax.top_k`` order over ``[winners,
    block]``: a stable sort, so among equal distances the earlier winner,
    then the lower column, stays. Returns (Q, k) int32 ids (the block's
    offset plus the column; NO_EDGE where the distance is not finite) and
    float32 squared distances."""
    N = corpus.shape[0]
    Q = queries.shape[0]
    dev = queries.device
    block = max(1, min(block, N))
    top_d = torch.full((Q, k), INF, dtype=torch.float32, device=dev)
    top_i = torch.full((Q, k), NO_EDGE, dtype=torch.int32, device=dev)
    for n0 in range(0, N, block):
        n1 = min(N, n0 + block)
        d = ops.pairwise_l2_masked(queries, corpus[n0:n1], lo[n0:n1],
                                   hi[n0:n1], ql, qh, mask)
        ids = torch.arange(n0, n1, dtype=torch.int32, device=dev)
        cat_d = torch.cat([top_d, d], dim=1)
        cat_i = torch.cat([top_i, ids.expand(Q, -1)], dim=1)
        order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
        top_d = cat_d.gather(1, order)
        top_i = cat_i.gather(1, order)
    top_i = torch.where(torch.isfinite(top_d), top_i, NO_EDGE)
    return top_i, top_d


def _prefix_len(member_ver, lvl, off, cnt, ver, iters: int):
    """Length of the valid prefix of each (Q, P) member slice at ``ver``:
    member versions ascend within a slice, so a binary search, vectorised
    over (Q, P)."""
    width = member_ver.shape[1]
    lo_i = torch.zeros_like(cnt)
    hi_i = cnt.clone()
    for _ in range(iters):
        mid = (lo_i + hi_i) // 2
        v = member_ver[lvl, (off + mid).clamp(0, width - 1)]
        go_right = (mid < cnt) & (v <= ver)
        lo_i = torch.where(go_right, mid + 1, lo_i)
        hi_i = torch.where(go_right, hi_i, mid)
    return lo_i


def _pruned_search_variant(arrays: dict, lo_attr, hi_attr, queries, ql, qh,
                           version, key_lo, key_hi, *, pred_mask_bits: int,
                           k: int, Kpad: int, block: int, max_blocks: int):
    """One variant's pruned scan: decomposition -> member prefixes -> blocked
    distance + running top-k. ``pred_mask_bits`` re-checks the exact
    predicate on gathered candidates (guards rank-boundary ties and lets one
    variant serve any sub-mask of its plan).

    ``arrays`` holds a float32 ``vectors`` table, or on a quantized tier
    ``codes`` with ``code_scale``, ``code_offset`` and ``code_sq_norm``:
    then the distances are approximate, ``cq - 2 wq.code + sq_norm`` with
    the scale folded into ``wq = q * scale`` and the offset into
    ``cq = |q|^2 - 2 q.offset``, and the engine re-ranks the merged top-k
    exactly."""
    quantized = "codes" in arrays
    if quantized:
        wq = queries * arrays["code_scale"][None, :]              # (Q, d)
        cq = ((queries * queries).sum(dim=1)
              - 2.0 * (queries @ arrays["code_offset"]))          # (Q,)
    members, member_ver = arrays["members"], arrays["member_ver"]
    node_off = arrays["node_off"]
    Q = queries.shape[0]
    dev = queries.device
    levels, idxs, valid = st.decompose_batched(key_lo, key_hi, Kpad)
    levels = levels.to(torch.int64)
    idxs = idxs.to(torch.int64)
    P = levels.shape[1]

    off = node_off[levels, idxs].to(torch.int64)                # (Q, P)
    cnt = node_off[levels, idxs + 1].to(torch.int64) - off
    cnt = torch.where(valid, cnt, 0)
    iters = int(np.ceil(np.log2(max(int(members.shape[1]), 2)))) + 1
    plen = _prefix_len(member_ver, levels, off, cnt,
                       version.to(torch.int64)[:, None], iters)
    plen = torch.where(valid, plen, 0)                          # (Q, P)

    # blocked scan over candidate prefixes
    cum = plen.cumsum(dim=1)
    starts = cum - plen                                         # candidate space
    total = cum[:, -1]

    top_d = torch.full((Q, k), INF, dtype=torch.float32, device=dev)
    top_i = torch.full((Q, k), NO_EDGE, dtype=torch.int32, device=dev)
    width = members.shape[1]
    lvl_max = members.shape[0] - 1
    for blk in range(max_blocks):
        pos = blk * block + torch.arange(block, device=dev)     # (B,)
        # map candidate position -> (node slot, offset within prefix)
        slot = (pos[None, :, None] >= cum[:, None, :]).sum(dim=2)
        slot = slot.clamp(0, P - 1)                             # (Q, B)
        inner = pos[None, :] - starts.gather(1, slot)
        ok = pos[None, :] < total[:, None]
        lvl_b = levels.gather(1, slot)
        off_b = off.gather(1, slot)
        midx = (off_b + inner).clamp(0, width - 1)
        cand = members[lvl_b.clamp(0, lvl_max), midx]           # (Q, B)
        cand_safe = torch.where(ok, cand, 0).to(torch.int64)
        # exact predicate re-check on raw endpoints
        sel = iv.eval_predicate(pred_mask_bits, lo_attr[cand_safe],
                                hi_attr[cand_safe], ql[:, None],
                                qh[:, None]) & ok
        if quantized:
            cb = arrays["codes"][cand_safe].to(torch.float32)   # (Q, B, d)
            dist = (cq[:, None]
                    - 2.0 * torch.einsum("qd,qbd->qb", wq, cb)
                    + arrays["code_sq_norm"][cand_safe])
        else:
            diff = arrays["vectors"][cand_safe] - queries[:, None, :]
            dist = (diff * diff).sum(dim=-1)
        dist = torch.where(sel, dist, INF)
        cat_d = torch.cat([top_d, dist], dim=1)
        cat_i = torch.cat([top_i, torch.where(sel, cand, NO_EDGE)], dim=1)
        top_d, order = torch.sort(cat_d, dim=1, stable=True)
        top_d = top_d[:, :k]
        top_i = cat_i.gather(1, order[:, :k])
    return top_i, top_d
