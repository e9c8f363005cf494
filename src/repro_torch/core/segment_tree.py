"""Perfect-binary segment tree over the rank domain (paper §4.1–4.2).

The tree is *structural only* (paper: "a segment tree T^0 based on A without
objects"): node (level, idx) at level ``lvl`` (root = level 0) covers ranks
``[idx * W, (idx+1) * W - 1]`` with ``W = Kpad >> lvl`` and ``Kpad`` the padded
power-of-two domain size. Object membership lives in the per-level adjacency
arrays built by :mod:`repro.core.mstg`.

Key property used throughout the system: the canonical decomposition of any rank
range returns nodes that are pairwise disjoint in key space and number at most 2
per level — so every qualifying vertex belongs to exactly ONE decomposition node,
and per-LEVEL dense adjacency arrays give one-gather neighbor lookups on the
device.
"""
from __future__ import annotations

from typing import List, Tuple

import torch


def padded_domain(K: int) -> int:
    """Smallest power of two >= K."""
    p = 1
    while p < K:
        p <<= 1
    return p


def num_levels(Kpad: int) -> int:
    return int(Kpad).bit_length()  # log2(Kpad) + 1 for powers of two


def node_range(level: int, idx: int, Kpad: int) -> Tuple[int, int]:
    w = Kpad >> level
    return idx * w, (idx + 1) * w - 1


def decompose(lo: int, hi: int, Kpad: int) -> List[Tuple[int, int]]:
    """Canonical cover of rank range [lo, hi] (inclusive) as (level, idx) nodes."""
    if lo > hi:
        return []
    lo = max(0, int(lo))
    hi = min(Kpad - 1, int(hi))
    if lo > hi:
        return []
    out = []
    a, b = lo + Kpad, hi + Kpad + 1  # half-open in heap coordinates
    while a < b:
        if a & 1:
            out.append(a)
            a += 1
        if b & 1:
            b -= 1
            out.append(b)
        a >>= 1
        b >>= 1
    nodes = []
    for h in out:
        level = h.bit_length() - 1
        nodes.append((level, h - (1 << level)))
    nodes.sort()
    return nodes


def max_cover_nodes(Kpad: int) -> int:
    """Static bound on decomposition size (2 emission slots per level)."""
    return 2 * num_levels(Kpad)


def decompose_batched(lo: torch.Tensor, hi: torch.Tensor, Kpad: int):
    """Batched canonical decomposition of ``(Q,)`` int rank ranges.

    Returns ``(levels, idxs, valid)``, each ``(Q, max_cover_nodes(Kpad))``:
    int32 levels and node indices (0 where invalid) and a bool validity
    mask. ``lo > hi`` (or a range outside ``[0, Kpad-1]``) yields an
    all-invalid row. The loop over the ``Lv`` levels runs in Python; each
    iteration emits at most one node from each end of the range, so slot
    ``2*i`` / ``2*i + 1`` holds level ``Lv-1-i``'s left / right node.
    """
    P = max_cover_nodes(Kpad)
    Lv = num_levels(Kpad)
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    empty = (lo > hi) | (hi < 0) | (lo > Kpad - 1)
    a = torch.where(empty, 2 * Kpad, lo.clamp(0, Kpad - 1) + Kpad)
    b = torch.where(empty, 2 * Kpad, hi.clamp(0, Kpad - 1) + Kpad + 1)
    heaps = torch.zeros(lo.shape + (P,), dtype=torch.int64, device=lo.device)
    for i in range(Lv):
        emit_a = (a < b) & ((a & 1) == 1)
        heaps[..., 2 * i] = torch.where(emit_a, a, 0)
        a = a + emit_a.to(torch.int64)
        emit_b = (a < b) & ((b & 1) == 1)
        b = b - emit_b.to(torch.int64)
        heaps[..., 2 * i + 1] = torch.where(emit_b, b, 0)
        a = a >> 1
        b = b >> 1
    valid = heaps > 0
    # heap index h sits at level floor(log2(h)): Lv-1-i for the node that
    # iteration i emitted
    lvl_of_slot = Lv - 1 - torch.arange(P, device=lo.device) // 2
    levels = torch.where(valid, lvl_of_slot, 0)
    idxs = torch.where(valid, heaps - (1 << levels), 0)
    return levels.to(torch.int32), idxs.to(torch.int32), valid


def node_ranges(levels: torch.Tensor, idxs: torch.Tensor, Kpad: int):
    """Inclusive key ranges ``(start, end)`` covered by (levels, idxs)
    nodes."""
    w = (Kpad >> levels.to(torch.int64)).to(torch.int32)
    start = idxs * w
    return start, start + w - 1


def vertex_levels_for_cover(tkeys, levels, idxs, valid, Kpad: int):
    """For each vertex key in ``tkeys`` (any leading dims), the level of
    the covering decomposition node among the (P,) ``levels`` / ``idxs``
    / ``valid`` nodes, or -1 where none covers it; int32."""
    start, end = node_ranges(levels, idxs, Kpad)            # (P,)
    t = tkeys[..., None]
    inside = valid & (t >= start) & (t <= end)              # (..., P)
    lvl = torch.where(inside, levels.to(torch.int32), -1).amax(dim=-1)
    return lvl.to(torch.int32)


def leaf_path_nodes(key_rank: int, Kpad: int) -> List[Tuple[int, int]]:
    """All (level, idx) ancestors of the leaf for ``key_rank`` — the O(log|A|)
    nodes an insertion touches (paper Algorithm 1)."""
    Lv = num_levels(Kpad)
    return [(lvl, int(key_rank) >> (Lv - 1 - lvl)) for lvl in range(Lv)]


def level_shift(level: int, Kpad: int) -> int:
    return num_levels(Kpad) - 1 - level
