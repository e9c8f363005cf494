"""Distributed filtered top-k over a corpus-sharded MSTG deployment.

Architecture (the reference's ``repro.distributed.topk``): the corpus
(vectors + ranges [+ per-shard MSTG arrays]) is sharded along
``corpus_axis``; each shard computes a local filtered top-k, then the shards'
lists are merged. Two kinds of mesh (:mod:`repro_torch.launch.mesh`):

* **A mesh of ranks** (``make_rank_mesh``), the reference's layout: one
  shard a rank, as one shard a device inside the reference's
  ``shard_map``. Each rank holds its own (Q, k') list and the merges run
  as collectives over ``corpus_axis``
  (:mod:`repro_torch.distributed.collectives`): :func:`rank_topk_merge`.
* **A logical mesh** (``make_mesh``): every shard on one device, every
  shard's list one slice of a stacked ``(D, Q, k')`` tensor, and each
  merge tensor code over that shard axis.

The schedules:

* ``all_gather`` — the lists concatenated shard-major, the first
  ``min(k, D·k')`` kept by a stable sort on distance: the order of
  ``lax.top_k``, which keeps the lowest position among equal distances
  (``torch.topk`` promises no order among ties).
* ``tournament`` — log2(D) rounds; in round r shard i concatenates
  ``[own, partner]`` with ``partner = i ^ 2^r`` and keeps ``min(k, 2w)``
  by a stable sort. On ranks each round is two ``ppermute``s (ids, then
  distances), the reference's butterfly, and rank i returns lane i's
  list, as each reference device does; lanes can hold different lists
  when distances tie. The logical merge returns shard 0's.

Both schedules accept local lists narrower than the global ``k`` (the
deployment's ``per_shard_k`` fan-in knob): every intermediate merge retains
``min(k, candidates so far)`` entries, so no candidate that can reach the
global top-k is ever dropped and the two schedules agree for distinct
distances. When ``D * k' < k`` the result is padded with
``NO_EDGE``/``inf`` columns. Dead shards (``alive`` mask) contribute only
sentinel rows — a lost shard degrades recall, never correctness of the
merge itself.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.flat import flat_search
from ..core.hnsw import NO_EDGE
from . import collectives as coll


def _pad_to_k(ids, dists, k: int):
    """Right-pad (..., w) lists to (..., k) with NO_EDGE/inf columns."""
    w = ids.shape[-1]
    if w >= k:
        return ids, dists
    pad = (0, k - w)
    return (torch.nn.functional.pad(ids, pad, value=NO_EDGE),
            torch.nn.functional.pad(dists, pad, value=float("inf")))


def _keep_smallest(ids, dists, kk: int):
    """The ``kk`` smallest distances along the last axis, lowest position
    first among equal ones."""
    order = torch.sort(dists, dim=-1, stable=True).indices[..., :kk]
    return ids.gather(-1, order), dists.gather(-1, order)


def global_topk_merge(ids, dists, k: int):
    """all_gather merge: stacked (D, Q, k') shard lists -> (Q, k) global.

    Accepts local width k' != k (the ``per_shard_k`` fan-in knob); pads with
    sentinels when the union D*k' holds fewer than k candidates."""
    D, Q, w = ids.shape
    flat_ids = ids.permute(1, 0, 2).reshape(Q, D * w)
    flat_d = dists.permute(1, 0, 2).reshape(Q, D * w)
    return _pad_to_k(*_keep_smallest(flat_ids, flat_d, min(k, D * w)), k)


def tournament_topk_merge(ids, dists, k: int):
    """Recursive-halving merge: log2(D) rounds of pairwise k-list merges
    over stacked (D, Q, k') lists -> shard 0's (Q, k) list.

    After round r, shard i holds the merged top-k of its 2^(r+1)-shard
    group. Each round keeps ``min(k, 2w)`` of the 2w concatenated
    candidates, so a narrow local width k' < k widens toward k instead of
    truncating — the final list equals :func:`global_topk_merge`'s whenever
    distances are distinct."""
    D = int(ids.shape[0])
    for r in range(_rounds(D)):
        partner = torch.arange(D, device=ids.device) ^ (1 << r)
        cat_ids = torch.cat([ids, ids[partner]], dim=2)
        cat_d = torch.cat([dists, dists[partner]], dim=2)
        ids, dists = _keep_smallest(cat_ids, cat_d, min(k, cat_d.shape[2]))
    return _pad_to_k(ids[0], dists[0], k)


def _rounds(D: int) -> int:
    rounds = D.bit_length() - 1
    if (1 << rounds) != D:
        raise ValueError(f"tournament merge needs power-of-two shards, got "
                         f"{D}")
    return rounds


MERGE_SCHEDULES = {"all_gather": global_topk_merge,
                   "tournament": tournament_topk_merge}


def rank_topk_merge(mesh, ids, dists, k: int, *, axis: str = "data",
                    merge: str = "all_gather"):
    """This rank's (Q, k') list merged with those of the other ranks of
    ``axis`` on a mesh of ranks: this rank's (Q, k) list. ``all_gather``
    gathers the lists (one ``all_gather`` each of ids and distances) and
    keeps the first ``min(k, D·k')`` shard-major; ``tournament`` runs
    log2(D) rounds of ``ppermute`` with partner ``i ^ 2^r`` and
    concatenates ``[own, partner]`` as the reference's butterfly does."""
    D = mesh.shape[axis]
    if resolve_merge(merge, D) == "all_gather":
        return global_topk_merge(coll.all_gather(ids[None], mesh, axis, 0),
                                 coll.all_gather(dists[None], mesh, axis, 0),
                                 k)
    for r in range(_rounds(D)):
        perm = [(i, i ^ (1 << r)) for i in range(D)]
        cat_ids = torch.cat([ids, coll.ppermute(ids, mesh, axis, perm)], -1)
        cat_d = torch.cat([dists, coll.ppermute(dists, mesh, axis, perm)], -1)
        ids, dists = _keep_smallest(cat_ids, cat_d, min(k, cat_d.shape[-1]))
    return _pad_to_k(ids, dists, k)


def resolve_merge(merge: str, n_shards: int) -> str:
    """``auto`` -> all_gather for small meshes, tournament for pow2 D > 8."""
    if merge == "auto":
        if n_shards > 8 and (n_shards & (n_shards - 1)) == 0:
            return "tournament"
        return "all_gather"
    if merge not in MERGE_SCHEDULES:
        raise ValueError(f"unknown merge schedule {merge!r}; "
                         f"expected one of {sorted(MERGE_SCHEDULES)} or 'auto'")
    return merge


def _alive_mask(alive, D: int) -> np.ndarray:
    return np.ones(D, bool) if alive is None else np.asarray(alive, bool)


def _on_ranks(mesh) -> bool:
    return mesh.device_mesh is not None


def sharded_topk_merge(mesh, ids, dists, k: int, *, axis: str = "data",
                       merge: str = "all_gather",
                       alive=None) -> Tuple[np.ndarray, np.ndarray]:
    """Merge the shards' top-k' lists through the chosen schedule
    (all_gather / tournament) and return the (Q, k) list as host arrays.

    On a mesh of ranks ``ids`` / ``dists`` are this rank's (Q, k') list,
    its shard's, and the result is this rank's (:func:`rank_topk_merge`).
    On a logical mesh they are (D, Q, k') arrays, one list per shard, as
    produced by heterogeneous per-shard engines (graph / pruned / flat),
    merged on the mesh's device. ``alive`` is an optional (D,) bool mask,
    the same on every rank: a dead shard's list is replaced by sentinels
    before the merge, modeling a shard that never answered."""
    dev = mesh.device
    ids = torch.as_tensor(ids, device=dev).to(torch.int64)
    dists = torch.as_tensor(dists, device=dev).to(torch.float32)
    D = mesh.shape[axis]
    live = _alive_mask(alive, D)
    if _on_ranks(mesh):
        if not live[coll.axis_index(mesh, axis)]:
            ids = torch.full_like(ids, NO_EDGE)
            dists = torch.full_like(dists, float("inf"))
        gi, gd = rank_topk_merge(mesh, ids, dists, k, axis=axis, merge=merge)
    else:
        if int(ids.shape[0]) != D:
            raise ValueError(f"stacked results have {int(ids.shape[0])} "
                             f"shards but mesh axis {axis!r} has size {D}")
        ok = torch.as_tensor(live, device=dev)[:, None, None]
        ids = torch.where(ok, ids, NO_EDGE)
        dists = torch.where(ok, dists, float("inf"))
        gi, gd = MERGE_SCHEDULES[resolve_merge(merge, D)](ids, dists, k)
    return gi.cpu().numpy(), gd.cpu().numpy()


def local_flat_topk(corpus, lo, hi, queries, ql, qh, *, mask: int, k: int,
                    offset: int):
    """One shard's exact scan of its rows with :func:`flat_search`, local
    ids rebased by ``offset`` to global ones: (Q, min(k, rows)) int64 ids
    and float32 dists."""
    li, ld = flat_search(corpus, lo, hi, queries, ql, qh, mask=mask,
                         k=min(k, corpus.shape[0]))
    li = li.to(torch.int64)
    return torch.where(li != NO_EDGE, li + offset, NO_EDGE), ld


def sharded_flat_topk(mesh, corpus, lo, hi, queries, ql, qh, *, mask: int,
                      k: int, corpus_axis: str = "data",
                      merge: str = "all_gather", per_shard_k: int = 0,
                      alive=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact sharded RRANN: one exact flat scan a live shard, local ids
    rebased to global ids, then the merge. Returns (Q, k) int64 ids and
    float32 dists on the mesh's device.

    On a mesh of ranks ``corpus`` / ``lo`` / ``hi`` are this rank's rows
    (as the reference's ``shard_map`` body sees its block): the rank scans
    them, rebases by its index on ``corpus_axis`` times their count, and
    returns its merged list. On a logical mesh they are the whole corpus,
    split into ``D`` equal row slices, each scanned in turn.

    ``per_shard_k`` < k narrows the per-shard fan-in (possibly lower
    recall); 0 means fetch the full k per shard. ``alive`` is an optional
    (D,) bool mask, the same on every rank — a False shard is not scanned
    and contributes only sentinels, yielding the degraded-recall answer a
    lost shard would."""
    D = mesh.shape[corpus_axis]
    k_loc = min(per_shard_k, k) if per_shard_k else k
    dev = mesh.device

    def on_dev(x):
        return torch.as_tensor(x, device=dev).to(torch.float32).contiguous()

    corpus, lo, hi = on_dev(corpus), on_dev(lo), on_dev(hi)
    queries, ql, qh = on_dev(queries), on_dev(ql), on_dev(qh)
    Q = queries.shape[0]
    live = _alive_mask(alive, D)
    if _on_ranks(mesh):
        nloc = corpus.shape[0]
        me = coll.axis_index(mesh, corpus_axis)
        k_loc = min(k_loc, nloc)
        if live[me]:
            ids, dists = local_flat_topk(corpus, lo, hi, queries, ql, qh,
                                         mask=mask, k=k_loc,
                                         offset=me * nloc)
        else:
            ids = torch.full((Q, k_loc), NO_EDGE, dtype=torch.int64,
                             device=dev)
            dists = torch.full((Q, k_loc), float("inf"), device=dev)
        return rank_topk_merge(mesh, ids, dists, k, axis=corpus_axis,
                               merge=merge)
    n = corpus.shape[0]
    if n % D:
        raise ValueError(f"corpus size {n} not divisible by {D} shards")
    nloc = n // D
    k_loc = min(k_loc, nloc)
    ids = torch.full((D, Q, k_loc), NO_EDGE, dtype=torch.int64, device=dev)
    dists = torch.full((D, Q, k_loc), float("inf"), dtype=torch.float32,
                       device=dev)
    for i in np.flatnonzero(live):
        a = int(i) * nloc
        ids[i], dists[i] = local_flat_topk(
            corpus[a:a + nloc], lo[a:a + nloc], hi[a:a + nloc], queries, ql,
            qh, mask=mask, k=k_loc, offset=a)
    return MERGE_SCHEDULES[resolve_merge(merge, D)](ids, dists, k)
