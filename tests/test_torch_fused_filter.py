"""Why fused_topk.cu may filter before it folds.

The card's ``fused_topk_l2`` does not fold every entry of a tile into its
running top-k. Per 128-column tile it forms the distances, drops each entry
whose distance does not reach its row's k-th distance, tests the RR
predicate only on the rest, and appends the survivors to a row queue of 16
in whatever order the threads' atomics land. The queue is folded by
(dist, id) at the start of the next tile's epilogue, so the k-th distance
another warp reads may lag a tile; when a queue is full, the block folds
every queue at once and offers the waiting entries again. Splits of the
corpus walk their tiles apart and a merge folds their lists.

These tests emulate that order of work in torch on the CPU (the same
``before`` order, the same insert-by-rank fold, survivors in a shuffled
order) and hold it to ``fused_topk_l2_ref``, bit for bit, on random,
adversarial and all-ties inputs: with the k-th distance as the previous
tile's fold leaves it, and with one a tile staler (a threshold that lags
admits a superset, so the answer must not change). The kernel itself is
held to the plain version on the card (``tests/test_torch_cuda.py``).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import fused_edge_inputs  # noqa: E402
from repro_torch.core import intervals as iv
from repro_torch.kernels import ref

NO_EDGE = ref.NO_EDGE
TILE = 128
QUEUE = 16


def before(ad, ai, bd, bi):
    """fused_topk.cu's order: (dist, id) as a pair."""
    return (ad < bd) | ((ad == bd) & (ai < bi))


def insert(list_d, list_i, cd, ci):
    """The kernel's fold of one candidate per row into a sorted (Q, k)
    list: enter only before the k-th entry, at the rank of the entries
    before it, shifting the rest down."""
    k = list_d.shape[1]
    enter = before(cd, ci, list_d[:, -1], list_i[:, -1])
    pos = before(list_d, list_i, cd[:, None], ci[:, None]).sum(1,
                                                                 keepdim=True)
    idx = torch.arange(k)[None, :]
    up_d = torch.cat([list_d[:, :1], list_d[:, :-1]], 1)
    up_i = torch.cat([list_i[:, :1], list_i[:, :-1]], 1)
    new_d = torch.where(idx < pos, list_d, torch.where(idx == pos,
                                                       cd[:, None], up_d))
    new_i = torch.where(idx < pos, list_i, torch.where(idx == pos,
                                                       ci[:, None], up_i))
    return (torch.where(enter[:, None], new_d, list_d),
            torch.where(enter[:, None], new_i, list_i))


def fold_shuffled(list_d, list_i, d, ids, take, gen):
    """Fold the (Q, M) entries ``take`` marks (dists ``d``, ids ``ids``)
    into the lists, row by row, in a random order."""
    prio = torch.where(take, torch.rand(take.shape, generator=gen), 2.0)
    order = torch.argsort(prio, dim=1)
    for s in range(int(take.sum(1).max())):
        col = order[:, s]
        rows = torch.arange(d.shape[0])
        live = take[rows, col]
        cd = torch.where(live, d[rows, col], torch.inf)
        ci = torch.where(live, ids[rows, col], NO_EDGE)
        list_d, list_i = insert(list_d, list_i, cd, ci)
    return list_d, list_i


def emulated_fused(queries, corpus, lo, hi, ql, qh, mask, k, *, splits=1,
                   stale=False, seed=0):
    """fused_topk.cu's order of work. Returns ((Q, k) ids, (Q, k) dists)
    and a count of what the filter did: entries offered to the queues,
    tiles walked, and tiles whose queue overflowed (folded at once)."""
    Q, N = queries.shape[0], corpus.shape[0]
    gen = torch.Generator().manual_seed(seed)
    # the plain scan's distances with every entry kept (the range [0, 1]
    # holds the query range [0, 1]), and the predicate apart
    ones = torch.ones(N), torch.zeros(Q), torch.ones(Q)
    dist = ref.pairwise_l2_masked_ref(queries, corpus, torch.zeros(N),
                                      ones[0], ones[1], ones[2],
                                      iv.QUERY_CONTAINED)
    sel = iv.eval_predicate(mask, lo[None, :], hi[None, :], ql[:, None],
                            qh[:, None])
    stats = {"offered": 0, "tiles": 0, "overflowed": 0}
    tiles = -(-N // TILE)
    per = -(-tiles // splits)
    parts = []
    for sp in range(splits):
        list_d = torch.full((Q, k), torch.inf)
        list_i = torch.full((Q, k), NO_EDGE, dtype=torch.int32)
        queued = None                   # the previous tile's queue
        for t in range(sp * per, min(tiles, (sp + 1) * per)):
            n0, n1 = t * TILE, min(N, (t + 1) * TILE)
            d = dist[:, n0:n1]
            ids = torch.arange(n0, n1, dtype=torch.int32).expand(Q, -1)
            # the owner folds the previous tile's queue first; a row read
            # before its owner got there sees the k-th distance before it
            thr = list_d[:, -1].clone()
            if queued is not None:
                list_d, list_i = fold_shuffled(list_d, list_i, *queued, gen)
            if not stale:
                thr = list_d[:, -1]
            pend = d <= thr[:, None]
            take = torch.zeros_like(pend)
            while True:
                ok = pend & (d <= thr[:, None]) & sel[:, n0:n1]
                stats["offered"] += int(ok.sum())
                # a row's offers land in a shuffled order; the first that
                # fit the queue get a slot, the rest wait
                prio = torch.where(ok, torch.rand(ok.shape, generator=gen),
                                   2.0)
                rank = (torch.argsort(torch.argsort(prio, dim=1), dim=1)
                        + take.sum(1, keepdim=True))
                got = ok & (rank < QUEUE)
                take |= got
                pend = ok & ~got
                if not bool(pend.any()):
                    break
                # a full queue: the block folds every queue now
                stats["overflowed"] += 1
                list_d, list_i = fold_shuffled(list_d, list_i, d, ids, take,
                                               gen)
                take = torch.zeros_like(take)
                thr = list_d[:, -1]
            queued = (d, ids, take)
            stats["tiles"] += 1
        if queued is not None:
            list_d, list_i = fold_shuffled(list_d, list_i, *queued, gen)
        parts.append((list_d, list_i))
    # the merge launch folds every split's list
    out_d = torch.full((Q, k), torch.inf)
    out_i = torch.full((Q, k), NO_EDGE, dtype=torch.int32)
    for list_d, list_i in parts:
        out_d, out_i = fold_shuffled(out_d, out_i, list_d, list_i,
                                     torch.isfinite(list_d), gen)
    return out_i, out_d, stats


def inputs(case: str, Q: int, N: int, d: int, seed: int):
    """(queries, corpus, lo, hi, ql, qh, mask) as float32 tensors.

    "random": normal vectors and integer ranges, NaN endpoints on a tenth
    of the rows and on one query; "falling" and "ties" are the card check's
    (``chip_smoke.fused_edge_inputs``): every query's distance falls
    strictly as the id grows, so every qualifying entry beats the k-th
    entry and the queue overflows in every tile; identical integer rows,
    so every distance of a query ties and the lowest ids must win.
    """
    if case != "random":
        arrays = fused_edge_inputs(case, Q, N, d, seed)
    else:
        rng = np.random.default_rng(seed)
        lo = rng.integers(0, 50, N).astype(np.float32)
        hi = lo + rng.integers(0, 20, N).astype(np.float32)
        ql = rng.integers(0, 50, Q).astype(np.float32)
        qh = ql + rng.integers(0, 20, Q).astype(np.float32)
        q = rng.normal(size=(Q, d)).astype(np.float32)
        c = rng.normal(size=(N, d)).astype(np.float32)
        nan = rng.random(N) < 0.1
        lo[nan & (rng.random(N) < 0.5)] = np.nan
        hi[nan] = np.nan
        ql[Q // 2] = np.nan
        arrays = q, c, lo, hi, ql, qh
    return [torch.from_numpy(a) for a in arrays] + [iv.ANY_OVERLAP]


CASES = {"random": (16, 3001, 24), "falling": (8, 2100, 8),
         "ties": (8, 2100, 8)}


@pytest.mark.parametrize("stale", [False, True], ids=["current", "stale"])
@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_filtered_fold_equals_the_plain_top_k(case, k, stale):
    Q, N, d = CASES[case]
    *args, mask = inputs(case, Q, N, d, seed=k)
    want_i, want_d = ref.fused_topk_l2_ref(*args, mask, k)
    got_i, got_d, stats = emulated_fused(*args, mask, k, splits=3,
                                         stale=stale, seed=k)
    assert torch.equal(got_d, want_d)
    assert torch.equal(got_i, want_i)
    tiles = -(-N // TILE)
    assert stats["tiles"] == tiles
    if case == "falling":
        # every entry reaches the k-th distance: the queue overflows in
        # every tile
        assert stats["offered"] >= Q * N
        assert stats["overflowed"] >= tiles
        assert want_i[:, :k].tolist() == [list(range(N - 1, N - 1 - k, -1))
                                          ] * Q
    if case == "ties":
        sel = iv.eval_predicate(mask, args[2][None, :], args[3][None, :],
                                args[4][:, None], args[5][:, None])
        lowest = [torch.nonzero(row).flatten()[:k].tolist() for row in sel]
        assert [r[:len(w)] for r, w in zip(got_i.tolist(), lowest)] == lowest
    if case == "random" and not stale:
        # the filter's point: a small share of the entries is offered
        assert stats["offered"] < 0.25 * Q * N
