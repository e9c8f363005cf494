"""The comparison that decides ``correct``: the program's answers against
the plain reference's exact ones, as numbers held to the limits of the
cell's traffic file.

* ``bad_ids``    entries that say something false: an id out of range or
  twice in a row, an id whose range fails the predicate, a hit after an
  empty slot, a finite distance without an id or an id without one, or
  distances that do not ascend. Exact: its limit is 0.
* ``short_share`` the share of rows with another number of hits than
  min(k, qualifying).
* ``dist_err``   the widest gap between a returned distance and the exact
  float64 distance of the id it names, relative to that distance or to the
  median reference distance, whichever is larger.
* ``rank_gap``   the widest gap between the exact distances of the returned
  ids, sorted, and the reference's at the same rank, on the same scale: 0
  for an exact top-k up to ties that rounding may swap.

* ``recall_gap`` where the traffic file states ``recall_expected`` (an
  approximate route): how far ``recall`` falls short of it, as a share of
  it, and 0 where it does not.

``recall`` (hits in the reference's top-k over its hits) is reported beside
them as ``recall_at_10``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench import reference


def numbers(n: int, k: int, pred_ok: np.ndarray, prog_ids: np.ndarray,
            prog_d: np.ndarray, true_d: np.ndarray, ref_ids: np.ndarray,
            ref_d: np.ndarray, counts: np.ndarray) -> Dict[str, float]:
    """The compared numbers over rows of one predicate's queries, each
    array (R, k) but ``counts`` (R,)."""
    ids = prog_ids.astype(np.int64)
    d = prog_d.astype(np.float64)
    valid = ids >= 0
    bad = (ids >= n) | (valid & ~pred_ok)
    bad |= valid & ~np.isfinite(d)
    bad |= ~valid & np.isfinite(d)
    bad[:, 1:] |= valid[:, 1:] & ~valid[:, :-1]
    srt = np.sort(np.where(valid, ids, -1 - np.arange(k)), axis=1)
    dup = np.zeros_like(bad)
    dup[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    both = valid[:, 1:] & valid[:, :-1]
    bad[:, 1:] |= both & (d[:, 1:] < d[:, :-1])
    want = np.minimum(counts, k)
    short = valid.sum(1) != want
    ref_valid = ref_ids >= 0
    fin = ref_d[ref_valid]
    scale = float(np.median(fin)) if fin.size else 1.0
    if valid.any():
        gap = np.where(valid, d, 0.0) - np.where(valid, true_d, 0.0)
        err = np.abs(gap) / np.maximum(np.where(valid, true_d, 0.0), scale)
        dist_err = float(err[valid].max())
    else:
        dist_err = 0.0
    tsort = np.sort(np.where(valid, true_d, np.inf), axis=1)
    pair = np.isfinite(tsort) & ref_valid
    gap = (tsort - ref_d) / np.maximum(ref_d, scale)
    rank_gap = float(np.maximum(gap[pair], 0.0).max()) if pair.any() else 0.0
    hits = sum(len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
               for a, b in zip(ids, ref_ids))
    return {"bad_ids": float(bad.sum() + dup.sum()),
            "short_rows": float(short.sum()), "rows": float(ids.shape[0]),
            "dist_err": dist_err,
            "rank_gap": rank_gap, "hits": float(hits),
            "ref_hits": float(ref_valid.sum())}


def judge(items: List[Tuple], corpus, k: int, device,
          block_rows: int = 2048,
          recall_expected: Optional[float] = None) -> Dict[str, float]:
    """Numbers over every compared answer.

    ``items`` are (predicate, vectors (b, d), qlo (b,), qhi (b,), ids
    (b, k), dists (b, k)) of the program's answers; the reference works
    out its own from the corpus the harness made."""
    dev = torch.device(device)
    X = torch.as_tensor(corpus.vectors, device=dev)
    lo = torch.as_tensor(corpus.lo, device=dev)
    hi = torch.as_tensor(corpus.hi, device=dev)
    by_pred: Dict[str, list] = {}
    for it in items:
        by_pred.setdefault(it[0], []).append(it[1:])
    out = {"bad_ids": 0.0, "short_rows": 0.0, "rows": 0.0, "dist_err": 0.0,
           "rank_gap": 0.0, "hits": 0.0, "ref_hits": 0.0}
    for pred, rows in by_pred.items():
        cat = [np.concatenate([r[f] for r in rows]) for f in range(5)]
        for r0 in range(0, cat[0].shape[0], block_rows):
            s = slice(r0, r0 + block_rows)
            q = torch.as_tensor(cat[0][s], device=dev)
            ql = torch.as_tensor(cat[1][s], device=dev)
            qh = torch.as_tensor(cat[2][s], device=dev)
            ids = np.asarray(cat[3][s])
            ref_ids, ref_d, counts = reference.exact_topk(
                X, lo, hi, q, ql, qh, pred, k)
            true_d = reference.pair_dists(X, q, np.where(ids < corpus.n,
                                                         ids, -1))
            safe = np.clip(ids, 0, corpus.n - 1)
            ok = np.asarray(reference.holds(
                pred, corpus.lo[safe], corpus.hi[safe],
                cat[1][s][:, None], cat[2][s][:, None]))
            got = numbers(corpus.n, k, ok, ids, np.asarray(cat[4][s]),
                          true_d, ref_ids, ref_d, counts)
            for key in ("bad_ids", "short_rows", "rows", "hits", "ref_hits"):
                out[key] += got[key]
            for key in ("dist_err", "rank_gap"):
                out[key] = max(out[key], got[key])
    out["recall"] = out["hits"] / out["ref_hits"] if out["ref_hits"] else 1.0
    out["short_share"] = (out["short_rows"] / out["rows"] if out["rows"]
                          else 0.0)
    if recall_expected is not None:
        out["recall_gap"] = max(0.0, 1.0 - out["recall"]
                                / float(recall_expected))
    return out
