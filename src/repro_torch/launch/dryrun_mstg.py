"""Dry-run and roofline of the paper's serving step itself: distributed
RR-filtered top-k (the MSTG flat engine) over a pod-scale corpus, on fake
tensors over a fake process group of 256 or 512 ranks
(:func:`repro_torch.launch.dryrun.fake_group`).

The port of the reference's ``repro.launch.dryrun_mstg``. Three layouts
on both production meshes, at N = 2^20, Q = 1,024, d = 128, k = 10:

* ``all_gather`` / ``tournament``: the corpus over (pod, data), the
  queries over ``model``; each rank scans its shard with
  :func:`repro_torch.core.flat.flat_search`, and the lists are merged over
  ``data`` (then ``pod``);
* ``fullmesh_v2``: the corpus over the whole mesh, the queries on every
  rank; each rank scans its shard with
  :func:`repro_torch.core.flat.flat_search_blocked` (no (Q, N) matrix)
  and the lists are merged over each axis, the innermost first.

A merge over an axis is :func:`repro_torch.distributed.topk.rank_topk_merge`,
the deployment's merge on a mesh of ranks: an ``all_gather`` of the
rank's list (``all-gather`` records), or the tournament's butterfly of
``ppermute`` rounds (``collective-permute`` records, two a round), as in
the reference's HLO. On the fake tensors the scans take the kernels'
plain versions, whose counted FLOPs are the model's 2·Q_loc·N_loc·d;
``flat_search``'s re-sort of rows tied across its top-k window
(:func:`repro_torch.core.flat._resort_unsure`) reads values that fake
tensors do not have, so the count leaves it out, as the reference's
``lax.top_k`` has no such step.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_mstg
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from typing import Iterable, Optional

import torch

from ..core import ANY_OVERLAP
from ..core import flat as core_flat
from ..core.flat import flat_search, flat_search_blocked
from ..core.hnsw import NO_EDGE
from ..distributed import collectives as coll
from ..distributed.topk import rank_topk_merge
from ..models.params import tree_bytes
from ..models.transformer import ShapeDtype
from .dryrun import (ARTIFACT_DIR, MESH_WORLD, collective_bytes, count_step,
                     fake_group)
from .mesh import make_production_mesh
from .roofline import DEFAULT_CARD, card_peaks

# production serving shape: 1M corpus x 1024-query batch, d=128 (SIFT-like)
N_CORPUS = 1 << 20
N_QUERIES = 1024
DIM = 128
K = 10
MERGES = ("all_gather", "tournament", "fullmesh_v2")


def _args(n_corpus: int, n_queries: int, dim: int):
    f32 = torch.float32
    return (ShapeDtype((n_corpus, dim), f32), ShapeDtype((n_corpus,), f32),
            ShapeDtype((n_corpus,), f32), ShapeDtype((n_queries, dim), f32),
            ShapeDtype((n_queries,), f32), ShapeDtype((n_queries,), f32))


@contextlib.contextmanager
def _without_tie_resort():
    """``flat_search`` without its data-dependent re-sort of tied rows, for
    a count on fake tensors (the shapes it returns are the same)."""
    saved = core_flat._resort_unsure
    core_flat._resort_unsure = lambda *args: None
    try:
        yield
    finally:
        core_flat._resort_unsure = saved


def _offset(mesh, axes, nloc: int, ids):
    """Local ids to global ones: this rank's shard starts at its index on
    ``axes`` times ``nloc``."""
    base = coll.axis_index(mesh, axes) * nloc
    return torch.where(ids != NO_EDGE, ids + base, NO_EDGE)


def build_step(mesh, merge: str, mask: int = ANY_OVERLAP, k: int = K, *,
               n_corpus: int = N_CORPUS, n_queries: int = N_QUERIES,
               dim: int = DIM):
    """(fn, args) of one rank of the ``all_gather`` / ``tournament``
    layout: the corpus over (pod, data), the queries over ``model``;
    ``args`` are this rank's shard shapes."""
    corpus_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    nloc = n_corpus // coll.axis_size(mesh, corpus_axes)
    qloc = n_queries // coll.axis_size(mesh, "model")

    def run(c, l, h, q, a, b):
        with _without_tie_resort():
            ids, d = flat_search(c, l, h, q, a, b, mask=mask, k=k)
        ids = _offset(mesh, corpus_axes, nloc, ids)
        ids, d = rank_topk_merge(mesh, ids, d, k, axis=corpus_axes[-1],
                                 merge=merge)
        if len(corpus_axes) > 1:
            ids, d = rank_topk_merge(mesh, ids, d, k, axis=corpus_axes[0],
                                     merge="all_gather")
        return ids, d

    return run, _args(nloc, qloc, dim)


def build_step_v2(mesh, mask: int = ANY_OVERLAP, k: int = K, *,
                  n_corpus: int = N_CORPUS, n_queries: int = N_QUERIES,
                  dim: int = DIM):
    """(fn, args) of one rank of the ``fullmesh_v2`` layout: the corpus
    over the whole mesh, the queries on every rank, a blocked scan and a
    tournament merge over each axis, the innermost first."""
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    nloc = n_corpus // coll.axis_size(mesh, axes)

    def run(c, l, h, q, a, b):
        ids, d = flat_search_blocked(c, l, h, q, a, b, mask=mask, k=k)
        ids = _offset(mesh, axes, nloc, ids)
        for ax in reversed(axes):
            ids, d = rank_topk_merge(mesh, ids, d, k, axis=ax,
                                     merge="tournament")
        return ids, d

    return run, _args(nloc, n_queries, dim)


def model_flops_per_device(mesh, merge: str, *, n_corpus: int = N_CORPUS,
                           n_queries: int = N_QUERIES,
                           dim: int = DIM) -> float:
    """Q_loc x N_loc masked distances, 2·d FLOPs each (the reference's
    formulas)."""
    ndev = mesh.size
    if merge == "fullmesh_v2":
        return n_queries * (n_corpus / ndev) * 2 * dim
    return ((n_queries / mesh.shape["model"])
            * (n_corpus * mesh.shape["model"] / ndev) * 2 * dim)


def run_cell(mesh_kind: str, merge: str, artifact_dir: str, force=False):
    """One cell's record, written to ``artifact_dir``, its terms against
    the peaks of ``roofline.DEFAULT_CARD``; needs the fake group of the
    mesh's world size."""
    cell = f"mstg-flat-serve__{merge}__{mesh_kind}"
    path = os.path.join(artifact_dir, cell + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            prev = json.load(f)
        if prev.get("status") == "ok":
            return prev
    peaks = card_peaks(DEFAULT_CARD)
    rec = {"cell": cell, "merge": merge, "mesh": mesh_kind,
           "corpus": N_CORPUS, "queries": N_QUERIES, "dim": DIM, "k": K}
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi_pod"),
                                    device="cpu")
        if merge == "fullmesh_v2":
            fn, args = build_step_v2(mesh)
        else:
            fn, args = build_step(mesh, merge)
        counted = count_step(fn, args)
        colls, wire, counts = collective_bytes(mesh.records, mesh.size)
        flops, nbytes = counted["flops"], counted["bytes"]
        mf = model_flops_per_device(mesh, merge)
        rec.update({
            "status": "ok", "devices": mesh.size,
            "mesh_shape": dict(mesh.shape),
            "run_s": round(time.time() - t0, 2),
            "flops_per_device": flops, "bytes_per_device": nbytes,
            "memory": {"temp_bytes": max(counted["peak_bytes"]
                                         - counted["output_bytes"], 0),
                       "output_bytes": counted["output_bytes"],
                       "argument_bytes": tree_bytes(args)},
            "collective_bytes": colls, "collective_wire_bytes": wire,
            "collective_counts": counts, "card": DEFAULT_CARD,
            # kernel 5's float32 product is three TF32 passes on the card
            "terms": {"compute_s": 3 * flops / peaks.tf32_flop_per_s,
                      "memory_hlo_s": nbytes / peaks.hbm_bytes_per_s,
                      "collective_s": sum(colls.values())
                      / peaks.link_bytes_per_s},
            "model_flops_per_device": mf,
            "flops_equal_model": flops == mf,
        })
        t = rec["terms"]
        print(f"[ok] {cell}: flops/dev {flops:.3e} compute "
              f"{t['compute_s']*1e3:.3f}ms mem-ub {t['memory_hlo_s']*1e3:.3f}"
              f"ms coll {t['collective_s']*1e3:.4f}ms "
              f"counts={ {c: v for c, v in counts.items() if v} }")
    except Exception as e:  # noqa: BLE001 — record failures as artifacts
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[ERROR] {cell}: {type(e).__name__}: {e}")
    os.makedirs(artifact_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv: Optional[Iterable[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifacts", default=ARTIFACT_DIR)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(None if argv is None else list(argv))
    failed = 0
    for mesh_kind in ("single_pod", "multi_pod"):
        with fake_group(MESH_WORLD[mesh_kind]):
            for merge in MERGES:
                rec = run_cell(mesh_kind, merge, args.artifacts,
                               force=args.force)
                failed += rec["status"] != "ok"
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
