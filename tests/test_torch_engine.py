"""The port's ``QueryEngine`` against the reference's, end to end, plus the
port's boundaries: it imports neither ``jax`` nor ``repro``, it runs on a
CUDA device unless told otherwise, and CPU runs launch no kernel.

The reference engine runs with ``EngineConfig(use_kernel=True)`` (its Pallas
kernels in interpret mode); the port runs its plain versions on the CPU.
Both see the same index (built by each package from the same inputs, which
the build tests hold byte-equal) and the same requests.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import EngineConfig as RefConfig
from repro.core import QueryEngine as RefEngine
from repro.core import SearchRequest as RefRequest
from repro.core import intervals as riv

from repro_torch.core import (EngineConfig, IndexSpec, MSTGIndex, QueryEngine,
                              SearchRequest)
from repro_torch.core import engine as tengine
from repro_torch.data import make_queries
from repro_torch.kernels import ops

MASKS = [
    riv.ANY_OVERLAP,
    riv.QUERY_CONTAINED,
    riv.QUERY_CONTAINING,
    riv.LEFT_OVERLAP,
    riv.RIGHT_OVERLAP,
    riv.LEFT_OVERLAP | riv.RIGHT_OVERLAP,
    riv.QUERY_CONTAINED | riv.QUERY_CONTAINING,
    riv.LEFT_OVERLAP | riv.QUERY_CONTAINED | riv.RIGHT_OVERLAP,
]
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def engines(small_ds, built_index):
    ds = small_ds
    port_index = MSTGIndex(ds.vectors, ds.lo, ds.hi,
                           variants=("T", "Tp", "Tpp"), m=8, ef_con=40)
    return (RefEngine(built_index, config=RefConfig(use_kernel=True)),
            QueryEngine(port_index, device="cpu"))


def _both(engines, ds, mask, qlo, qhi, **kw):
    ref_eng, port_eng = engines
    a = ref_eng.search(RefRequest(ds.queries, (qlo, qhi), mask, **kw))
    b = port_eng.search(SearchRequest(ds.queries, (qlo, qhi), mask, **kw))
    return a, b


@pytest.mark.parametrize("mask", MASKS, ids=riv.mask_name)
@pytest.mark.parametrize("route", ["graph", "pruned", "flat", "auto"])
def test_engine_matches_reference(small_ds, engines, mask, route):
    """Same route decision, slot count and ids; distances within 1e-5
    (graph, pruned) or 1e-4 (flat, the pairwise expansion)."""
    ds = small_ds
    qlo, qhi = make_queries(ds, mask, 0.15, seed=13)
    a, b = _both(engines, ds, mask, qlo, qhi, k=10, ef=48, route=route,
                 fanout=2)
    assert b.report.route == a.report.route
    assert b.report.slot_count == a.report.slot_count
    assert b.report.variants == a.report.variants
    np.testing.assert_array_equal(b.ids, a.ids)
    tol = 1e-4 if a.report.route == "flat" else 1e-5
    np.testing.assert_allclose(b.dists, a.dists, rtol=tol, atol=tol)


@pytest.mark.parametrize("sel", [0.02, 0.6])
def test_auto_router_and_chunked_engine_match_reference(small_ds, engines,
                                                        sel):
    """The work-model router picks the reference's route at both ends of
    selectivity, and a 64-query batch (chunked compaction on) gives the
    reference's ids."""
    ds = small_ds
    rng = np.random.default_rng(int(sel * 100))
    pick = rng.integers(0, ds.queries.shape[0], 64)
    qlo, qhi = make_queries(ds, riv.ANY_OVERLAP, sel, seed=41)
    ref_eng, port_eng = engines
    for route in ("auto", "graph"):
        kw = dict(k=10, ef=32, route=route)
        a = ref_eng.search(RefRequest(ds.queries[pick], (qlo[pick], qhi[pick]),
                                      riv.ANY_OVERLAP, **kw))
        b = port_eng.search(SearchRequest(ds.queries[pick],
                                          (qlo[pick], qhi[pick]),
                                          riv.ANY_OVERLAP, **kw))
        assert b.report.route == a.report.route
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_allclose(b.dists, a.dists, rtol=1e-5, atol=1e-5)
    assert port_eng.estimate_selectivity(riv.ANY_OVERLAP, qlo, qhi) == \
        pytest.approx(ref_eng.estimate_selectivity(riv.ANY_OVERLAP, qlo, qhi))


def test_empty_slot_skip_and_empty_batch(small_ds, engines):
    ds = small_ds
    qlo = np.full(5, float(ds.lo.min()) - 30.0)
    qhi = np.full(5, float(ds.lo.min()) - 20.0)
    ref_eng, port_eng = engines
    for mask in (riv.QUERY_CONTAINED, riv.ANY_OVERLAP):
        req = dict(k=5, route="graph", fanout=1)
        a = ref_eng.search(RefRequest(ds.queries[:5], (qlo, qhi), mask, **req))
        b = port_eng.search(SearchRequest(ds.queries[:5], (qlo, qhi), mask,
                                          **req))
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_array_equal(b.dists, a.dists)
    empty = port_eng.search(SearchRequest(ds.queries[:0], (qlo[:0], qhi[:0]),
                                          riv.ANY_OVERLAP, k=4))
    assert empty.ids.shape == (0, 4)


def test_pruned_route_is_exact(small_ds, engines):
    from repro_torch.data import brute_force_topk
    ds = small_ds
    _, port_eng = engines
    qlo, qhi = make_queries(ds, riv.ANY_OVERLAP, 0.1, seed=37)
    res = port_eng.search(SearchRequest(ds.queries, (qlo, qhi),
                                        riv.ANY_OVERLAP, k=10,
                                        route="pruned"))
    true_ids, _ = brute_force_topk(ds.vectors, ds.lo, ds.hi, ds.queries, qlo,
                                   qhi, riv.ANY_OVERLAP, 10)
    assert res.recall_vs(true_ids) == 1.0


def _assert_same_topk(got, want, tol):
    """Ids equal wherever the reference's distance is not tied, within
    ``tol``, with another of the row's; dists within ``tol``."""
    (gi, gd), (wi, wd) = got, want
    assert gi.shape == wi.shape and gd.shape == wd.shape
    np.testing.assert_allclose(gd, wd, rtol=tol, atol=tol)
    with np.errstate(invalid="ignore"):
        gap = np.abs(wd[:, :, None] - wd[:, None, :])
    tied = ((gap <= tol * (np.abs(wd[:, :, None]) + 1.0))
            & np.isfinite(wd[:, :, None])).sum(axis=2) > 1
    np.testing.assert_array_equal(np.where(tied, -2, gi),
                                  np.where(tied, -2, wi))


@pytest.mark.parametrize("entry", ["search_graph", "search_pruned",
                                   "search_pruned_capped", "search_flat"])
def test_fixed_route_entry_points_match_reference(small_ds, engines, entry):
    """The reference's tuple-returning entry points, on the same numpy
    inputs: search_graph (its default fanout 1), search_pruned exact and
    with a max_candidates cap that truncates the candidate list, and
    search_flat."""
    ds = small_ds
    ref_eng, port_eng = engines
    mask = riv.LEFT_OVERLAP | riv.QUERY_CONTAINED | riv.RIGHT_OVERLAP
    qlo, qhi = make_queries(ds, mask, 0.3, seed=23)
    args = (ds.queries, qlo, qhi, mask)
    if entry == "search_graph":
        kw, tol = dict(k=10, ef=48), 1e-5
    elif entry == "search_pruned":
        kw, tol = dict(k=10, block=64), 1e-5
    elif entry == "search_pruned_capped":
        kw, tol = dict(k=10, block=16, max_candidates=48), 1e-5
    else:
        kw, tol = dict(k=10), 1e-4
    name = "search_pruned" if entry == "search_pruned_capped" else entry
    want = getattr(ref_eng, name)(*args, **kw)
    got = getattr(port_eng, name)(*args, **kw)
    assert all(isinstance(a, np.ndarray) for a in got)
    _assert_same_topk(got, want, tol)
    if entry == "search_pruned_capped":
        # the cap truncates: the exact scan finds closer rows
        exact = port_eng.search_pruned(*args, k=10, block=16)
        assert not np.array_equal(got[0], exact[0])
        assert bool(np.all(np.nan_to_num(got[1], posinf=1e30)
                           >= np.nan_to_num(exact[1], posinf=1e30) - 1e-6))
    assert port_eng.search_pruned(ds.queries[:0], qlo[:0], qhi[:0], mask,
                                  k=4)[0].shape == (0, 4)


def test_cpu_engine_launches_no_kernel(small_ds, engines):
    ds = small_ds
    _, port_eng = engines
    ops.reset_launches()
    qlo, qhi = make_queries(ds, riv.ANY_OVERLAP, 0.2, seed=5)
    for route in ("graph", "pruned", "flat"):
        port_eng.search(SearchRequest(ds.queries, (qlo, qhi),
                                      riv.ANY_OVERLAP, k=5, route=route))
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_default_device_is_cuda_and_raises_without_it(built_index,
                                                      monkeypatch):
    from repro_torch.convert import index_from_arrays
    fields = ("sort_rank", "tkey", "nbr", "lab_b", "lab_e", "entry_ids",
              "entry_ver", "members", "member_ver", "node_off")
    idx = index_from_arrays(
        built_index.vectors, built_index.lo, built_index.hi,
        {v: {f: getattr(fv, f) for f in fields}
         for v, fv in built_index.variants.items()}, IndexSpec())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryEngine(idx)
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryEngine(idx, device="cuda")
    assert QueryEngine(idx, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(storage_dtype="bf16"),
                                dict(rerank_k=0)])
def test_engine_config_validates_the_storage_knobs(kw):
    EngineConfig(storage_dtype="int8", rerank_k=32)
    EngineConfig(storage_dtype="float16")
    with pytest.raises(ValueError, match=next(iter(kw))):
        EngineConfig(**kw)


def test_fanout_default_by_device(engines):
    _, port_eng = engines
    assert port_eng._resolve_fanout(None) == 1
    assert port_eng._resolve_fanout(3) == 3
    assert tengine.CUDA_DEFAULT_FANOUT >= 1


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch.core, repro_torch.core.compressed, "
            "repro_torch.kernels.ops, repro_torch.convert, repro_torch.data, "
            "repro_torch.obs.profile, repro_torch.streaming, "
            "repro_torch.distributed, repro_torch.launch\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
