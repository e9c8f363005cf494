"""The port's wavefront graph search against the JAX reference.

The reference runs with ``use_kernel=True`` (its Pallas kernels in interpret
mode here); the port runs its kernels' plain versions on the CPU. On the
8-mask grid both drivers must return the reference's ids, with distances
within 1e-5. Inside the port, packed and dense visited sets, and the chunked
and single-loop drivers, must agree bit for bit, as the reference's own
tests require of it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import EngineConfig as RefConfig
from repro.core import QueryEngine as RefEngine
from repro.core import intervals as riv
from repro.core.search import mstg_graph_search as ref_search
from repro.core.search import mstg_graph_search_chunked as ref_chunked
from repro.core.search import merge_topk as ref_merge_topk

from repro_torch.core import QueryEngine, search as tsearch
from repro_torch.core.search import (merge_topk, mstg_graph_search,
                                     mstg_graph_search_chunked)
from repro_torch.data import make_queries

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


@pytest.fixture(scope="module")
def engines(built_index):
    """The reference engine and the port's CPU engine over the same arrays
    (the port reads the reference's frozen variants through its artifact
    format, which the build tests hold byte-equal)."""
    from repro_torch.convert import index_from_arrays
    from repro_torch.core import IndexSpec
    fields = ("sort_rank", "tkey", "nbr", "lab_b", "lab_e", "entry_ids",
              "entry_ver", "members", "member_ver", "node_off")
    idx = built_index
    port = index_from_arrays(
        idx.vectors, idx.lo, idx.hi,
        {v: {f: getattr(fv, f) for f in fields}
         for v, fv in idx.variants.items()},
        IndexSpec.from_dict(idx.spec.to_dict()))
    return (RefEngine(idx, config=RefConfig(use_kernel=True)),
            QueryEngine(port, device="cpu"))


def _slot_inputs(ref_eng, port_eng, slot, queries):
    dv = ref_eng.graph_dev(slot.variant)
    ref_args = (dv.tree(), jnp.asarray(queries),
                jnp.asarray(slot.version, jnp.int32),
                jnp.asarray(slot.key_lo, jnp.int32),
                jnp.asarray(slot.key_hi, jnp.int32))
    port_args = (port_eng.graph_dev(slot.variant), torch.from_numpy(queries),
                 slot.version, slot.key_lo, slot.key_hi)
    return ref_args, port_args, dv.meta.Kpad


def _assert_matches(port_ids, port_d, ref_ids, ref_d):
    np.testing.assert_array_equal(np.asarray(port_ids), np.asarray(ref_ids))
    np.testing.assert_allclose(np.asarray(port_d), np.asarray(ref_d),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mask", MASKS, ids=riv.mask_name)
def test_graph_search_matches_reference(small_ds, engines, mask):
    ds = small_ds
    ref_eng, port_eng = engines
    qlo, qhi = make_queries(ds, mask, 0.15, seed=3)
    for s in ref_eng.plan(mask, qlo, qhi):
        ref_args, port_args, Kpad = _slot_inputs(ref_eng, port_eng, s,
                                                 ds.queries)
        kw = dict(k=10, ef=32, max_steps=150, Kpad=Kpad, fanout=2)
        ri, rd, rsteps = ref_search(*ref_args, **kw, use_kernel=True,
                                    with_steps=True)
        pi, pd, psteps = mstg_graph_search(*port_args, **kw, with_steps=True)
        _assert_matches(pi, pd, ri, rd)
        assert psteps == int(rsteps)
        ci, cd, cstats = mstg_graph_search_chunked(*port_args, **kw, chunk=5,
                                                   with_stats=True)
        rci, rcd, rstats = ref_chunked(*ref_args, **kw, chunk=5,
                                       use_kernel=True, with_stats=True)
        _assert_matches(ci, cd, rci, rcd)
        assert cstats["steps"] == rstats["steps"]
        np.testing.assert_array_equal(cstats["conv_steps"],
                                      rstats["conv_steps"])


@pytest.mark.parametrize("Q,ef,fanout,chunk", [(1, 4, 1, 1), (5, 17, 3, 3),
                                               (12, 32, 4, 8), (16, 64, 2, 50)])
def test_packed_dense_chunked_single_bit_identical(small_ds, engines, Q, ef,
                                                   fanout, chunk):
    ds = small_ds
    _, port_eng = engines
    rng = np.random.default_rng(Q * 7 + ef)
    pick = rng.integers(0, ds.queries.shape[0], Q)
    qlo, qhi = make_queries(ds, riv.ANY_OVERLAP, 0.2, seed=ef)
    queries, qlo, qhi = ds.queries[pick], qlo[pick], qhi[pick]
    steps = (4 * ef + 64) // fanout + 8
    for s in port_eng.plan(riv.ANY_OVERLAP, qlo, qhi):
        args = (port_eng.graph_dev(s.variant), torch.from_numpy(queries),
                s.version, s.key_lo, s.key_hi)
        kw = dict(k=min(10, ef), ef=ef, max_steps=steps,
                  Kpad=port_eng.index.variants[s.variant].Kpad, fanout=fanout)
        pi, pd = mstg_graph_search(*args, **kw, packed=True)
        di, dd = mstg_graph_search(*args, **kw, packed=False)
        ci, cd = mstg_graph_search_chunked(*args, **kw, chunk=chunk)
        for ids, d in ((di, dd), (torch.from_numpy(ci), torch.from_numpy(cd))):
            assert torch.equal(pi, ids) and torch.equal(pd, d)


def test_step_budget_truncation_matches_reference(small_ds, engines):
    """A budget far below convergence: both drivers stop at exactly
    max_steps, as the reference does."""
    ds = small_ds
    ref_eng, port_eng = engines
    qlo, qhi = make_queries(ds, riv.ANY_OVERLAP, 0.3, seed=9)
    s = ref_eng.plan(riv.ANY_OVERLAP, qlo, qhi)[0]
    ref_args, port_args, Kpad = _slot_inputs(ref_eng, port_eng, s, ds.queries)
    kw = dict(k=6, ef=24, max_steps=3, Kpad=Kpad, fanout=1)
    ri, rd, rsteps = ref_search(*ref_args, **kw, use_kernel=True,
                                with_steps=True)
    pi, pd, psteps = mstg_graph_search(*port_args, **kw, with_steps=True)
    _assert_matches(pi, pd, ri, rd)
    assert psteps == int(rsteps) == 3
    ci, cd = mstg_graph_search_chunked(*port_args, **kw, chunk=2)
    _assert_matches(ci, cd, ri, rd)


def test_first_occurrence_and_vertex_zero():
    """Invalid slots get out-of-range sentinels, so an earlier 0-filled slot
    never swallows a real proposal of vertex 0; true duplicates collapse to
    their first occurrence."""
    n, FS = 10, 4
    cols = torch.arange(FS, dtype=torch.int32)[None, :]
    tg = torch.tensor([[5, 0, 0, 3]], dtype=torch.int32)
    ok = torch.tensor([[True, False, True, True]])
    keep = ok & tsearch._first_occurrence(torch.where(ok, tg, n + cols))
    assert keep.tolist() == [[True, False, True, True]]
    tg2 = torch.tensor([[7, 7, 0, 0]], dtype=torch.int32)
    keep2 = tsearch._first_occurrence(tg2)
    assert keep2.tolist() == [[True, False, True, False]]


def test_packed_visited_words_round_trip():
    """int64 words hold 32 bits each; bit 31 sets and reads like the rest."""
    visited = tsearch._visited_init(2, 70, True, "cpu")
    assert visited.shape == (2, tsearch.packed_words(70)) == (2, 3)
    ids = torch.tensor([[31, 0, 63, 69], [5, 32, 31, 1]])
    mark = torch.tensor([[True, True, True, False], [True, False, True, True]])
    visited = tsearch._visited_set(visited, ids, mark, True)
    assert tsearch._visited_get(visited, ids, True).tolist() == mark.tolist()
    assert int(visited[0, 0]) == (1 << 31) | 1


def test_merge_topk_matches_reference():
    rng = np.random.default_rng(4)
    ids_a = rng.integers(-1, 20, (6, 5)).astype(np.int32)
    ids_b = rng.integers(-1, 20, (6, 5)).astype(np.int32)
    d_a = rng.integers(0, 6, (6, 5)).astype(np.float32)   # ties on purpose
    d_b = rng.integers(0, 6, (6, 5)).astype(np.float32)
    d_a[ids_a < 0] = np.inf
    d_b[ids_b < 0] = np.inf
    wi, wd = ref_merge_topk(*map(jnp.asarray, (ids_a, d_a, ids_b, d_b)), k=5)
    gi, gd = merge_topk(*map(torch.from_numpy, (ids_a, d_a, ids_b, d_b)), 5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
