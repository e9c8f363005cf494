"""The port's quantized storage tier (int8 / float16 codes with an exact
float32 re-rank) against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages. The
reference runs its Pallas kernels as its own tests do: the kernel
functions with ``interpret=True``, the engine with
``EngineConfig(use_kernel=True)``. The port runs its plain versions on the
CPU. Tolerances: the int8 scan within 1e-4 relative to (|dist| + 1), the
quantized wavefront step and every re-ranked distance within 1e-5; ids
equal wherever the distances are distinct.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import EngineConfig as RefConfig
from repro.core import MSTGIndex as RefIndex
from repro.core import QueryEngine as RefEngine
from repro.core import SearchRequest as RefRequest
from repro.core import compressed as rcomp
from repro.core import intervals as riv
from repro.core.quant import QuantizedStore as RefStore
from repro.kernels import ref as jref
from repro.kernels.gathered_topk import gathered_topk_quant as pallas_gtq
from repro.kernels.pairwise_l2_int8 import pairwise_l2_int8 as pallas_int8

from repro_torch.convert import index_from_arrays
from repro_torch.core import (EngineConfig, IndexSpec, MSTGIndex, QueryEngine,
                              SearchRequest)
from repro_torch.core import compressed as tcomp
from repro_torch.core.quant import QuantizedStore
from repro_torch.data import make_queries
from repro_torch.kernels import ops, ref as tref

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
ROUTES = ["graph", "pruned", "flat", "auto"]
FV_FIELDS = ("sort_rank", "tkey", "nbr", "lab_b", "lab_e", "entry_ids",
             "entry_ver", "members", "member_ver", "node_off")
T = torch.from_numpy


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _ties(d, tol):
    """(Q, k) bool: the entry's distance is within ``tol`` (relative to
    |d| + 1) of another finite entry of its row."""
    d = np.asarray(d, np.float64)
    with np.errstate(invalid="ignore"):          # inf - inf
        gap = np.abs(d[:, :, None] - d[:, None, :])
        close = gap <= tol * (np.abs(d[:, :, None]) + 1.0)
    np.einsum("qii->qi", close)[:] = False
    return close.any(axis=2) & np.isfinite(d)


def assert_same_topk(got_ids, got_d, want_ids, want_d, tol=1e-5):
    got_d, want_d = np.asarray(got_d), np.asarray(want_d)
    np.testing.assert_array_equal(np.isfinite(got_d), np.isfinite(want_d))
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=tol, atol=tol)
    free = ~_ties(want_d, tol)
    np.testing.assert_array_equal(np.asarray(got_ids)[free],
                                  np.asarray(want_ids)[free])


# ---- the query prologue and the int8 scan ----------------------------------

@pytest.mark.parametrize("Q,d", [(64, 128), (7, 17), (1, 1)])
def test_query_prologue_matches_reference(Q, d):
    rng = np.random.default_rng(Q * 31 + d)
    q = rng.normal(0, 1, (Q, d)).astype(np.float32)
    q[0] = 0.0                                   # amax == 0 -> alpha == 1
    st = RefStore.from_vectors(rng.normal(0, 2, (50, d)).astype(np.float32),
                               "int8")
    wq, alpha, cq = tref.quantize_query_weights_ref(T(q), T(st.scale),
                                                    T(st.offset))
    rwq, ralpha, rcq = jref.quantize_query_weights_ref(
        jnp.asarray(q), jnp.asarray(st.scale), jnp.asarray(st.offset))
    assert wq.dtype == torch.int8
    assert _np(wq).tobytes() == np.asarray(rwq).tobytes()
    assert _np(alpha).tobytes() == np.asarray(ralpha).tobytes()
    np.testing.assert_allclose(_np(cq), np.asarray(rcq), rtol=1e-6,
                               atol=1e-6)


def _int8_scan_inputs(Q, N, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (Q, d)).astype(np.float32)
    st = RefStore.from_vectors(rng.normal(0, 2, (N, d)).astype(np.float32),
                               "int8")
    lo = rng.uniform(0, 100, N).astype(np.float32)
    hi = lo + rng.uniform(0, 30, N).astype(np.float32)
    ql = rng.uniform(0, 80, Q).astype(np.float32)
    qh = ql + rng.uniform(0, 40, Q).astype(np.float32)
    if N > 3:                                    # NaN-padded rows
        lo[-2:] = np.nan
        hi[-2:] = np.nan
    return q, st.codes, st.scale, st.offset, st.sq_norm, lo, hi, ql, qh


@pytest.mark.parametrize("mask", [1, 15, 48, 63])
@pytest.mark.parametrize("Q,N,d", [(4, 96, 16), (5, 130, 17), (9, 257, 32)])
def test_pairwise_l2_int8_ref_matches_pallas(mask, Q, N, d):
    args = _int8_scan_inputs(Q, N, d, seed=mask * 100 + N)
    got = _np(ops.pairwise_l2_int8(*map(T, args), mask))
    want = np.asarray(pallas_int8(*map(jnp.asarray, args), mask,
                                  interpret=True))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert np.all(np.abs(got[fin] - want[fin])
                  <= 1e-4 * (np.abs(want[fin]) + 1.0))


def test_int8_scan_ref_takes_exact_integer_dot_products():
    """The plain int8 scan's float64 dot products equal int32 ones, so its
    output is the prologue followed by the reference's integer formula."""
    args = [T(a) for a in _int8_scan_inputs(6, 40, 24, seed=3)]
    q, codes, scale, offset = args[:4]
    wq, alpha, cq = tref.quantize_query_weights_ref(q, scale, offset)
    acc = wq.to(torch.int32) @ codes.to(torch.int32).T
    want = (cq[:, None] - 2.0 * alpha[:, None] * acc.to(torch.float32)
            + args[4][None, :])
    got = tref.pairwise_l2_int8_ref(*args, riv.ANY_OVERLAP)
    fin = torch.isfinite(got)
    assert torch.equal(got[fin], want[fin])


# ---- the quantized wavefront step ------------------------------------------

def _quant_step_inputs(dtype, Q, n, d, M, L, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (n, d)).astype(np.float32)
    table[1::2] = table[0::2][: len(table[1::2])]          # exact ties
    st = RefStore.from_vectors(table, dtype)
    q = rng.normal(0, 1, (Q, d)).astype(np.float32)
    ids = rng.integers(-1, n, (Q, M)).astype(np.int32)
    avail = (rng.random((Q, M)) < 0.8) & (ids >= 0)
    b = rng.integers(0, 40, (Q, M)).astype(np.int32)
    e = b + rng.integers(0, 40, (Q, M)).astype(np.int32)
    ver = rng.integers(0, 70, Q).astype(np.int32)
    pool_d = np.sort(rng.random((Q, L)).astype(np.float32), axis=1)
    pool_ids = rng.integers(0, n, (Q, L)).astype(np.int32)
    tail = rng.integers(0, L + 1, Q)
    for qi in range(Q):
        pool_d[qi, tail[qi]:] = np.inf
        pool_ids[qi, tail[qi]:] = -1
    pool_exp = (rng.random((Q, L)) < 0.5) & np.isfinite(pool_d)
    return (q, st.codes, st.scale, st.offset, ids, avail, b, e, ver,
            pool_ids, pool_d, pool_exp)


@pytest.mark.parametrize("dtype", ["int8", "float16"])
@pytest.mark.parametrize("shape", [(4, 200, 16, 12, 16), (9, 300, 17, 40, 8)])
def test_gathered_topk_quant_ref_matches_pallas(dtype, shape):
    args = _quant_step_inputs(dtype, *shape, seed=len(dtype) + shape[0])
    gi, gd, ge = (_np(a) for a in ops.gathered_topk_quant(*map(T, args)))
    wi, wd, we = (np.asarray(a) for a in pallas_gtq(
        *map(jnp.asarray, args), interpret=True))
    assert_same_topk(gi, gd, wi, wd)
    np.testing.assert_array_equal(ge[gi == wi], we[gi == wi])


# ---- top-R and the exact re-rank ---------------------------------------------

@pytest.mark.parametrize("N,R,levels", [(4, 3, 0), (70, 16, 0), (500, 40, 0),
                                        (500, 40, 6), (300, 20, 300)])
def test_topr_from_dists_matches_reference(N, R, levels):
    """Ties (``levels`` distinct finite values) go to the lowest column as
    under ``lax.top_k``; rows with few qualifiers pad with NO_EDGE/+inf."""
    rng = np.random.default_rng(N + R + levels)
    Q = 6
    d = rng.random((Q, N)).astype(np.float32)
    if levels:
        d = np.floor(d * levels).astype(np.float32)
    d[rng.random((Q, N)) < 0.4] = np.inf
    d[0] = np.inf                                     # nothing qualifies
    if N == 4:
        d[1] = [0.5, np.inf, 0.1, np.inf]
    ids, dd = tcomp.topr_from_dists(T(d), rerank=R)
    rids, rdd = rcomp.topr_from_dists(jnp.asarray(d), rerank=R)
    np.testing.assert_array_equal(_np(ids), np.asarray(rids))
    np.testing.assert_array_equal(_np(dd), np.asarray(rdd))


@pytest.mark.parametrize("R,k", [(8, 3), (40, 10)])
def test_exact_rerank_matches_reference(R, k):
    rng = np.random.default_rng(R)
    Q, d = 5, 16
    q = rng.normal(size=(Q, d)).astype(np.float32)
    rows = rng.normal(size=(Q, R, d)).astype(np.float32)
    rows[:, 1] = rows[:, 0]                         # exact ties
    cand = rng.integers(0, 1000, (Q, R)).astype(np.int32)
    cand[:, R // 2:] = -1                           # NO_EDGE padding
    cand[0] = -1                                    # a row with none
    ids, dd = tcomp.exact_rerank(T(q), T(rows), T(cand), k=k)
    rids, rdd = rcomp.exact_rerank(jnp.asarray(q), jnp.asarray(rows),
                                   jnp.asarray(cand), k=k)
    assert_same_topk(_np(ids), _np(dd), np.asarray(rids), np.asarray(rdd))
    np.testing.assert_array_equal(_np(ids)[0], np.full(k, -1))


# ---- the store ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int8", "float16"])
@pytest.mark.parametrize("n,d", [(300, 16), (57, 17)])
def test_quantized_store_is_byte_equal(dtype, n, d):
    rng = np.random.default_rng(n * d)
    v = rng.normal(0, 3, (n, d)).astype(np.float32)
    v[:, 2] = 1.5                                   # a constant dimension
    a, b = QuantizedStore.from_vectors(v, dtype), RefStore.from_vectors(v,
                                                                        dtype)
    for f in ("codes", "scale", "offset", "sq_norm"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


# ---- the engine ------------------------------------------------------------

@pytest.fixture(scope="module")
def port_index(small_ds):
    ds = small_ds
    return MSTGIndex(ds.vectors, ds.lo, ds.hi, variants=("T", "Tp", "Tpp"),
                     m=8, ef_con=40)


@pytest.fixture(scope="module")
def quant_engines(built_index, port_index):
    """{tier: (reference engine, port engine)} on the same index."""
    return {t: (RefEngine(built_index, config=RefConfig(use_kernel=True,
                                                        storage_dtype=t)),
                QueryEngine(port_index, EngineConfig(storage_dtype=t),
                            device="cpu"))
            for t in ("int8", "float16")}


def _both(engines, queries, qlo, qhi, mask, **kw):
    ref_eng, port_eng = engines
    a = ref_eng.search(RefRequest(queries, (qlo, qhi), mask, **kw))
    b = port_eng.search(SearchRequest(queries, (qlo, qhi), mask, **kw))
    return a, b


def _assert_same_result(a, b):
    assert b.report.route == a.report.route
    assert b.report.slot_count == a.report.slot_count
    assert_same_topk(b.ids, b.dists, np.asarray(a.ids), np.asarray(a.dists))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("tier,mask",
                         [("int8", m) for m in MASKS]
                         + [("float16", m) for m in MASKS[:3]],
                         ids=lambda v: v if isinstance(v, str)
                         else riv.mask_name(v))
def test_quantized_engine_matches_reference(small_ds, quant_engines, tier,
                                            mask, route):
    ds = small_ds
    qlo, qhi = make_queries(ds, mask, 0.15, seed=13)
    a, b = _both(quant_engines[tier], ds.queries, qlo, qhi, mask, k=10,
                 ef=48, route=route, fanout=2)
    _assert_same_result(a, b)


@pytest.mark.parametrize("tier", ["int8", "float16"])
def test_quantized_chunked_graph_batch_matches_reference(small_ds,
                                                         quant_engines, tier):
    """A 64-query batch: the chunked driver's compaction is on."""
    ds = small_ds
    pick = np.random.default_rng(64).integers(0, ds.queries.shape[0], 64)
    qlo, qhi = make_queries(ds, riv.ANY_OVERLAP, 0.3, seed=41)
    a, b = _both(quant_engines[tier], ds.queries[pick], qlo[pick], qhi[pick],
                 riv.ANY_OVERLAP, k=10, ef=32, route="graph")
    _assert_same_result(a, b)


@pytest.mark.parametrize("rerank_k", [5, 64])
def test_rerank_k_matches_reference(small_ds, built_index, port_index,
                                    rerank_k):
    """The reference's ``test_rerank_k_knob`` case: the int8 flat route at
    a narrow and a wide re-rank budget."""
    ds = small_ds
    qlo, qhi = make_queries(ds, riv.ANY_OVERLAP, 0.25, seed=21)
    engines = (RefEngine(built_index, config=RefConfig(
                   use_kernel=True, storage_dtype="int8", rerank_k=rerank_k)),
               QueryEngine(port_index, EngineConfig(storage_dtype="int8",
                                                    rerank_k=rerank_k),
                           device="cpu"))
    a, b = _both(engines, ds.queries, qlo, qhi, riv.ANY_OVERLAP, k=5,
                 route="flat")
    _assert_same_result(a, b)
    assert engines[1]._rerank_width(5) == engines[0]._rerank_width(5)


@pytest.mark.parametrize("tier,ratio", [(None, 1.0), ("float32", 1.0),
                                        ("float16", 0.5), ("int8", 0.25)])
def test_scan_cost_ratio_and_auto_route(small_ds, built_index, port_index,
                                        tier, ratio):
    ds = small_ds
    ref_eng = RefEngine(built_index, config=RefConfig(storage_dtype=tier))
    eng = QueryEngine(port_index, EngineConfig(storage_dtype=tier),
                      device="cpu")
    assert eng._scan_cost_ratio == ref_eng._scan_cost_ratio == ratio
    for sel in (0.02, 0.1, 0.6):
        qlo, qhi = make_queries(ds, riv.ANY_OVERLAP, sel, seed=7)
        est = eng.estimate_selectivity(riv.ANY_OVERLAP, qlo, qhi)
        for ef in (16, 64):
            assert eng._auto_route(est, ef) == ref_eng._auto_route(est, ef)


@pytest.mark.parametrize("tier", ["int8", "float16"])
def test_float32_corpus_is_never_staged_and_cpu_launches_nothing(
        small_ds, quant_engines, tier):
    ds = small_ds
    eng = quant_engines[tier][1]
    qlo, qhi = make_queries(ds, riv.ANY_OVERLAP, 0.2, seed=5)
    ops.reset_launches()
    for route in ROUTES:
        eng.search(SearchRequest(ds.queries, (qlo, qhi), riv.ANY_OVERLAP,
                                 k=5, route=route))
    assert eng._corpus_dev is None
    assert eng.store_dev()["codes"].dtype == (torch.int8 if tier == "int8"
                                              else torch.float16)
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_reference_int8_artifact_loads_with_its_store(small_ds, tmp_path):
    """An int8 index saved by the reference loads in the port with a
    byte-equal store, which the engine serves as it is."""
    ds = small_ds
    ref_idx = RefIndex(ds.vectors, ds.lo, ds.hi, variants=("T", "Tp"), m=8,
                       ef_con=40, storage_dtype="int8")
    path = ref_idx.save(str(tmp_path / "int8.npz"))
    idx = MSTGIndex.load(path)
    assert idx.spec.storage_dtype == "int8"
    for f in ("codes", "scale", "offset", "sq_norm"):
        assert (getattr(idx.storage, f).tobytes()
                == getattr(ref_idx.storage, f).tobytes()), f
    eng = QueryEngine(idx, device="cpu")
    assert eng._store is idx.storage
    qlo, qhi = make_queries(ds, riv.ANY_OVERLAP, 0.2, seed=9)
    a, b = _both((RefEngine(ref_idx, config=RefConfig(use_kernel=True)), eng),
                 ds.queries, qlo, qhi, riv.ANY_OVERLAP, k=10, ef=48,
                 route="graph")
    _assert_same_result(a, b)


@pytest.mark.parametrize("tier", ["int8", "float16"])
def test_index_from_arrays_carries_the_store(small_ds, built_index, tier):
    """A store handed over as arrays is served as it is: a store whose
    codes differ from a fresh quantization shows up in the results."""
    ds = small_ds
    st = RefStore.from_vectors(ds.vectors * 1.01, tier)   # not the corpus's
    variants = {v: {f: getattr(fv, f) for f in FV_FIELDS}
                for v, fv in built_index.variants.items()}
    idx = index_from_arrays(ds.vectors, ds.lo, ds.hi, variants, IndexSpec(),
                            storage=st.to_arrays())
    assert idx.spec.storage_dtype == tier
    assert idx.storage.dtype == tier
    assert idx.storage.codes.tobytes() == st.codes.tobytes()
    eng = QueryEngine(idx, device="cpu")
    assert eng._store is idx.storage
    assert eng.store_dev()["codes"].numpy().tobytes() == st.codes.tobytes()
    with pytest.raises(ValueError, match="storage_dtype"):
        other = "float16" if tier == "int8" else "int8"
        index_from_arrays(ds.vectors, ds.lo, ds.hi, variants,
                          IndexSpec(storage_dtype=other),
                          storage=st.to_arrays())
