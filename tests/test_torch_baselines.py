"""The port's baselines (``repro_torch.core.baselines``) against the
reference's ``repro.core.baselines`` on the CPU, on the reference's own
fixture. The host baselines must return the reference's ids, dists and
``last_dist_evals`` exactly; ``IRangeGraphLike`` (whose search runs the
port's wavefront on ``device="cpu"``) equal ids wherever distances are
distinct, dists within 1e-5. The reference's recall floors and validity
checks (``tests/test_baselines.py``) are held for the port too.

The reference is imported inside :func:`_ref` with ``DeprecationWarning``
ignored there only, as the repository's pytest settings turn jax's
deprecation warnings into errors.
"""
import functools
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import ANY_OVERLAP, intervals as iv
from repro_torch.core import baselines as tb
from repro_torch.data import (brute_force_topk, make_queries,
                              make_range_dataset, recall_at_k)


@functools.lru_cache(maxsize=None)
def _ref():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.core import baselines
    return baselines


@pytest.fixture(scope="module")
def ds():
    return make_range_dataset(n=500, d=16, n_queries=10, quantize=32, seed=9)


def _queries(ds, case):
    """(mask, qlo, qhi, search knobs) of each test in test_baselines.py."""
    if case == "prefilter":
        return (ANY_OVERLAP,) + make_queries(ds, ANY_OVERLAP, 0.2, seed=1) \
            + ({},)
    if case in ("postfilter", "acorn"):
        return (ANY_OVERLAP,) + make_queries(ds, ANY_OVERLAP, 0.3, seed=2) \
            + ({"ef": 80},)
    if case == "tsgraph":
        t = float(np.median((ds.lo + ds.hi) / 2))
        return iv.TSANN_MASK, np.full(10, t), np.full(10, t), {"ef": 64}
    if case == "hipng":
        return (iv.IFANN_MASK,) + make_queries(ds, iv.IFANN_MASK, 0.25,
                                               seed=3) + ({"ef": 80},)
    attr = (ds.lo + ds.hi) / 2
    return (iv.RFANN_MASK, np.quantile(attr, 0.2) * np.ones(10),
            np.quantile(attr, 0.6) * np.ones(10), {"ef": 64})


def _make(mod, case, ds, **kw):
    if case == "prefilter":
        return mod.Prefiltering(ds.vectors, ds.lo, ds.hi)
    if case == "postfilter":
        return mod.Postfiltering(ds.vectors, ds.lo, ds.hi, m=8, ef_con=40)
    if case == "acorn":
        return mod.AcornLike(ds.vectors, ds.lo, ds.hi, m=8, ef_con=40)
    if case == "tsgraph":
        return mod.TSGraphLike(ds.vectors, ds.lo, ds.hi, n_buckets=8, m=8,
                               ef_con=40)
    if case == "hipng":
        return mod.HiPNGLike(ds.vectors, ds.lo, ds.hi, leaf_size=48, m=8,
                             ef_con=40)
    return mod.IRangeGraphLike(ds.vectors, (ds.lo + ds.hi) / 2, m=8,
                               ef_con=40, **kw)


HOST = ("prefilter", "postfilter", "acorn", "tsgraph", "hipng")


@pytest.mark.parametrize("case", HOST)
def test_host_baseline_equals_reference(ds, case):
    mask, qlo, qhi, knobs = _queries(ds, case)
    want_b, got_b = _make(_ref(), case, ds), _make(tb, case, ds)
    want = want_b.search(ds.queries, qlo, qhi, mask, k=10, **knobs)
    got = got_b.search(ds.queries, qlo, qhi, mask, k=10, **knobs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert got_b.last_dist_evals == want_b.last_dist_evals > 0
    assert got_b.index_bytes() == want_b.index_bytes()
    assert got_b.storage_bytes() == want_b.storage_bytes()


def test_irangegraph_equals_reference(ds):
    mask, qlo, qhi, knobs = _queries(ds, "irangegraph")
    want_b = _make(_ref(), "irangegraph", ds)
    got_b = _make(tb, "irangegraph", ds, device="cpu")
    wi, wd = want_b.search(ds.queries, qlo, qhi, k=10, **knobs)
    gi, gd = got_b.search(ds.queries, qlo, qhi, k=10, **knobs)
    assert gi.shape == wi.shape == (10, 10)
    assert gi.dtype == np.int32 and gd.dtype == np.float32
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)
    # ids equal wherever the distance is not tied with a neighbour's
    for q in range(gi.shape[0]):
        for r in range(gi.shape[1]):
            ties = np.abs(wd[q] - wd[q, r]) <= 1e-5 * (abs(wd[q, r]) + 1)
            if ties.sum() == 1:
                assert gi[q, r] == wi[q, r], (q, r)
    assert got_b.index_bytes() == want_b.index_bytes()
    assert got_b.storage_bytes() == want_b.storage_bytes()
    # a copy on another device shares the host index and answers the same
    again = got_b.to("cpu")
    assert again.idx is got_b.idx
    np.testing.assert_array_equal(again.search(ds.queries, qlo, qhi, k=10,
                                               **knobs)[0], gi)


# the reference's floors (tests/test_baselines.py), held for the port
FLOORS = {"prefilter": 1.0, "postfilter": 0.55, "acorn": 0.55,
          "tsgraph": 0.6, "hipng": 0.6, "irangegraph": 0.85}


@pytest.mark.parametrize("case", HOST + ("irangegraph",))
def test_port_recall_floor_and_validity(ds, case):
    mask, qlo, qhi, knobs = _queries(ds, case)
    if case == "irangegraph":
        attr = (ds.lo + ds.hi) / 2
        lo, hi = attr, attr
        b = _make(tb, case, ds, device="cpu")
        ids, _ = b.search(ds.queries, qlo, qhi, k=10, **knobs)
    else:
        lo, hi = ds.lo, ds.hi
        b = _make(tb, case, ds)
        ids, _ = b.search(ds.queries, qlo, qhi, mask, k=10, **knobs)
    tids, _ = brute_force_topk(ds.vectors, lo, hi, ds.queries, qlo, qhi,
                               mask, 10)
    assert recall_at_k(ids, tids) >= FLOORS[case]
    for qi in range(ids.shape[0]):
        got = ids[qi][ids[qi] >= 0]
        sel = np.asarray(iv.eval_predicate(mask, lo[got], hi[got], qlo[qi],
                                           qhi[qi]))
        assert sel.all()
    if case in ("postfilter", "acorn"):
        assert b.index_bytes() > 0


def test_irangegraph_runs_on_cuda_by_default(ds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    attr = (ds.lo + ds.hi) / 2
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.IRangeGraphLike(ds.vectors, attr, m=8, ef_con=40)
    b = tb.IRangeGraphLike(ds.vectors, attr, m=8, ef_con=40, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        b.to("cuda")
