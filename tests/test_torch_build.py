"""The port's host layer against the JAX reference: the batched segment-tree
decomposition, the bulk builder (byte-equal frozen arrays), the ``.npz``
artifact in both directions, and ``convert.index_from_arrays``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import MSTGIndex as RefIndex
from repro.core import segment_tree as rst

from repro_torch import convert
from repro_torch.core import IndexSpec, MSTGIndex, QueryEngine, SearchRequest
from repro_torch.core import intervals as tiv
from repro_torch.core import segment_tree as tst
from repro_torch.data import make_queries

FV_FIELDS = ("sort_rank", "tkey", "nbr", "lab_b", "lab_e", "entry_ids",
             "entry_ver", "members", "member_ver", "node_off")


@pytest.mark.parametrize("Kpad", [1, 2, 4, 8, 16, 32, 64])
def test_decompose_batched_matches_decompose_jax(Kpad):
    """Every (lo, hi), including empty and out-of-domain ranges."""
    r = np.arange(-2, Kpad + 2)
    lo, hi = (a.ravel() for a in np.meshgrid(r, r, indexing="ij"))
    want = jax.vmap(lambda a, b: rst.decompose_jax(a, b, Kpad))(
        jnp.asarray(lo), jnp.asarray(hi))
    got = tst.decompose_batched(torch.from_numpy(lo), torch.from_numpy(hi),
                                Kpad)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ws, we = rst.node_ranges_jax(want[0], want[1], Kpad)
    gs, ge = tst.node_ranges(got[0], got[1], Kpad)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))


@pytest.fixture(scope="module")
def port_index(small_ds):
    ds = small_ds
    return MSTGIndex(ds.vectors, ds.lo, ds.hi, variants=("T", "Tp", "Tpp"),
                     m=8, ef_con=40)


def _assert_same_arrays(a, b):
    assert sorted(a.variants) == sorted(b.variants)
    for v in a.variants:
        fa, fb = a.variants[v], b.variants[v]
        assert (fa.K, fa.Kpad, fa.Lv, fa.n) == (fb.K, fb.Kpad, fb.Lv, fb.n)
        for f in FV_FIELDS:
            x, y = getattr(fa, f), getattr(fb, f)
            assert x.dtype == y.dtype and x.shape == y.shape, (v, f)
            assert x.tobytes() == y.tobytes(), (v, f)


def test_bulk_builder_byte_equal_to_reference(built_index, port_index):
    _assert_same_arrays(built_index, port_index)
    np.testing.assert_array_equal(built_index.domain.values,
                                  port_index.domain.values)


@pytest.mark.parametrize("builder,stage", [("scan", "exact"),
                                           ("bulk", "coarse")])
def test_other_builders_byte_equal(small_ds, builder, stage):
    ds = small_ds
    kw = dict(variants=("T", "Tp"), m=8, ef_con=24, builder=builder,
              candidate_stage=stage, coarse_threshold=128)
    _assert_same_arrays(RefIndex(ds.vectors, ds.lo, ds.hi, **kw),
                        MSTGIndex(ds.vectors, ds.lo, ds.hi, **kw))


def test_npz_artifacts_cross_load(tmp_path, built_index, port_index):
    ref_path = built_index.save(str(tmp_path / "ref.npz"))
    port_path = port_index.save(str(tmp_path / "port.npz"))
    _assert_same_arrays(built_index, MSTGIndex.load(ref_path))
    _assert_same_arrays(port_index, RefIndex.load(port_path))
    loaded = MSTGIndex.load(ref_path)
    assert loaded.spec.to_dict() == built_index.spec.to_dict()
    np.testing.assert_array_equal(loaded.vectors, built_index.vectors)


def test_index_from_arrays_searches_like_the_built_index(small_ds,
                                                         built_index,
                                                         port_index):
    ds = small_ds
    variants = {v: {f: getattr(fv, f) for f in FV_FIELDS}
                for v, fv in built_index.variants.items()}
    spec = IndexSpec.from_dict(built_index.spec.to_dict())
    conv = convert.index_from_arrays(ds.vectors, ds.lo, ds.hi, variants, spec)
    _assert_same_arrays(built_index, conv)
    qlo, qhi = make_queries(ds, tiv.ANY_OVERLAP, 0.15, seed=7)
    for route in ("graph", "pruned"):
        req = SearchRequest(ds.queries, (qlo, qhi), tiv.ANY_OVERLAP, k=8,
                            ef=32, route=route)
        a = QueryEngine(conv, device="cpu").execute(req)
        b = QueryEngine(port_index, device="cpu").execute(req)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)


def test_index_from_arrays_names_missing_arrays(small_ds, built_index):
    ds = small_ds
    fv = built_index.variants["T"]
    partial = {"T": {f: getattr(fv, f) for f in FV_FIELDS[:-1]}}
    with pytest.raises(KeyError, match="node_off"):
        convert.index_from_arrays(ds.vectors, ds.lo, ds.hi, partial,
                                  IndexSpec())
