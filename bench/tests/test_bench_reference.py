"""The plain reference against loops written here from the paper's
definitions."""
import itertools

import numpy as np
import pytest
import torch

from bench import reference


def _loop_holds(name, lo, hi, ql, qh):
    left = lo <= ql <= hi <= qh
    contained = lo <= ql and qh <= hi
    right = ql <= lo <= qh <= hi
    containing = ql <= lo and hi <= qh
    return {"LeftOverlap": left, "QueryContained": contained,
            "RightOverlap": right, "QueryContaining": containing,
            "Overlaps": left or contained or right or containing}[name]


@pytest.mark.parametrize("name", reference.PREDICATES)
def test_predicates_match_a_loop(name):
    # a grid of 6 values, so endpoints tie often
    rng = np.random.default_rng(3)
    a = rng.integers(0, 6, (400, 2))
    lo, hi = a.min(1).astype(float), a.max(1).astype(float)
    for ql, qh in itertools.combinations_with_replacement(range(6), 2):
        got = reference.holds(name, lo, hi, float(ql), float(qh))
        want = [_loop_holds(name, l, h, ql, qh) for l, h in zip(lo, hi)]
        assert got.tolist() == want


def test_overlaps_is_any_intersection():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 9, (2000, 2))
    lo, hi = a.min(1).astype(float), a.max(1).astype(float)
    q = rng.integers(0, 9, (2000, 2))
    ql, qh = q.min(1).astype(float), q.max(1).astype(float)
    got = reference.holds("Overlaps", lo, hi, ql, qh)
    assert got.tolist() == ((lo <= qh) & (ql <= hi)).tolist()


def _brute(X, lo, hi, q, ql, qh, name, k):
    ids = np.full((q.shape[0], k), -1)
    ds = np.full((q.shape[0], k), np.inf)
    for i in range(q.shape[0]):
        ok = [j for j in range(X.shape[0])
              if _loop_holds(name, lo[j], hi[j], ql[i], qh[i])]
        d = [float(((X[j].astype(np.float64) - q[i]) ** 2).sum()) for j in ok]
        order = sorted(range(len(ok)), key=lambda t: (d[t], ok[t]))[:k]
        ids[i, :len(order)] = [ok[t] for t in order]
        ds[i, :len(order)] = [d[t] for t in order]
    return ids, ds


@pytest.mark.parametrize("block", [7, 64, 10000])
@pytest.mark.parametrize("name", reference.PREDICATES)
def test_exact_topk_matches_a_loop(name, block):
    rng = np.random.default_rng(5)
    n, d, Q, k = 150, 8, 12, 10
    X = rng.normal(size=(n, d)).astype(np.float32)
    a = rng.integers(0, 20, (n, 2))
    lo, hi = a.min(1).astype(float), a.max(1).astype(float)
    q = rng.normal(size=(Q, d)).astype(np.float32)
    b = rng.integers(0, 20, (Q, 2))
    ql, qh = b.min(1).astype(float), b.max(1).astype(float)
    t = torch.as_tensor
    ids, ds, counts = reference.exact_topk(t(X), t(lo), t(hi), t(q), t(ql),
                                           t(qh), name, k, block=block)
    want_ids, want_d = _brute(X, lo, hi, q, ql, qh, name, k)
    assert ids.tolist() == want_ids.tolist()
    np.testing.assert_allclose(ds, want_d, rtol=1e-12, atol=1e-12)
    assert counts.tolist() == [
        sum(_loop_holds(name, lo[j], hi[j], ql[i], qh[i]) for j in range(n))
        for i in range(Q)]


def test_ties_go_to_the_lowest_id():
    # rows 0..29 hold three distinct vectors, each ten times over
    base = np.eye(3, 4, dtype=np.float32)
    X = np.repeat(base, 10, axis=0)[np.random.default_rng(6).permutation(30)]
    lo = np.zeros(30)
    hi = np.ones(30)
    q = np.zeros((1, 4), np.float32)
    q[0, 0] = 0.1
    t = torch.as_tensor
    for block in (4, 30):
        ids, ds, _ = reference.exact_topk(t(X), t(lo), t(hi), t(q),
                                          t(np.zeros(1)), t(np.ones(1)),
                                          "Overlaps", 10, block=block)
        want = np.flatnonzero((X == base[0]).all(1))[:10]
        assert ids[0].tolist() == want.tolist()


def test_fewer_qualifying_than_k_pads():
    t = torch.as_tensor
    X = np.arange(12, dtype=np.float32).reshape(6, 2)
    lo = np.array([0., 0., 5., 5., 5., 5.])
    hi = np.array([1., 1., 6., 6., 6., 6.])
    ids, ds, counts = reference.exact_topk(
        t(X), t(lo), t(hi), t(np.zeros((1, 2), np.float32)),
        t(np.zeros(1)), t(np.ones(1)), "Overlaps", 4)
    assert ids.tolist() == [[0, 1, -1, -1]]
    assert np.isinf(ds[0, 2:]).all() and counts.tolist() == [2]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -12)])
    got = reference._tf32_round(x).tolist()
    # ties round to even; below half a unit rounds down
    assert got == [1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -9, -1.0]


def test_pair_dists_are_exact_differences():
    rng = np.random.default_rng(8)
    X = rng.normal(size=(50, 6)).astype(np.float32)
    q = rng.normal(size=(3, 6)).astype(np.float32)
    ids = np.array([[0, 5, -1], [49, 1, 2], [-1, -1, -1]])
    got = reference.pair_dists(torch.as_tensor(X), torch.as_tensor(q), ids)
    for i in range(3):
        for j in range(3):
            if ids[i, j] < 0:
                assert np.isinf(got[i, j])
            else:
                want = ((X[ids[i, j]].astype(np.float64) - q[i]) ** 2).sum()
                assert got[i, j] == pytest.approx(want, rel=1e-12)
