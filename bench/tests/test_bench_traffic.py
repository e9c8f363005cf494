"""The query generator: achieved selectivity within its tolerance for each
predicate, counted by brute force with the reference's predicates, and
the same set of sizes for every seed."""
import numpy as np
import pytest

from bench import corpus as corpus_mod, reference
from bench.traffic import histogram_ranges as gen

RECIPE = {"recipe": "gaussian_ranges", "clusters": 16, "noise": 0.35,
          "span": 1000.0, "max_width_frac": 0.25, "attribute_dist": "uniform",
          "attribute_domain": 1024}


@pytest.fixture(scope="module")
def corpus():
    return corpus_mod.make(RECIPE, 20000, 8, 11, "cpu")


def _mix(pred, low, high, batch=40, pool=2):
    return {"batch": batch, "pool": pool, "predicates": [pred],
            "selectivity": {"law": "log_uniform", "low": low, "high": high,
                            "tolerance": 0.1}}


@pytest.mark.parametrize("pred", reference.PREDICATES)
def test_achieved_selectivity_within_tolerance(corpus, pred):
    mix = _mix(pred, 0.01, 0.5)
    t = gen.make(mix, corpus, 2**31 + 77, "cpu")
    assert t.out_of_tolerance == 0
    for r in t.pool:
        count = reference.holds(pred, corpus.lo[None, :], corpus.hi[None, :],
                                r.qlo[:, None], r.qhi[:, None]).sum(1)
        np.testing.assert_array_equal(count / corpus.n, r.achieved)
        rel = np.abs(r.achieved - r.target) / r.target
        assert rel.max() <= 0.1 + 1e-12
        assert (r.qlo <= r.qhi).all()
        assert np.isin(r.qlo, corpus.grid).all()


def test_unreachable_law_takes_the_nearest_reachable(corpus):
    # the disjunction cannot fall below ~6% on these ranges
    t = gen.make(_mix("Overlaps", 0.0005, 0.01), corpus, 5, "cpu")
    assert t.out_of_tolerance == 0
    s = np.concatenate([r.achieved for r in t.pool])
    assert s.min() > 0.01


def test_every_seed_gets_the_same_sizes(corpus):
    mix = _mix("QueryContaining", 0.001, 0.3, batch=16, pool=4)
    a = gen.make(mix, corpus, 1, "cpu")
    b = gen.make(mix, corpus, 2**33 + 5, "cpu")
    ta = np.sort(np.concatenate([r.target for r in a.pool]))
    tb = np.sort(np.concatenate([r.target for r in b.pool]))
    np.testing.assert_array_equal(ta, tb)
    assert not np.array_equal(a.pool[0].vectors, b.pool[0].vectors)
    due_a, _ = a.arrivals(1000.0, 2.0, 3)
    due_b, _ = b.arrivals(1000.0, 2.0, 3)
    assert abs(len(due_a) - len(due_b)) <= 2
    assert (np.diff(due_a) > 0).all() and due_a[-1] < 2.0


def test_same_seed_same_traffic(corpus):
    mix = _mix("LeftOverlap", 0.01, 0.1, batch=8, pool=3)
    a = gen.make(mix, corpus, 9, "cpu")
    b = gen.make(mix, corpus, 9, "cpu")
    for x, y in zip(a.pool, b.pool):
        np.testing.assert_array_equal(x.vectors, y.vectors)
        np.testing.assert_array_equal(x.qlo, y.qlo)
        np.testing.assert_array_equal(x.qhi, y.qhi)


def test_predicates_spread_evenly_over_the_pool(corpus):
    mix = _mix("LeftOverlap", 0.01, 0.1, batch=4, pool=10)
    mix["predicates"] = list(reference.PREDICATES)
    t = gen.make(mix, corpus, 3, "cpu")
    names = [r.predicate for r in t.pool]
    assert sorted(names) == sorted(list(reference.PREDICATES) * 2)
