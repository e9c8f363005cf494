"""The port's streaming layer (``repro_torch.streaming``) against the
reference's ``repro.streaming``, on the CPU.

Both packages take the same sequence of adds, deletes, upserts, flushes, a
size-tiered compaction and an unflushed delta, from the same numpy data.
The reference's engines run ``EngineConfig(use_kernel=True)`` (its Pallas
kernels in interpret mode); the port runs its plain versions on the CPU.
Answers must carry equal ids wherever distances are distinct, distances
within 1e-5 on the graph and pruned routes and 1e-4 on the scans (the flat
route and the delta), and equal graph step counts.
"""
import numpy as np
import pytest

from repro.core import EngineConfig as RefConfig
from repro.core import IndexSpec as RefSpec
from repro.core import MSTGIndex as RefIndex
from repro.core import SearchRequest as RefRequest
from repro.streaming import CompactionPolicy as RefPolicy
from repro.streaming import DeltaBuffer as RefDelta
from repro.streaming import SegmentedIndex as RefSegmented

from repro_torch.core import (EngineConfig, IndexSpec, MSTGIndex,
                              SearchRequest)
from repro_torch.core import intervals as iv
from repro_torch.data import make_queries, make_range_dataset
from repro_torch.kernels import ops
from repro_torch.streaming import (CompactionPolicy, DeltaBuffer,
                                   SegmentedIndex)

N = 380
MASKS8 = (1, 2, 4, 8, 15, 16, 32, 48)
SPEC = dict(variants=("T", "Tp", "Tpp"), m=8, ef_con=40)


@pytest.fixture(scope="module")
def sds():
    return make_range_dataset(n=N, d=16, n_queries=8, quantize=32, seed=5)


def _apply_ops(s, ds, compact_full: bool = False):
    """The op sequence both packages take: two flushed waves with deletes
    in a segment and in the delta and upserts of frozen rows, a third
    segment, a size-tiered compaction (the policy's tier_ratio of 2.5 picks
    segments 2 and 3), then an unflushed delta with kills, more tombstones
    and upserts of compacted rows. ``compact_full`` flushes that delta and
    compacts everything instead of leaving it."""
    rng = np.random.default_rng(11)
    ids = np.arange(ds.n)
    v, lo, hi = ds.vectors, ds.lo, ds.hi

    def add(rows, vecs=None):
        s.add(rows, v[rows] if vecs is None else vecs, lo[rows], hi[rows])

    add(ids[:160])
    assert s.flush() is not None
    add(ids[160:280])
    dead = np.concatenate([rng.choice(160, 12, replace=False),
                           160 + rng.choice(120, 8, replace=False)])
    assert s.delete(dead) == len(dead)
    up = rng.choice(np.setdiff1d(np.arange(160), dead), 6, replace=False)
    add(up, v[up] + 0.05 * rng.normal(0, 1, (6, ds.d)).astype(np.float32))
    assert s.flush() is not None
    add(ids[280:330])
    s.flush()
    report = s.compact()
    add(ids[330:380])
    s.delete(ids[330:335])
    frozen = np.setdiff1d(np.arange(160), np.concatenate([dead, up]))
    s.delete(rng.choice(frozen, 4, replace=False))
    moved = rng.choice(np.setdiff1d(np.arange(160, 330), dead), 3,
                       replace=False)
    add(moved, v[moved] + 0.05 * rng.normal(0, 1, (3, ds.d)).astype(
        np.float32))
    if compact_full:
        s.flush()
        s.compact(full=True)
    return report


def _pair(ds, compact_full=False, **spec_kw):
    ref = RefSegmented(RefSpec(**SPEC, **spec_kw),
                       policy=RefPolicy(tier_ratio=2.5),
                       engine_config=RefConfig(use_kernel=True))
    port = SegmentedIndex(IndexSpec(**SPEC, **spec_kw),
                          policy=CompactionPolicy(tier_ratio=2.5),
                          device="cpu")
    reports = [_apply_ops(s, ds, compact_full) for s in (ref, port)]
    assert reports[0] == reports[1]
    return ref, port


@pytest.fixture(scope="module")
def streamed(sds):
    return _pair(sds)


def _steps(trace) -> int:
    return sum(int(sp.args.get("steps", 0)) for sp, _ in trace.walk()
               if sp.name == "wavefront_totals")


def _segment_rows(report):
    return [(r.segment, r.n, r.route, r.k_fetched, r.tombstones, r.slot_count)
            for r in report.segments]


def _assert_same_answer(got, want, tol):
    """Ids equal wherever the reference's distance is not tied, within
    ``tol``, with another of its row's; dists within ``tol`` (an array,
    per entry, or a number)."""
    (gi, gd), (wi, wd) = got, want
    assert gi.shape == wi.shape and gd.shape == wd.shape
    tol = np.broadcast_to(np.asarray(tol, np.float64), wd.shape)
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    assert bool(np.all(np.abs(gd[fin] - wd[fin])
                       <= tol[fin] * (np.abs(wd[fin]) + 1.0)))
    with np.errstate(invalid="ignore"):
        gap = np.abs(wd[:, :, None] - wd[:, None, :])
    tied = ((gap <= tol[:, :, None] * (np.abs(wd[:, :, None]) + 1.0))
            & fin[:, :, None]).sum(axis=2) > 1
    np.testing.assert_array_equal(np.where(tied, -2, gi),
                                  np.where(tied, -2, wi))


def _tolerance(port, ids, route):
    """1e-4 where the id was served by the delta scan or the flat route,
    1e-5 where a graph or pruned segment search served it."""
    in_delta = np.vectorize(lambda e: e >= 0 and e in port.delta,
                            otypes=[bool])(ids)
    return np.where(in_delta | (route == "flat"), 1e-4, 1e-5)


def _both(pair, ds, mask, qlo, qhi, **kw):
    ref, port = pair
    a = ref.search(RefRequest(ds.queries, (qlo, qhi), mask, **kw))
    b = port.search(SearchRequest(ds.queries, (qlo, qhi), mask, **kw))
    return a, b


def test_the_op_sequence_leaves_segments_tombstones_and_a_delta(streamed):
    ref, port = streamed
    for s in (ref, port):
        assert [seg.seg_id for seg in s.segments] == ["seg-000001",
                                                      "seg-000004"]
        assert [len(seg.tombs) for seg in s.segments] == [22, 3]
        assert len(s.delta) == 48 and s.delta.n_dead == 5
    assert port.stats() == ref.stats()
    for a, b in zip(ref.segments, port.segments):
        np.testing.assert_array_equal(a.ext_ids, b.ext_ids)
        assert a.tombs == b.tombs
    for x, y in zip(ref.delta.live(), port.delta.live()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mask", MASKS8, ids=iv.mask_name)
@pytest.mark.parametrize("route", ["graph", "pruned", "flat", "auto"])
def test_route_grid_matches_reference(sds, streamed, mask, route):
    """Every route over the two segments and the delta: the same
    per-segment routes, widths and slots, the same ids and step counts."""
    qlo, qhi = make_queries(sds, mask, 0.15, seed=mask)
    a, b = _both(streamed, sds, mask, qlo, qhi, k=5, ef=48, route=route,
                 fanout=2, chunk=4, trace=True)
    assert b.report.route == a.report.route == "segmented"
    assert _segment_rows(b.report) == _segment_rows(a.report)
    assert b.report.slot_count == a.report.slot_count
    assert bool((a.ids >= 0).any())
    _assert_same_answer(b.astuple(), a.astuple(),
                        _tolerance(streamed[1], a.ids, route))
    assert _steps(b.trace) == _steps(a.trace)
    if any(r.route == "graph" for r in a.report.segments):
        assert _steps(a.trace) > 0


def test_cpu_fanout_launches_no_kernel(sds, streamed):
    _, port = streamed
    qlo, qhi = make_queries(sds, 15, 0.2, seed=3)
    ops.reset_launches()
    for route in ("graph", "pruned", "flat"):
        port.search(SearchRequest(sds.queries, (qlo, qhi), 15, k=5,
                                  route=route))
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_default_device_is_cuda_and_raises_without_it(sds, monkeypatch):
    import torch
    delta = DeltaBuffer()
    delta.add(np.arange(4), sds.vectors[:4], sds.lo[:4], sds.hi[:4])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentedIndex(IndexSpec(**SPEC))
    with pytest.raises(RuntimeError, match="CUDA"):
        delta.search(sds.queries, sds.lo[:8], sds.hi[:8], 15, 3)
    assert SegmentedIndex(IndexSpec(**SPEC), device="cpu").device.type == \
        "cpu"


@pytest.fixture(scope="module")
def compacted(sds):
    return _pair(sds, compact_full=True)


def _live_corpus(port):
    seg = port.segments[0]
    return seg.ext_ids, seg.index.vectors, seg.index.lo, seg.index.hi


def _payload_equal(a, b):
    (aa, am), (ba, bm) = a.to_payload(), b.to_payload()
    assert sorted(aa) == sorted(ba)
    for key in aa:
        np.testing.assert_array_equal(np.asarray(aa[key]),
                                      np.asarray(ba[key]), err_msg=key)
        assert np.asarray(aa[key]).dtype == np.asarray(ba[key]).dtype, key
    for key in ("format", "format_version", "storage_dtype", "spec",
                "params", "variants"):
        assert am[key] == bm[key], key


def test_full_compaction_is_byte_equal_to_static_build(compacted):
    """One clean segment, byte-equal in payload to the reference's
    compacted segment and to a static build over the live rows sorted by
    external id."""
    ref, port = compacted
    assert len(port.segments) == 1 and not port.segments[0].tombs
    assert len(port.delta) == 0
    ext, vecs, lo, hi = _live_corpus(port)
    assert bool(np.all(np.diff(ext) > 0))
    np.testing.assert_array_equal(ext, ref.segments[0].ext_ids)
    _payload_equal(port.segments[0].index, ref.segments[0].index)
    _payload_equal(port.segments[0].index,
                   MSTGIndex.build(IndexSpec(**SPEC), vecs, lo, hi))
    _payload_equal(port.segments[0].index,
                   RefIndex.build(RefSpec(**SPEC), vecs, lo, hi))


@pytest.mark.parametrize("mask", (15, 2, 48), ids=iv.mask_name)
def test_compacted_index_answers_like_the_reference(sds, compacted, mask):
    qlo, qhi = make_queries(sds, mask, 0.15, seed=mask)
    for route in ("graph", "pruned", "flat"):
        a, b = _both(compacted, sds, mask, qlo, qhi, k=5, ef=48, route=route,
                     fanout=2)
        _assert_same_answer(b.astuple(), a.astuple(),
                            1e-4 if route == "flat" else 1e-5)


def _answers(s, ds, request_cls):
    out = []
    for mask, route in ((15, "graph"), (2, "pruned"), (48, "flat")):
        qlo, qhi = make_queries(ds, mask, 0.15, seed=mask)
        out.append(s.search(request_cls(ds.queries, (qlo, qhi), mask, k=5,
                                        ef=48, route=route,
                                        fanout=2)).astuple())
    return out


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_manifests_cross_load(sds, streamed, tmp_path, direction):
    """A save by either package loads in the other, tombstones and the
    unflushed delta included, and answers as the saving index did."""
    ref, port = streamed
    if direction == "port_to_reference":
        port.save(tmp_path)
        loaded = RefSegmented.load(tmp_path,
                                   engine_config=RefConfig(use_kernel=True))
        want = _answers(port, sds, SearchRequest)
        got = _answers(loaded, sds, RefRequest)
    else:
        ref.save(tmp_path)
        loaded = SegmentedIndex.load(tmp_path, device="cpu")
        want = _answers(ref, sds, RefRequest)
        got = _answers(loaded, sds, SearchRequest)
    assert [s.seg_id for s in loaded.segments] == ["seg-000001",
                                                   "seg-000004"]
    assert [len(s.tombs) for s in loaded.segments] == [22, 3]
    assert len(loaded.delta) == 48
    for (gi, gd), (wi, wd) in zip(got, want):
        _assert_same_answer((gi, gd), (wi, wd), 1e-4)


def _delta_pair_search(ref, port, q, qlo, qhi, mask, k):
    a = ref.search(q, qlo, qhi, mask, k, use_kernel=True)
    b = port.search(q, qlo, qhi, mask, k, device="cpu")
    assert b[0].dtype == np.int64 and b[1].dtype == np.float32
    _assert_same_answer(b, a, 1e-4)
    return b


def test_delta_buffer_matches_reference(sds):
    """Upserts, kills, k past the live rows and past the capacity, and a
    capacity jump, on both buffers."""
    ref, port = RefDelta(), DeltaBuffer()
    v, lo, hi = sds.vectors, sds.lo, sds.hi
    q = sds.queries
    qlo, qhi = make_queries(sds, 15, 0.4, seed=7)
    for b in (ref, port):
        b.add(np.arange(40), v[:40], lo[:40], hi[:40])
        b.add(np.arange(5), v[100:105], lo[100:105], hi[100:105])  # upsert
        assert b.kill(7) and b.kill(8) and b.kill(2) and not b.kill(999)
    assert len(port) == len(ref) == 37 and port._cap == 64
    got = _delta_pair_search(ref, port, q, qlo, qhi, 15, 50)    # k > live
    assert got[0].shape == (8, 50)
    assert not np.isin(got[0], [2, 7, 8]).any()
    assert bool(np.all(got[0][:, 37:] == -1))
    for b in (ref, port):                                       # 64 -> 256
        b.add(np.arange(40, 240), v[40:240], lo[40:240], hi[40:240])
    assert port._cap == ref._cap == 256
    _delta_pair_search(ref, port, q, qlo, qhi, 15, 10)
    got = _delta_pair_search(ref, port, q, qlo, qhi, 63, 400)   # k > cap
    assert got[0].shape == (8, 256)
    for x, y in zip(ref.live(), port.live()):
        np.testing.assert_array_equal(x, y)
    assert port.bytes_breakdown() == ref.bytes_breakdown()
    assert port.nbytes == ref.nbytes
    empty = DeltaBuffer().search(q, qlo, qhi, 15, 5, device="cpu")
    assert empty[0].shape == (8, 0)


def test_delta_restages_after_every_change(sds):
    """The staged arena is reused until an add, kill or clear."""
    port = DeltaBuffer()
    v, lo, hi = sds.vectors, sds.lo, sds.hi
    qlo, qhi = make_queries(sds, 15, 0.5, seed=2)
    port.add(np.arange(30), v[:30], lo[:30], hi[:30])
    first = port.search(sds.queries, qlo, qhi, 15, 5, device="cpu")
    staged = port._staged
    port.search(sds.queries, qlo, qhi, 15, 5, device="cpu")
    assert port._staged is staged
    port.kill(int(first[0][0, 0]))
    assert port._staged is None
    after = port.search(sds.queries, qlo, qhi, 15, 5, device="cpu")
    assert first[0][0, 0] not in after[0][0]


def test_graph_overfetch_raises_ef_past_tombstones(sds):
    """The reference's case: more tombstones than the request's ef; the
    segment's beam widens to k + tombstones on both."""
    v, lo, hi = sds.vectors, sds.lo, sds.hi
    q = v[:1]
    d2 = ((v[:24] - q) ** 2).sum(1)
    full = (float(lo[:24].min()), float(hi[:24].max()))
    ref = RefSegmented(RefSpec(**SPEC),
                       engine_config=RefConfig(use_kernel=True))
    port = SegmentedIndex(IndexSpec(**SPEC), device="cpu")
    res = []
    for s, req in ((ref, RefRequest), (port, SearchRequest)):
        s.add(np.arange(24), v[:24], lo[:24], hi[:24])
        s.flush()
        s.delete(np.argsort(d2)[:8])
        res.append(s.search(req(q, [full], 15, k=5, ef=5, route="graph")))
    a, b = res
    assert b.report.segments[0].k_fetched == a.report.segments[0].k_fetched \
        == 13
    live = np.array(sorted(e for e in range(24) if e in port))
    got = b.ids[0][b.ids[0] >= 0]
    assert len(got) == 5 and set(got.tolist()) <= set(live.tolist())
    _assert_same_answer(b.astuple(), a.astuple(), 1e-5)


def test_int8_tier_segments_match_reference(sds):
    """Segments frozen on the int8 tier (spec.storage_dtype) and the exact
    float32 delta, on every route."""
    ref = RefSegmented(RefSpec(**SPEC, storage_dtype="int8"),
                       engine_config=RefConfig(use_kernel=True))
    port = SegmentedIndex(IndexSpec(**SPEC, storage_dtype="int8"),
                          device="cpu")
    v, lo, hi = sds.vectors, sds.lo, sds.hi
    for s in (ref, port):
        s.add(np.arange(200), v[:200], lo[:200], hi[:200])
        s.flush()
        s.delete(np.arange(0, 200, 17))
        s.add(np.arange(200, 260), v[200:260], lo[200:260], hi[200:260])
    assert port.stats() == ref.stats()
    assert port.stats()["storage_bytes"]["codes"] > 0
    qlo, qhi = make_queries(sds, 15, 0.2, seed=4)
    for route in ("graph", "pruned", "flat", "auto"):
        a, b = _both((ref, port), sds, 15, qlo, qhi, k=5, ef=48, route=route,
                     fanout=2)
        assert _segment_rows(b.report) == _segment_rows(a.report)
        _assert_same_answer(b.astuple(), a.astuple(),
                            _tolerance(port, a.ids, "flat"))


def test_stats_and_bookkeeping_follow_the_reference(sds, streamed):
    ref, port = streamed
    assert len(port) == len(ref)
    for e in (0, 170, 335, 379, 10_000):
        assert (e in port) == (e in ref)
    with pytest.raises(KeyError):
        port.delete([10_000])
    assert port.delete([10_000], strict=False) == 0
    with pytest.raises(TypeError):
        port.execute("not a request")
    assert EngineConfig() == port.engine_config
