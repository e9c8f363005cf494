"""The port's serving layer (``repro_torch.serving`` and
``repro_torch.core.WavefrontStream``) against the reference's, on the CPU:
the stream, the scheduler and ops, the sync ``RetrievalServer``, and the
async server over a mutable, a sharded and a quantized backend.

The reference's serving package imports its LM (``repro.models``), which
imports ``jax.experimental.shard_map``; that warns under the installed jax,
and the repository's pytest settings turn the warning into an error. So the
reference is imported inside :func:`_ref`, with ``DeprecationWarning``
ignored there only. No test reads the wall clock: deadlines and waits run
on :class:`FakeClock`. The reference's engines run
``EngineConfig(use_kernel=True)`` (its Pallas kernels in interpret mode);
the port runs its plain versions. Ids must be equal wherever distances are
distinct, distances within 1e-5 (1e-4 on the flat scan).
"""
import functools
import os
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest

from repro_torch.core import (ANY_OVERLAP, EngineConfig, IndexSpec, MSTGIndex,
                              QueryEngine, Rejected, SearchRequest, Served,
                              WavefrontStream, mstg_graph_search)
from repro_torch.data import make_queries
from repro_torch.distributed import DeploymentSpec, ShardedDeployment
from repro_torch.serving import (AsyncRetrievalServer, DeleteOp, QueryOp,
                                 RetrievalServer, Scheduler, ServerMetrics,
                                 SLOPolicy, StreamingHistogram, UpsertOp)
from repro_torch.streaming import SegmentedIndex

# jax caches its lookups of deprecated names: only the first access of
# ``jax.experimental.shard_map.shard_map`` in a process warns. Whether a
# reference import inside a test then raises under the repository's
# warnings-as-errors setting would depend on which test file happened to
# run first in the same worker; taking the first access here, while the
# test files are collected, with the warning ignored, makes every
# in-test reference import behave the same in every worker.
with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from jax.experimental.shard_map import shard_map  # noqa: F401

MASKS8 = (1, 2, 4, 8, 15, 16, 32, 48)
SPEC = dict(variants=("T", "Tp", "Tpp"), m=8, ef_con=40)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


class FakeClock:
    """Deterministic injectable clock (seconds)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


@functools.lru_cache(maxsize=1)
def _ref():
    """The reference's serving, core, streaming and distributed names."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro.core as core
        import repro.serving as serving
        from repro.core.search import WavefrontStream as RefStream
        from repro.distributed import DeploymentSpec as RefDeploySpec
        from repro.distributed import ShardedDeployment as RefSharded
        from repro.streaming import SegmentedIndex as RefSegmented
    return types.SimpleNamespace(
        core=core, serving=serving, Stream=RefStream,
        Segmented=RefSegmented, Sharded=RefSharded,
        DeploySpec=RefDeploySpec)


def _port_ns():
    return types.SimpleNamespace(
        SLOPolicy=SLOPolicy, Scheduler=Scheduler, QueryOp=QueryOp,
        UpsertOp=UpsertOp, DeleteOp=DeleteOp, ServerMetrics=ServerMetrics,
        StreamingHistogram=StreamingHistogram, Rejected=Rejected)


def _ref_ns():
    s = _ref().serving
    return types.SimpleNamespace(
        SLOPolicy=s.SLOPolicy, Scheduler=s.Scheduler, QueryOp=s.QueryOp,
        UpsertOp=s.UpsertOp, DeleteOp=s.DeleteOp,
        ServerMetrics=s.ServerMetrics,
        StreamingHistogram=s.StreamingHistogram, Rejected=_ref().core.Rejected)


@pytest.fixture(scope="module")
def engines(small_ds, built_index):
    """(reference engine, port engine) over the same index."""
    ds = small_ds
    port_index = MSTGIndex(ds.vectors, ds.lo, ds.hi, **SPEC)
    ref_eng = _ref().core.QueryEngine(
        built_index, config=_ref().core.EngineConfig(use_kernel=True))
    return ref_eng, QueryEngine(port_index, device="cpu")


def _assert_same_answer(got_ids, got_d, want_ids, want_d, tol=1e-5):
    """Ids equal wherever the wanted distance is distinct (within ``tol``)
    from every other of its row's; dists within ``tol``; +inf equal."""
    gi, gd = np.atleast_2d(got_ids), np.atleast_2d(got_d)
    wi, wd = np.atleast_2d(want_ids), np.atleast_2d(want_d)
    assert gi.shape == wi.shape
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=tol, atol=tol)
    with np.errstate(invalid="ignore"):
        gap = np.abs(wd[:, :, None] - wd[:, None, :])
    eye = np.eye(wd.shape[1], dtype=bool)[None]
    tied = np.any((gap <= tol * (np.abs(wd[:, :, None]) + 1.0)) & ~eye,
                  axis=2)
    distinct = fin & ~tied
    np.testing.assert_array_equal(gi[distinct], wi[distinct])


# ---- WavefrontStream --------------------------------------------------------

def _stream_rows(eng, ds, mask):
    """(variant, rows, version, key_lo, key_hi) of each plan slot's
    non-empty tasks for ``mask``."""
    qlo, qhi = make_queries(ds, mask, 0.2, seed=11)
    out = []
    for s in eng.plan(mask, qlo, qhi):
        rows = np.flatnonzero((s.version >= 0) & (s.key_lo <= s.key_hi))
        if rows.size:
            out.append((s.variant, rows, s.version[rows], s.key_lo[rows],
                        s.key_hi[rows]))
    return out


def _drive(stream, ds, rows, ver, klo, khi, budget):
    """Admit half the rows, run one chunk, admit the rest mid-flight, and
    drain; returns the harvests of each step."""
    half = max(1, rows.size // 2)
    steps = []
    for part in (slice(0, half), slice(half, None)):
        if rows[part].size:
            stream.admit(rows[part], ds.queries[rows[part]], ver[part],
                         klo[part], khi[part], budget)
        steps.append(stream.step())
    while not stream.idle:
        steps.append(stream.step())
    return steps


COUNTERS = ("executed_row_steps", "useful_row_steps", "occupancy_rows",
            "occupancy_capacity", "refills", "refilled_rows", "chunks",
            "admitted", "completed")


@pytest.mark.parametrize("budget", [40, 3])
@pytest.mark.parametrize("mask", MASKS8)
def test_stream_matches_solo_and_reference(small_ds, engines, mask, budget):
    """Rows admitted in two waves (the second into a running batch) come
    out bit-identical to the port's solo ``mstg_graph_search`` (ids, dists
    and step count, also when truncated at ``budget``), in the reference
    stream's harvest order, with its counters and its answers."""
    ds = small_ds
    ref_eng, eng = engines
    kw = dict(ef=24, fanout=2, chunk=2, min_bucket=4, max_bucket=8)
    for variant, rows, ver, klo, khi in _stream_rows(eng, ds, mask):
        Kpad = eng.index.variants[variant].Kpad
        arrays = eng.graph_dev(variant)
        port = WavefrontStream(arrays, Kpad=Kpad, **kw)
        dv = ref_eng.graph_dev(variant)
        ref = _ref().Stream(dv.tree(), Kpad=dv.meta.Kpad, use_kernel=True,
                            **kw)
        got = _drive(port, ds, rows, ver, klo, khi, budget)
        want = _drive(ref, ds, rows, ver, klo, khi, budget)
        assert [[h[0] for h in s] for s in got] == \
            [[h[0] for h in s] for s in want]
        for name in COUNTERS:
            assert getattr(port, name) == getattr(ref, name), name
        assert port.refills > 0 and port.idle
        pos = {int(r): j for j, r in enumerate(rows)}
        for (tag, ids, d, steps), (_, rids, rd, rsteps) in zip(
                sum(got, []), sum(want, [])):
            j = pos[tag]
            sid, sd, ssteps = mstg_graph_search(
                arrays, ds.queries[tag:tag + 1], ver[j:j + 1],
                klo[j:j + 1], khi[j:j + 1], k=24, ef=24, max_steps=budget,
                Kpad=Kpad, fanout=2, with_steps=True)
            np.testing.assert_array_equal(ids, sid[0].numpy())
            np.testing.assert_array_equal(d, sd[0].numpy())
            assert steps == ssteps == rsteps
            _assert_same_answer(ids, d, rids, rd)


def test_stream_validates_its_inputs(engines):
    _, eng = engines
    arrays, Kpad = eng.graph_dev("T"), eng.index.variants["T"].Kpad
    with pytest.raises(ValueError, match="power of two"):
        WavefrontStream(arrays, ef=8, Kpad=Kpad, max_bucket=12)
    s = WavefrontStream(arrays, ef=8, Kpad=Kpad)
    q = np.zeros((1, eng.index.vectors.shape[1]), np.float32)
    with pytest.raises(ValueError, match="tags"):
        s.admit([-1], q, [0], [0], [0], 5)
    with pytest.raises(ValueError, match="max_steps"):
        s.admit([0], q, [0], [0], [0], 0)
    assert s.idle and s.step() == [] and s.refill_efficiency == 1.0


# ---- scheduler and ops, case by case against the reference ----------------

def _q(m, i=0, deadline_ms=None, priority=0):
    return m.QueryOp(i, 0.0, 1.0, ANY_OVERLAP, deadline_ms=deadline_ms,
                     priority=priority)


def _bounded_queue(m, clk):
    sch = m.Scheduler(m.SLOPolicy(max_queue=2, max_wait_ms=0.0), clock=clk)
    out = [sch.offer(_q(m, 0)), sch.offer(_q(m, 1))]
    rej = sch.offer(_q(m, 2))
    return out + [(type(rej).__name__, rej.reason, bool(rej),
                   rej.queue_depth)]


def _due_triggers(m, clk):
    sch = m.Scheduler(m.SLOPolicy(max_wait_ms=5.0, max_batch=3), clock=clk)
    out = [sch.due()]
    sch.offer(_q(m, 0))
    out.append(sch.due())
    clk.advance(0.006)
    out += [sch.due(), round(sch.oldest_wait_ms(), 9)]
    full = m.Scheduler(m.SLOPolicy(max_wait_ms=1e9, max_batch=3), clock=clk)
    for i in range(3):
        full.offer(_q(m, i))
    mut = m.Scheduler(m.SLOPolicy(max_wait_ms=1e9), clock=clk)
    mut.offer(m.DeleteOp(7))
    return out + [full.due(), mut.due()]


def _edf_order(m, clk):
    sch = m.Scheduler(m.SLOPolicy(max_wait_ms=0.0), clock=clk)
    t = [sch.offer(_q(m, 0)), sch.offer(_q(m, 1, deadline_ms=500.0)),
         sch.offer(_q(m, 2, deadline_ms=100.0)), sch.offer(_q(m, 3,
                                                              priority=5))]
    rnd = sch.next_round()
    return [t, [e.ticket for e in rnd.queries], bool(rnd.mutations),
            bool(rnd.shed), sch.depth]


def _fifo(m, clk):
    sch = m.Scheduler(m.SLOPolicy(max_wait_ms=0.0, edf=False), clock=clk)
    t = [sch.offer(_q(m, i, deadline_ms=1e3 - i)) for i in range(4)]
    return [t, [e.ticket for e in sch.next_round().queries]]


def _expired(m, clk):
    sch = m.Scheduler(m.SLOPolicy(max_wait_ms=0.0), clock=clk)
    sch.offer(_q(m, 0, deadline_ms=10.0))
    sch.offer(_q(m, 1, deadline_ms=1e4))
    clk.advance(0.05)
    rnd = sch.next_round()
    out = [[e.ticket for e in rnd.queries],
           [(e.ticket, r.reason, r.op) for e, r in rnd.shed]]
    keep = m.Scheduler(m.SLOPolicy(max_wait_ms=0.0, shed_expired=False),
                       clock=clk)
    keep.offer(_q(m, 0, deadline_ms=10.0))
    clk.advance(0.05)
    rnd = keep.next_round()
    return out + [len(rnd.queries), len(rnd.shed)]


def _barrier(m, clk):
    sch = m.Scheduler(m.SLOPolicy(max_wait_ms=0.0), clock=clk)
    sch.offer(_q(m, 0))
    sch.offer(m.UpsertOp(9, 9, 0.0, 1.0))
    sch.offer(_q(m, 1, deadline_ms=1.0))
    sch.offer(m.DeleteOp(3))
    out = []
    while sch.depth:
        rnd = sch.next_round()
        out.append(([type(e.op).__name__ for e in rnd.mutations],
                    [e.ticket for e in rnd.queries]))
    return out


def _capacity_close(m, clk):
    sch = m.Scheduler(m.SLOPolicy(max_wait_ms=0.0, max_batch=64), clock=clk)
    for i in range(6):
        sch.offer(_q(m, i))
    rnd = sch.next_round(capacity=2)
    out = [[e.ticket for e in rnd.queries], sch.depth]
    shed = sch.close()
    late = sch.offer(_q(m, 99))
    return out + [[(e.ticket, r.reason, r.queue_depth) for e, r in shed],
                  late.reason, sch.depth]


def _histogram(m, clk):
    h = m.StreamingHistogram()
    for v in (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0):
        h.record(v)
    return [h.count, h.max_ms, h.mean] + [h.percentile(p)
                                          for p in (50, 95, 99, 100)] + \
        [m.StreamingHistogram().percentile(99)]


def _metrics(m, clk):
    met = m.ServerMetrics()
    met.record_admitted()
    met.record_admitted()
    met.record_shed("queue_full")
    met.record_shed("deadline_expired")
    met.record_served(1.5, 4.0, degraded=True)
    met.record_served(0.5, 2.0, deadline_missed=True, mutation=True)
    stream = types.SimpleNamespace(
        occupancy_rows=30, occupancy_capacity=40, executed_row_steps=90,
        useful_row_steps=60, refills=2, refilled_rows=7, chunks=5)
    return [met.snapshot(), met.snapshot([stream])]


def _validation(m, clk):
    out = []
    for make in (lambda: _q(m, deadline_ms=0.0),
                 lambda: m.SLOPolicy(max_queue=0),
                 lambda: m.SLOPolicy(max_batch=0),
                 lambda: m.SLOPolicy(max_wait_ms=-1.0)):
        try:
            make()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


SCENARIOS = {
    "bounded_queue": (_bounded_queue,
                      [0, 1, ("Rejected", "queue_full", False, 2)]),
    "due_triggers": (_due_triggers, [False, False, True, 6.0, True, True]),
    "edf_order": (_edf_order, [[0, 1, 2, 3], [2, 1, 3, 0], False, False, 0]),
    "fifo": (_fifo, [[0, 1, 2, 3], [0, 1, 2, 3]]),
    "expired": (_expired, [[1], [(0, "deadline_expired", "query")], 1, 0]),
    "barrier": (_barrier, [([], [0]), (["UpsertOp"], [2]),
                           (["DeleteOp"], [])]),
    "capacity_close": (_capacity_close,
                       [[0, 1], 4, [(2, "shutdown", 4), (3, "shutdown", 4),
                                    (4, "shutdown", 4), (5, "shutdown", 4)],
                        "shutdown", 0]),
    "histogram": (_histogram, None),
    "metrics": (_metrics, None),
    "validation": (_validation, None),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_and_ops_match_reference(name):
    """Each case runs on the port's and the reference's scheduler, ops and
    metrics under a fake clock; the observations must be equal, and equal
    to the spelled-out expectation where there is one."""
    fn, expected = SCENARIOS[name]
    got = fn(_port_ns(), FakeClock())
    assert got == fn(_ref_ns(), FakeClock())
    if expected is not None:
        assert got == expected
    if name == "histogram":
        vals = [0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0]
        for p, est in zip((50, 95, 99), got[3:6]):
            true = float(np.percentile(vals, p, method="inverted_cdf"))
            assert true <= est <= true * 1.12
    if name == "metrics":
        snap, with_stream = got
        assert snap["shed_total"] == 2 and snap["submitted"] == 3
        assert with_stream["batch_occupancy"] == 0.75
        assert with_stream["refill_efficiency"] == 60 / 90
    if name == "validation":
        assert None not in got


# ---- the sync RetrievalServer ------------------------------------------------

def _embedder(ds, probe=None):
    def embed(items):
        return np.stack([probe if isinstance(it, str) else ds.queries[it]
                         for it in items])
    return embed


@pytest.mark.parametrize("route", ["graph", "pruned", "flat"])
def test_retrieval_server_tick_matches_reference_and_execute(
        small_ds, engines, route):
    """Two masks interleaved in one tick: one batched embed call, each mask
    group's answers equal the port's ``execute`` on the group bit for bit,
    and the reference server's tick."""
    ds = small_ds
    ref_eng, eng = engines
    masks = (ANY_OVERLAP, 2)
    ranges = {m: make_queries(ds, m, 0.2, seed=4) for m in masks}
    calls = []

    def embed(items):
        calls.append(list(items))
        return ds.queries[np.asarray(items)]

    port_eng = QueryEngine(eng.index, EngineConfig(route=route),
                           device="cpu")
    rcore = _ref().core
    ref_srv = _ref().serving.RetrievalServer(
        rcore.QueryEngine(ref_eng.index, config=rcore.EngineConfig(
            use_kernel=True, route=route)), embed_fn=embed, k=8, ef=24)
    srv = RetrievalServer(port_eng, embed_fn=embed, k=8, ef=24)
    for s in (srv, ref_srv):
        for i in range(10):
            m = masks[i % 2]
            s.submit(i, ranges[m][0][i], ranges[m][1][i], m)
    got, want = srv.tick(), ref_srv.tick()
    assert calls[0] == list(range(10)) and len(calls) == 2
    assert sorted(got) == sorted(want) == list(range(10))
    tol = 1e-4 if route == "flat" else 1e-5
    for m in masks:
        idx = [i for i in range(10) if masks[i % 2] == m]
        res = port_eng.execute(SearchRequest(
            ds.queries[idx], (ranges[m][0][idx], ranges[m][1][idx]), m, k=8,
            ef=24))
        for j, i in enumerate(idx):
            np.testing.assert_array_equal(got[i].ids, res.ids[j])
            np.testing.assert_array_equal(got[i].dists, res.dists[j])
            _assert_same_answer(got[i].ids, got[i].dists, want[i].ids,
                                want[i].dists, tol)
    assert srv.tick_stats["queries"] == 10 and srv.tick_stats["ticks"] == 1
    assert set(srv.snapshot()) == set(ref_srv.snapshot())
    assert srv.tick() == {} and srv.tick_stats["queries"] == 0


def test_retrieval_server_embed_probe_and_frozen_backend(small_ds, engines):
    """A per-item embedder is detected on the first tick and looped over
    (the reference's probe); a frozen backend refuses mutations."""
    ds = small_ds
    _, eng = engines

    def embed_one(i):
        if isinstance(i, list):
            raise TypeError("not batched")
        return ds.queries[i]

    srv = RetrievalServer(eng, embed_fn=embed_one, k=5)
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.2, seed=4)
    for i in range(4):
        srv.submit(i, qlo[i], qhi[i], "any_overlap")
    res = srv.tick()
    assert srv._embed.batched is False and len(res) == 4
    want = eng.execute(SearchRequest(ds.queries[:4], (qlo[:4], qhi[:4]),
                                     ANY_OVERLAP, k=5))
    np.testing.assert_array_equal(np.stack([res[i].ids for i in range(4)]),
                                  want.ids)
    assert not srv.mutable
    with pytest.raises(TypeError, match="frozen"):
        srv.submit_upsert(1, 0, 0.0, 1.0)
    with pytest.raises(TypeError, match="frozen"):
        srv.submit_delete(1)


def _segmented_pair(ds, n=300):
    ref = _ref().Segmented(_ref().core.IndexSpec(variants=("T", "Tp"), m=8,
                                                 ef_con=40))
    port = SegmentedIndex(IndexSpec(variants=("T", "Tp"), m=8, ef_con=40),
                          device="cpu")
    for s in (ref, port):
        s.add(np.arange(n), ds.vectors[:n], ds.lo[:n], ds.hi[:n])
        s.flush()
    return ref, port


def test_retrieval_server_mutations_over_segmented(small_ds):
    """Upserts and deletes queued with queries over a ``SegmentedIndex``: a
    tick applies them first, so no deleted id comes back, the upserted
    probe is its own nearest neighbour, and the answers equal ``execute``
    after the tick and the reference server's."""
    ds = small_ds
    ref_idx, port_idx = _segmented_pair(ds)
    probe = ds.vectors[5] + 1e-4
    lo, hi = float(ds.lo.min()), float(ds.hi.max())
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.3, seed=7)
    dead = np.arange(0, 40, 3)
    out = []
    for srv in (RetrievalServer(port_idx, _embedder(ds, probe), k=6, ef=32),
                _ref().serving.RetrievalServer(ref_idx, _embedder(ds, probe),
                                               k=6, ef=32)):
        assert srv.mutable
        for i in range(6):
            srv.submit(i, qlo[i], qhi[i], ANY_OVERLAP)
        srv.submit_upsert(7777, "probe", lo, hi)
        for e in dead:
            srv.submit_delete(int(e))
        srv.submit("probe", lo, hi, ANY_OVERLAP)
        out.append((srv.tick(), dict(srv.tick_stats)))
    (got, stats), (want, rstats) = out
    for key in ("queries", "upserts", "deletes", "compactions"):
        assert stats[key] == rstats[key]
    assert stats["upserts"] == 1 and stats["deletes"] == dead.size
    slots = sorted(got)
    assert slots == sorted(want) and len(slots) == 7
    assert got[slots[-1]].ids[0] == 7777
    after = port_idx.execute(SearchRequest(ds.queries[:6], (qlo[:6], qhi[:6]),
                                           ANY_OVERLAP, k=6, ef=32))
    for j, i in enumerate(slots[:6]):
        assert not np.isin(got[i].ids, dead).any()
        np.testing.assert_array_equal(got[i].ids, after.ids[j])
        np.testing.assert_array_equal(got[i].dists, after.dists[j])
        _assert_same_answer(got[i].ids, got[i].dists, want[i].ids,
                            want[i].dists, 1e-4)


# ---- the async server over a mutable, a sharded and a quantized backend ----

def test_async_segmented_mutations_are_barriers(small_ds):
    """A query submitted before an upsert does not see it, one submitted
    after it does (its own nearest neighbour), and a delete after both
    affects neither; as the reference's server does."""
    ds = small_ds
    ref_idx, port_idx = _segmented_pair(ds)
    probe = ds.vectors[5] + 1e-4
    lo, hi = float(ds.lo.min()), float(ds.hi.max())
    outs = []
    for srv in (AsyncRetrievalServer(port_idx, _embedder(ds, probe), k=5,
                                     ef=32, policy=SLOPolicy(max_wait_ms=0.0),
                                     clock=FakeClock()),
                _ref().serving.AsyncRetrievalServer(
                    ref_idx, _embedder(ds, probe), k=5, ef=32,
                    policy=_ref().serving.SLOPolicy(max_wait_ms=0.0),
                    clock=FakeClock())):
        assert srv.mutable
        t = [srv.submit(0, lo, hi, ANY_OVERLAP),
             srv.submit_upsert(7777, "probe", lo, hi),
             srv.submit("probe", lo, hi, ANY_OVERLAP),
             srv.submit_delete(7777)]
        res = srv.run_until_idle()
        outs.append((t, res, srv.snapshot()))
    (t, res, snap), (rt, rres, rsnap) = outs
    assert t == rt and all(isinstance(res[x], Served) for x in t)
    assert res[t[1]].hit is None and res[t[3]].hit is None
    assert 7777 not in res[t[0]].hit.ids and res[t[2]].hit.ids[0] == 7777
    for x in (t[0], t[2]):
        _assert_same_answer(res[x].hit.ids, res[x].hit.dists,
                            rres[x].hit.ids, rres[x].hit.dists, 1e-4)
    assert snap["mutations"] == rsnap["mutations"] == 2


def test_async_shard_loss_degrades_without_stalling(small_ds):
    """A shard lost between waves: the later wave's responses are degraded,
    the earlier and the healed ones are not, nothing is shed, and every
    answer and flag equals the reference server's."""
    ds = small_ds
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.3, seed=6)
    port = ShardedDeployment.flat(ds.vectors, ds.lo, ds.hi, device="cpu",
                                  spec=DeploymentSpec(n_shards=4))
    ref = _ref().Sharded.flat(ds.vectors, ds.lo, ds.hi,
                              spec=_ref().DeploySpec(n_shards=4))
    outs = []
    for dep, srv in (
            (port, AsyncRetrievalServer(
                port, _embedder(ds), k=8, ef=32, clock=FakeClock(),
                policy=SLOPolicy(max_wait_ms=0.0, max_batch=4))),
            (ref, _ref().serving.AsyncRetrievalServer(
                ref, _embedder(ds), k=8, ef=32, clock=FakeClock(),
                policy=_ref().serving.SLOPolicy(max_wait_ms=0.0,
                                                max_batch=4)))):
        waves = []
        for w, act in ((range(0, 4), None), (range(4, 8), dep.fail),
                       (range(8, 12), dep.restore)):
            if act is not None:
                act(2)
            ts = [srv.submit(i, qlo[i], qhi[i], ANY_OVERLAP) for i in w]
            res = srv.run_until_idle()
            waves.append([res[x] for x in ts])
        outs.append((waves, srv.snapshot()))
    (waves, snap), (rwaves, rsnap) = outs
    for w, (got, want) in enumerate(zip(waves, rwaves)):
        for g, r in zip(got, want):
            assert isinstance(g, Served) and g.degraded == (w == 1)
            assert g.degraded == r.degraded and g.hit.ids.shape == (8,)
            _assert_same_answer(g.hit.ids, g.hit.dists, r.hit.ids,
                                r.hit.dists, 1e-4)
    assert snap["served"] == rsnap["served"] == 12
    assert snap["degraded"] == rsnap["degraded"] == 4
    assert snap["shed_total"] == 0


def test_async_quantized_engine_serves_the_unreranked_beam(small_ds,
                                                           built_index):
    """The continuous path on an int8 engine serves the beam's dequantized
    distances without the exact re-rank, as the reference's does: equal to
    the reference server's, and not to solo ``execute``'s exact ones."""
    ds = small_ds
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.2, seed=3)
    port_eng = QueryEngine(MSTGIndex(ds.vectors, ds.lo, ds.hi, **SPEC),
                           EngineConfig(storage_dtype="int8"), device="cpu")
    rcore = _ref().core
    ref_eng = rcore.QueryEngine(built_index, config=rcore.EngineConfig(
        use_kernel=True, storage_dtype="int8"))
    outs = []
    for eng, cls, pol in (
            (port_eng, AsyncRetrievalServer, SLOPolicy),
            (ref_eng, _ref().serving.AsyncRetrievalServer,
             _ref().serving.SLOPolicy)):
        srv = cls(eng, _embedder(ds), k=5, ef=24, route="graph", chunk=2,
                  clock=FakeClock(), policy=pol(max_wait_ms=0.0, max_batch=4))
        ts = [srv.submit(i, qlo[i], qhi[i], ANY_OVERLAP) for i in range(8)]
        res = srv.run_until_idle()
        outs.append([res[t].hit for t in ts])
    exact = port_eng.execute(SearchRequest(ds.queries[:8], (qlo[:8], qhi[:8]),
                                           ANY_OVERLAP, k=5, ef=24,
                                           route="graph"))
    got = np.stack([h.dists for h in outs[0]])
    _assert_same_answer(np.stack([h.ids for h in outs[0]]), got,
                        np.stack([h.ids for h in outs[1]]),
                        np.stack([h.dists for h in outs[1]]))
    fin = np.isfinite(got)
    assert not np.array_equal(got[fin], exact.dists[fin])


def test_serving_imports_neither_jax_nor_repro_nor_a_model():
    code = ("import sys, repro_torch.serving\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
            "or '.models' in m)\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
