"""The port's ``AsyncRetrievalServer`` on a ``QueryEngine``, on the CPU:
every hit served through staggered admission, mid-flight slot refill
(graph) or micro-batches (pruned, flat) equals solo ``execute`` bit for bit
(ids and dists), and equals the reference server's answer (ids wherever
distances are distinct, dists within 1e-5, 1e-4 on the flat scan) with the
same refill counters. Deadlines, shedding and metrics run on a fake clock.

The reference's serving package is imported inside :func:`_ref` with
``DeprecationWarning`` ignored (its LM imports ``jax.experimental.shard_map``,
whose warning the repository's pytest settings make an error). The
``@given`` test builds its context through a module-level cache, since it
cannot take fixtures under the offline hypothesis shim.
"""
import functools
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as hst

from repro_torch.core import (ANY_OVERLAP, MSTGIndex, QueryEngine, Rejected,
                              SearchRequest, Served)
from repro_torch.data import make_queries, make_range_dataset
from repro_torch.serving import AsyncRetrievalServer, SLOPolicy

MASKS8 = (1, 2, 4, 8, 15, 16, 32, 48)
ROUTES = ("graph", "pruned", "flat")
SPEC = dict(variants=("T", "Tp", "Tpp"), m=8, ef_con=32)
COUNTERS = ("refills", "refilled_rows", "chunks", "batch_occupancy",
            "refill_efficiency", "served", "submitted", "shed_total")


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
    """The reference's core and serving packages."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro.core as core
        import repro.serving as serving
    return core, serving


@functools.lru_cache(maxsize=1)
def _grid_ctx():
    """A tiny corpus with the port's engine and the reference's over the
    same index (the reference's own grid sizes)."""
    core, _ = _ref()
    ds = make_range_dataset(n=240, d=12, n_queries=12, quantize=32, seed=2)
    port = QueryEngine(MSTGIndex(ds.vectors, ds.lo, ds.hi, **SPEC),
                       device="cpu")
    ref = core.QueryEngine(core.MSTGIndex(ds.vectors, ds.lo, ds.hi, **SPEC),
                           config=core.EngineConfig(use_kernel=True))
    return ds, port, ref


def _solo(eng, ds, mask, route, qlo, qhi, k, ef):
    """Each query executed alone: what the server must return."""
    return [eng.execute(SearchRequest(ds.queries[i:i + 1],
                                      (qlo[i:i + 1], qhi[i:i + 1]), mask,
                                      k=k, ef=ef, route=route))
            for i in range(len(qlo))]


def _serve_in_waves(cls, policy, eng, ds, mask, route, qlo, qhi, k, ef,
                    wave_sizes, steps_between=2):
    """Submit queries in waves with server steps in between, so later waves
    are admitted into slots freed mid-flight, then drain. Returns the
    server and its outcome per query."""
    srv = cls(eng, lambda items: ds.queries[np.asarray(items)], k=k, ef=ef,
              route=route, max_inflight=16, chunk=3, clock=FakeClock(),
              policy=policy(max_wait_ms=0.0, max_batch=4))
    tickets = {}
    i = 0
    for w in wave_sizes:
        for _ in range(min(w, len(qlo) - i)):
            tickets[srv.submit(i, qlo[i], qhi[i], mask)] = i
            i += 1
        for _ in range(steps_between):
            srv.step()
    while i < len(qlo):
        tickets[srv.submit(i, qlo[i], qhi[i], mask)] = i
        i += 1
    res = srv.run_until_idle()
    assert set(res) == set(tickets)
    out = {}
    for t, o in res.items():
        assert type(o).__name__ == "Served" and o
        out[tickets[t]] = o
    return srv, out


def _both_servers(mask, route, qlo, qhi, k, ef, **kw):
    ds, port, ref = _grid_ctx()
    got = _serve_in_waves(AsyncRetrievalServer, SLOPolicy, port, ds, mask,
                          route, qlo, qhi, k, ef, **kw)
    want = _serve_in_waves(_ref()[1].AsyncRetrievalServer,
                           _ref()[1].SLOPolicy, ref, ds, mask, route, qlo,
                           qhi, k, ef, **kw)
    return got, want


def _assert_parity(got, want, solo, tol):
    """Bit-equal to solo execute; ids equal to the reference server's
    wherever its distances are distinct, dists within ``tol``."""
    for i, s in enumerate(solo):
        np.testing.assert_array_equal(got[i].hit.ids, s.ids[0])
        np.testing.assert_array_equal(got[i].hit.dists, s.dists[0])
        wd, wi = want[i].hit.dists, want[i].hit.ids
        fin = np.isfinite(wd)
        np.testing.assert_array_equal(np.isfinite(got[i].hit.dists), fin)
        np.testing.assert_allclose(got[i].hit.dists[fin], wd[fin], rtol=tol,
                                   atol=tol)
        gap = np.abs(wd[:, None] - wd[None, :]) + np.diag(np.full(len(wd),
                                                                  np.inf))
        with np.errstate(invalid="ignore"):
            distinct = fin & ~np.any(gap <= tol * (np.abs(wd)[:, None] + 1),
                                     axis=1)
        np.testing.assert_array_equal(got[i].hit.ids[distinct],
                                      wi[distinct])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("mask", MASKS8)
def test_async_grid_bit_identical_to_solo(mask, route):
    """8 masks x 3 routes: staggered admission with slot refill (graph) or
    micro-batching (pruned, flat) returns solo execution's results bit for
    bit, the reference server's answers, and on the graph route its refill
    counters."""
    ds, port, _ = _grid_ctx()
    qlo, qhi = make_queries(ds, mask, 0.2, seed=11)
    k, ef = 8, 24
    solo = _solo(port, ds, mask, route, qlo, qhi, k, ef)
    (srv, got), (rsrv, want) = _both_servers(mask, route, qlo, qhi, k, ef,
                                             wave_sizes=(5, 4, 3))
    _assert_parity(got, want, solo, 1e-4 if route == "flat" else 1e-5)
    snap, rsnap = srv.snapshot(), rsrv.snapshot()
    for key in COUNTERS:
        assert snap.get(key) == rsnap.get(key), key


@settings(max_examples=6, deadline=None)
@given(hst.integers(0, 2**30), hst.sampled_from([1, 2, 3, 5]),
       hst.sampled_from([1, 2, 4]))
def test_async_refill_property_random_waves(seed, wave, steps_between):
    """Random wave shapes and step interleavings on the wavefront path stay
    bit-identical to solo execution and equal to the reference server:
    refill changes when a row runs, never what it computes."""
    ds, port, _ = _grid_ctx()
    rng = np.random.default_rng(seed)
    mask = MASKS8[int(rng.integers(0, len(MASKS8)))]
    qlo, qhi = make_queries(ds, mask, 0.25, seed=seed % 89)
    k, ef = 6, 16
    solo = _solo(port, ds, mask, "graph", qlo, qhi, k, ef)
    (srv, got), (rsrv, want) = _both_servers(
        mask, "graph", qlo, qhi, k, ef, wave_sizes=[wave] * 6,
        steps_between=steps_between)
    _assert_parity(got, want, solo, 1e-5)
    assert srv.snapshot()["refills"] == rsrv.snapshot()["refills"]


def test_refill_happens_and_is_observable():
    """The staggered schedule really refills mid-flight, and the snapshot's
    occupancy and refill efficiency say so."""
    ds, _, _ = _grid_ctx()
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.2, seed=11)
    (srv, _), (rsrv, _) = _both_servers(ANY_OVERLAP, "graph", qlo, qhi, 8,
                                        24, wave_sizes=(4, 4, 4),
                                        steps_between=3)
    snap = srv.snapshot()
    assert snap["refills"] > 0 and snap["refilled_rows"] > 0
    assert 0.0 < snap["batch_occupancy"] <= 1.0
    assert 0.0 < snap["refill_efficiency"] <= 1.0
    assert snap["served"] == len(qlo) and snap["shed_total"] == 0
    assert set(snap) == set(rsrv.snapshot())


def _server(eng, ds, clk, **kw):
    return AsyncRetrievalServer(eng, lambda items: ds.queries[np.asarray(
        items)], k=5, ef=16, clock=clk, **kw)


def test_async_deadline_shed_and_missed_flag():
    """An op whose deadline passes in the queue is shed; one dispatched in
    time that finishes late is served and flagged."""
    ds, eng, _ = _grid_ctx()
    clk = FakeClock()
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.2, seed=3)
    srv = _server(eng, ds, clk, policy=SLOPolicy(max_wait_ms=0.0))
    t_dead = srv.submit(0, qlo[0], qhi[0], ANY_OVERLAP, deadline_ms=5.0)
    t_slow = srv.submit(1, qlo[1], qhi[1], ANY_OVERLAP, deadline_ms=1e7)
    clk.advance(0.05)
    res = srv.run_until_idle()
    assert isinstance(res[t_dead], Rejected)
    assert res[t_dead].reason == "deadline_expired"
    assert isinstance(res[t_slow], Served) and not res[t_slow].deadline_missed
    slow = _server(eng, ds, clk, chunk=1, route="graph",
                   policy=SLOPolicy(max_wait_ms=0.0))
    t_late = slow.submit(2, qlo[2], qhi[2], ANY_OVERLAP, deadline_ms=5.0)
    slow.step()                              # dispatched before expiry
    assert slow.inflight == 1
    clk.advance(1.0)
    res = slow.run_until_idle()
    assert isinstance(res[t_late], Served) and res[t_late].deadline_missed
    assert res[t_late].e2e_ms == 1000.0 and res[t_late].queue_ms == 0.0
    assert slow.snapshot()["deadline_missed"] == 1
    snap = srv.snapshot()
    assert snap["shed"]["deadline_expired"] == 1
    assert snap["deadline_missed"] == 0 and snap["served"] == 1


def test_async_max_wait_holds_a_young_query():
    """While a stream has rows in flight, a lone young query waits on the
    clock until ``max_wait_ms`` makes it due; an idle server dispatches at
    once."""
    ds, eng, _ = _grid_ctx()
    clk = FakeClock()
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.2, seed=3)
    srv = _server(eng, ds, clk, route="graph", chunk=1,
                  policy=SLOPolicy(max_wait_ms=5.0, max_batch=4))
    srv.submit(0, qlo[0], qhi[0], ANY_OVERLAP)
    srv.step()                       # idle server: dispatched at once
    assert srv.scheduler.depth == 0 and srv.inflight == 1
    srv.submit(1, qlo[1], qhi[1], ANY_OVERLAP)
    srv.step()                       # a row in flight: the young one waits
    assert srv.scheduler.depth == 1
    clk.advance(0.006)
    srv.step()
    assert srv.scheduler.depth == 0
    srv.run_until_idle()
    assert srv.snapshot()["queue_wait_ms"]["max"] >= 6.0


def test_async_close_sheds_queue_but_drains_inflight():
    ds, eng, _ = _grid_ctx()
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.2, seed=3)
    srv = _server(eng, ds, FakeClock(), route="graph",
                  policy=SLOPolicy(max_wait_ms=0.0, max_batch=2))
    tickets = [srv.submit(i, qlo[i], qhi[i], ANY_OVERLAP) for i in range(6)]
    srv.step()                               # dispatches the first two
    res = srv.close()
    assert sum(1 for r in res.values() if isinstance(r, Rejected)
               and r.reason == "shutdown") == 4
    assert srv.submit(9, qlo[0], qhi[0], ANY_OVERLAP).reason == "shutdown"
    final = srv.run_until_idle()
    assert sum(isinstance(final.get(t), Served) for t in tickets) == 2


def test_async_step_stats_metrics_and_frozen_backend():
    ds, eng, _ = _grid_ctx()
    clk = FakeClock()
    srv = _server(eng, ds, clk, policy=SLOPolicy(max_wait_ms=0.0))
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.2, seed=3)
    for i in range(4):
        srv.submit(i, qlo[i], qhi[i], ANY_OVERLAP)
    clk.advance(0.002)
    srv.run_until_idle()
    st = srv.step_stats
    for key in ("dispatched", "served", "shed", "admitted_rows",
                "harvested_rows", "queue_depth", "inflight", "step_s"):
        assert key in st
    snap = srv.snapshot()
    assert snap["submitted"] == snap["admitted"] == snap["served"] == 4
    assert snap["e2e_ms"]["p99"] >= snap["e2e_ms"]["p50"] >= 2.0
    assert not srv.mutable
    rej = srv.submit_upsert(1, 0, 0.0, 1.0)
    assert isinstance(rej, Rejected) and rej.reason == "not_mutable"
    assert srv.submit_delete(1).reason == "not_mutable"
    assert srv.snapshot()["shed"]["not_mutable"] == 2


# ---- the lockstep's pieces, one process ----------------------------------

def test_scheduler_take_pops_the_named_tickets_in_order():
    from repro_torch.serving import QueryOp, Scheduler
    sch = Scheduler(SLOPolicy(), clock=FakeClock())
    tickets = [sch.offer(QueryOp(i, 0.0, 1.0, ANY_OVERLAP)) for i in range(5)]
    got = sch.take([tickets[3], tickets[0], tickets[4]])
    assert [e.ticket for e in got] == [tickets[3], tickets[0], tickets[4]]
    assert [e.op.item for e in got] == [3, 0, 4]
    assert [e.ticket for e in sch._queue] == [tickets[1], tickets[2]]
    assert sch.take([]) == [] and sch.depth == 2


def test_scheduler_take_of_a_missing_ticket_raises():
    from repro_torch.serving import QueryOp, Scheduler
    sch = Scheduler(SLOPolicy(), clock=FakeClock())
    tickets = [sch.offer(QueryOp(i, 0.0, 1.0, ANY_OVERLAP)) for i in range(3)]
    with pytest.raises(RuntimeError, match="ticket 7"):
        sch.take([tickets[1], 7])
    assert sch.depth == 3                          # nothing popped
    sch.take([tickets[1]])
    with pytest.raises(RuntimeError, match=f"ticket {tickets[1]}"):
        sch.take([tickets[1]])


def test_one_process_backends_never_broadcast(monkeypatch):
    """A ``QueryEngine`` and a deployment on a logical mesh decide every
    round on the server's own clock: no broadcast."""
    from repro_torch.distributed import DeploymentSpec, ShardedDeployment
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import make_mesh

    def refuse(*args, **kwargs):
        raise AssertionError("broadcast in one process")

    monkeypatch.setattr(coll, "broadcast", refuse)
    monkeypatch.setattr(coll, "_broadcast", refuse)
    ds, eng, _ = _grid_ctx()
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.2, seed=3)
    dep = ShardedDeployment.flat(
        ds.vectors, ds.lo, ds.hi, mesh=make_mesh((2,), ("data",),
                                                 device="cpu"),
        spec=DeploymentSpec(n_shards=2))
    for backend in (eng, dep):
        srv = _server(backend, ds, FakeClock(),
                      policy=SLOPolicy(max_wait_ms=0.0, max_batch=3))
        assert srv._lockstep is None
        tickets = [srv.submit(i, qlo[i], qhi[i], ANY_OVERLAP)
                   for i in range(6)]
        got = srv.run_until_idle()
        assert all(isinstance(got[t], Served) for t in tickets)


def test_broadcast_over_no_axes_returns_its_input():
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import make_mesh
    mesh = make_mesh((2,), ("data",), device="cpu")
    x = torch.arange(4.0)
    for axes in (None, ()):
        assert coll.broadcast(x, mesh, axes) is x
    assert not mesh.counts


def test_broadcast_backward_raises(tmp_path):
    """On a one-rank gloo group, a backward through ``broadcast`` raises;
    forward it returns the tensor, counted once."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import make_rank_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_rank_mesh((1,), ("data",), device="cpu")
        x = torch.arange(4.0, requires_grad=True)
        y = coll.broadcast(x, mesh, "data")
        assert torch.equal(y.detach(), x.detach())
        assert mesh.counts["broadcast"] == 1
        with pytest.raises(RuntimeError, match="no backward"):
            y.sum().backward()
        with pytest.raises(ValueError, match="src"):
            coll.broadcast(x, mesh, "data", src=1)
    finally:
        dist.destroy_process_group()
