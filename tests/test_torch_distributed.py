"""The port's sharded serving (``repro_torch.distributed``) against the
reference's ``repro.distributed``, on the CPU.

The reference's distributed package imports ``jax.experimental.shard_map``,
which warns under the installed jax, and the repository's pytest settings
turn that warning into an error; so the reference is imported inside a
fixture, with ``DeprecationWarning`` ignored there only. Its two merge
schedules run per shard under ``jax.vmap(..., axis_name="data")``, one
vmapped lane per shard; the port's take the stacked (D, Q, k') lists and
return shard 0's list, which is what they are held against. Distances are
small integers, so ties occur in every merge.

Every deployment here but the heartbeat test's is made with a heartbeat
timeout (``shard_timeout_s``) that no run reaches: under a loaded parallel
test run, the time between a build and its first search has passed the
default 30 s, and a shard found lost then changed the answer. The
heartbeat test keeps its own timeout and pings a stale heartbeat.
"""
import time
import warnings

import numpy as np
import pytest
import torch

from repro.core import EngineConfig as RefConfig
from repro.core import IndexSpec as RefSpec
from repro.core import SearchRequest as RefRequest
from repro.streaming import SegmentedIndex as RefSegmented

from repro_torch.core import IndexSpec, SearchRequest
from repro_torch.data import make_queries, make_range_dataset
from repro_torch.distributed import (DeploymentSpec, HeartbeatRegistry,
                                     ShardedDeployment, global_topk_merge,
                                     resolve_merge, sharded_flat_topk,
                                     sharded_topk_merge,
                                     tournament_topk_merge)
from repro_torch.distributed.deployment import _host_merge
from repro_torch.launch import make_mesh
from repro_torch.streaming import SegmentedIndex

SPEC = dict(variants=("T", "Tp", "Tpp"), m=8, ef_con=40)
NO_EDGE = -1
NEVER_S = 1e9      # a heartbeat timeout no run reaches (module docstring)


@pytest.fixture(scope="module")
def ref_dist():
    """The reference's topk, deployment and fault modules."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.distributed import deployment, fault, topk
    return topk, deployment, fault


@pytest.fixture(scope="module")
def dds():
    return make_range_dataset(n=400, d=16, n_queries=8, quantize=32, seed=9)


def _stacked(D, Q, w, seed):
    """(D, Q, w) shard lists: integer distances (ties within and across
    shards), sorted per row as a shard's top-k is, with NO_EDGE/inf tails
    on some rows."""
    rng = np.random.default_rng(seed)
    d = np.sort(rng.integers(0, 6, (D, Q, w)).astype(np.float32), axis=2)
    ids = rng.integers(0, 1000, (D, Q, w)).astype(np.int32)
    tail = rng.integers(0, w + 1, (D, Q))
    cols = np.arange(w)[None, None, :]
    empty = cols >= tail[:, :, None]
    return (np.where(empty, NO_EDGE, ids).astype(np.int32),
            np.where(empty, np.inf, d).astype(np.float32))


def _ref_merge(topk, schedule, ids, dists, k, alive):
    """The reference's schedule, one vmapped lane per shard, with the alive
    masking of its ``sharded_topk_merge`` body; shard 0's row."""
    import jax
    import jax.numpy as jnp
    fn = topk.MERGE_SCHEDULES[schedule]
    alive = np.ones(ids.shape[0], bool) if alive is None else alive

    def lane(i, d):
        ok = jnp.asarray(alive)[jax.lax.axis_index("data")]
        i = jnp.where(ok, i, NO_EDGE)
        d = jnp.where(ok, d, jnp.inf)
        return fn(i, d, k, "data")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        gi, gd = jax.vmap(lane, axis_name="data")(ids, dists)
    return np.asarray(gi), np.asarray(gd)


@pytest.mark.parametrize("alive", [None, "some_dead"])
@pytest.mark.parametrize("schedule", ["all_gather", "tournament"])
@pytest.mark.parametrize("D", [1, 2, 4, 8, 16])
def test_merge_schedules_match_reference_shard_zero(ref_dist, D, schedule,
                                                    alive):
    topk = ref_dist[0]
    Q, w, k = 5, 3, 7                              # k' < k
    ids, dists = _stacked(D, Q, w, seed=D)
    if alive is not None:
        alive = np.arange(D) % 3 != 1
    want_i, want_d = _ref_merge(topk, schedule, ids, dists, k, alive)
    mesh = make_mesh((D,), ("data",), device="cpu")
    got_i, got_d = sharded_topk_merge(mesh, ids, dists, k, merge=schedule,
                                      alive=alive)
    assert got_i.dtype == np.int64 and got_d.dtype == np.float32
    np.testing.assert_array_equal(got_i, want_i[0])
    np.testing.assert_array_equal(got_d, want_d[0])
    if schedule == "all_gather":       # every lane holds one list
        assert all(np.array_equal(want_i[0], want_i[j]) for j in range(D))


def test_tournament_lanes_differ_on_ties_and_the_port_returns_shard_zero(
        ref_dist):
    """The reason the port names a shard: with ties, the reference's lanes
    end with different lists."""
    topk = ref_dist[0]
    ids, dists = _stacked(4, 6, 3, seed=0)
    want_i, _ = _ref_merge(topk, "tournament", ids, dists, 5, None)
    assert not all(np.array_equal(want_i[0], want_i[j]) for j in range(4))
    gi, _ = tournament_topk_merge(torch.as_tensor(ids).long(),
                                  torch.as_tensor(dists), 5)
    np.testing.assert_array_equal(gi.numpy(), want_i[0])


def test_schedules_agree_when_distances_are_distinct():
    rng = np.random.default_rng(3)
    d = torch.as_tensor(np.sort(rng.permutation(8 * 4 * 5).reshape(8, 4, 5)
                                .astype(np.float32), axis=2))
    ids = torch.arange(8 * 4 * 5).reshape(8, 4, 5)
    a = global_topk_merge(ids, d, 9)
    b = tournament_topk_merge(ids, d, 9)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_resolve_merge_and_argument_checks(ref_dist):
    topk = ref_dist[0]
    for merge in ("auto", "all_gather", "tournament"):
        for D in (1, 4, 8, 16, 12):
            assert resolve_merge(merge, D) == topk.resolve_merge(merge, D)
    with pytest.raises(ValueError, match="unknown merge"):
        resolve_merge("ring", 4)
    with pytest.raises(ValueError, match="power-of-two"):
        tournament_topk_merge(torch.zeros((3, 1, 2), dtype=torch.int64),
                              torch.zeros((3, 1, 2)), 2)
    mesh = make_mesh((4,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="mesh axis"):
        sharded_topk_merge(mesh, np.zeros((2, 1, 2)), np.zeros((2, 1, 2)), 2)
    with pytest.raises(ValueError, match="divisible"):
        sharded_flat_topk(mesh, np.zeros((6, 4), np.float32), np.zeros(6),
                          np.ones(6), np.zeros((1, 4), np.float32),
                          np.zeros(1), np.ones(1), mask=15, k=2)
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data",), device="cpu")
    assert make_mesh((2, 3), ("data", "model"), device="cpu").shape == {
        "data": 2, "model": 3}


def test_host_merge_matches_reference(ref_dist):
    dep = ref_dist[1]
    for D, w, k in ((4, 3, 5), (3, 4, 20), (1, 2, 2)):
        ids, dists = _stacked(D, 6, w, seed=w)
        got = _host_merge(ids.astype(np.int64), dists, k)
        want = dep._host_merge(ids.astype(np.int64), dists, k)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x)
            assert g.dtype == x.dtype


def test_heartbeat_registry_matches_reference(ref_dist):
    fault = ref_dist[2]
    for reg in (HeartbeatRegistry(timeout_s=5.0),
                fault.HeartbeatRegistry(timeout_s=5.0)):
        reg.ping("a", 1, now=100.0)
        reg.ping("b", 1, now=103.0)
        assert reg.dead_workers(now=106.0) == ["a"]
        assert reg.should_restart(now=106.0)
        assert not reg.should_restart(now=104.0)


def _answers(dep, ds, request_cls, mask=15, **kw):
    qlo, qhi = make_queries(ds, mask, 0.2, seed=mask)
    return dep.execute(request_cls(ds.queries, (qlo, qhi), mask, k=6, ef=48,
                                   fanout=2, **kw))


def _same(got, want, tol):
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.dists, want.dists, rtol=tol, atol=tol)


def _shard_rows(report):
    return [(r.shard, r.n, r.route, r.alive, r.k_fetched, r.slot_count)
            for r in report.shards]


@pytest.fixture(scope="module")
def built(ref_dist, dds):
    dep = ref_dist[1]
    ref = dep.ShardedDeployment.build(
        dds.vectors, dds.lo, dds.hi,
        spec=dep.DeploymentSpec(n_shards=3, index=RefSpec(**SPEC),
                                engine=RefConfig(use_kernel=True),
                                shard_timeout_s=NEVER_S))
    port = ShardedDeployment.build(
        dds.vectors, dds.lo, dds.hi,
        spec=DeploymentSpec(n_shards=3, index=IndexSpec(**SPEC),
                            shard_timeout_s=NEVER_S),
        device="cpu")
    return ref, port


@pytest.mark.parametrize("route", ["graph", "pruned", "flat", "auto"])
def test_build_layout_matches_reference(dds, built, route):
    ref, port = built
    a = _answers(ref, dds, RefRequest, route=route)
    b = _answers(port, dds, SearchRequest, route=route)
    assert b.report.route == a.report.route == "sharded"
    assert b.report.merge == a.report.merge == "host"
    assert _shard_rows(b.report) == _shard_rows(a.report)
    _same(b, a, 1e-4 if route == "flat" else 1e-5)
    for rs, ps in zip(ref.shards, port.shards):
        assert (ps.n, ps.id_offset) == (rs.n, rs.id_offset)
        assert ps.engine.device.type == "cpu"


def test_build_pool_builds_the_same_shards(dds, built):
    """Two spawned build workers give the serial build's shards."""
    _, serial = built
    pooled = ShardedDeployment.build(
        dds.vectors, dds.lo, dds.hi,
        spec=DeploymentSpec(n_shards=3, index=IndexSpec(**SPEC),
                            build_workers=2, shard_timeout_s=NEVER_S),
        device="cpu")
    assert pooled.build_report["pool_size"] == 2
    assert len(pooled.build_report["shard_seconds"]) == 3
    for a, b in zip(serial.shards, pooled.shards):
        pa, pb = a.engine.index.to_payload()[0], b.engine.index.to_payload()[0]
        assert all(np.array_equal(pa[key], pb[key]) for key in pa)
    _same(_answers(pooled, dds, SearchRequest, route="graph"),
          _answers(serial, dds, SearchRequest, route="graph"), 0)


def _flat_pair(ref_dist, dds, D=4, **kw):
    kw.setdefault("shard_timeout_s", NEVER_S)
    dep = ref_dist[1]
    ref = dep.ShardedDeployment.flat(
        dds.vectors, dds.lo, dds.hi,
        spec=dep.DeploymentSpec(n_shards=D, engine=RefConfig(use_kernel=True),
                                **kw))
    port = ShardedDeployment.flat(dds.vectors, dds.lo, dds.hi,
                                  spec=DeploymentSpec(n_shards=D, **kw),
                                  device="cpu")
    return ref, port


@pytest.mark.parametrize("per_shard_k", [0, 2])
def test_flat_layout_matches_reference(ref_dist, dds, per_shard_k):
    ref, port = _flat_pair(ref_dist, dds, per_shard_k=per_shard_k)
    for mask in (15, 2, 48):
        a = _answers(ref, dds, RefRequest, mask=mask)
        b = _answers(port, dds, SearchRequest, mask=mask)
        assert _shard_rows(b.report) == _shard_rows(a.report)
        _same(b, a, 1e-4)
    # the device schedules on a logical mesh give the host merge's answer
    for merge in ("all_gather", "tournament"):
        mesh = make_mesh((4,), ("data",), device="cpu")
        dev = ShardedDeployment.flat(
            dds.vectors, dds.lo, dds.hi, mesh=mesh,
            spec=DeploymentSpec(n_shards=4, merge=merge,
                                per_shard_k=per_shard_k,
                                shard_timeout_s=NEVER_S))
        assert dev.device.type == "cpu"
        c = _answers(dev, dds, SearchRequest)
        assert c.report.merge == merge
        _same(c, _answers(port, dds, SearchRequest), 0)


def test_flat_layout_is_staged_once(dds):
    port = ShardedDeployment.flat(dds.vectors, dds.lo, dds.hi,
                                  spec=DeploymentSpec(
                                      n_shards=4, shard_timeout_s=NEVER_S),
                                  device="cpu")
    corpus, lo, hi = port._flat
    assert isinstance(corpus, torch.Tensor) and corpus.shape == (400, 16)
    assert lo.dtype == hi.dtype == torch.float32
    _answers(port, dds, SearchRequest)
    assert port._flat[0] is corpus


def test_fail_restore_and_missing_shards_match_reference(ref_dist, dds):
    ref, port = _flat_pair(ref_dist, dds)
    mesh = make_mesh((4,), ("data",), device="cpu")
    dev = ShardedDeployment.flat(dds.vectors, dds.lo, dds.hi, mesh=mesh,
                                 spec=DeploymentSpec(
                                     n_shards=4, merge="tournament",
                                     shard_timeout_s=NEVER_S))
    for d in (ref, port, dev):
        d.fail(3)
    a = _answers(ref, dds, RefRequest)
    b = _answers(port, dds, SearchRequest)
    c = _answers(dev, dds, SearchRequest)
    for r in (a, b, c):
        assert r.report.missing_shards == (3,) and r.degraded
        assert r.report.shards[3].route == "lost"
        assert not bool(np.isin(r.ids, np.arange(300, 400)).any())
    _same(b, a, 1e-4)
    _same(c, b, 0)
    for d in (ref, port, dev):
        d.restore(3)
    a, b = _answers(ref, dds, RefRequest), _answers(port, dds, SearchRequest)
    assert not b.degraded and b.report.missing_shards == ()
    _same(b, a, 1e-4)


def test_a_raising_shard_is_a_lost_shard(ref_dist, dds, built):
    ref, port = built

    def boom(request):
        raise RuntimeError("shard down mid-search")

    for dep in (ref, port):
        dep.shards[1].engine.execute = boom
    try:
        a = _answers(ref, dds, RefRequest, route="pruned")
        b = _answers(port, dds, SearchRequest, route="pruned")
    finally:
        for dep in (ref, port):
            del dep.shards[1].engine.execute
    assert b.report.missing_shards == a.report.missing_shards == (1,)
    assert b.report.shards[1].route == "error" and b.degraded
    assert _shard_rows(b.report) == _shard_rows(a.report)
    _same(b, a, 1e-5)


def test_heartbeat_timeout_marks_a_shard_lost(ref_dist, dds):
    ref, port = _flat_pair(ref_dist, dds, shard_timeout_s=60.0)
    stale = time.time() - 3600.0
    for dep in (ref, port):
        dep.heartbeats.ping(dep.shards[2].name, 0, now=stale)
    a = _answers(ref, dds, RefRequest)
    b = _answers(port, dds, SearchRequest)
    assert b.report.missing_shards == a.report.missing_shards == (2,)
    _same(b, a, 1e-4)
    port.restore(2)
    assert not _answers(port, dds, SearchRequest).degraded


@pytest.fixture(scope="module")
def segmented_pair(dds):
    ref = RefSegmented(RefSpec(**SPEC),
                       engine_config=RefConfig(use_kernel=True))
    port = SegmentedIndex(IndexSpec(**SPEC), device="cpu")
    v, lo, hi = dds.vectors, dds.lo, dds.hi
    for s in (ref, port):
        for a, b in ((0, 150), (150, 260), (260, 330)):
            s.add(np.arange(a, b), v[a:b], lo[a:b], hi[a:b])
            s.flush()
        s.delete(np.arange(0, 330, 13))
        s.add(np.arange(330, 400), v[330:400], lo[330:400], hi[330:400])
    return ref, port


@pytest.mark.parametrize("route", ["graph", "pruned", "flat"])
def test_from_segmented_matches_reference(ref_dist, dds, segmented_pair,
                                          route):
    dep = ref_dist[1]
    ref_s, port_s = segmented_pair
    ref = dep.ShardedDeployment.from_segmented(
        ref_s, spec=dep.DeploymentSpec(n_shards=2,
                                       engine=RefConfig(use_kernel=True),
                                       shard_timeout_s=NEVER_S))
    port = ShardedDeployment.from_segmented(
        port_s, spec=DeploymentSpec(n_shards=2, shard_timeout_s=NEVER_S),
        device="cpu")
    assert [s.n for s in port.shards] == [s.n for s in ref.shards]
    assert port.shards[0].engine.delta is port_s.delta
    a = _answers(ref, dds, RefRequest, route=route)
    b = _answers(port, dds, SearchRequest, route=route)
    assert _shard_rows(b.report) == _shard_rows(a.report)
    _same(b, a, 1e-4)
    # the same answer as the segmented index itself when k' == k
    whole = _answers(port_s, dds, SearchRequest, route=route)
    if route != "graph":
        _same(b, whole, 0)


def test_from_segmented_shares_the_source_engines(dds, segmented_pair):
    """Views on the source's config and device reuse its segment engines,
    so no segment is staged twice; another config builds its own."""
    port_s = segmented_pair[1]
    port = ShardedDeployment.from_segmented(
        port_s, spec=DeploymentSpec(n_shards=2,
                                    engine=port_s.engine_config,
                                    shard_timeout_s=NEVER_S),
        device="cpu")
    _answers(port, dds, SearchRequest, route="pruned")
    before = dict(port_s._engines)
    _answers(port, dds, SearchRequest, route="graph")
    for j, seg in enumerate(port_s.segments):
        view = port.shards[j % 2].engine
        assert view._engine(seg) is port_s._engine(seg)
    assert all(port_s._engines[k] is e for k, e in before.items())
    other = ShardedDeployment.from_segmented(
        port_s, spec=DeploymentSpec(
            n_shards=2,
            engine=port_s.engine_config.replace(flat_threshold=0.25)),
        device="cpu")
    seg = port_s.segments[0]
    assert other.shards[0].engine._engine(seg) is not port_s._engine(seg)


def test_a_device_other_than_the_mesh_s_is_refused(dds):
    mesh = make_mesh((2,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="mesh's device"):
        ShardedDeployment.flat(dds.vectors, dds.lo, dds.hi, mesh=mesh,
                               spec=DeploymentSpec(n_shards=2),
                               device="meta")
    dep = ShardedDeployment.flat(dds.vectors, dds.lo, dds.hi, mesh=mesh,
                                 spec=DeploymentSpec(n_shards=2),
                                 device="cpu")
    assert dep.device == mesh.device


def test_device_defaults_to_cuda_and_raises_without_it(dds, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedDeployment.flat(dds.vectors, dds.lo, dds.hi,
                               spec=DeploymentSpec(n_shards=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((4,), ("data",))
    mesh = make_mesh((4,), ("data",), device="cpu")
    dep = ShardedDeployment.flat(dds.vectors, dds.lo, dds.hi, mesh=mesh,
                                 spec=DeploymentSpec(n_shards=4))
    assert dep.device.type == "cpu"
    with pytest.raises(ValueError, match="mesh axis"):
        ShardedDeployment.flat(dds.vectors, dds.lo, dds.hi, mesh=mesh,
                               spec=DeploymentSpec(n_shards=2))
