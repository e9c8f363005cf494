"""Sharded retrieval on a mesh of ranks (``ShardedDeployment`` with one
shard a rank, the merges as collectives) against the reference's
``ShardedDeployment`` on a device mesh, on the CPU.

Four gloo ranks on a (data 4) mesh (``tests/_mesh_ranks.py``, group
``retrieval``, one torch thread a rank) serve the ``flat``, ``build`` and
``from_segmented`` layouts under ``all_gather`` and ``tournament``, with
``per_shard_k`` 0 and 2 and with shard 3 failed; each rank stages, builds
and scans its own shard only. The reference serves the same corpus,
index spec and requests on four forced host devices
(``tests/_mesh_reference.py``): rank 0's ids equal its answer and its
distances lie within the tolerances of ``tests/test_torch_distributed.py``
(1e-4; 1e-5 on the built shards' graph and pruned routes). The merges alone
run on tie-laden integer distances: rank r's list equals the reference's
lane r under ``jax.vmap`` (and rank 0's its ``shard_map`` result). Then
``ppermute`` directly; a rank whose local search raises and one whose
heartbeat is stale, which every rank must answer degraded within the
harness's time limits; ``broadcast``; and ``launch.serve.main`` with
``--shards 2``, and with ``--async``, on two pairs of the ranks, whose
summaries equal the one-process logical runs'.

The async server on the ranks (``_mesh_common.async_script`` over the
flat and build layouts): each rank runs the same script on its own
injected clock, rank r's offset and (1 + r) times as fast as rank 0's,
which is the reference's. Every rank's outcomes, steps and snapshot equal
rank 0's bit for bit, though a follower's own clock would shed otherwise;
rank 0's equal the reference server's (ids, reasons, flags, counts and
times; dists within the tolerances above); only rank 0 embeds; and the
ranks broadcast as the server's ``_Lockstep`` says.
"""
import json
import os

import numpy as np
import pytest

import _mesh_common as mc
import _mesh_ranks as mr

D = mc.RET_SHAPE[0]


def _cases():
    out = []
    for merge in mc.RET_MERGES:
        for psk in mc.RET_PER_SHARD_K:
            out += [f"flat/{merge}/{psk}/{m}"
                    for m in mc.RET_MASKS[:None if psk == 0 else 1]]
            for route in mc.RET_ROUTES[0 if psk == 0 else 1:]:
                out += [f"build/{merge}/{psk}/{route}",
                        f"segmented/{merge}/{psk}/{route}"]
        out += [f"{layout}/{merge}/failed3"
                for layout in ("flat", "build", "segmented")]
    return out


CASES = _cases()
LISTS = [f"{seed}/{name}/{merge}" for seed in (0, 1)
         for name in mc.RET_LIST_ALIVE for merge in mc.RET_MERGES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's two processes (the async script in its own, beside
    the rest) and the ranks, all at once."""
    d = str(tmp_path_factory.mktemp("mesh_retrieval"))
    outs = {w: os.path.join(d, f"{w}.npz")
            for w in ("retrieval", "retrieval_async")}
    refs = {w: mr.run_reference(out, w) for w, out in outs.items()}
    try:
        ranks = mr.run_ranks("retrieval", d)
    finally:
        try:
            want = {}
            for w, ref in refs.items():
                want.update(mr.finish_reference(ref, outs[w]))
        finally:
            for ref in refs.values():      # the other, where one raised
                if ref.poll() is None:
                    ref.kill()
                    ref.communicate()
    return want, ranks


def _tol(case: str) -> float:
    return 1e-5 if case.startswith("build") and "flat" not in case else 1e-4


def _same(got: dict, want: dict, key: str, wkey: str, tol: float):
    np.testing.assert_array_equal(got[f"{key}/ids"], want[f"{wkey}/ids"],
                                  err_msg=key)
    np.testing.assert_allclose(got[f"{key}/dists"], want[f"{wkey}/dists"],
                               rtol=tol, atol=tol, err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_rank_zero_equals_reference(runs, case):
    want, ranks = runs
    _same(ranks[0], want, case, case, _tol(case))
    np.testing.assert_array_equal(ranks[0][f"{case}/rows"],
                                  want[f"{case}/rows"])
    np.testing.assert_array_equal(ranks[0][f"{case}/missing"],
                                  want[f"{case}/missing"])
    if case.endswith("failed3"):
        assert tuple(want[f"{case}/missing"]) == (D - 1,)


@pytest.mark.parametrize("case", CASES)
def test_every_rank_reports_the_same_and_merges_by_collectives(runs, case):
    ranks = runs[1]
    merge = case.split("/")[1]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res[f"{case}/rows"],
                                      ranks[0][f"{case}/rows"])
        np.testing.assert_array_equal(res[f"{case}/missing"],
                                      ranks[0][f"{case}/missing"])
        if merge == "all_gather":      # one list on every rank
            np.testing.assert_array_equal(res[f"{case}/ids"],
                                          ranks[0][f"{case}/ids"])
            np.testing.assert_array_equal(res[f"{case}/dists"],
                                          ranks[0][f"{case}/dists"])
        # one all_gather agrees on the alive mask and report rows; the
        # merge is two more, or log2(D) rounds of two ppermutes
        assert res[f"{case}/count/all_gather"] == (
            3 if merge == "all_gather" else 1)
        assert res[f"{case}/count/ppermute"] == (
            0 if merge == "all_gather" else 2 * (D.bit_length() - 1))


@pytest.mark.parametrize("case", LISTS)
def test_rank_r_list_equals_reference_lane_r(runs, case):
    want, ranks = runs
    key = f"lists/{case}"
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res[f"{key}/ids"],
                                      want[f"{key}/lanes/ids"][r])
        np.testing.assert_array_equal(res[f"{key}/dists"],
                                      want[f"{key}/lanes/dists"][r])
    _same(ranks[0], want, key, f"{key}/mesh", 0.0)


@pytest.mark.parametrize("merge", mc.RET_MERGES)
def test_sharded_flat_topk_on_ranks_equals_the_reference_flat_layout(runs,
                                                                     merge):
    """``sharded_flat_topk`` given each rank's own rows, as the reference's
    ``shard_map`` body sees its block."""
    want, ranks = runs
    for res in ranks:
        _same(res, want, f"sharded_flat_topk/{merge}",
              f"flat/{merge}/0/15", 1e-4)


def test_tournament_lanes_differ_on_ties(runs):
    """Why rank r returns lane r's list: with ties the lanes differ."""
    want = runs[0]
    lanes = want["lists/0/all/tournament/lanes/ids"]
    assert not all(np.array_equal(lanes[0], lanes[j]) for j in range(D))


def test_ppermute(runs):
    ranks = runs[1]
    x = lambda r: np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["ppermute/ring"], x((r - 1) % D))
        np.testing.assert_array_equal(
            res["ppermute/pair"],
            x(2 - r) if r in (0, 2) else np.zeros((2, 3), np.float32))
        assert res["ppermute/count"] == 2
        np.testing.assert_array_equal(res["ppermute/records"],
                                      [[24, D, 2]])
        assert res["ppermute/tuple_refused"]
        assert res["ppermute/twice_refused"]


def test_each_rank_stages_its_own_shard_only(runs):
    ranks = runs[1]
    n = mc.retrieval_data().n
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["shape/flat"], [n // D, 16])
        np.testing.assert_array_equal(res["shape/flat_ranges"],
                                      [n // D, n // D])
        want = np.full(D, -1)
        want[r] = n // D
        np.testing.assert_array_equal(res["shape/build"], want)
        own = [j for j in range(len(mc.RET_FLUSHES)) if j % D == r]
        assert [i for i, c in enumerate(res["shape/segmented"])
                if c >= 0] == [r]
        np.testing.assert_array_equal(res["shape/segmented_ids"], own)


def test_a_raising_rank_degrades_every_rank(runs):
    want, ranks = runs
    key = "build/all_gather/raised1"
    for res in ranks:
        assert tuple(res[f"{key}/missing"]) == (1,)
        assert mc.RET_ROUTE_CODES[res[f"{key}/rows"][1][2]] == "error"
        _same(res, want, key, "build/all_gather/failed1", 1e-5)


def test_a_stale_heartbeat_degrades_every_rank(runs):
    want, ranks = runs
    key = "flat/all_gather/stale2"
    for res in ranks:
        assert tuple(res[f"{key}/missing"]) == (2,)
        assert mc.RET_ROUTE_CODES[res[f"{key}/rows"][2][2]] == "lost"
        _same(res, want, key, "flat/all_gather/failed2", 1e-4)
        assert not res["flat/all_gather/restored_degraded"]


def test_serve_on_rank_pairs_equals_the_logical_run(runs):
    from repro_torch.launch import serve
    for key, extra, mode in (("summary", [], "sharded"),
                             ("async_summary", ["--async"], "async")):
        logical = serve.main(mc.RET_SERVE_ARGS + extra)
        assert logical["ranks"] == 1 and logical["mode"] == mode
        for res in runs[1]:
            got = json.loads(str(res[f"serve/{key}"]))
            assert got.pop("ranks") == 2
            for s in (got, logical):
                s.pop("seconds", None)
            assert got == {k: v for k, v in logical.items() if k != "ranks"}
            assert got["served"] == got["non_empty"] == 8


def test_broadcast(runs):
    ranks = runs[1]
    x = lambda r: np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
    for res in ranks:
        np.testing.assert_array_equal(res["broadcast/from0"], x(0))
        np.testing.assert_array_equal(res["broadcast/from2"], x(2))
        assert res["broadcast/count"] == 2
        np.testing.assert_array_equal(res["broadcast/records"], [[24, D, 2]])
        assert res["broadcast/backward_raises"]


# what every rank's async script must give as rank 0's does, and rank 0's
# as the reference's
ASYNC_KEYS = ("submits", "steps", "tickets", "ids", "dists", "times",
              "flags", "snapshot", "executes")


def _script(res: dict, layout: str) -> dict:
    pre = f"async/{layout}/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


@pytest.mark.parametrize("layout", mc.ASYNC_LAYOUTS)
def test_async_every_rank_equals_rank_zero(runs, layout):
    ranks = [_script(res, layout) for res in runs[1]]
    for r, got in enumerate(ranks[1:], 1):
        for key in ASYNC_KEYS:
            np.testing.assert_array_equal(got[key], ranks[0][key],
                                          err_msg=f"rank {r}: {key}")


@pytest.mark.parametrize("layout", mc.ASYNC_LAYOUTS)
def test_async_rank_zero_equals_reference(runs, layout):
    want = _script(runs[0], layout)
    got = _script(runs[1][0], layout)
    for key in ASYNC_KEYS:
        if key != "dists":
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    tol = _tol(f"{layout}/async")
    np.testing.assert_allclose(got["dists"], want["dists"], rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("layout", mc.ASYNC_LAYOUTS)
def test_async_followers_never_embed(runs, layout):
    want = _script(runs[0], layout)
    ranks = [_script(res, layout) for res in runs[1]]
    assert ranks[0]["embeds"] == want["embeds"] > 0
    assert [got["embeds"] for got in ranks[1:]] == [0] * (D - 1)


@pytest.mark.parametrize("layout", mc.ASYNC_LAYOUTS)
def test_async_broadcasts_as_designed(runs, layout):
    """A step's header; a round's entries; its vectors where it dispatches
    queries; rank 0's clock after each ``execute``."""
    for got in (_script(res, layout) for res in runs[1]):
        want = 0
        for dispatched, shed, *_, executes, _ in got["steps"]:
            want += (1 + (dispatched + shed > 0) + (dispatched > 0)
                     + executes)
        assert got["broadcasts"] == want


@pytest.mark.parametrize("layout", mc.ASYNC_LAYOUTS)
def test_async_script_exercises_the_rules(runs, layout):
    """Sheds at dispatch, at submit and at close, late answers, shard 3
    lost and restored, a young query dispatched at once (the reference
    holds none behind ``max_wait_ms`` when no stream rows are in flight),
    and followers whose own clocks would have shed otherwise."""
    ranks = [_script(res, layout) for res in runs[1]]
    got = ranks[0]
    reason = {r: i for i, r in enumerate(mc.ASYNC_REASONS)}
    flags, subs = got["flags"], list(got["submits"])
    shed_at = {r: set(got["tickets"][flags[:, 0] == i])
               for r, i in reason.items()}
    assert shed_at["deadline_expired"] and len(shed_at["shutdown"]) == 2
    for r in ("queue_full", "not_mutable", "shutdown"):
        assert -1 - reason[r] in subs, r
    served = flags[:, 0] == -1
    assert 0 < flags[served, 1].sum() < served.sum()      # degraded
    assert flags[served, 2].any()                          # deadline missed
    young = subs[sum(len(w) for w in mc.ASYNC_WAVES[:2]) + 1]
    j = list(got["tickets"]).index(young)
    assert served[j] and got["times"][j, 0] < mc.ASYNC_POLICY["max_wait_ms"]
    first_shed = set(got["would_shed"])
    assert first_shed == shed_at["deadline_expired"] & set(range(6))
    assert any(set(res["would_shed"]) != first_shed for res in ranks[1:])
