"""The port's window capture on the CPU: ``obs.capture(timeline=True)``
keeps every span on the profiler's epoch clock, requests inside it run as
untraced ones do and return no trace of their own, the kernel wrappers open
their spans around the enqueue alone, and a server step with nothing to do
records nothing."""
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import ANY_OVERLAP, MSTGIndex, QueryEngine, SearchRequest
from repro_torch.data import make_queries, make_range_dataset
from repro_torch.kernels import ops
from repro_torch.serving import AsyncRetrievalServer, SLOPolicy


@pytest.fixture(scope="module")
def ds():
    return make_range_dataset(n=300, d=8, n_queries=80, quantize=32, seed=4)


@pytest.fixture(scope="module")
def engine(ds):
    idx = MSTGIndex(ds.vectors, ds.lo, ds.hi, variants=("T", "Tp"), m=8,
                    ef_con=32)
    return QueryEngine(idx, device="cpu")


def _names(tr):
    return [sp[0] for sp in tr.spans()]


def test_window_capture_modes_and_flat_spans():
    assert not obs.tracing() and not obs.timing_kernels()
    before = time.time_ns()
    with obs.capture(timeline=True) as tr:
        assert obs.tracing() and not obs.timing_kernels()
        assert obs.begin_request_trace() is None       # requests join it
        with obs.span("outer"):
            with obs.span("inner") as sp:
                sp.set("rows", 3)
            obs.span("bare").stop()
        with obs.capture() as inner:                   # nested: joins
            assert inner is tr and not obs.timing_kernels()
            obs.span("late").stop()
    after = time.time_ns()
    assert not obs.tracing()
    got = tr.spans()
    assert [(n, d) for n, _, _, d, _ in got] == [
        ("outer", 0), ("inner", 1), ("bare", 1), ("late", 0)]
    for name, s, t, _, args in got:
        assert isinstance(s, int) and before <= s <= t <= after
    assert dict(got[1][4]) == {"rows": 3} and dict(got[2][4]) == {}
    outer = tr.roots[0]
    assert outer.duration_ms == pytest.approx((got[0][2] - got[0][1]) / 1e6)
    assert len(tr.trace()) == 4


def test_a_span_stores_nothing_until_used():
    with obs.capture(timeline=True) as tr:
        with obs.span("leaf"):
            pass
    leaf = tr.roots[0]
    assert leaf._args is None and leaf._children is None
    assert dict(leaf.args) == {} and list(leaf.children) == []
    with pytest.raises(TypeError):
        leaf.args["x"] = 1                              # set() writes


def test_per_request_trace_times_kernels():
    t = obs.begin_request_trace()
    assert obs.tracing() and obs.timing_kernels()
    trace = obs.end_request_trace(t)
    assert len(trace) == 0 and not obs.timing_kernels()
    with obs.capture():
        assert obs.timing_kernels()


def test_window_spans_enclose_the_profiler_events():
    """A span around a torch op holds the op's own profiler event: the
    window's clock and the profiler's are the same epoch clock."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(192, 192)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.capture(timeline=True) as tr:
            for _ in range(20):
                with obs.span("mm"):
                    torch.mm(a, a)
    mms = sorted((e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mm")
    spans = [(s, t) for n, s, t, _, _ in tr.spans() if n == "mm"]
    assert len(mms) == len(spans) == 20
    for (es, ee), (ss, st) in zip(mms, spans):
        assert ss <= es and ee <= st


@pytest.mark.parametrize("route", ("flat", "pruned", "graph"))
def test_request_in_the_window_runs_as_an_untraced_one(ds, engine, route):
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.2, seed=5)

    def req(trace=False):
        return SearchRequest(ds.queries, (qlo, qhi), ANY_OVERLAP, k=5, ef=24,
                             route=route, trace=trace, chunk=4)
    plain = engine.execute(req())
    with obs.capture(timeline=True) as tr:
        inside = engine.execute(req())
        asked = engine.execute(req(trace=True))
    assert inside.trace is None and asked.trace is None
    for res in (inside, asked):
        np.testing.assert_array_equal(res.ids, plain.ids)
        np.testing.assert_array_equal(res.dists, plain.dists)
    names = _names(tr)
    assert names.count("search") == 2
    assert {"stage", "to_host"} <= set(names)
    if route == "flat":
        assert {"topk", "kernel:pairwise_l2_masked"} <= set(names)
    if route == "graph":
        assert {"chunk", "harvest", "kernel:gathered_topk"} <= set(names)
    kernel_args = [dict(sp[4]) for sp in tr.spans()
                   if sp[0].startswith("kernel:")]
    assert all(a == {} for a in kernel_args)
    assert bool(kernel_args) == (route != "pruned")     # no kernel of its own


class _OnCard:
    """An argument that says it lies on a card; the probe ignores it."""
    device = torch.device("cuda", 0)


def _probe(monkeypatch):
    """A wrapped entry point with a byte model that counts its calls, and
    a stand-in for the card's stream that counts synchronizations."""
    calls = {"bytes": 0, "sync": 0}

    class Stream:
        def synchronize(self):
            calls["sync"] += 1

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(ops.profile, "device_peaks", lambda dev: None)

    def nbytes(*args):
        calls["bytes"] += 1
        return 1024

    fn = ops._traced("probe", nbytes)(lambda x: 7)
    return fn, calls


def test_traced_wrapper_does_not_wait_in_the_window(monkeypatch):
    fn, calls = _probe(monkeypatch)
    assert fn(_OnCard()) == 7 and calls == {"bytes": 0, "sync": 0}
    with obs.capture(timeline=True) as tr:
        assert fn(_OnCard()) == 7
    assert calls == {"bytes": 0, "sync": 0}
    (name, _, _, _, args), = tr.spans()
    assert name == "kernel:probe" and dict(args) == {}


def test_traced_wrapper_times_the_kernel_under_a_request_trace(monkeypatch):
    fn, calls = _probe(monkeypatch)
    t = obs.begin_request_trace()
    assert fn(_OnCard()) == 7
    trace = obs.end_request_trace(t)
    assert calls == {"bytes": 1, "sync": 2}
    sp = trace.roots[0]
    assert sp.name == "kernel:probe"
    assert sp.args["bytes"] == 1024 and sp.args["impl"] == "cuda"


def _server(engine):
    return AsyncRetrievalServer(engine, lambda items: np.stack(items), k=5,
                                policy=SLOPolicy(max_batch=8), route="flat")


def test_an_empty_step_records_no_span(engine):
    srv = _server(engine)
    with obs.capture(timeline=True) as tr:
        for _ in range(5):
            assert srv.step() == {}
    assert tr.spans() == []


def test_round_spans_follow_rounds_not_polls(ds, engine):
    """Polls of an empty queue around one round of three queries record
    one ``round``, holding the round's one ``search``."""
    qlo, qhi = make_queries(ds, ANY_OVERLAP, 0.2, seed=6)
    srv = _server(engine)
    with obs.capture(timeline=True) as tr:
        srv.step()
        for i in range(3):
            srv.submit(ds.queries[i], float(qlo[i]), float(qhi[i]),
                       ANY_OVERLAP)
        out = srv.step()
        for _ in range(3):
            srv.step()
    assert len(out) == 3 and srv.idle
    names = _names(tr)
    assert names.count("round") == 1 and names.count("search") == 1
    depth = {sp[0]: sp[3] for sp in tr.spans()}
    assert depth["round"] == 0 and depth["search"] > depth["admission"] > 0
