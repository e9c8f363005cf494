"""The port's traced kernel path on the CPU: ``repro_torch.obs.profile``
(peaks by card, the bandwidth annotation, the profiler capture) and the
``kernel:<name>`` spans every wrapper in ``repro_torch.kernels.ops`` opens
when a trace is active, mirroring the reference's ``tests/test_obs.py``.
On the CPU the spans time the plain versions and carry no fraction of a
peak; their values on the card are checked in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``."""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import obs as robs
from repro.core import intervals as riv
from repro.kernels import ops as rops

from repro_torch import obs
from repro_torch.core import MSTGIndex, QueryEngine, SearchRequest
from repro_torch.core.quant import QuantizedStore
from repro_torch.data import make_queries
from repro_torch.kernels import ops
from repro_torch.obs import Trace, profile

H100 = "NVIDIA H100 80GB HBM3"


def test_bandwidth_annotation():
    peak = profile.PEAKS[H100].hbm_bytes_per_s
    ann = obs.bandwidth_annotation(peak, 1.0, peak)   # one peak-second
    assert ann["frac_of_peak"] == pytest.approx(1.0)
    assert ann["gb_per_s"] == pytest.approx(peak / 1e9)
    assert ann["bytes"] == peak
    assert obs.bandwidth_annotation(1024, 0.0, peak)["gb_per_s"] == 0.0


def test_no_peak_without_a_known_card(monkeypatch):
    assert obs.device_peaks("cpu") is None
    assert obs.bandwidth_annotation(1e9, 1.0)["frac_of_peak"] is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    names = {0: "NVIDIA Unlisted Card", 1: H100}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: names[i])
    assert obs.device_peaks(torch.device("cuda", 0)) is None
    assert obs.device_peaks(torch.device("cuda", 1)) == profile.PEAKS[H100]
    assert profile.PEAKS[H100].fp32_flop_per_s == 67e12


def _scan_args(rng, Q=3, N=40, d=8):
    q = rng.normal(size=(Q, d)).astype(np.float32)
    c = rng.normal(size=(N, d)).astype(np.float32)
    lo = rng.uniform(0, 100, N).astype(np.float32)
    hi = lo + rng.uniform(0, 30, N).astype(np.float32)
    ql = rng.uniform(0, 100, Q).astype(np.float32)
    qh = ql + rng.uniform(0, 30, Q).astype(np.float32)
    return q, c, lo, hi, ql, qh


def _step_args(rng, Q=3, n=50, d=8, M=12, L=6):
    ids = rng.integers(-1, n, (Q, M)).astype(np.int32)
    b = rng.integers(0, 40, (Q, M)).astype(np.int32)
    pool_d = np.sort(rng.random((Q, L)).astype(np.float32), axis=1)
    return [torch.from_numpy(a) for a in (
        ids, rng.random((Q, M)) < 0.7, b,
        b + rng.integers(0, 40, (Q, M)).astype(np.int32),
        rng.integers(0, 70, Q).astype(np.int32),
        rng.integers(0, n, (Q, L)).astype(np.int32), pool_d,
        rng.random((Q, L)) < 0.5)]


def _calls():
    """Each wrapper with small CPU inputs and its byte model."""
    rng = np.random.default_rng(0)
    q, c, lo, hi, ql, qh = (torch.from_numpy(a) for a in _scan_args(rng))
    Q, d = q.shape
    N = c.shape[0]
    st = QuantizedStore.from_vectors(c.numpy(), "int8")
    i8 = [torch.from_numpy(a) for a in (st.codes, st.scale, st.offset,
                                        st.sq_norm)]
    cand = c[:Q * 5].reshape(Q, 5, d).contiguous()
    step = _step_args(rng)
    live = ops.live_rows(*step[:5], N)
    m = riv.ANY_OVERLAP
    return {
        "pairwise_l2_masked": ((q, c, lo, hi, ql, qh, m),
                               ops.pairwise_stream_bytes(Q, N, d)),
        "pairwise_l2_int8": ((q, *i8, lo, hi, ql, qh, m),
                             ops.int8_scan_stream_bytes(Q, N, d)),
        "fused_topk_l2": ((q, c, lo, hi, ql, qh, m, 4),
                          ops.fused_topk_stream_bytes(Q, N, d, 4)),
        "gathered_l2": ((q, cand), ops.gathered_l2_stream_bytes(Q, 5, d)),
        "gathered_l2_dot": ((q, cand), ops.gathered_l2_stream_bytes(Q, 5, d)),
        "gathered_topk": ((q, c, *step),
                          ops.gathered_stream_bytes(Q, 12, 6, d, live)),
        # int8 rows, and the (d,) float32 scale and offset
        "gathered_topk_quant": ((q, *i8[:3], *step), ops.gathered_stream_bytes(
            Q, 12, 6, d, live, 1) + 8 * d),
    }


def _same(a, b) -> bool:
    if torch.is_tensor(a):
        a, b = (a,), (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", list(_calls()))
def test_traced_wrapper_opens_a_kernel_span(name):
    args, nbytes = _calls()[name]
    fn = getattr(ops, name)
    untraced = fn(*args)
    t = obs.begin_request_trace()
    traced = fn(*args)
    trace = obs.end_request_trace(t)
    assert _same(traced, untraced)
    assert [sp.name for sp in trace.roots] == [f"kernel:{name}"]
    sp = trace.roots[0]
    assert {"bytes", "gb_per_s", "frac_of_peak"} <= set(sp.args)
    assert sp.args["bytes"] == nbytes
    assert sp.args["gb_per_s"] >= 0.0
    assert sp.args["frac_of_peak"] is None          # the CPU has no peak
    assert sp.args["impl"] == "plain"
    assert not obs.tracing()


def test_kernel_span_has_the_reference_schema(small_ds):
    """The reference's gathered_l2 span (tests/test_obs.py) and the port's
    carry the same name and annotation keys on the same inputs."""
    ds = small_ds
    q = ds.queries[:2]
    cand = np.broadcast_to(ds.vectors[:8], (2, 8, ds.vectors.shape[1])).copy()
    t = robs.begin_request_trace()
    want = np.asarray(rops.gathered_l2(jnp.asarray(q), jnp.asarray(cand)))
    rtrace = robs.end_request_trace(t)
    t = obs.begin_request_trace()
    got = ops.gathered_l2(torch.from_numpy(q), torch.from_numpy(cand))
    trace = obs.end_request_trace(t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    rsp, sp = rtrace.roots[0], trace.roots[0]
    assert sp.name == rsp.name == "kernel:gathered_l2"
    assert set(rsp.args) <= set(sp.args)


@pytest.fixture(scope="module")
def cpu_engine(small_ds):
    ds = small_ds
    idx = MSTGIndex(ds.vectors, ds.lo, ds.hi, variants=("T", "Tp"), m=8,
                    ef_con=40)
    return QueryEngine(idx, device="cpu")


@pytest.mark.parametrize("route,kernel", [("graph", "gathered_topk"),
                                          ("flat", "pairwise_l2_masked")])
def test_traced_engine_request_matches_untraced(small_ds, cpu_engine, route,
                                                kernel):
    ds = small_ds
    qlo, qhi = make_queries(ds, riv.ANY_OVERLAP, 0.15, seed=3)

    def req(trace):
        return SearchRequest(ds.queries, (qlo, qhi), riv.ANY_OVERLAP, k=10,
                             ef=32, route=route, fanout=2, trace=trace)
    plain = cpu_engine.execute(req(False))
    traced = cpu_engine.execute(req(True))
    np.testing.assert_array_equal(traced.ids, plain.ids)
    np.testing.assert_array_equal(traced.dists, plain.dists)
    assert plain.trace is None
    spans = [sp for sp, _ in traced.trace.walk()
             if sp.name == f"kernel:{kernel}"]
    assert spans and all(sp.args["impl"] == "plain" for sp in spans)
    if route == "graph":            # every step runs under a plan slot
        under_slots = set()
        for sp, _ in traced.trace.walk():
            if sp.name == "slot":
                under_slots.update(id(d) for d, _ in Trace([sp], 0).walk())
        assert all(id(sp) in under_slots for sp in spans)
        assert "kernel:gathered_l2" in traced.trace.span_names()


def test_profiler_capture_writes_a_chrome_trace(tmp_path):
    with obs.profiler_capture(str(tmp_path / "prof")) as cap:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert cap.ok and cap.error is None
    with open(cap.path) as f:
        assert "traceEvents" in json.load(f)


def test_profiler_capture_records_a_failure_and_does_not_raise(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    with obs.profiler_capture(os.path.join(str(blocker), "prof")) as cap:
        x = torch.ones(4).sum()
    assert float(x) == 4.0
    assert not cap.ok and cap.error
