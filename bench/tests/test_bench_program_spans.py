"""``bench/program_spans.py``: the idle gaps of a profiled window named by
the port's spans, on synthetic profiler events, the readers of the metrics
it feeds, and a traced window of each tiny cell with the spans on."""
import pytest
import torch

from bench import harness, profiling, program_spans
from bench.tests.conftest import REPO

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
US = 1000                                   # ns


class Ev:
    """The slice of a kineto event that the summaries read."""

    def __init__(self, name, s, t, device=False):
        self._n, self._s, self._t = name, s, t
        self._d = CUDA if device else CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._t

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return False


def _kernel(s, t):
    return Ev("kernel_a", s * US, t * US, device=True)


def _call(name, s, t):
    return Ev(name, s * US, t * US)


def _span(name, s, t, depth, args=None):
    return (name, s * US, t * US, depth, args or {})


# a window of 0-1000 us: kernels at 100-200, 300-400, 600-700; gaps
# 0-100 (under no span), 200-300 (under a sync call inside to_host),
# 400-600 (under topk inside flat inside search) and 700-1000 (under
# search alone)
EVENTS = [_kernel(100, 200), _kernel(300, 400), _kernel(600, 700),
          _call("cudaLaunchKernel", 95, 99),
          _call("cudaStreamSynchronize", 210, 295)]
SPANS = [_span("search", 90, 900, 0), _span("flat", 91, 690, 1),
         _span("to_host", 205, 298, 2), _span("topk", 410, 590, 2)]


def _both(events, spans):
    return (profiling.summarise(events, 0, 1000 * US),
            program_spans.summarise(events, 0, 1000 * US, spans))


def test_gaps_named_by_call_then_innermost_span_then_no_op():
    _, got = _both(EVENTS, SPANS)
    idle = got["idle_s"]
    assert idle["cudaStreamSynchronize"] == pytest.approx(100e-6)
    assert idle["span:topk"] == pytest.approx(200e-6)
    assert idle["span:search"] == pytest.approx(300e-6)
    assert idle["host (no op)"] == pytest.approx(100e-6)
    table = got["program"]["spans"]
    assert table["to_host"]["idle_ms"] == pytest.approx(0.1)  # its call's gap
    assert table["to_host"]["syncs"] == 1
    assert got["program"]["syncs"] == 1
    assert table["flat"]["idle_ms"] == 0 and table["flat"]["count"] == 1
    assert table["search"]["host_ms"] == pytest.approx(0.81)


def test_totals_and_runtime_buckets_are_unchanged_by_the_spans():
    base, got = _both(EVENTS, SPANS)
    for key in ("window_s", "busy_s", "kernel_s", "kernels"):
        assert got[key] == base[key]
    assert sum(got["idle_s"].values()) == pytest.approx(
        sum(base["idle_s"].values()))
    named = {k: v for k, v in got["idle_s"].items()
             if k.startswith("span:") or k == "host (no op)"}
    assert sum(named.values()) == pytest.approx(base["idle_s"]["host (no op)"])
    for k, v in base["idle_s"].items():
        if k != "host (no op)":
            assert got["idle_s"][k] == v
    assert program_spans.summarise(EVENTS, 0, 1000 * US)["idle_s"] \
        == base["idle_s"]


def test_an_outer_span_far_behind_is_still_found():
    """A gap under a ``round`` that began 300 launches earlier: the
    runtime calls' 256-event search finds nothing, the nesting does."""
    events = [_call("cudaLaunchKernel", 10 + 2 * i, 11 + 2 * i)
              for i in range(300)]
    events += [_kernel(0, 700), _kernel(900, 1000)]
    spans = [_span("round", 5, 950, 0)]
    base, got = _both(events, spans)
    assert base["idle_s"] == pytest.approx({"host (no op)": 200e-6})
    assert got["idle_s"] == pytest.approx({"span:round": 200e-6})


def test_round_ms_is_the_round_less_its_searches():
    spans = [_span("round", 0, 500, 0), _span("admission", 10, 480, 1),
             _span("search", 20, 220, 2), _span("search", 230, 430, 2),
             _span("round", 600, 650, 0)]             # no search: not counted
    got = program_spans.summarise([_kernel(0, 1000)], 0, 1000 * US, spans)
    assert got["program"]["round_ms"] == pytest.approx([0.1])


def test_clock_check_finds_each_kernel_spans_launch():
    host = [(100 * US, 104 * US, "cudaLaunchKernel"),
            (300 * US, 310 * US, "cuLaunchKernelEx"),
            (500 * US, 510 * US, "cudaMemcpyAsync")]
    spans = [_span("kernel:a", 99, 105, 0), _span("kernel:b", 301, 320, 0),
             _span("kernel:c", 5000, 5010, 0), _span("stage", 99, 105, 0)]
    got = program_spans.clock_check(host, spans)
    assert got == {"spans": 2, "inside": 1, "no_launch": 1, "worst_us": 1.0}


def _reader(name):
    return harness.load_module(REPO / "bench" / "metrics" / f"{name}.py",
                               "test_metric_")


def test_metric_readers_on_a_record():
    _, summary = _both(EVENTS, SPANS)
    rec = {"profile": summary, "requests": 4}
    # idle under any span: the sync's 100 us, topk's 200, search's 300
    for name in ("idle.program_batch", "idle.program_served"):
        assert _reader(name).read(rec) == pytest.approx(60.0)
    assert _reader("host.syncs").read(rec) == pytest.approx(0.25)
    assert _reader("serving.round_ms").read(rec) is None     # no round
    summary["program"]["round_ms"] = [0.5, 1.5]
    assert _reader("serving.round_ms").read(rec) == pytest.approx(1.0)
    # a profile without the program's spans (the harness's own capture)
    bare = {"profile": profiling.summarise(EVENTS, 0, 1000 * US),
            "requests": 4}
    for name in ("idle.program_batch", "idle.program_served", "host.syncs",
                 "serving.round_ms"):
        assert _reader(name).read(bare) is None
        assert _reader(name).read({"profile": None, "requests": 4}) is None


CELLS = ("flat-1m-b256", "pruned-50k-b1024", "graph-50k-b16384",
         "served-1m-open")


@pytest.mark.parametrize("cell", CELLS)
def test_traced_window_reports_the_span_metrics_of_its_loop(tiny_root,
                                                             tiny_spec, cell):
    wl = harness.workload(tiny_spec, cell)
    r = program_spans.run(tiny_root, tiny_spec, wl, 2**31 + 7, 0.4, "cpu")
    loop = "open" if cell.startswith("served") else "closed"
    assert set(r["metrics"]) == set(program_spans.METRICS[loop])
    assert r["requests"] > 0 and r["failed"] == 0
    table = r["program"]["spans"]
    assert table["search"]["count"] >= 1 and "stage" in table
    if loop == "open":
        assert table["round"]["count"] >= 1
    off = program_spans.run(tiny_root, tiny_spec, wl, 2**31 + 7, 0.4, "cpu",
                            spans=False)
    assert off["metrics"] == {} and off["program"] == {}
