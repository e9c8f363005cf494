"""The harness end to end on the CPU at tiny sizes, with the look for a
card skipped: new traffic and metric files are picked up by name, a sound
run comes out correct, and the control and each planted fault do not."""
import json

import numpy as np
import pytest

from bench import harness
from bench.control import Broken, ReferenceEngine
from bench.tests.conftest import REPO, make_tiny_root

CELLS = ("flat-1m-b256", "pruned-50k-b1024", "graph-50k-b16384",
         "served-1m-open")
SEED = 2**31 + 101


def _run(root, spec, cell, make_engine=None, trace=False, seconds=0.4):
    return harness.run_cell(root, spec, harness.workload(spec, cell), SEED,
                            seconds, trace, "cpu", make_engine=make_engine)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, tiny_spec, cell):
    r = _run(tiny_root, tiny_spec, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    names = set(r["metrics"])
    assert "setup_s" in names and "recall_at_10" in names
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ("half_batch", "altered_answer"))
def test_planted_fault_is_not_correct(tiny_root, tiny_spec, cell, fault):
    r = _run(tiny_root, tiny_spec, cell,
             make_engine=lambda e, c: Broken(e, c.n, fault))
    assert not r["correct"], r["checks"]


def test_beam_cut_to_k_fails_the_graph_cell(tiny_root, tiny_spec):
    """A sound answer of a worse search (the beam's list cut to k) is not
    correct: the graph cell holds its recall to ``recall_expected``."""
    cell = "graph-50k-b16384"
    sound = _run(tiny_root, tiny_spec, cell)
    r = _run(tiny_root, tiny_spec, cell,
             make_engine=lambda e, c: Broken(e, c.n, "beam_ef_k"))
    assert sound["checks"]["recall_gap"][0] < sound["checks"]["recall_gap"][1]
    assert not r["correct"], r["checks"]
    gap, limit = r["checks"]["recall_gap"]
    assert gap > limit
    for name in ("bad_ids", "short_share", "dist_err"):
        assert r["checks"][name][0] <= r["checks"][name][1]


@pytest.mark.parametrize("batch", (256, 1024, 16384))
def test_pruned_candidates_do_not_scale_with_the_batch(batch):
    """A slot bounds ``candidates`` rows for every query of the batch, so
    the reading is the summed caps of a request, whatever its batch."""
    reader = harness.load_module(
        REPO / "bench" / "metrics" / "pruned.candidates.py", "test_metric_")
    atom = [("plan", 0.1, {}), ("slot", 5.0, {"candidates": 50000})]
    overlaps = atom + [("slot", 5.0, {"candidates": 50000})]
    rec = {"mix": {"batch": batch}, "spans": [atom] * 4 + [overlaps]}
    assert reader.read(rec) == 60000.0
    assert reader.read({"mix": {"batch": batch}, "spans": [[]]}) is None


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, tiny_spec, cell):
    """The reference in TF32 in the program's place fails a limit."""
    r = _run(tiny_root, tiny_spec, cell,
             make_engine=lambda e, c: ReferenceEngine(c, "cpu"))
    assert not r["correct"], r["checks"]
    assert r["checks"]["dist_err"][0] > r["checks"]["dist_err"][1]


# what a traced run of the tiny cells on the CPU can read: spans and
# counters, no device time; no wavefront_totals span below the chunked
# driver's 64 rows, and no 95th percentile of fewer than 200 queries
TRACED = {"flat-1m-b256": set(),
          "pruned-50k-b1024": {"plan_ms", "pruned.candidates"},
          "graph-50k-b16384": {"plan_ms"},
          "served-1m-open": {"serving.fill"}}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics_only(tiny_root, tiny_spec, cell):
    r = _run(tiny_root, tiny_spec, cell, trace=True)
    assert r["correct"]
    assert set(r["metrics"]) == TRACED[cell]
    assert "window_s" in r["device"] and "breakdown" in r


def test_new_traffic_and_metric_files_are_picked_up(tmp_path):
    """A throwaway traffic mix and metric, added as files and entries in
    BENCHMARK.json of a copy, run without an edit to the harness."""
    root = make_tiny_root(tmp_path)
    mix = json.loads((root / "bench/traffic/flat_b256.json").read_text())
    mix.update(batch=8, pool=5, predicates=["QueryContaining"])
    (root / "bench/traffic/throwaway_mix.json").write_text(json.dumps(mix))
    (root / "bench/metrics/throwaway.requests.py").write_text(
        "def read(rec):\n    return rec['requests']\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "throwaway-cell", "config": "sift1m-rr",
                              "traffic": "throwaway_mix", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "throwaway.requests", "unit": "1",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["throwaway-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = harness.run_cell(root, spec, harness.workload(spec, "throwaway-cell"),
                         3, 0.3, False, "cpu")
    assert r["correct"]
    assert r["metrics"]["throwaway.requests"]["value"] >= 1
    for f in ("run.py", "harness.py"):
        assert ((root / "bench" / f).read_bytes()
                == (REPO / "bench" / f).read_bytes())
