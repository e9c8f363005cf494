"""``BENCHMARK.json`` against the limits its checker holds it to, and every
name in it backed by the file the harness finds it by."""
import json
import math
import re

import pytest

from bench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per_token|^d$")


@pytest.fixture(scope="module")
def spec():
    raw = (REPO / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    return json.loads(raw)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir()
    assert 1 <= len(spec["command"]) <= 32
    assert all(_line(w) for w in spec["command"])
    for w in spec["command"]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in spec["paths"])
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51


def test_a_full_check_fits_with_24_cells(spec):
    runs = 2 + 14 * 24
    total = runs * (spec["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_configs(spec):
    cfgs = spec["configs"]
    assert 1 <= len(cfgs) <= 24
    assert len({c["name"] for c in cfgs}) == len(cfgs)
    assert len({c["file"] for c in cfgs}) == len(cfgs)
    used = {w["config"] for w in spec["workloads"]}
    for c in cfgs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"bench/configs/{c['name']}.json"
        body = json.loads((REPO / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key)


def test_workloads(spec):
    ws = spec["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    four = sum(w["chips"] == 4 for w in ws)
    assert four <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (REPO / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / "bench" / "configs" / f"{w['config']}.json").is_file()
        mix = json.loads((REPO / "bench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert (REPO / "bench" / "loops" / f"{mix['loop']}.py").is_file()
        assert (REPO / "bench" / "traffic"
                / f"{mix['generator']}.py").is_file()
        assert mix["limits"]


def _cells(metric, spec):
    return set(metric.get("workloads", [w["name"] for w in spec["workloads"]]))


def test_metrics(spec):
    e2e, layers = spec["end_to_end"], spec["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    names = [m["name"] for m in e2e + layers]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in spec["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    by_name = {m["name"]: m for m in e2e}
    for m in layers:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in by_name
        assert _cells(m, spec) <= _cells(by_name[m["moves"]], spec)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert _cells(m, spec) <= cells
        assert (REPO / "bench" / "metrics" / f"{m['name']}.py").is_file()
    layer_names = {}
    for m in layers:
        layer_names.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layer_names.values())


def test_every_cell_reports_enough(spec):
    for w in spec["workloads"]:
        e2e = [m for m in spec["end_to_end"] if w["name"] in _cells(m, spec)]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in _cells(m, spec) for m in spec["per_layer"])


def test_bounds_are_finite(spec):
    assert all(math.isfinite(m["bound"]) for m in spec["end_to_end"])
