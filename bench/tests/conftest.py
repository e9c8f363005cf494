"""Fixtures of the benchmark's own tests (run them with ``python -m pytest
bench/tests``; the repository's test run does not collect them).

``tiny_root`` is a copy of the benchmark in a temporary checkout whose
configurations and traffic mixes are cut to sizes the CPU runs in seconds:
the same files, read by the same harness, with fewer rows and queries.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (REPO / "src", REPO):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY_ROWS = {"sift1m-rr": 4000, "sift50k-mstg": 2000}
TINY_MIX = {"flat_b256": {"batch": 32, "pool": 10},
            # the beam's recall at this size (0.955-0.967 on three seeds)
            "graph_b16384": {"batch": 16, "pool": 5,
                             "recall_expected": 0.96},
            "pruned_b1024": {"batch": 32, "selectivity": {
                "law": "log_uniform", "low": 0.005, "high": 0.05,
                "tolerance": 0.1}},
            "open_single": {"rate_per_s": 300, "pool": 500,
                            "warm_seconds": 0.5, "check": {"queries": 200}}}


def make_tiny_root(dst: Path) -> Path:
    shutil.copytree(REPO / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("cache", "tests",
                                                  "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst)
    (dst / "src").symlink_to(REPO / "src")
    for name, n in TINY_ROWS.items():
        p = dst / "bench" / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        cfg["n"] = n
        cfg["index"].pop("build_workers", None)
        p.write_text(json.dumps(cfg, indent=1))
    for name, over in TINY_MIX.items():
        p = dst / "bench" / "traffic" / f"{name}.json"
        mix = json.loads(p.read_text())
        mix.update(over)
        p.write_text(json.dumps(mix, indent=1))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench_root"))


@pytest.fixture(scope="session")
def tiny_spec(tiny_root) -> dict:
    return json.loads((tiny_root / "BENCHMARK.json").read_text())
