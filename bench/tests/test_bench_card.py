"""``bench/run.py`` as the checker runs it: without a card it exits
non-zero and prints no result; on a card (tests marked ``cuda``) a short
run of a cell comes out correct."""
import json
import subprocess
import sys

import pytest

from bench.tests.conftest import REPO


def _run(cell, seconds, trace=0):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         str(2**31 + 9), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=1200)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run("flat-1m-b256", 1)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("trace", (0, 1))
def test_flat_cell_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run("flat-1m-b256", 2, trace)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    want = "scan_roofline" if trace else "qps"
    assert want in line["metrics"]
