"""Nothing under ``bench/`` loads ``jax``, ``jaxlib`` or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is not
``repro``), and the plain reference loads nothing of ``repro_torch``."""
import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

IMPORT_ALL = r"""
import sys
from pathlib import Path
root = Path(sys.argv[1]); tiny = Path(sys.argv[2])
sys.path[:0] = [str(root / "src"), str(root)]
from bench import harness
for sub in ("", "traffic", "loops", "metrics"):
    for f in sorted((root / "bench" / sub).glob("*.py")):
        harness.load_module(f, "bench_all_")
spec = harness.load_json(tiny / "BENCHMARK.json")
r = harness.run_cell(tiny, spec, harness.workload(spec, "flat-1m-b256"), 5,
                     0.3, False, "cpu")
assert r["correct"], r
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_bench_loads_no_jax_nor_repro(tiny_root):
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL, str(REPO),
                          str(tiny_root)], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(out.stdout.split())
    assert "repro_torch" in top             # the program ran
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import bench.reference, bench.compare, bench.corpus; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(out.stdout.split())
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    tree = ast.parse((REPO / "bench" / "reference.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "typing", "numpy", "torch"}


def test_foreign_modules_compares_whole_names():
    from bench import harness
    before = dict(sys.modules)
    base = set(harness.foreign_modules()) - {"repro"}
    try:
        sys.modules.pop("repro", None)
        sys.modules["repro_torch_like"] = sys
        assert set(harness.foreign_modules()) == base
        sys.modules["repro.core"] = sys
        assert set(harness.foreign_modules()) == base | {"repro"}
    finally:
        sys.modules.clear()
        sys.modules.update(before)
