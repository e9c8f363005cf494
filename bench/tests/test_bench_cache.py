"""The graph configuration's index cache: a changed configuration or build
source misses it, an unchanged one hits it, and a loaded index answers as
the freshly built one does."""
import json
import shutil

import numpy as np
import pytest

from bench import corpus as corpus_mod, system
from bench.tests.conftest import make_tiny_root

CFG = "sift50k-mstg"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("cache_root"))
    # a private copy of the build sources the key reads, so that one can
    # be changed without touching the program
    (root / "src").unlink()
    cfg = json.loads((root / "bench" / "configs" / f"{CFG}.json").read_text())
    for rel in cfg["index"]["cache"]["sources"]:
        dst = root / "src" / "repro_torch" / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(system.Path(__file__).resolve().parents[2] / "src"
                    / "repro_torch" / rel, dst)
    return root


def _setup(root):
    cfg = json.loads((root / "bench" / "configs" / f"{CFG}.json").read_text())
    corp = corpus_mod.make(cfg["corpus"], cfg["n"], cfg["d"],
                           cfg["corpus_seed"], "cpu")
    return cfg, corp


def _index(root, cfg, corp):
    said = []
    idx = system.index(root, cfg, corp, log=said.append)
    return idx, said


def test_cache_misses_on_change_and_hits_otherwise(root):
    cfg, corp = _setup(root)
    idx, said = _index(root, cfg, corp)
    assert any("built" in s for s in said) and any("saved" in s for s in said)
    _, said = _index(root, cfg, corp)
    assert said == [s for s in said if "loaded" in s] and said
    # a changed configuration file
    p = root / "bench" / "configs" / f"{CFG}.json"
    text = p.read_text()
    p.write_text(text.replace('"n":', '"note": "changed", "n":', 1))
    try:
        _, said = _index(root, cfg, corp)
        assert any("built" in s for s in said)
    finally:
        p.write_text(text)
    _, said = _index(root, cfg, corp)
    assert any("loaded" in s for s in said)
    # a changed build source of the program
    src = root / "src" / "repro_torch" / cfg["index"]["cache"]["sources"][0]
    code = src.read_text()
    src.write_text(code + "\n# changed\n")
    try:
        _, said = _index(root, cfg, corp)
        assert any("built" in s for s in said)
    finally:
        src.write_text(code)


def test_loaded_index_answers_as_the_built_one(root):
    from repro_torch.core import QueryEngine, SearchRequest
    cfg, corp = _setup(root)
    built, _ = _index(root, cfg, corp)
    loaded, said = _index(root, cfg, corp)
    assert any("loaded" in s for s in said)
    a, meta_a = built.to_payload()
    b, meta_b = loaded.to_payload()
    assert sorted(a) == sorted(b) and meta_a["variants"] == meta_b["variants"]
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
        assert a[key].dtype == b[key].dtype
    rng = np.random.default_rng(0)
    q = corp.vectors[rng.choice(corp.n, 16)] + 0.1
    ql = np.full(16, corp.grid[200])
    qh = np.full(16, corp.grid[600])
    for pred in ("Overlaps", "RightOverlap", "QueryContained"):
        req = SearchRequest(q, (ql, qh), system.predicate(pred), k=10,
                            route="graph")
        a = QueryEngine(built, device="cpu").execute(req)
        b = QueryEngine(loaded, device="cpu").execute(req)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)


def test_a_cached_index_of_another_corpus_is_built_again(root):
    cfg, corp = _setup(root)
    _index(root, cfg, corp)
    other = corpus_mod.make(cfg["corpus"], cfg["n"], cfg["d"], 1, "cpu")
    idx, said = _index(root, cfg, other)
    assert any("another corpus" in s for s in said)
    np.testing.assert_array_equal(idx.vectors, other.vectors)
