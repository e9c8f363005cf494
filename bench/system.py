"""The system under test: ``repro_torch``'s MSTG index over the harness's
corpus and a ``QueryEngine`` in front of it.

A configuration whose ``index`` has ``"cache": {"sources": [...]}`` keeps
its built index under ``bench/cache/index/``, keyed by a hash of the
configuration file, the corpus recipe, this file and the listed build
sources of the port: the first run in a checkout builds and saves it, every
later run loads it, and a loaded index whose corpus is not the one this run
made is built again.

The cache holds the index's own payload (``MSTGIndex.to_payload``), with
the labeled graphs' dense ``(Lv, n, S)`` arrays packed to their live
entries: a graph's widest row sets S for every row (~590 at 50,000 rows,
against ~10 live edges a row), so the dense file of the three variants is
11.7 GB and the packed one a few hundred MB. Loading unpacks them exactly
and hands them to ``MSTGIndex.from_payload``.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

CACHE = Path("bench") / "cache" / "index"
_SPEC_KEYS = ("variants", "m", "ef_con", "m_max", "n_entries", "builder",
              "batch_size", "candidate_stage", "n_clusters", "n_probe",
              "coarse_threshold")


def predicate(name: str):
    """The program's predicate object of that name (``Overlaps`` ...)."""
    from repro_torch.core import predicates
    return getattr(predicates, name)()


_PACKED = ("nbr", "lab_b", "lab_e")
_META = "@meta"


def save_index(idx, path: Path) -> None:
    """``idx``'s payload to one ``.npz``, each variant's graph arrays packed
    to the entries where ``nbr`` holds an edge (where every other entry
    holds one fill value; otherwise they are kept dense)."""
    arrays, meta = idx.to_payload()
    out = {}
    for v in meta["variants"]:
        live = arrays[f"{v}.nbr"] >= 0
        dense = {f: arrays[f"{v}.{f}"] for f in _PACKED}
        fills = {f: a[~live] for f, a in dense.items()}
        if not all(x.size == 0 or (x == x.flat[0]).all()
                   for x in fills.values()):
            continue
        out[f"{v}@pos"] = np.flatnonzero(live)
        for f, a in dense.items():
            del arrays[f"{v}.{f}"]
            out[f"{v}.{f}@shape"] = np.asarray(a.shape, np.int64)
            out[f"{v}.{f}@fill"] = (fills[f][:1] if fills[f].size
                                    else np.zeros(1, a.dtype))
            out[f"{v}.{f}@live"] = a[live]
    out.update(arrays)
    out[_META] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **out)
    os.replace(tmp, path)


def load_index(path: Path):
    """The index :func:`save_index` wrote, every array as it was."""
    from repro_torch.core import MSTGIndex
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    meta = json.loads(data.pop(_META).tobytes().decode())
    arrays = {}
    for key, a in data.items():
        if key.endswith("@live"):
            base = key[:-len("@live")]
            v = base.rpartition(".")[0]
            full = np.full(tuple(data[base + "@shape"]),
                           data[base + "@fill"][0], dtype=a.dtype)
            full.reshape(-1)[data[v + "@pos"]] = a
            arrays[base] = full
        elif "@" not in key:
            arrays[key] = a
    return MSTGIndex.from_payload(arrays, meta, path=str(path))


def cache_key(root: Path, config_name: str, sources) -> str:
    h = hashlib.sha256()
    for rel in [f"bench/configs/{config_name}.json", "bench/corpus.py",
                "bench/system.py"] + [
            f"src/repro_torch/{s}" for s in sources]:
        h.update(rel.encode())
        h.update((root / rel).read_bytes())
    return h.hexdigest()[:16]


def _same_corpus(idx, corpus) -> bool:
    return (np.array_equal(idx.vectors, corpus.vectors)
            and np.array_equal(idx.lo, corpus.lo)
            and np.array_equal(idx.hi, corpus.hi))


def index(root: Path, cfg: dict, corpus, log=print):
    """Build the configuration's index over ``corpus``, or load it from the
    cache where the configuration keeps one."""
    from repro_torch.core import IndexSpec, MSTGIndex
    spec_cfg = cfg["index"]
    spec = IndexSpec(predicate=predicate(spec_cfg["predicate"]),
                     **{k: spec_cfg[k] for k in _SPEC_KEYS if k in spec_cfg})
    workers = int(spec_cfg.get("build_workers", 0))
    cache = spec_cfg.get("cache")
    path = None
    if cache is not None:
        key = cache_key(root, cfg["name"], cache["sources"])
        path = root / CACHE / f"{cfg['name']}-{key}.npz"
        if path.exists():
            idx = load_index(path)
            if _same_corpus(idx, corpus):
                log(f"index: loaded {path.name}")
                return idx
            log(f"index: {path.name} holds another corpus; building again")
    idx = MSTGIndex.build(spec, corpus.vectors, corpus.lo, corpus.hi,
                          workers=workers)
    secs = {k: round(v, 1) for k, v in idx.build_seconds.items()}
    log(f"index: built in {sum(secs.values()):.1f} s ({json.dumps(secs)})")
    if path is not None:
        save_index(idx, path)
        log(f"index: saved {path.name}")
    return idx


def engine(root: Path, cfg: dict, corpus, device, log=print):
    from repro_torch.core import EngineConfig, QueryEngine
    idx = index(root, cfg, corpus, log=log)
    return QueryEngine(idx, EngineConfig(**cfg.get("engine", {})),
                       device=device)
