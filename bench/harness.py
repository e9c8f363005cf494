"""One run of one cell: set-up, warm-up, the measured window, the
comparison with the plain reference, and the result line.

Everything a cell needs is found by name: its configuration in
``bench/configs/<config>.json``, its traffic mix in
``bench/traffic/<traffic>.json`` (whose ``generator`` and ``loop`` name a
module of ``bench/traffic/`` and ``bench/loops/``), and each metric of
``BENCHMARK.json`` in ``bench/metrics/<metric>.py``, whose ``read(rec)``
returns the metric from the run's record, or None where the run holds
nothing for it.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Callable, Optional

FOREIGN = ("jax", "jaxlib", "flax", "repro")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, prefix: str):
    """The module in ``path``, imported under a name of its own."""
    name = prefix + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def process_age_s() -> float:
    """Seconds since this process started (from ``/proc``), so set-up
    counts the interpreter's start and the imports too."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


_T0 = time.perf_counter()


def foreign_modules() -> list:
    """Top-level names of loaded modules that the benchmark must never
    load, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))


def run_cell(root: Path, spec: dict, wl: dict, seed: int, seconds: float,
             trace: bool, device, make_engine: Optional[Callable] = None
             ) -> dict:
    """Run ``wl`` once and return its result object. ``make_engine(engine,
    corpus)`` may put another engine in the program's place (the control,
    a planted fault)."""
    import torch
    from bench import compare, corpus as corpus_mod, profiling, system

    root = Path(root)
    cfg = load_json(root / "bench" / "configs" / f"{wl['config']}.json")
    mix = load_json(root / "bench" / "traffic" / f"{wl['traffic']}.json")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cseed = cfg.get("corpus_seed")
    corp = corpus_mod.make(cfg["corpus"], int(cfg["n"]), int(cfg["d"]),
                           seed if cseed is None else int(cseed), dev)
    gen = load_module(root / "bench" / "traffic" / f"{mix['generator']}.py",
                      "bench_gen_")
    traffic = gen.make(mix, corp, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    engine = system.engine(root, cfg, corp, dev, log=log)
    if make_engine is not None:
        engine = make_engine(engine, corp)
    loop_mod = load_module(root / "bench" / "loops" / f"{mix['loop']}.py",
                           "bench_loop_")
    loop = loop_mod.Loop(engine, traffic, mix)
    loop.warm()
    if cuda:
        torch.cuda.synchronize(dev)
    # what set-up made stays alive: keep the collector from walking it again
    # in the window, as a server process does once it has loaded
    gc.collect()
    gc.freeze()
    setup_s = process_age_s()
    log(f"set-up {setup_s:.2f} s; window {seconds} s")
    cap = None
    if trace:
        t_sec = min(float(seconds), float(mix.get("trace_seconds") or seconds))
        with profiling.Capture(dev) as cap:
            out = loop.run(t_sec)
        log(f"profile read in {cap.read_s:.1f} s")
        spans = loop.spans(int(mix.get("span_requests", 0)))
    else:
        out = loop.run(float(seconds))
        spans = []
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    items = loop.sample(out)
    del loop, engine
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    k = int(mix["k"])
    got = compare.judge(items, corp, k, dev,
                        recall_expected=mix.get("recall_expected"))
    check_s = time.perf_counter() - t_check
    limits = mix["limits"]
    correct = all(got[name] <= float(lim) for name, lim in limits.items())
    log(f"window {out['window_s']:.2f} s, {out['requests']} requests, "
        f"routes {out.get('routes')}, ms by predicate "
        f"{out.get('ms_by_predicate')}; compared {len(items)} answers in "
        f"{check_s:.1f} s, recall {got['recall']:.6f}")
    card = torch.cuda.get_device_name(dev) if cuda else "cpu"
    rec = dict(out)
    rec.update(setup_s=setup_s, recall=got["recall"], spans=spans,
               memory_peak_bytes=memory_peak, card=card, config=cfg, mix=mix,
               profile=cap.summary if cap is not None else None)
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        if "workloads" in m and wl["name"] not in m["workloads"]:
            continue
        reader = load_module(root / "bench" / "metrics" / f"{m['name']}.py",
                             "bench_metric_")
        v = reader.read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": card,
                   "count": int(wl["chips"]) if cuda else 0,
                   "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device_info}
    if trace and cap is not None and cap.summary:
        device_info["busy_s"] = cap.summary["busy_s"]
        device_info["window_s"] = cap.summary["window_s"]
        result["breakdown"] = profiling.breakdown(cap.summary)
    # a number that is not finite (a distance of +inf beside an id) is
    # printed as the largest finite float, so the line stays plain JSON
    result["checks"] = {name: [got[name] if math.isfinite(got[name])
                               else sys.float_info.max, float(lim)]
                        for name, lim in limits.items()}
    return result


def emit(result: dict) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line on standard output."""
    for name, (value, limit) in result["checks"].items():
        log(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
