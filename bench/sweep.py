"""The rate sweep of an open-loop cell: the highest rate it sustains.

    python bench/sweep.py --workload served-1m-open --seed 7 --seconds 8 \
        --rates 4000 5000 6000

One set-up, then for each rate a window of ``--seconds`` at that rate on a
fresh server: offered and answered queries, the backlog when the window
closed, how long it took to drain, and the latency percentiles. A rate is
sustained where the backlog stays near one round and every query is
answered. The cell's ``rate_per_s`` is fixed at about four fifths of the
highest sustained rate.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from bench import corpus as corpus_mod, harness, system
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    wl = harness.workload(spec, args.workload)
    bench = ROOT / "bench"
    cfg = harness.load_json(bench / "configs" / f"{wl['config']}.json")
    mix = harness.load_json(bench / "traffic" / f"{wl['traffic']}.json")
    dev = torch.device("cuda")
    cseed = cfg.get("corpus_seed")
    corp = corpus_mod.make(cfg["corpus"], int(cfg["n"]), int(cfg["d"]),
                           args.seed if cseed is None else int(cseed), dev)
    gen = harness.load_module(ROOT / "bench" / "traffic"
                              / f"{mix['generator']}.py", "bench_gen_")
    traffic = gen.make(mix, corp, args.seed, dev)
    engine = system.engine(ROOT, cfg, corp, dev, log=harness.log)
    loop = harness.load_module(ROOT / "bench" / "loops" / f"{mix['loop']}.py",
                               "bench_loop_").Loop(engine, traffic, mix)
    loop.warm()
    for rate in args.rates:
        mix["rate_per_s"] = rate
        out = loop.run(args.seconds)
        lat = np.asarray(out["latency_ms"])
        print(json.dumps({
            "rate_per_s": rate, "offered": out["attempted"],
            "answered": out["queries_answered"], "failed": out["failed"],
            "answered_per_s": out["queries_answered"] / out["window_s"],
            "backlog_at_close": out["backlog_at_close"],
            "drain_s": out["drain_s"],
            "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
            "p95_ms": float(np.percentile(lat, 95)) if lat.size else None,
            "p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
            "late_p95_ms": float(np.percentile(out["late_ms"], 95)),
            "fill": 100.0 * sum(out["dispatched"]) / max(
                1, len(out["dispatched"]) * out["max_batch"]),
            "card": torch.cuda.get_device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
