"""Run one cell of ``BENCHMARK.json`` once on the card.

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It makes the corpus and the traffic from
the seed, builds or loads the index, warms up every shape the traffic
uses, measures for ``--seconds`` (``--trace 1``: under ``torch.profiler``,
reporting the per-layer metrics instead of the end-to-end ones), compares
the window's answers with the plain reference and prints one JSON line.
It exits non-zero without a result when no CUDA card is present, when the
program cannot be imported, or when ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` was loaded.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / "bench" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from bench import harness
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    wl = harness.workload(spec, args.workload)
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA card: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < int(wl["chips"]):
        harness.log(f"{args.workload} needs {wl['chips']} cards, "
                    f"{torch.cuda.device_count()} present")
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        harness.log(f"the program is not importable: {e}")
        return 2
    result = harness.run_cell(ROOT, spec, wl, args.seed, args.seconds,
                              bool(args.trace), "cuda")
    found = harness.foreign_modules()
    if found:
        harness.log(f"loaded modules the benchmark must not load: {found}")
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
