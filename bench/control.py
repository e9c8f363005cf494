"""The control of ``correct``, and the readings its limits are set from.

    python bench/control.py --workload <name> --seeds 1 2 3 \
        [--program | --fault <name>]

For each seed it runs the cell as ``bench/run.py`` does, with the plain
reference computed in TF32 (the nearest precision below the float32 that
the configurations state) put in the program's place, and prints the
compared numbers: the control has to fail one of them. With ``--program``
it runs the program itself on the same seeds instead: the lower readings.
With ``--fault`` it runs the program with one of :data:`FAULTS` planted
(:class:`Broken`): the readings of that fault. Every seed runs in this one
process. The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


class ReferenceEngine:
    """``execute(SearchRequest)`` answered by the plain reference at
    ``precision``, over the corpus the harness made."""

    def __init__(self, corpus, device, precision: str = "tf32"):
        import torch
        from bench.reference import PREDICATES
        from bench.system import predicate
        self.corpus = corpus
        self.device = torch.device(device)
        self.precision = precision
        self.names = {predicate(p).mask: p for p in PREDICATES}
        self.X = torch.as_tensor(corpus.vectors, device=self.device)
        self.lo = torch.as_tensor(corpus.lo, device=self.device)
        self.hi = torch.as_tensor(corpus.hi, device=self.device)

    def execute(self, req):
        import torch
        from bench import reference
        dev = self.device
        ids, d, _ = reference.exact_topk(
            self.X, self.lo, self.hi, torch.as_tensor(req.vectors, device=dev),
            torch.as_tensor(req.qlo, device=dev),
            torch.as_tensor(req.qhi, device=dev), self.names[req.mask],
            req.k, precision=self.precision)
        return types.SimpleNamespace(
            ids=ids.astype(np.int32), dists=d.astype(np.float32),
            report=types.SimpleNamespace(route=f"reference-{self.precision}"))


FAULTS = ("half_batch", "altered_answer", "beam_ef_k")


class Broken:
    """The program's engine with a fault planted:

    * ``half_batch``      half of the batch left out (its rows empty); a
      single query drops out every other request;
    * ``altered_answer``  the first id of a request altered where it is
      produced;
    * ``beam_ef_k``       the beam search's list cut to k (``ef = k``): a
      sound answer of a worse search, for the graph cell's recall.
    """

    def __init__(self, engine, n: int, fault: str):
        if fault not in FAULTS:
            raise ValueError(f"no fault {fault!r}; one of {FAULTS}")
        self.engine, self.n, self.fault = engine, n, fault
        self.drop = False

    def execute(self, req):
        if self.fault == "beam_ef_k":
            return self.engine.execute(dataclasses.replace(req, ef=req.k))
        res = self.engine.execute(req)
        ids = np.array(res.ids)
        d = np.array(res.dists)
        if self.fault == "half_batch":
            self.drop = not self.drop
            h = ids.shape[0] // 2 if ids.shape[0] > 1 else int(self.drop)
            ids[ids.shape[0] - h:] = -1
            d[ids.shape[0] - h:] = np.inf
        else:
            ids[0, 0] = (ids[0, 0] + 1) % self.n
        return dataclasses.replace(res, ids=ids, dists=d)

    def __getattr__(self, name):
        return getattr(self.engine, name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    side = ap.add_mutually_exclusive_group()
    side.add_argument("--program", action="store_true",
                      help="run the program instead of the control")
    side.add_argument("--fault", choices=FAULTS,
                      help="run the program with this fault planted")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from bench import harness
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    wl = harness.workload(spec, args.workload)
    make, name = None, "program"
    if args.fault:
        name = f"fault-{args.fault}"

        def make(engine, corpus):
            return Broken(engine, corpus.n, args.fault)
    elif not args.program:
        name = "control"

        def make(engine, corpus):
            return ReferenceEngine(corpus, args.device)
    for seed in args.seeds:
        r = harness.run_cell(ROOT, spec, wl, seed, args.seconds, False,
                             args.device, make_engine=make)
        print(json.dumps({"workload": wl["name"], "seed": seed,
                          "side": name,
                          "correct": r["correct"], "checks": r["checks"],
                          "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
