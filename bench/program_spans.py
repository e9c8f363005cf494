"""The port's own spans inside the traced window, on the profiler's clock.

:class:`SpanCapture` is :class:`bench.profiling.Capture` with the program's
window capture (``repro_torch.obs.capture(timeline=True)``) open inside the
profiler: every span the port opens in the window is kept, on the epoch
clock of the profiler's events, and no span waits for the card, so the
window's requests run as untraced ones do. :func:`summarise` is
:func:`bench.profiling.summarise` with the program's spans beside the
profiler's events, in a list of their own:

* a gap whose middle a CUDA runtime call covers keeps that call's name, as
  there (the same 256-event search, so every runtime-call bucket, the total
  idle and ``busy_s`` read the same with and without spans);
* any other gap takes the innermost span of the port that covers its middle,
  as ``span:<name>``, found through the spans' nesting and not a window of
  recent events, since a ``round`` or ``search`` span can hold thousands of
  launches;
* a gap under no span stays ``host (no op)``: outside the port, in the
  benchmark's loop or the open loop's empty polls.

``summary["program"]``, where the window holds a span, has per span name
its ``count``, its host ``host_ms``, the ``idle_ms`` of the gaps it is the
innermost span over (whatever names the gap), and the ``syncs``:
host-blocking runtime calls (:data:`SYNC_CALLS`) it is the innermost span
over; besides them each dispatching round's own ms (``round_ms``: a
``round`` span less the ``search`` spans inside it) and the clock check
(:func:`clock_check`).

The per-layer metrics read from it are in ``bench/metrics/`` (their
functions below): ``idle.program_batch``, ``idle.program_served``,
``serving.round_ms`` and ``host.syncs``. Run one cell with the spans on or
off and print them, with the window's requests and tail:

    python3 bench/program_spans.py --workload <cell> --seed <n> \\
        --seconds <s> [--spans 0|1]
"""
from __future__ import annotations

import argparse
import bisect
import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from bench import profiling  # noqa: E402

NO_OP = "host (no op)"
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize"})
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
# the per-layer metrics of the spans, by the cell's loop
METRICS = {"closed": ("idle.program_batch", "host.syncs"),
           "open": ("idle.program_served", "serving.round_ms")}
# a kernel span's launch is looked for this far around it (ns)
_LAUNCH_REACH = 1_000_000


class SpanCapture(profiling.Capture):
    """``with SpanCapture(device) as cap: <window>``; afterwards
    ``cap.summary`` as :func:`summarise` gives it. ``spans=False`` opens no
    window capture: the profiler alone, as the harness's capture."""

    def __init__(self, device, spans: bool = True):
        super().__init__(device)
        self.with_spans = spans
        self.spans: list = []
        self._obs = None

    def __enter__(self) -> "SpanCapture":
        super().__enter__()
        if self.with_spans:
            from repro_torch import obs
            self._obs = obs.capture(timeline=True)
            self._tracer = self._obs.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._obs is not None:
            self._obs.__exit__(*exc)
            self.spans = self._tracer.spans()
            self._obs = self._tracer = None
        if self.cuda:
            torch.cuda.synchronize()
        w1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        if exc[0] is None:
            t0 = time.perf_counter()
            self.summary = summarise(
                self._prof.profiler.kineto_results.events(), self._w0, w1,
                self.spans)
            self.read_s = time.perf_counter() - t0
        self._prof = None
        return False


class _Nest:
    """Spans in start order (:meth:`repro_torch.obs.Tracer.spans`) and the
    innermost one over a point, through each span's parent."""

    def __init__(self, spans: Sequence[tuple]):
        self.spans = spans
        self.starts = [sp[1] for sp in spans]
        self.ends = [sp[2] for sp in spans]
        self.parent: List[int] = []
        open_at: List[int] = []             # the open span at each depth
        for i, sp in enumerate(spans):
            del open_at[sp[3]:]
            self.parent.append(open_at[-1] if open_at else -1)
            open_at.append(i)

    def innermost(self, t: int) -> int:
        """Index of the innermost span with start <= t < end, or -1."""
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.ends[j] <= t:
            j = self.parent[j]
        return j


def summarise(events, w0: int, w1: int, spans: Sequence[tuple] = ()) -> dict:
    """:func:`bench.profiling.summarise` of ``events`` over [w0, w1], with
    the idle gaps that no runtime call covers named by ``spans`` (epoch ns,
    as ``Tracer.spans()`` gives them), and ``"program"`` beside it."""
    dev: List[Tuple[int, int]] = []
    kernel_s: Dict[str, float] = {}
    kernels = 0
    host: List[Tuple[int, int, str]] = []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if profiling._is_device(e):
            if profiling._is_annotation(e):
                continue
            s, t = max(s, w0), min(t, w1)
            if t <= s:
                continue
            dev.append((s, t))
            name = e.name()
            kernel_s[name] = kernel_s.get(name, 0.0) + (t - s) / 1e9
            if not name.startswith(("Memcpy", "Memset")):
                kernels += 1
        elif t > w0 and s < w1:
            host.append((s, t, e.name()))
    busy = profiling._union(dev)
    gaps: List[Tuple[int, int]] = []
    cur = w0
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if cur < w1:
        gaps.append((cur, w1))
    host.sort()
    nest = _Nest(spans)
    table: Dict[str, dict] = {}
    for name, s, t, _, _ in spans:
        row = table.setdefault(name, {"count": 0, "host_ms": 0.0,
                                      "idle_ms": 0.0, "syncs": 0})
        row["count"] += 1
        row["host_ms"] += (t - s) / 1e6
    idle_s = _name_gaps(gaps, host, nest, table)
    syncs = 0
    for s, t, name in host:
        if name in SYNC_CALLS:
            j = nest.innermost((s + t) // 2)
            if j >= 0:
                table[spans[j][0]]["syncs"] += 1
                syncs += 1
    out = {"window_s": (w1 - w0) / 1e9,
           "busy_s": sum(t - s for s, t in busy) / 1e9,
           "kernel_s": kernel_s, "kernels": kernels, "idle_s": idle_s}
    if spans:
        out["program"] = {"spans": table, "syncs": syncs,
                          "round_ms": round_ms(spans, nest),
                          "clock": clock_check(host, spans)}
    return out


def _name_gaps(gaps, host, nest: _Nest, table: Dict[str, dict]
               ) -> Dict[str, float]:
    """Idle seconds by the innermost runtime call over each gap's middle
    (:func:`bench.profiling._name_gaps`'s search), else ``span:<name>`` of
    the innermost span over it, else ``host (no op)``; each gap's ms also
    goes to that span's ``idle_ms`` in ``table``."""
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    for s, t in gaps:
        mid = (s + t) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = None
        for k in range(i, max(i - 256, -1), -1):
            if host[k][1] > mid:
                name = host[k][2]
                break
        j = nest.innermost(mid)
        if j >= 0:
            table[nest.spans[j][0]]["idle_ms"] += (t - s) / 1e6
        if name is None:
            name = f"span:{nest.spans[j][0]}" if j >= 0 else NO_OP
        out[name] = out.get(name, 0.0) + (t - s) / 1e9
    return out


def round_ms(spans: Sequence[tuple], nest: _Nest) -> List[float]:
    """Each dispatching round's own host ms: a ``round`` span that holds a
    ``search`` span, less the ``search`` spans inside it."""
    searched: Dict[int, int] = {}
    for i, sp in enumerate(spans):
        if sp[0] != "search":
            continue
        j = nest.parent[i]
        while j >= 0 and spans[j][0] != "round":
            j = nest.parent[j]
        if j >= 0:
            searched[j] = searched.get(j, 0) + sp[2] - sp[1]
    return [(spans[j][2] - spans[j][1] - ns) / 1e6
            for j, ns in sorted(searched.items())]


def clock_check(host, spans: Sequence[tuple]) -> dict:
    """Each ``kernel:<name>`` span against the launch call nearest it
    (``cudaLaunchKernel*`` / ``cuLaunchKernel*``): how many hold theirs
    whole, and the widest stretch of a launch outside its span, in us.
    Spans with no launch within a millisecond are counted apart."""
    launches = sorted((s, t) for s, t, name in host
                      if name.startswith(LAUNCH_CALLS))
    starts = [s for s, _ in launches]
    checked = inside = alone = 0
    worst = 0
    for name, s, t, _, _ in spans:
        if not name.startswith("kernel:"):
            continue
        lo = bisect.bisect_left(starts, s - _LAUNCH_REACH)
        hi = bisect.bisect_right(starts, t + _LAUNCH_REACH)
        if lo == hi:
            alone += 1
            continue
        off = min(max(s - a, b - t, 0) for a, b in launches[lo:hi])
        checked += 1
        inside += off == 0
        worst = max(worst, off)
    return {"spans": checked, "inside": inside, "no_launch": alone,
            "worst_us": worst / 1e3}


# ---- the per-layer metrics (bench/metrics/<name>.py read them) --------------

def _program(rec: dict) -> Optional[dict]:
    prof = rec.get("profile")
    return prof.get("program") if prof else None


def program_idle_percent(rec: dict) -> Optional[float]:
    """Share of the window with nothing on the card while the host was
    inside a span of the port, in percent."""
    prog = _program(rec)
    if prog is None or not rec["profile"]["window_s"]:
        return None
    idle_ms = sum(row["idle_ms"] for row in prog["spans"].values())
    return 100.0 * idle_ms / 1e3 / rec["profile"]["window_s"]


def mean_round_ms(rec: dict) -> Optional[float]:
    prog = _program(rec)
    rounds = prog["round_ms"] if prog else None
    return sum(rounds) / len(rounds) if rounds else None


def syncs_per_request(rec: dict) -> Optional[float]:
    """Host-blocking runtime calls under the port's spans in the window,
    per request run there."""
    prog = _program(rec)
    if prog is None or not rec.get("requests"):
        return None
    return prog["syncs"] / rec["requests"]


# ---- one cell with the spans on or off ---------------------------------------

def run(root: Path, spec: dict, wl: dict, seed: int, seconds: float, device,
        spans: bool = True) -> dict:
    """The traced window of ``wl`` as ``bench/harness.py`` sets it up (the
    same corpus, traffic, engine, loop and warm-up), under
    :class:`SpanCapture`; the window's requests, failures and tail, the
    idle by name, the span table and the metrics of :data:`METRICS` for
    the cell's loop. The answers are not compared (the harness does that)."""
    from bench import corpus as corpus_mod, harness, records, system
    root = Path(root)
    cfg = harness.load_json(root / "bench" / "configs" / f"{wl['config']}.json")
    mix = harness.load_json(root / "bench" / "traffic" / f"{wl['traffic']}.json")
    dev = torch.device(device)
    cseed = cfg.get("corpus_seed")
    corp = corpus_mod.make(cfg["corpus"], int(cfg["n"]), int(cfg["d"]),
                           seed if cseed is None else int(cseed), dev)
    gen = harness.load_module(
        root / "bench" / "traffic" / f"{mix['generator']}.py", "bench_gen_")
    traffic = gen.make(mix, corp, seed, dev)
    engine = system.engine(root, cfg, corp, dev, log=harness.log)
    loop_mod = harness.load_module(
        root / "bench" / "loops" / f"{mix['loop']}.py", "bench_loop_")
    loop = loop_mod.Loop(engine, traffic, mix)
    loop.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gc.collect()
    gc.freeze()
    t_sec = min(float(seconds), float(mix.get("trace_seconds") or seconds))
    with SpanCapture(dev, spans=spans) as cap:
        out = loop.run(t_sec)
    gc.unfreeze()
    rec = dict(out, profile=cap.summary)
    prof = cap.summary
    result = {"workload": wl["name"], "seed": seed, "spans": bool(spans),
              "card": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "requests": int(out["requests"]), "failed": int(out["failed"]),
              "p95_ms": records.p95(out["latency_ms"]),
              "window_s": prof["window_s"], "busy_s": prof["busy_s"],
              "idle_share": (1.0 - prof["busy_s"] / prof["window_s"]
                             if prof["window_s"] else None),
              "read_s": cap.read_s, "metrics": {}}
    for name in METRICS[mix["loop"]]:
        reader = harness.load_module(root / "bench" / "metrics" / f"{name}.py",
                                     "bench_metric_")
        v = reader.read(rec)
        if v is not None:
            result["metrics"][name] = float(v)
    result["idle_gaps"] = sorted(prof["idle_s"].items(), key=lambda kv: -kv[1])
    result["program"] = {k: v for k, v in prof.get("program", {}).items()
                         if k != "round_ms"}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    from bench import harness, run as bench_run
    if not torch.cuda.is_available():
        harness.log("no CUDA card: the window is measured on the card only")
        return 2
    bench_run._caches()
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    wl = harness.workload(spec, args.workload)
    print(json.dumps(run(ROOT, spec, wl, args.seed, args.seconds, "cuda",
                         spans=bool(args.spans))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
