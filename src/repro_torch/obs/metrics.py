"""Process-local metrics registry: Counter / Gauge / Histogram families.

One :class:`MetricsRegistry` per process (:data:`REGISTRY`) holds named
metric *families*; a family fans out into labeled *series* (``requests_total
{route="graph"}``). The registry renders three ways:

* :meth:`MetricsRegistry.snapshot` — a typed, JSON-stable schema (versioned
  ``schema`` field) that round-trips through
  :meth:`MetricsRegistry.from_snapshot` bit-for-bit, so operators can diff,
  persist, or ship snapshots;
* :meth:`MetricsRegistry.render_prometheus` — Prometheus text exposition
  (``# TYPE``/``# HELP`` + series lines, cumulative ``_bucket`` rows for
  histograms), served by :func:`start_metrics_server` /
  ``repro.launch.serve --metrics-port``;
* plain attribute reads (``counter.value()``) for tests and in-process
  consumers.

:class:`StreamingHistogram` moved here from ``repro.serving.scheduler`` (PR
7) and is re-exported there for compat: log-spaced bins give p50/p95/p99 in
O(bins) memory with no samples stored — the same structure now backs every
labeled :class:`Histogram` series.

Recording is designed for hot paths: a labeled child is resolved once
(``c = counter.labels(route="graph")``) and cached by the caller; ``inc`` /
``observe`` on a child is then one attribute update. Unlabeled families skip
the child layer entirely.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "StreamingHistogram",
           "MetricsRegistry", "REGISTRY", "get_registry",
           "start_metrics_server"]

SNAPSHOT_SCHEMA = 1


class StreamingHistogram:
    """Log-spaced latency histogram: percentile estimates in O(bins) memory,
    no samples stored. Values are milliseconds; out-of-range values clamp to
    the edge bins. ``percentile`` returns the upper edge of the bin holding
    the target rank (conservative: never under-reports a latency SLO)."""

    def __init__(self, lo_ms: float = 1e-3, hi_ms: float = 6e4,
                 bins: int = 128):
        self.lo_ms = float(lo_ms)
        self.hi_ms = float(hi_ms)
        self.bins = int(bins)
        self._edges = np.geomspace(lo_ms, hi_ms, bins - 1)
        self._counts = np.zeros(bins, np.int64)
        self.count = 0
        self.total_ms = 0.0
        self.max_ms = 0.0

    def record(self, ms: float) -> None:
        self._counts[int(np.searchsorted(self._edges, ms))] += 1
        self.count += 1
        self.total_ms += ms
        self.max_ms = max(self.max_ms, ms)

    def percentile(self, p: float) -> float:
        """p in [0, 100]; 0.0 when empty."""
        if not self.count:
            return 0.0
        target = max(1, int(np.ceil(p / 100.0 * self.count)))
        idx = int(np.searchsorted(np.cumsum(self._counts), target))
        if idx >= self._edges.size:
            return self.max_ms
        return float(min(self._edges[idx], self.max_ms))

    @property
    def mean(self) -> float:
        return self.total_ms / self.count if self.count else 0.0

    # ---- snapshot round-trip ----
    def to_dict(self) -> dict:
        return {"lo_ms": self.lo_ms, "hi_ms": self.hi_ms, "bins": self.bins,
                "count": self.count, "sum_ms": self.total_ms,
                "max_ms": self.max_ms,
                "counts": self._counts.tolist(),
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99), "mean": self.mean}

    @classmethod
    def from_dict(cls, d: dict) -> "StreamingHistogram":
        h = cls(d["lo_ms"], d["hi_ms"], d["bins"])
        h._counts = np.asarray(d["counts"], np.int64)
        h.count = int(d["count"])
        h.total_ms = float(d["sum_ms"])
        h.max_ms = float(d["max_ms"])
        return h


def _label_key(label_names: Tuple[str, ...], labels: dict) -> tuple:
    if set(labels) != set(label_names):
        raise ValueError(f"expected labels {label_names}, got "
                         f"{tuple(sorted(labels))}")
    return tuple(str(labels[n]) for n in label_names)


class _Family:
    """Shared family mechanics: name, help text, labeled series dict."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._series: Dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _child(self, labels: dict):
        key = _label_key(self.label_names, labels)
        child = self._series.get(key)
        if child is None:
            with self._lock:
                child = self._series.setdefault(key, self._new_child())
        return child

    def labels(self, **labels):
        """Resolve (and cache) one labeled series — hot paths hold on to the
        returned child instead of re-resolving per event."""
        return self._child(labels)

    def series(self) -> List[Tuple[dict, object]]:
        return [(dict(zip(self.label_names, key)), child)
                for key, child in sorted(self._series.items())]


class _CounterChild:
    __slots__ = ("v",)

    def __init__(self):
        self.v = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.v += amount


class Counter(_Family):
    """Monotone counter family. ``inc(n, **labels)``, or cache a
    ``labels()`` child and ``child.inc(n)`` on the hot path."""

    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0, **labels) -> None:
        self._child(labels).inc(amount)

    def value(self, **labels) -> float:
        return self._child(labels).v


class _GaugeChild:
    __slots__ = ("v",)

    def __init__(self):
        self.v = 0.0

    def set(self, value: float) -> None:
        self.v = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.v += amount


class Gauge(_Family):
    """Point-in-time value family (queue depth, inflight rows, ...)."""

    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float, **labels) -> None:
        self._child(labels).set(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        self._child(labels).inc(amount)

    def value(self, **labels) -> float:
        return self._child(labels).v


class Histogram(_Family):
    """Labeled family of :class:`StreamingHistogram` series. Values are
    milliseconds by convention (matches the serving layer)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[str, ...] = (), lo_ms: float = 1e-3,
                 hi_ms: float = 6e4, bins: int = 128):
        super().__init__(name, help, labels)
        self._hist_args = (lo_ms, hi_ms, bins)

    def _new_child(self):
        return StreamingHistogram(*self._hist_args)

    def observe(self, ms: float, **labels) -> None:
        self._child(labels).record(ms)

    def percentile(self, p: float, **labels) -> float:
        return self._child(labels).percentile(p)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named metric families with get-or-create semantics: asking twice for
    the same (name, kind) returns the same family; a kind or label-set
    mismatch raises (metric names are a schema, not a suggestion)."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    # ---- family constructors ----
    def _get_or_create(self, cls, name: str, help: str, labels, **kw):
        fam = self._families.get(name)
        if fam is not None:
            if not isinstance(fam, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{fam.kind}, not {cls.kind}")
            if labels and tuple(labels) != fam.label_names:
                raise ValueError(f"metric {name!r} registered with labels "
                                 f"{fam.label_names}, not {tuple(labels)}")
            return fam
        with self._lock:
            return self._families.setdefault(
                name, cls(name, help, tuple(labels), **kw))

    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels=(), **kw
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, **kw)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    def clear(self) -> None:
        """Drop every family (test isolation)."""
        self._families.clear()

    # ---- typed snapshot schema (round-trips via from_snapshot) ----
    def snapshot(self) -> dict:
        out = {"schema": SNAPSHOT_SCHEMA, "metrics": {}}
        for name, fam in sorted(self._families.items()):
            series = []
            for labels, child in fam.series():
                if fam.kind == "histogram":
                    series.append({"labels": labels, **child.to_dict()})
                else:
                    series.append({"labels": labels, "value": child.v})
            entry = {"type": fam.kind, "help": fam.help,
                     "label_names": list(fam.label_names), "series": series}
            if fam.kind == "histogram":
                entry["hist_args"] = list(fam._hist_args)
            out["metrics"][name] = entry
        return out

    @classmethod
    def from_snapshot(cls, snap: dict) -> "MetricsRegistry":
        if snap.get("schema") != SNAPSHOT_SCHEMA:
            raise ValueError(f"unknown metrics snapshot schema "
                             f"{snap.get('schema')!r} (expected "
                             f"{SNAPSHOT_SCHEMA})")
        reg = cls()
        for name, entry in snap["metrics"].items():
            kind = entry["type"]
            if kind not in _KINDS:
                raise ValueError(f"unknown metric type {kind!r} for {name!r}")
            labels = tuple(entry["label_names"])
            if kind == "histogram":
                lo, hi, bins = entry.get("hist_args", (1e-3, 6e4, 128))
                fam = reg.histogram(name, entry["help"], labels, lo_ms=lo,
                                    hi_ms=hi, bins=bins)
                for s in entry["series"]:
                    fam._series[_label_key(labels, s["labels"])] = \
                        StreamingHistogram.from_dict(s)
            else:
                fam = (reg.counter if kind == "counter" else reg.gauge)(
                    name, entry["help"], labels)
                for s in entry["series"]:
                    fam._child(s["labels"]).v = float(s["value"])
        return reg

    # ---- Prometheus text exposition ----
    def render_prometheus(self) -> str:
        lines: List[str] = []
        for name, fam in sorted(self._families.items()):
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for labels, child in fam.series():
                if fam.kind == "histogram":
                    lines.extend(_prom_histogram(name, labels, child))
                else:
                    lines.append(f"{name}{_prom_labels(labels)} "
                                 f"{_prom_num(child.v)}")
        return "\n".join(lines) + "\n"


def _prom_labels(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items.items())
    return "{" + body + "}"


def _prom_num(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def _prom_histogram(name: str, labels: dict, h: StreamingHistogram
                    ) -> List[str]:
    lines = []
    cum = np.cumsum(h._counts)
    for edge, c in zip(h._edges, cum[:-1]):
        lines.append(f"{name}_bucket"
                     f"{_prom_labels(labels, {'le': f'{edge:.6g}'})} "
                     f"{int(c)}")
    lines.append(f"{name}_bucket{_prom_labels(labels, {'le': '+Inf'})} "
                 f"{h.count}")
    lines.append(f"{name}_sum{_prom_labels(labels)} {_prom_num(h.total_ms)}")
    lines.append(f"{name}_count{_prom_labels(labels)} {h.count}")
    return lines


REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-default registry every subsystem records into."""
    return REGISTRY


def start_metrics_server(port: int, registry: Optional[MetricsRegistry] = None,
                         host: str = "127.0.0.1"):
    """Serve ``/metrics`` (Prometheus text) and ``/metrics.json`` (typed
    snapshot) on a daemon thread. ``port=0`` binds an ephemeral port; read
    ``server.server_address[1]``. Returns the ``ThreadingHTTPServer`` —
    call ``.shutdown()`` to stop."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry if registry is not None else REGISTRY

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path.startswith("/metrics.json"):
                body = json.dumps(reg.snapshot()).encode()
                ctype = "application/json"
            elif self.path.startswith("/metrics"):
                body = reg.render_prometheus().encode()
                ctype = "text/plain; version=0.0.4"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # metrics scrapes don't spam stderr
            pass

    server = ThreadingHTTPServer((host, port), _Handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="obs-metrics-http", daemon=True)
    thread.start()
    server._obs_thread = thread
    return server
