"""Structured trace spans — where one request spent its time.

A :class:`Tracer` records a tree of timed :class:`Span` records; finished
tracers freeze into a :class:`Trace` that exports Chrome-trace/Perfetto JSON
(``chrome://tracing`` / https://ui.perfetto.dev) or renders as a text tree
(:meth:`Trace.render`, which backs ``SearchResult.explain()``).

The instrumentation contract is a **no-op fast path**: library code calls the
module-level :func:`span` unconditionally; when no tracer is installed it
returns the singleton :data:`NULL_SPAN` — one thread-local attribute read,
no allocation, no dict churn — so always-on instrumentation costs nothing on
untraced requests. Annotations attach via ``sp.set("key", value)``
(positional, so the disabled path never builds a kwargs dict) and should sit
behind ``if obs.tracing():`` when computing the value itself is not free.
Work that waits for the device to time a region sits behind
:func:`timing_kernels` instead.

Three activation styles:

* **per request** — ``SearchRequest(trace=True)``; the outermost engine
  (:class:`repro_torch.core.QueryEngine`, :class:`repro_torch.distributed.\
ShardedDeployment`, :class:`repro_torch.streaming.SegmentedIndex`) installs a
  tracer via :func:`begin_request_trace`, inner layers add spans into it, and
  the finished :class:`Trace` rides back on ``SearchResult.trace``;
* **scoped** — ``with obs.capture() as tr: ...`` around any code (serving
  steps, flush/compact, benchmarks); ``tr.trace()`` afterwards. Both time
  each kernel alone (:func:`timing_kernels`: its wrapper waits for the
  device before and after it);
* **window** — ``with obs.capture(timeline=True) as tr: ...`` around a
  stretch of a running system, such as a ``torch.profiler`` window. Spans
  read ``time.time_ns()``, the epoch clock of the profiler's events, so
  each can be laid over the device's timeline; nothing waits for the
  device (:func:`timing_kernels` is False), so the requests inside run as
  untraced ones do. Requests inside join the window's tracer, so
  ``SearchResult.trace`` stays None; ``tr.spans()`` afterwards lists every
  closed span flat.

Spans support both ``with`` blocks and explicit start/stop (``sp =
obs.span("jit_region"); ...; sp.stop()``) for regions whose boundaries do
not nest lexically (dispatch vs device completion of a jit call).
"""
from __future__ import annotations

import json
import threading
import time
from types import MappingProxyType
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = ["Span", "Tracer", "Trace", "NULL_SPAN", "span", "tracing",
           "timing_kernels", "active_tracer", "capture",
           "begin_request_trace", "end_request_trace"]

_STATE = threading.local()
_NO_ARGS: Mapping[str, Any] = MappingProxyType({})


def active_tracer() -> Optional["Tracer"]:
    """The tracer currently installed on this thread, or None."""
    return getattr(_STATE, "tracer", None)


def tracing() -> bool:
    """True when a tracer is installed — guard for non-free annotations."""
    return getattr(_STATE, "tracer", None) is not None


def timing_kernels() -> bool:
    """True under a per-request or scoped trace, False under a window
    capture and with no tracer — guard for work that waits for the device
    to time a region."""
    t = getattr(_STATE, "tracer", None)
    return t is not None and not t.timeline


class _NullSpan:
    """The disabled-instrumentation singleton: every operation is a no-op
    returning self, so hot paths never branch on 'is tracing on'."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, key: str, value: Any) -> "_NullSpan":
        return self

    def stop(self) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One timed region. Started at construction; closed by ``stop()`` or
    leaving its ``with`` block. ``set(key, value)`` attaches an annotation
    (rendered in Chrome-trace ``args`` and ``explain()``). ``args`` and
    ``children`` are read-only views; their storage is made on first
    use, so a bare span allocates nothing beyond itself."""

    __slots__ = ("name", "t_start", "t_stop", "_args", "_children",
                 "_tracer")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self.name = name
        self.t_start = tracer.clock()
        self.t_stop = None
        self._args: Optional[Dict[str, Any]] = None
        self._children: Optional[List["Span"]] = None

    @property
    def args(self) -> Mapping[str, Any]:
        return _NO_ARGS if self._args is None else self._args

    @property
    def children(self) -> Sequence["Span"]:
        return () if self._children is None else self._children

    def set(self, key: str, value: Any) -> "Span":
        if self._args is None:
            self._args = {}
        self._args[key] = value
        return self

    def stop(self) -> "Span":
        if self.t_stop is None:
            self.t_stop = self._tracer.clock()
            self._tracer._close(self)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    @property
    def duration_ms(self) -> float:
        end = self.t_stop if self.t_stop is not None else self._tracer.clock()
        return (end - self.t_start) * self._tracer.tick_s * 1e3


class Tracer:
    """Collects a span tree for one capture. Not thread-safe (one tracer per
    thread by construction — :func:`capture` installs thread-locally).

    ``timeline`` makes it a window capture's (:func:`capture` with
    ``timeline=True``): ``clock`` is then the epoch clock in integer
    nanoseconds (``tick_s``, the seconds of one unit, 1e-9), and no span
    waits for the device."""

    def __init__(self, clock=time.perf_counter, timeline: bool = False):
        self.clock = time.time_ns if timeline else clock
        self.tick_s = 1e-9 if timeline else 1.0
        self.timeline = timeline
        self.t0 = self.clock()
        self.roots: List[Span] = []
        self._stack: List[Span] = []

    def span(self, name: str) -> Span:
        sp = Span(self, name)
        if self._stack:
            parent = self._stack[-1]
            if parent._children is None:
                parent._children = [sp]
            else:
                parent._children.append(sp)
        else:
            self.roots.append(sp)
        self._stack.append(sp)
        return sp

    def _close(self, sp: Span) -> None:
        stack = self._stack
        if stack and stack[-1] is sp:
            stack.pop()
            return
        # tolerate out-of-lexical-order stops (explicit start/stop regions):
        # unwind to the stopped span, force-closing anything it encloses
        if sp in stack:
            while stack:
                top = stack.pop()
                if top is sp:
                    break
                if top.t_stop is None:
                    top.t_stop = top._tracer.clock()

    def spans(self) -> List[Tuple[str, Any, Any, int, Mapping[str, Any]]]:
        """Every closed span as ``(name, start, stop, depth, args)``, in
        start order, times in the clock's units (epoch nanoseconds for a
        window capture)."""
        return [(sp.name, sp.t_start, sp.t_stop, d, sp.args)
                for sp, d in Trace(self.roots, self.t0).walk()
                if sp.t_stop is not None]

    def trace(self) -> "Trace":
        """Freeze into a Trace (open spans are closed at the current time)."""
        for sp in list(self._stack):
            if sp.t_stop is None:
                sp.t_stop = self.clock()
        self._stack.clear()
        return Trace(self.roots, self.t0, self.tick_s)


class Trace:
    """A finished span tree: export as Chrome-trace JSON or a text tree."""

    def __init__(self, roots: List[Span], t0: float, tick_s: float = 1.0):
        self.roots = list(roots)
        self.t0 = t0
        self.tick_s = tick_s

    def __len__(self) -> int:
        return sum(1 for _ in self.walk())

    def walk(self):
        """Yield ``(span, depth)`` depth-first in start order."""
        stack = [(sp, 0) for sp in reversed(self.roots)]
        while stack:
            sp, d = stack.pop()
            yield sp, d
            for ch in reversed(sp.children):
                stack.append((ch, d + 1))

    def span_names(self) -> List[str]:
        return [sp.name for sp, _ in self.walk()]

    def to_chrome(self) -> dict:
        """Chrome-trace/Perfetto JSON object (``traceEvents`` of complete
        'X' events; timestamps/durations in microseconds per the format)."""
        events = []
        for sp, _ in self.walk():
            end = sp.t_stop if sp.t_stop is not None else sp.t_start
            events.append({
                "name": sp.name, "cat": "repro", "ph": "X",
                "ts": round((sp.t_start - self.t0) * self.tick_s * 1e6, 3),
                "dur": round((end - sp.t_start) * self.tick_s * 1e6, 3),
                "pid": 0, "tid": 0,
                "args": {k: _jsonable(v) for k, v in sp.args.items()},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        return json.dumps(self.to_chrome())

    def save(self, path: str) -> str:
        """Write Chrome-trace JSON; load in chrome://tracing or Perfetto."""
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    def render(self, width: int = 72) -> str:
        """Text tree — one line per span with duration and annotations."""
        lines = []
        for sp, depth in self.walk():
            pad = "  " * depth
            args = " ".join(f"{k}={_compact(v)}" for k, v in sp.args.items())
            head = f"{pad}{sp.name}"
            lines.append(f"{head:<{width}s} {sp.duration_ms:9.3f} ms"
                         + (f"  {args}" if args else ""))
        return "\n".join(lines)


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


def _compact(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    s = str(v)
    return s if len(s) <= 48 else s[:45] + "..."


# ---- module-level instrumentation surface ----------------------------------

def span(name: str) -> Any:
    """Open a span on the active tracer; :data:`NULL_SPAN` when tracing is
    off (the no-op fast path: one thread-local read, zero allocation)."""
    t = getattr(_STATE, "tracer", None)
    if t is None:
        return NULL_SPAN
    return t.span(name)


class capture:
    """``with obs.capture() as tr:`` — install a fresh tracer for the block
    (no-op passthrough if one is already active: nested captures join the
    outer trace). ``tr.trace()`` afterwards returns the finished Trace.

    ``timeline=True`` makes it a window capture: spans on the profiler's
    epoch clock (``time.time_ns()``), kernels not timed alone
    (:func:`timing_kernels` is False), and ``tr.spans()`` for the flat list."""

    def __init__(self, clock=time.perf_counter, timeline: bool = False):
        self._clock = clock
        self._timeline = timeline
        self._installed = False
        self.tracer: Optional[Tracer] = None

    def __enter__(self) -> Tracer:
        cur = getattr(_STATE, "tracer", None)
        if cur is not None:
            self.tracer = cur
            return cur
        self.tracer = Tracer(clock=self._clock, timeline=self._timeline)
        _STATE.tracer = self.tracer
        self._installed = True
        return self.tracer

    def __exit__(self, *exc) -> bool:
        if self._installed:
            _STATE.tracer = None
        return False


def begin_request_trace() -> Optional[Tracer]:
    """Install a fresh tracer for one traced request IF none is active;
    returns it (caller must pass it to :func:`end_request_trace`). Returns
    None when a tracer is already installed — the caller is an inner layer
    of an ongoing trace and must not finish it."""
    if getattr(_STATE, "tracer", None) is not None:
        return None
    t = Tracer()
    _STATE.tracer = t
    return t


def end_request_trace(tracer: Optional[Tracer]) -> Optional[Trace]:
    """Uninstall ``tracer`` (from :func:`begin_request_trace`) and return its
    finished Trace; None passthrough for inner layers."""
    if tracer is None:
        return None
    if getattr(_STATE, "tracer", None) is tracer:
        _STATE.tracer = None
    return tracer.trace()
