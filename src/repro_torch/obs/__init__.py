"""Unified observability: metrics registry, trace spans, logs.

One subsystem, three pillars, shared by core / serving / streaming /
distributed (and the benchmark drivers):

* **metrics** (:mod:`repro_torch.obs.metrics`) — process-local
  :class:`MetricsRegistry` of labeled :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` families with a typed, round-trippable ``snapshot()``
  schema and Prometheus text exposition
  (:func:`start_metrics_server`, ``repro_torch.launch.serve
  --metrics-port``). :class:`StreamingHistogram` is the shared percentile
  structure.
* **traces** (:mod:`repro_torch.obs.trace`) — per-request span trees. Library
  code calls :func:`span` unconditionally; with no tracer installed it
  returns a no-op singleton (one thread-local read, zero allocation), so
  instrumentation-off is the fast path. ``SearchRequest(trace=True)``
  (or ``EngineConfig(trace_sample=...)``) rides a finished :class:`Trace`
  back on ``SearchResult.trace`` — export Chrome-trace JSON with
  ``.save()`` or print ``result.explain()``; ``with obs.capture() as tr:``
  scopes a trace around arbitrary code (serving steps, flush/compact);
  ``obs.capture(timeline=True)`` records a window of a running system on
  the profiler's epoch clock without waiting for the device
  (:func:`timing_kernels` tells the two kinds apart).
* **logs** (:mod:`repro_torch.obs.log`) — rate-limited structured progress
  logging (:func:`get_logger`).

Beside them, :mod:`repro_torch.obs.profile` holds the card's published
peaks (:func:`device_peaks`), the achieved-bandwidth annotation that every
``kernel:<name>`` span carries (:func:`bandwidth_annotation`), and an
opt-in ``torch.profiler`` capture (:func:`profiler_capture`).
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
                      StreamingHistogram, get_registry, start_metrics_server)
from .trace import (NULL_SPAN, Span, Trace, Tracer, active_tracer,
                    begin_request_trace, capture, end_request_trace, span,
                    timing_kernels, tracing)
from .log import StructuredLogger, get_logger
from .profile import (DevicePeaks, PEAKS, bandwidth_annotation, device_peaks,
                      profiler_capture)

__all__ = [
    # metrics
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "StreamingHistogram", "get_registry", "start_metrics_server",
    # traces
    "NULL_SPAN", "Span", "Trace", "Tracer", "active_tracer",
    "begin_request_trace", "capture", "end_request_trace", "span",
    "timing_kernels", "tracing",
    # logs
    "StructuredLogger", "get_logger",
    # profiling
    "DevicePeaks", "PEAKS", "bandwidth_annotation", "device_peaks",
    "profiler_capture",
]
