"""The traced window: ``torch.profiler`` over it, read from its raw events.

:class:`Capture` records the card's activity around the window (on a card
only ``ProfilerActivity.CUDA``: the kernels, copies and the CUDA runtime
calls that launched them, and no host op, whose recording slowed the
host-bound cells' windows by a fifth and pushed the served cell past its
capacity) and then sums, between the window's start and end (read from the
same epoch clock as the profiler's events):

* ``busy_s``: the union of every device interval (kernels, copies, fills);
* ``kernel_s``: device seconds by operation name, and ``kernels``: their
  count (copies and fills excluded);
* ``idle``: the gaps between device intervals, each named by the innermost
  host event that spans its middle (a CUDA runtime call, or "host (no
  op)" where the host ran Python or the program's own code).

The raw event list (``kineto_results.events()``) is read instead of
``prof.events()``, which builds a tree of every host op and takes minutes on
a window of millions of launches.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

import torch

def _is_device(ev) -> bool:
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def _is_annotation(ev) -> bool:
    """A ``record_function`` range, which the profiler also draws on the
    device's timeline: no operation ran there."""
    try:
        return bool(ev.is_user_annotation())
    except AttributeError:
        return False


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Capture:
    """``with Capture(device) as cap: <window>``; afterwards ``cap.summary``
    (None where the profiler saw no window)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.summary: Optional[dict] = None
        self.read_s = 0.0

    def __enter__(self) -> "Capture":
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                         else ProfilerActivity.CPU])
        self._prof.__enter__()
        if self.cuda:
            torch.cuda.synchronize()
        self._w0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.cuda:
            torch.cuda.synchronize()
        w1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        if exc[0] is None:
            t0 = time.perf_counter()
            self.summary = summarise(
                self._prof.profiler.kineto_results.events(), self._w0, w1)
            self.read_s = time.perf_counter() - t0
        self._prof = None
        return False


def summarise(events, w0: int, w1: int) -> dict:
    """The window [w0, w1] (epoch ns, the profiler's clock) of ``events``."""
    dev: List[Tuple[int, int]] = []
    kernel_s: Dict[str, float] = {}
    kernels = 0
    host: List[Tuple[int, int, str]] = []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if _is_device(e):
            if _is_annotation(e):
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
    busy = _union(dev)
    busy_ns = sum(t - s for s, t in busy)
    gaps: List[Tuple[int, int]] = []
    cur = w0
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if cur < w1:
        gaps.append((cur, w1))
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "kernel_s": kernel_s, "kernels": kernels,
            "idle_s": _name_gaps(gaps, host)}


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost host op spanning each gap's middle."""
    host.sort()
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    for s, t in gaps:
        mid = (s + t) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "host (no op)"
        for j in range(i, max(i - 256, -1), -1):
            if host[j][1] > mid:
                name = host[j][2]
                break
        out[name] = out.get(name, 0.0) + (t - s) / 1e9
    return out


def breakdown(summary: Optional[dict], top: int = 10) -> Optional[dict]:
    if not summary:
        return None
    ops = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle_s"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
