"""Small readings of a run's record that several metric readers share."""
from __future__ import annotations

import re
from typing import List, Optional

import numpy as np


def p95(values) -> Optional[float]:
    """The 95th percentile, or None for fewer than 200 values (ten beyond
    it)."""
    if len(values) < 200:
        return None
    return float(np.percentile(np.asarray(values, np.float64), 95))


def span_sums(rec: dict, names) -> List[float]:
    """For each traced request, the summed ms of its spans named in
    ``names``."""
    return [sum(ms for name, ms, _ in req if name in names)
            for req in rec.get("spans") or []]


def span_arg_sums(rec: dict, name: str, arg: str) -> List[float]:
    """For each traced request, the sum of ``arg`` over its ``name`` spans."""
    return [float(sum(a.get(arg, 0) for n, _, a in req if n == name))
            for req in rec.get("spans") or []]


def profiled_requests(rec: dict) -> Optional[int]:
    """Requests run inside the profiled window (None without a profile)."""
    if not rec.get("profile") or not rec["profile"]["busy_s"]:
        return None
    return int(rec["requests"]) or None


def device_seconds(rec: dict, pattern: Optional[str] = None) -> float:
    """Device seconds in the profiled window, of the operations whose name
    matches ``pattern`` (all without one)."""
    rx = re.compile(pattern, re.I) if pattern else None
    return sum(s for name, s in rec["profile"]["kernel_s"].items()
               if rx is None or rx.search(name))


def idle_percent(rec: dict) -> Optional[float]:
    prof = rec.get("profile")
    if not prof or not prof["busy_s"] or not prof["window_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
