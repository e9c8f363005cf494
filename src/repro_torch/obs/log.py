"""Rate-limited structured logging for build/search progress.

Stdlib ``logging`` underneath (handlers, levels, and capture keep working),
but events are structured — an event name plus ``key=value`` fields — so
progress lines stay greppable and machine-parseable instead of ad-hoc
``print`` f-strings:

    log = obs.get_logger(__name__)
    log.info("bulk_insert", variant="T", done=4096, total=20000)
    # repro_torch.core.build: bulk_insert variant=T done=4096 total=20000

``progress()`` is the rate-limited variant for per-batch/per-item loops: at
most one emission per ``every_s`` seconds per event name (the final call can
force-flush with ``final=True`` so the 100% line always lands). Rate state
is per-logger, so two builders logging the same event don't suppress each
other.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict

__all__ = ["StructuredLogger", "get_logger"]


def _fmt(event: str, fields: Dict[str, Any]) -> str:
    if not fields:
        return event
    body = " ".join(f"{k}={_fmt_val(v)}" for k, v in fields.items())
    return f"{event} {body}"


def _fmt_val(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    s = str(v)
    return s if " " not in s else repr(s)


class StructuredLogger:
    """Thin structured facade over one stdlib logger."""

    def __init__(self, name: str):
        self._log = logging.getLogger(name)
        self._last_emit: Dict[str, float] = {}

    def debug(self, event: str, **fields) -> None:
        self._log.debug("%s", _fmt(event, fields))

    def info(self, event: str, **fields) -> None:
        self._log.info("%s", _fmt(event, fields))

    def warning(self, event: str, **fields) -> None:
        self._log.warning("%s", _fmt(event, fields))

    def error(self, event: str, **fields) -> None:
        self._log.error("%s", _fmt(event, fields))

    def progress(self, event: str, every_s: float = 1.0, final: bool = False,
                 **fields) -> bool:
        """Rate-limited info: emits at most once per ``every_s`` per
        ``event`` (``final=True`` bypasses the limit and resets it, so a
        loop's closing 100% line is never swallowed). Returns whether the
        line was emitted. Field formatting is skipped on suppressed calls —
        a suppressed progress call costs one clock read and a dict get."""
        now = time.perf_counter()
        last = self._last_emit.get(event)
        if not final and last is not None and (now - last) < every_s:
            return False
        if final:
            self._last_emit.pop(event, None)
        else:
            self._last_emit[event] = now
        self._log.info("%s", _fmt(event, fields))
        return True


_LOGGERS: Dict[str, StructuredLogger] = {}


def get_logger(name: str) -> StructuredLogger:
    """Process-cached structured logger (mirrors ``logging.getLogger``)."""
    log = _LOGGERS.get(name)
    if log is None:
        log = _LOGGERS.setdefault(name, StructuredLogger(name))
    return log
