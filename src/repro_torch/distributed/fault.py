"""Fault-tolerance scaffolding: heartbeat registry + failure/straggler
simulation hooks (single-process stand-ins for the fleet controller)."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class Heartbeat:
    worker: str
    last_seen: float
    step: int


class HeartbeatRegistry:
    """Controller-side view of worker liveness. At fleet scale each host pings
    its heartbeat; a missed deadline triggers elastic restart from the latest
    checkpoint on the surviving topology (tests simulate this end to end)."""

    def __init__(self, timeout_s: float = 30.0):
        self.timeout = timeout_s
        self.beats: Dict[str, Heartbeat] = {}

    def ping(self, worker: str, step: int, now: Optional[float] = None):
        self.beats[worker] = Heartbeat(worker, now or time.time(), step)

    def dead_workers(self, now: Optional[float] = None) -> List[str]:
        now = now or time.time()
        return [w for w, hb in self.beats.items()
                if now - hb.last_seen > self.timeout]

    def should_restart(self, now: Optional[float] = None) -> bool:
        return len(self.dead_workers(now)) > 0
