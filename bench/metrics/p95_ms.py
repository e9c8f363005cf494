"""95th percentile of every request's latency in the window: a batch in a
closed loop, one query from when it was due in an open one."""
from bench.records import p95


def read(rec):
    return p95(rec["latency_ms"])
