"""95th percentile of the server's queue wait (``Served.queue_ms``) over
every query answered in the window."""
from bench.records import p95


def read(rec):
    queue = rec.get("queue_ms")
    return None if queue is None else p95(queue)
