"""Device ms a request of the top-k and sort kernels (names with topk,
sort, radix or kth), over the profiled window's requests."""
from bench.records import device_seconds, profiled_requests

PATTERN = r"topk|sort|radix|kth"


def read(rec):
    n = profiled_requests(rec)
    if n is None:
        return None
    s = device_seconds(rec, PATTERN)
    return 1e3 * s / n if s else None
