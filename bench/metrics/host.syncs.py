"""Host-blocking CUDA runtime calls (stream, device and event
synchronizations) under the port's spans in the profiled window, per
request (``bench/program_spans.py``)."""
from bench.program_spans import syncs_per_request


def read(rec):
    return syncs_per_request(rec)
