"""Device kernels a request in the profiled window over the wavefront steps
a request (``graph.steps``)."""
from bench.records import profiled_requests, span_arg_sums


def read(rec):
    n = profiled_requests(rec)
    steps = [s for s in span_arg_sums(rec, "wavefront_totals", "steps") if s]
    if n is None or not steps:
        return None
    return rec["profile"]["kernels"] / n / (sum(steps) / len(steps))
