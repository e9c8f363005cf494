"""Wavefront steps a request (``wavefront_totals`` spans, summed over the
request's slots), averaged over the traced requests."""
from bench.records import span_arg_sums


def read(rec):
    sums = [s for s in span_arg_sums(rec, "wavefront_totals", "steps") if s]
    return sum(sums) / len(sums) if sums else None
