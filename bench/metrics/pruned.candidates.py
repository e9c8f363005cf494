"""Candidate rows a query of the pruned route bounds: a request's ``slot``
spans' ``candidates``, summed, averaged over the traced requests. A slot
scans its ``candidates`` positions for every query of the batch, so this
is rows a query, whatever the batch's size."""
from bench.records import span_arg_sums


def read(rec):
    sums = [s for s in span_arg_sums(rec, "slot", "candidates") if s]
    if not sums:
        return None
    return sum(sums) / len(sums)
