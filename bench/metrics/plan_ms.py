"""Host ms a request spends in the engine's ``route`` and ``plan`` spans,
averaged over the traced requests run after the window."""
from bench.records import span_sums


def read(rec):
    sums = span_sums(rec, ("route", "plan"))
    return sum(sums) / len(sums) if sums else None
