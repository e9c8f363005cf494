"""Host ms of a dispatching ``round`` span outside its ``search`` spans
(admission, grouping, stacking, outcomes), averaged over the profiled
window's rounds (``bench/program_spans.py``)."""
from bench.program_spans import mean_round_ms


def read(rec):
    return mean_round_ms(rec)
