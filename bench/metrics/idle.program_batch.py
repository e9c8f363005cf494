"""Share of the profiled window with nothing on the card while the host was
inside a span of the port (``bench/program_spans.py``), in percent."""
from bench.program_spans import program_idle_percent


def read(rec):
    return program_idle_percent(rec)
