"""Share of the profiled window with nothing on the card while the server's
host code was inside a span of the port (``bench/program_spans.py``), in
percent; the rest of the idle is outside the port: arrivals not yet due."""
from bench.program_spans import program_idle_percent


def read(rec):
    return program_idle_percent(rec)
