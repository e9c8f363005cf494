"""Share of the profiled window with no operation on the card, in percent."""
from bench.records import idle_percent


def read(rec):
    return idle_percent(rec)
