"""Share of the profiled stretch in which no device operation runs. One
reader for every ``idle_pct.<kind>`` metric."""

from benchmark.readers import idle_pct


def read(rec):
    return idle_pct(rec)
