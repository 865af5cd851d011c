"""90th percentile over every frame of the window of its encode wall time
plus its decode wall time (host clock after ``synchronize()``, rANS
included)."""

from benchmark.readers import latency_ms


def read(rec):
    return latency_ms(rec, 90)
