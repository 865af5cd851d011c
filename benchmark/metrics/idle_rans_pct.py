"""Share of the profiled stretch with no device operation running while
the host is in a ``rans`` span (``program_trace.idle_by_span``). One reader
for every ``idle_rans_pct.<kind>`` metric."""

from benchmark.program_trace import idle_pct


def read(rec):
    return idle_pct(rec, "rans")
