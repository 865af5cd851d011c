"""Share of the profiled stretch with no device operation running while
the host is inside a runtime call or a train step and in none of its waits
(rANS, readbacks, uploads, the loss's readback): issuing launches, running
Python and numpy (``program_trace.idle_by_span``). One reader for every
``idle_host_pct.<kind>`` metric."""

from benchmark.program_trace import idle_pct


def read(rec):
    return idle_pct(rec, "host")
