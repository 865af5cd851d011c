"""Host ms an item spends, on the calling thread, inside the runtimes'
entropy coder methods (rANS encode, flush, stream, decode). One reader
for every ``entropy_ms.<kind>`` metric."""

from benchmark.readers import span_ms


def read(rec):
    return span_ms(rec, "entropy")
