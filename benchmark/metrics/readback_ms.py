"""Host ms an item (frame or image) spends in the program's
``runtime.readback`` spans, over the window: the device-to-host copies of
symbols, scale indexes and z, each after a wait for the device's queued
work. One reader for every ``readback_ms.<kind>`` metric."""

from benchmark.program_trace import span_ms


def read(rec):
    return span_ms(rec, "runtime.readback")
