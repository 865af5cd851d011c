"""Mean host ms an item (frame or image) inside the encode span:
``compress``, the container and the wait for the device. One reader for
every ``encode_ms.<kind>`` metric; the run's record gives the kind."""

from benchmark.readers import span_ms


def read(rec):
    return span_ms(rec, "encode")
