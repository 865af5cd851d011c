"""Mean host ms an item (frame or image) inside the decode span: the
container, ``decompress`` and the wait for the device. One reader for
every ``decode_ms.<kind>`` metric."""

from benchmark.readers import span_ms


def read(rec):
    return span_ms(rec, "decode")
