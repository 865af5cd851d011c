"""Convolution FLOPs of the window's items per second (a training step:
forward and backward), as a share of the card's float32 peak. One reader
for every ``mfu.<kind>`` metric."""

from benchmark.readers import mfu


def read(rec):
    return mfu(rec)
