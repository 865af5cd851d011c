"""Training clips whose update completed in the window, per second of the
window."""

from benchmark.readers import rate


def read(rec):
    return rate(rec, rec['batch'])
