"""Peak device memory allocated in the window (``max_memory_allocated``
after ``reset_peak_memory_stats``), GiB: the program's tensors alone, as
the check's sample is held on the host. One reader for every
``peak_gib.<kind>`` metric."""

from benchmark.readers import peak_gib


def read(rec):
    return peak_gib(rec)
