"""Host ns in the program's ``rans`` spans (the entropy coder's calls into
the native coder, on the runtime calls' thread) per symbol it encoded or
decoded (``rans.symbols``), over the window. One reader for every
``rans_ns_per_symbol.<kind>`` metric."""

from benchmark.program_trace import rans_ns_per_symbol


def read(rec):
    return rans_ns_per_symbol(rec)
