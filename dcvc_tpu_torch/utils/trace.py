"""In-memory spans and counters of the port's runtimes, entropy coder and
trainer.

Off by default: ``span`` then hands out one shared no-op context and
``count`` returns at once, after one check of a module flag. Whoever reads
the trace turns it on with ``enable()`` and collects it with ``take()``;
nothing is written anywhere.

A span records its name, its start and end (``time.perf_counter_ns``), the
thread that opened it, its id, its parent (the innermost span open on that
thread) and its attributes. While the recorder is on, each
span is also a ``torch.profiler.record_function`` range, so under a
profiler the program's spans sit on the same timeline as the device's
kernels. A counter is a running sum by name.

The recorder is one per process: spans opened on any thread (an
asynchronous entropy coder's worker, say) land in the same trace.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

_on = False
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_spans: list = []
_counters: dict = {}


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def enabled() -> bool:
    return _on


_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        _local.stack.pop()
        rec = {"name": self.name, "start_ns": self.start, "end_ns": end,
               "thread": threading.get_ident(), "id": self.id,
               "parent": self.parent, "attrs": self.attrs}
        with _lock:
            _spans.append(rec)
        return False


def span(name: str, **attrs):
    """A context that records ``name`` while the recorder is on."""
    if not _on:
        return _NO_SPAN
    return _Span(name, attrs)


def count(name: str, n: int = 1):
    """Adds ``n`` to the counter ``name`` while the recorder is on."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def take() -> dict:
    """``{"spans": [...], "counters": {...}}`` recorded so far, cleared."""
    global _spans, _counters
    with _lock:
        out = {"spans": _spans, "counters": _counters}
        _spans, _counters = [], {}
    return out
