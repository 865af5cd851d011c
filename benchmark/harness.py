"""What every driver and metric of the benchmark shares: finding the files
of a cell by name, host-clock spans, the percentile, the reduction of a
``torch.profiler`` trace to busy time, kernel time and labelled idle gaps,
and the check that no JAX module was loaded.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that the process may not hold (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "dcvc_tpu")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM f32, outside the tensor cores


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(spec_: dict, name: str) -> dict:
    for w in spec_["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return load_json(BENCH / "limits" / f"{cell_name}.json")


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(metric: str):
    """The module of ``metrics/<metric>.py`` (metric names hold dots) or,
    where there is none, of the metric's quantity, ``metrics/<q>.py`` for
    ``<q>.<kind>``: one reader serves every kind of cell, which it takes
    from the run's record."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.is_file() and "." in metric:
        path = BENCH / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    mod_name = "benchmark_metric_" + metric.replace(".", "_").replace("-", "_")
    spec_ = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def metrics_for(spec_: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of ``cell_name`` reports: the end-to-end
    ones untraced, the per-layer ones traced."""
    group = spec_["per_layer"] if trace else spec_["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (Linux
    ``/proc/self/stat``; falls back to the first import of this module)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values``, interpolated linearly
    between the two nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no samples")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Phases:
    """Seconds since the process started at the end of each set-up phase
    (``since_start`` maps a ``time.perf_counter()`` reading to them)."""

    def __init__(self, since_start):
        self.since_start = since_start
        self.done: dict = {}

    def mark(self, name: str):
        self.done[name] = self.since_start(time.perf_counter())


class Spans:
    """Host-clock spans by name (total seconds). With
    ``trace`` each span is also a ``torch.profiler.record_function``
    range, so the profiler's idle gaps can be labelled by it."""

    def __init__(self, trace: bool = False):
        self.trace = trace
        self.total: dict = {}

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.trace:
            import torch

            rf = torch.profiler.record_function(name)
        t = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                self.total[name] = (self.total.get(name, 0.0)
                                    + time.perf_counter() - t)

    def wrap(self, obj, methods, name: str):
        """Time ``obj``'s ``methods`` (bound on the instance) under
        ``name``."""
        for m in methods:
            fn = getattr(obj, m)

            def timed(*a, _fn=fn, **k):
                with self.span(name):
                    return _fn(*a, **k)

            setattr(obj, m, timed)


def _device_events(prof):
    """(start us, end us, name) of every device operation (kernels,
    copies, sets) of a ``torch.profiler`` run, and (start, end, name) of
    every host range."""
    dev, host = [], []
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end, e.name)
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            # a user annotation projected on the device spans kernels
            # counted on their own
            if not getattr(e, "is_user_annotation", False):
                dev.append(rng)
        else:
            host.append(rng)
    return dev, host


def reduce_profile(prof, labels, stretch: str = "stretch") -> dict:
    """Busy and idle time of the device over the host range ``stretch``,
    device seconds by operation name, and each idle gap labelled by the
    innermost of the host ranges named in ``labels`` that holds its
    middle ("other" where none does)."""
    dev, host = _device_events(prof)
    bounds = [(s, e) for s, e, n in host if n == stretch]
    if not bounds:
        raise RuntimeError(f"no host range {stretch!r} in the trace")
    s0, s1 = min(b[0] for b in bounds), max(b[1] for b in bounds)
    spans = [(s, e, n) for s, e, n in host if n in labels]
    by_name: dict = {}
    clipped = []
    for s, e, n in dev:
        s, e = max(s, s0), min(e, s1)
        if e > s:
            clipped.append((s, e))
            by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    clipped.sort()
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    last_end = s0
    for s, e in clipped:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > last_end:
                gaps.append((last_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last_end = max(last_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if s1 > last_end:
        gaps.append((last_end, s1))

    def label(a, b):
        mid = (a + b) / 2
        inside = [(e - s, n) for s, e, n in spans if s <= mid <= e]
        return min(inside)[1] if inside else "other"

    labelled = sorted(((label(a, b), (b - a) * 1e-6) for a, b in gaps),
                      key=lambda r: -r[1])
    return {"busy_s": busy * 1e-6, "window_s": (s1 - s0) * 1e-6,
            "device_s_by_name": by_name, "gaps": labelled}


def breakdown(profile: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that
    took most time and the ten longest idle gaps."""
    ops = sorted(profile["device_s_by_name"].items(), key=lambda r: -r[1])
    return {"device_ops": [[n[:120], s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in profile["gaps"][:10]]}
