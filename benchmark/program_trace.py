"""What the program's own spans and counters (``dcvc_tpu_torch/utils/
trace.py``) say about a run: each idle interval of the device put down to
what the host was doing, and the arithmetic of the metrics that read the
program's trace (``metrics/readback_ms.py``, ``rans_ns_per_symbol.py``,
``idle_rans_pct.py``, ``idle_host_pct.py``).

A traffic driver (``drivers/<kind>.py``) that calls ``start()`` as a
traced window opens and puts ``finish(prof)`` into its record as the
window closes gives the record ``program_trace``, the recorder's
``take()`` over the window, and ``idle_by_program_span``,
``idle_by_span`` of the profiled stretch. Where a record has neither (an
untraced run, or a driver that makes neither call), the readers report
nothing.

The drivers make neither call yet. ``WIRING`` holds the lines that make
them, each at its place in the driver's source, and ``PER_LAYER`` the
metric entries that report what the readers read; ``wired(kind)`` is the
driver with those lines in. Run a cell with both:

    python3 -m benchmark.program_trace --workload <cell> --seed <n> \\
        --seconds <s> --trace 1

prints the line of ``benchmark/run.py`` with ``PER_LAYER``'s metrics of
the cell among the traced run's metrics.
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

from .readers import items


def start():
    """Turns the program's recorder on (the window's first item)."""
    from dcvc_tpu_torch.utils import trace

    trace.take()
    trace.enable()


def finish(prof) -> dict:
    """The record's keys of the window just closed; the recorder off."""
    from dcvc_tpu_torch.utils import trace

    trace.disable()
    return {"program_trace": trace.take(),
            "idle_by_program_span": idle_by_span(prof)}


# the waits of the host inside a runtime call or a train step, by the
# program's span names; the rest of such a call is the host issuing work
WAITS = {"rans": "rans", "runtime.readback": "readback",
         "train.readback": "readback", "runtime.upload": "upload"}
TOPS = ("runtime.compress", "runtime.decompress", "train.step")
LABELS = ("rans", "readback", "upload", "host", "outside")


def _events(prof, stretch: str):
    """One walk of a ``torch.profiler`` run's events: (start us, end us) of
    every device operation, taken as ``harness._device_events`` takes
    them; the bounds of each host range ``stretch``; and (start, end, name,
    thread) of the program's spans among the host ranges."""
    dev, bounds, spans = [], [], []
    for e in prof.events():
        r = e.time_range
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            # a user annotation projected on the device spans kernels
            # counted on their own
            if not getattr(e, "is_user_annotation", False):
                dev.append((r.start, r.end))
        elif e.name == stretch:
            bounds.append((r.start, r.end))
        elif e.name in WAITS or e.name in TOPS:
            spans.append((r.start, r.end, e.name, e.thread))
    return dev, bounds, spans


def _timeline(spans, s0, s1):
    """Sorted, disjoint (start, end, label) covering [s0, s1]: the label of
    the innermost span open (spans nest, as they do on one thread)."""
    out = []
    stack = []                  # (end, label) of the spans open

    def emit(a, b, label):
        a, b = max(a, s0), min(b, s1)
        if b > a:
            out.append((a, b, label))

    t = s0
    for s, e, label in sorted(spans, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= s:
            end, lab = stack.pop()
            emit(t, end, lab)
            t = max(t, end)
        emit(t, s, stack[-1][1] if stack else "outside")
        t = max(t, s)
        stack.append((e, label))
    while stack:
        end, lab = stack.pop()
        emit(t, end, lab)
        t = max(t, end)
    emit(t, s1, "outside")
    return out


def _idle(dev, s0, s1):
    """Sorted, disjoint (start, end) within [s0, s1] in which no device
    operation runs: the complement of ``harness.reduce_profile``'s busy
    time."""
    gaps, last = [], s0
    for s, e in sorted(dev):
        s, e = max(s, s0), min(e, s1)
        if e <= s:
            continue
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if s1 > last:
        gaps.append((last, s1))
    return gaps


def idle_by_span(prof, stretch: str = "stretch") -> dict:
    """Seconds of the device's idle time over the host range ``stretch``
    by what the thread that opened the program's top spans (runtime calls,
    train steps) was in: ``rans``, ``readback`` (``runtime.readback``,
    ``train.readback``), ``upload``, ``host`` (inside a top span and in
    none of those waits: issuing work, Python, numpy) or ``outside`` (in
    no program span: the benchmark's own code). The labels sum to the idle
    time of ``harness.reduce_profile`` over the same stretch."""
    dev, bounds, spans = _events(prof, stretch)
    if not bounds:
        raise RuntimeError(f"no host range {stretch!r} in the trace")
    s0, s1 = min(b[0] for b in bounds), max(b[1] for b in bounds)
    threads = {t for _, _, n, t in spans if n in TOPS}
    timeline = _timeline([(s, e, WAITS.get(n, "host"))
                          for s, e, n, t in spans if t in threads], s0, s1)
    idle = dict.fromkeys(LABELS, 0.0)
    k = 0
    for a, b in _idle(dev, s0, s1):
        while k < len(timeline) and timeline[k][1] <= a:
            k += 1
        j = k
        while j < len(timeline) and timeline[j][0] < b:
            ts, te, label = timeline[j]
            idle[label] += (min(b, te) - max(a, ts)) * 1e-6
            j += 1
    return {"window_s": (s1 - s0) * 1e-6, "idle_s": idle}


def idle_pct(rec: dict, label: str):
    """Share of the profiled stretch with the device idle while the host
    was in ``label``."""
    p = rec.get("idle_by_program_span")
    if not p:
        return None
    return 100.0 * p["idle_s"][label] / p["window_s"]


def _spans(rec: dict, name: str) -> list:
    t = rec.get("program_trace")
    return [s for s in t["spans"] if s["name"] == name] if t else []


def span_ms(rec: dict, name: str):
    """Host ms an item spends in the program's spans ``name``, over the
    window."""
    spans, it = _spans(rec, name), items(rec)
    if not spans or not it:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / len(it) * 1e-6


def rans_ns_per_symbol(rec: dict):
    """Host ns in ``rans`` spans, on every thread, per symbol coded
    (``rans.symbols``: encoded plus decoded, on every thread). A ``rans``
    span holds one call into the native coder and no wait, so an
    asynchronous coder's worker adds its time and its symbols alike."""
    symbols = (rec.get("program_trace") or {}).get("counters", {}).get(
        "rans.symbols")
    if not symbols:
        return None
    return sum(s["end_ns"] - s["start_ns"]
               for s in _spans(rec, "rans")) / symbols


# the drivers' lines that wire the program's trace into a traced run:
# (anchor, line, "before" | "after"), each anchor found once in the driver
WIRING = {
    "coding_stream": [
        ("from .. import harness\n", "from .. import program_trace\n",
         "after"),
        ('"decode_stream"), "entropy")\n',
         "        program_trace.start()\n", "after"),
        ("        prof_box.clear()\n",
         '        rec.update(program_trace.finish(prof_box["prof"]))\n',
         "before"),
    ],
    "train_step": [
        ("from .. import harness\n", "from .. import program_trace\n",
         "after"),
        ("    t_start = time.perf_counter()\n",
         "    if trace:\n        program_trace.start()\n", "before"),
        ('        rec["profile"] = harness.reduce_profile(prof, ("step",))\n',
         "        rec.update(program_trace.finish(prof))\n", "after"),
    ],
}


# the per-layer entries of BENCHMARK.json that report the readers
PER_LAYER = [
    {"name": n, "unit": u, "better": "lower", "source": src, "layer": layer,
     "moves": moves, "workloads": [cell]}
    for n, u, src, layer, moves, cell in (
        ("readback_ms.video", "ms", "program_span", "runtimes",
         "frame_latency_ms.p90", "dc_1080p_stream"),
        ("readback_ms.image", "ms", "program_span", "runtimes",
         "image_latency_ms.p90", "evc_ll_1080p_stream"),
        ("rans_ns_per_symbol.video", "ns", "program_counter",
         "host entropy coding", "frame_latency_ms.p90", "dc_1080p_stream"),
        ("rans_ns_per_symbol.image", "ns", "program_counter",
         "host entropy coding", "image_latency_ms.p90",
         "evc_ll_1080p_stream"),
        ("idle_rans_pct.video", "%", "device_trace", "device", "fps",
         "dc_1080p_stream"),
        ("idle_rans_pct.image", "%", "device_trace", "device",
         "images_per_s", "evc_ll_1080p_stream"),
        ("idle_host_pct.video", "%", "device_trace", "device", "fps",
         "dc_1080p_stream"),
        ("idle_host_pct.image", "%", "device_trace", "device",
         "images_per_s", "evc_ll_1080p_stream"),
        ("idle_host_pct.train", "%", "device_trace", "device",
         "train_clips_per_s", "dc_train_256"))
]


def wired_source(kind: str) -> str:
    """The text of ``drivers/<kind>.py`` with ``WIRING[kind]``'s lines in
    place."""
    src = (Path(__file__).resolve().parent / "drivers"
           / f"{kind}.py").read_text()
    for anchor, line, where in WIRING[kind]:
        if src.count(anchor) != 1:
            raise RuntimeError(f"drivers/{kind}.py holds {anchor!r} "
                               f"{src.count(anchor)} times, not once")
        src = src.replace(anchor, anchor + line if where == "after"
                          else line + anchor)
    return src


def wired(kind: str):
    """The module of ``drivers/<kind>.py`` with ``WIRING[kind]``'s lines
    in place."""
    path = Path(__file__).resolve().parent / "drivers" / f"{kind}.py"
    mod = types.ModuleType(f"benchmark.drivers.{kind}")
    mod.__file__, mod.__package__ = str(path), "benchmark.drivers"
    exec(compile(wired_source(kind), str(path), "exec"), mod.__dict__)
    return mod


def with_program_metrics(metrics_for):
    """``metrics_for`` (``harness.metrics_for``) with ``PER_LAYER``'s
    entries of the cell among the traced run's metrics."""

    def both(spec_: dict, cell_name: str, trace: bool) -> list:
        extra = [m for m in PER_LAYER if cell_name in m["workloads"]]
        return metrics_for(spec_, cell_name, trace) + (extra if trace
                                                        else [])

    return both


def main(argv=None) -> int:
    from . import harness, run

    harness.driver = wired
    harness.metrics_for = with_program_metrics(harness.metrics_for)
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
