"""The program's own spans and counters as the benchmark reads them
(``program_trace.py`` and its readers): idle intervals put down to what the
host was in, the readers on records, and tiny CPU runs of the drivers
with ``program_trace.WIRING``'s lines in (``start()`` as the traced window
opens, ``finish(prof)`` as it closes)."""

from types import SimpleNamespace

import pytest

from benchmark import harness, program_trace
from benchmark.drivers import coding_stream, train_step

from . import _tiny

CUDA, CPU = "DeviceType.CUDA", "DeviceType.CPU"


def _ev(s, e, name, dev=CPU, thread=1):
    return SimpleNamespace(time_range=SimpleNamespace(start=s, end=e),
                           name=name, device_type=dev, thread=thread,
                           is_user_annotation=False)


class _Prof:
    def __init__(self, events):
        self._e = events

    def events(self):
        return self._e


def _idle_s(prof, labels):
    p = harness.reduce_profile(prof, labels)
    return p["window_s"] - p["busy_s"]


def test_idle_by_span_labels_each_gap():
    prof = _Prof([
        _ev(0, 200, "stretch"),
        _ev(10, 100, "runtime.compress"), _ev(20, 40, "rans"),
        _ev(50, 60, "runtime.readback"), _ev(70, 75, "runtime.upload"),
        _ev(110, 190, "runtime.decompress"),
        _ev(120, 150, "rans", thread=2),          # a worker: not the caller
        _ev(0, 5, "conv", CUDA), _ev(30, 35, "conv", CUDA),
        _ev(55, 58, "copy", CUDA), _ev(80, 115, "conv", CUDA),
        _ev(150, 210, "conv", CUDA),              # clipped at the stretch
    ])
    got = program_trace.idle_by_span(prof)
    # idle 5-30: outside 5, host 10, rans 10; 35-55: rans 5, host 10,
    # readback 5; 58-80: readback 2, host 10, upload 5, host 5; 115-150:
    # host 35
    want = {"outside": 5, "host": 70, "rans": 15, "readback": 7, "upload": 5}
    assert got["window_s"] == pytest.approx(200e-6)
    assert got["idle_s"] == pytest.approx({k: v * 1e-6
                                           for k, v in want.items()})
    assert sum(got["idle_s"].values()) == pytest.approx(
        _idle_s(prof, ("runtime.compress",)))


def test_idle_by_span_puts_the_loss_readback_down_to_readback():
    prof = _Prof([_ev(0, 120, "stretch"), _ev(0, 100, "train.step"),
                  _ev(80, 100, "train.readback"), _ev(0, 50, "bwd", CUDA)])
    got = program_trace.idle_by_span(prof)["idle_s"]
    assert got == pytest.approx({"host": 30e-6, "readback": 20e-6,
                                 "outside": 20e-6, "rans": 0.0,
                                 "upload": 0.0})


def _span(name, start, end, thread=7, **attrs):
    return {"name": name, "start_ns": start, "end_ns": end,
            "thread": thread, "attrs": attrs}


def test_readers_read_the_program_trace():
    rec = {"kind": "video", "frames": [{}, {}],
           "program_trace": {
               "spans": [_span("runtime.compress", 0, 10_000_000),
                         _span("runtime.readback", 0, 1_000_000),
                         _span("runtime.readback", 2_000_000, 5_000_000),
                         _span("rans", 0, 500, op="encode_with_indexes"),
                         _span("rans", 600, 700, op="flush"),
                         # a worker's call: its symbols are counted too
                         _span("rans", 0, 400, thread=9,
                               op="encode_with_indexes")],
               "counters": {"rans.symbols": 4}},
           "idle_by_program_span": {"window_s": 2.0, "idle_s": {
               "rans": 0.5, "host": 0.1, "readback": 0.0, "upload": 0.0,
               "outside": 0.2}}}
    read = {m: harness.reader(f"{m}.video").read(rec) for m in
            ("readback_ms", "rans_ns_per_symbol", "idle_rans_pct",
             "idle_host_pct")}
    assert read == pytest.approx({"readback_ms": 2.0,
                                  "rans_ns_per_symbol": 250.0,
                                  "idle_rans_pct": 25.0,
                                  "idle_host_pct": 5.0})
    bare = {"kind": "image", "frames": [{}]}
    for m in read:
        assert harness.reader(f"{m}.image").read(bare) is None


def test_rans_ns_per_symbol_holds_the_async_workers_time_and_symbols():
    """The worker encodes and counts its symbols on its own thread; the
    reader takes its time with them, and the caller's spans hold no wait
    for it."""
    import numpy as np

    from dcvc_tpu_torch.entropy.bit_estimator import (
        BitEstimator, build_factorized_tables, encode_factorized)
    from dcvc_tpu_torch.entropy.coder import AsyncEntropyCoder
    from dcvc_tpu_torch.utils import trace

    table = build_factorized_tables(BitEstimator(4))
    z = np.random.default_rng(1).integers(-3, 3, (1, 8, 8, 4)).astype(
        np.float32)
    coder = AsyncEntropyCoder()
    program_trace.start()
    try:
        coder.reset()
        encode_factorized(coder, z, table)
        coder.flush()
        coder.get_encoded_stream()
    finally:
        trace.disable()
        coder.close()
    t = trace.take()
    rec = {"kind": "video", "frames": [{}], "program_trace": t}
    rans = [s for s in t["spans"] if s["name"] == "rans"]
    worker = [s for s in rans if s["thread"] == coder._worker.ident]
    assert {s["attrs"]["op"] for s in worker} == {"encode_with_indexes",
                                                  "flush"}
    assert t["counters"]["rans.symbols"] == z.size
    assert harness.reader("rans_ns_per_symbol.video").read(rec) == \
        pytest.approx(sum(s["end_ns"] - s["start_ns"] for s in rans)
                      / z.size)


def test_per_layer_entries_fit_the_benchmark():
    """``PER_LAYER`` is what BENCHMARK.json gains when the drivers are
    wired: new names, the keys and layers the accepted entries have, and
    for each cell an end-to-end metric the cell reports."""
    spec = harness.spec()
    old = spec["per_layer"]
    names = {m["name"] for m in old + spec["end_to_end"]}
    layers = {m["layer"] for m in old}
    for m in program_trace.PER_LAYER:
        assert set(m) == set(old[0]) and m["name"] not in names
        assert m["layer"] in layers
        cell, = m["workloads"]
        harness.cell(spec, cell)
        assert m["moves"] in {e["name"] for e in
                              harness.metrics_for(spec, cell, False)}
        # one reader a quantity, found by the harness's fallback
        assert harness.reader(m["name"]).read({"kind": "video",
                                               "frames": []}) is None


def test_wiring_adds_only_its_lines_to_each_driver():
    import difflib

    for kind, lines in program_trace.WIRING.items():
        src = (harness.BENCH / "drivers" / f"{kind}.py").read_text()
        diff = [d for d in difflib.ndiff(
            src.splitlines(True), program_trace.wired_source(kind)
            .splitlines(True)) if d[0] in "+-"]
        added = "".join(line for _, line, _ in lines)
        assert all(d[0] == "+" for d in diff)
        assert "".join(d[2:] for d in diff) == added
        assert program_trace.wired(kind).program_trace is program_trace


@pytest.fixture
def wired(monkeypatch):
    """The drivers with ``program_trace.WIRING``'s lines and the traced
    runs with ``PER_LAYER``'s metrics, as ``python3 -m
    benchmark.program_trace`` runs them; each run's record appended to the
    list."""
    from dcvc_tpu_torch.utils import trace

    recs = []

    def driver(kind):
        run = program_trace.wired(kind).run

        def recorded(ctx):
            rec = run(ctx)
            recs.append(rec)
            return rec

        return SimpleNamespace(run=recorded)

    monkeypatch.setattr(harness, "driver", driver)
    monkeypatch.setattr(harness, "metrics_for",
                        program_trace.with_program_metrics(
                            harness.metrics_for))
    yield recs
    trace.disable()
    trace.take()


def _sums_to_idle(rec):
    prof = rec["profile"]
    idle = rec["idle_by_program_span"]
    assert idle["window_s"] == pytest.approx(prof["window_s"])
    assert sum(idle["idle_s"].values()) == pytest.approx(
        prof["window_s"] - prof["busy_s"])


def test_tiny_traced_coding_run_reads_the_program(monkeypatch, wired):
    from dcvc_tpu_torch.models.video_dc import CH_MV, G_CH

    _tiny.shrink(monkeypatch)
    out = _tiny.run("dc_1080p_stream", seconds=0.1, trace=1)
    assert out["correct"] is True
    rec, = wired
    got = {m: v["value"] for m, v in out["metrics"].items()}
    assert {m["name"] for m in program_trace.PER_LAYER
            if m["name"].endswith(".video")} <= set(got)
    assert got["readback_ms.video"] > 0
    assert got["rans_ns_per_symbol.video"] > 0
    names = [s["name"] for s in rec["program_trace"]["spans"]]
    n = len(rec["frames"])
    assert names.count("runtime.compress") == names.count(
        "runtime.decompress") == n
    # 64 x 64: z 1 x 1, y 4 x 4; an I-frame's z and y have 256 channels, a
    # P-frame's mv_z + z and mv_y + y 64 + 128; each symbol encoded and
    # decoded once
    per = {"I": 256 * 17, "P1": (CH_MV + G_CH["16x"]) * 17}
    per["P"] = per["P1"]
    assert rec["program_trace"]["counters"]["rans.symbols"] == sum(
        2 * per[f["kind"]] for f in rec["frames"])
    _sums_to_idle(rec)
    # on the CPU no device operation runs: the stretch is idle throughout,
    # and the runtime calls hold most of it
    assert rec["idle_by_program_span"]["idle_s"]["host"] > 0


def test_tiny_traced_train_run_records_its_steps(monkeypatch, wired):
    _tiny.shrink(monkeypatch, crop=64, batch=2, pool=4, remat=False)
    out = _tiny.run("dc_train_256", seconds=0.1, trace=1)
    assert out["correct"] is True
    rec, = wired
    spans = rec["program_trace"]["spans"]
    steps = [s for s in spans if s["name"] == "train.step"]
    reads = [s for s in spans if s["name"] == "train.readback"]
    assert len(steps) == len(reads) == len(rec["step_s"])
    assert {s["parent"] for s in reads} == {s["id"] for s in steps}
    _sums_to_idle(rec)
    assert "idle_host_pct.train" in out["metrics"]


def test_untraced_run_leaves_the_recorder_off(monkeypatch, wired):
    from dcvc_tpu_torch.utils import trace

    _tiny.shrink(monkeypatch)
    out = _tiny.run("evc_ll_1080p_stream", seconds=0.1)
    rec, = wired
    assert out["correct"] is True
    assert "program_trace" not in rec and not trace.enabled()
    assert trace.take() == {"spans": [], "counters": {}}
    for m in ("readback_ms", "rans_ns_per_symbol", "idle_rans_pct",
              "idle_host_pct"):
        assert harness.reader(f"{m}.image").read(rec) is None
