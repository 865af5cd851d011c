"""The result line and the refusals of ``run.py``."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

from . import _tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_untraced_line(monkeypatch):
    _tiny.shrink(monkeypatch)
    out = _tiny.run("evc_ll_1080p_stream", seconds=0.3)
    assert all(k in out for k in KEYS)
    assert list(out)[-1] == "checks"          # the compared numbers last
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == out["samples"]["window_items"]
    spec = harness.spec()
    want = {m["name"]: m["unit"] for m in
            harness.metrics_for(spec, "evc_ll_1080p_stream", False)}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    for k, c in out["checks"].items():
        assert c["value"] <= c["limit"]
    d = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(d)
    json.dumps(out)


def test_traced_line(monkeypatch):
    _tiny.shrink(monkeypatch)
    out = _tiny.run("dc_1080p_stream", seconds=0.1, trace=1)
    spec = harness.spec()
    want = {m["name"] for m in
            harness.metrics_for(spec, "dc_1080p_stream", True)}
    # on the CPU the trace has no device operations and K1 no launch, so
    # the readers that need them report nothing
    got = set(out["metrics"])
    assert got <= want and {"encode_ms.video", "decode_ms.video",
                            "entropy_ms.video", "mfu.video"} <= got
    assert "k1_roofline" not in got
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["correct"] is True


def _cli(args, cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=120)


def test_no_card_no_result():
    res = _cli(["--workload", "dc_1080p_stream", "--seed", "1",
                "--seconds", "1", "--trace", "0"], harness.ROOT,
               dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_bench_run_ignored(monkeypatch):
    """``BENCH_RUN`` in the environment changes nothing."""
    _tiny.shrink(monkeypatch)
    monkeypatch.setenv("BENCH_RUN", "anything")
    out = _tiny.run("evc_ll_1080p_stream", seconds=0.1)
    assert out["correct"] is True


def test_a_parameter_of_the_limits_is_not_a_number_compared():
    from benchmark.run import checks, correct

    lim = {"symbol_faults": 0, "tie_delta": 1e-5}
    assert set(checks({"symbol_faults": 0}, lim)) == {"symbol_faults"}
    assert correct(checks({"symbol_faults": 0}, lim))
    assert not correct(checks({"symbol_faults": 1}, lim))


def test_checks_count_a_missing_number_as_failed():
    from benchmark.run import checks, correct

    assert correct(checks({"a": 0.0}, {"a": 1e-4}))
    assert not correct(checks({"a": 2e-4}, {"a": 1e-4}))
    assert not correct(checks({}, {"a": 1e-4}))
    assert not correct(checks({"a": float("nan")}, {"a": 1e-4}))


@pytest.mark.parametrize("extra", [[], ["--trace", "1"]])
def test_alone_without_the_program(tmp_path, extra):
    """In a directory with only BENCHMARK.json and the benchmark's files
    the command exits non-zero and prints no result."""
    import shutil

    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    res = _cli(["--workload", "dc_1080p_stream", "--seed", "1",
                "--seconds", "1", *extra], tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""
