"""Per-test phase times of a pytest run, and their sums by file and worker.

As a pytest plugin it appends one JSON line per test phase (setup, call,
teardown) to the file named by ``PHASE_TIMES``: the test, the xdist worker,
start and stop on the host's clock, the duration, the outcome, and the
seconds that JAX spent tracing, lowering and compiling inside that phase
(``jax._src.monitoring`` duration events)::

    PYTHONPATH=tests PHASE_TIMES=/tmp/t.jsonl python -m pytest ... -p _phase_times

Under xdist the controller writes the lines; each worker sends its phase's
JAX seconds along with its report. Run as a script it sums a file::

    python tests/_phase_times.py /tmp/t.jsonl [--tests N]

printing each port file's (``test_torch_port_*``) setup + call seconds and
the JAX seconds inside them, then each worker's files in the order it ran
them, then the ``N`` longest tests.
"""

import collections
import json
import os
import sys

import pytest

_OUT = os.environ.get("PHASE_TIMES")
_EVENTS = ("jaxpr_trace_duration", "jaxpr_to_mlir_module_duration",
           "backend_compile_duration")
_acc = collections.Counter()
_hooked = []


def _listen():
    if _hooked:
        return
    from jax._src import monitoring

    def on_event(event, seconds, **_):
        name = event.rsplit("/", 1)[-1]
        if name in _EVENTS:
            _acc[name] += seconds
            _acc[name + "_n"] += 1

    monitoring.register_event_duration_secs_listener(on_event)
    _hooked.append(True)


def pytest_sessionstart(session):
    if _OUT:
        _listen()


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    report = (yield).get_result()
    if _OUT:
        report.user_properties.append(("jax_seconds", dict(_acc)))
        _acc.clear()


def pytest_runtest_logreport(report):
    # under xdist only the controller's reports carry the worker's node
    if not _OUT or (os.environ.get("PYTEST_XDIST_WORKER")
                    and not hasattr(report, "node")):
        return
    node = getattr(report, "node", None)
    jax_seconds = dict(report.user_properties).get("jax_seconds", {})
    with open(_OUT, "a") as f:
        f.write(json.dumps({
            "id": report.nodeid, "when": report.when,
            "worker": getattr(getattr(node, "gateway", None), "id", "-"),
            "start": report.start, "stop": report.stop,
            "seconds": report.duration, "outcome": report.outcome,
            "jax": jax_seconds}) + "\n")


def summarize(path, n_tests=0):
    rows = [json.loads(line) for line in open(path)]
    t0 = min(r["start"] for r in rows)
    per_file = collections.defaultdict(float)
    per_file_jax = collections.defaultdict(float)
    per_test = collections.defaultdict(float)
    span = {}
    order = collections.defaultdict(list)
    for r in sorted(rows, key=lambda r: r["start"]):
        f = r["id"].split("::")[0]
        if r["when"] in ("setup", "call"):
            per_file[f] += r["seconds"]
            per_file_jax[f] += sum(r["jax"].get(k, 0.0) for k in _EVENTS)
            per_test[r["id"]] += r["seconds"]
        s, e = span.get(f, (r["start"], r["stop"]))
        span[f] = (min(s, r["start"]), max(e, r["stop"]))
        if f not in order[r["worker"]]:
            order[r["worker"]].append(f)
    port = {f: v for f, v in per_file.items() if "test_torch_port_" in f}
    print(f"all files {sum(per_file.values()):.1f} s setup + call; "
          f"port files {sum(port.values()):.1f} s over {len(port)}; "
          f"other files {sum(per_file.values()) - sum(port.values()):.1f} s")
    print("  seconds  JAX trace + lower + compile (nested traces count twice)")
    for f, v in sorted(port.items(), key=lambda kv: -kv[1]):
        print(f"  {v:8.1f}  {per_file_jax[f]:8.1f}  {f}")
    for w, files in sorted(order.items()):
        end = max(span[f][1] for f in files) - t0
        print(f"worker {w}: last phase ends {end:.1f} s after the first")
        for f in files:
            s, e = span[f]
            print(f"  {s - t0:8.1f} -> {e - t0:8.1f}  {per_file[f]:8.1f}  {f}")
    for t, v in sorted(per_test.items(), key=lambda kv: -kv[1])[:n_tests]:
        print(f"  {v:8.1f}  {t}")


if __name__ == "__main__":
    args = sys.argv[1:]
    n = int(args[args.index("--tests") + 1]) if "--tests" in args else 0
    summarize(args[0], n)
