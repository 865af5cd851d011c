"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Finds the cell in ``BENCHMARK.json``, its configuration, traffic mix and
limits under ``benchmark/``, runs the traffic's driver on the card for the
window's seconds (``--trace 1``: with spans, a profiled stretch and the
per-layer metrics), checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output. The numbers
compared, each beside its limit, are the last lines on standard error and
the last key of the result line. Exits non-zero with no result line when
the cell's cards are missing or when a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402

# build outputs of the program and any kernel cache stay in the checkout,
# at fixed paths
_CACHE = harness.ROOT / "dcvc_tpu_torch" / "_build"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(_CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(_CACHE / "triton"))
os.environ.setdefault("USE_FLAX", "0")
# one process with few host threads: the host's cores are shared, and idle
# OpenMP workers spinning beside the launching thread make runs spread
THREADS = 1
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(THREADS)


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 2


# keys of a limits file that set how a number is read, not a limit
PARAMETERS = ("tie_delta",)


def checks(readings: dict, lim: dict) -> dict:
    """Each number compared beside its limit; a number the run did not
    produce is not correct."""
    return {k: {"value": readings.get(k), "limit": v}
            for k, v in lim.items() if k not in PARAMETERS}


def correct(chk: dict) -> bool:
    return all(c["value"] is not None and math.isfinite(c["value"])
               and c["value"] <= c["limit"] for c in chk.values())


def _item_ms(rec: dict) -> list:
    """Each timed item's milliseconds: a frame's encode + decode, or a
    step."""
    if rec["kind"] == "train":
        return [round(t * 1e3, 1) for t in rec["step_s"]]
    return [round((f["encode_s"] + f["decode_s"]) * 1e3, 1)
            for f in rec["frames"]]


def run(args, device=None) -> dict:
    """The run as a result dict (the printed line), or raises. ``device``
    other than the card is for rehearsals and tests."""
    import torch

    t0 = harness.process_start()
    spec = harness.spec()
    cell = harness.cell(spec, args.workload)
    cfg = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"])
    lim = harness.limits(args.workload)
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        from dcvc_tpu_torch.device import exact_numerics

        exact_numerics()
    if cfg.get("dtype") != "float32" or cfg.get("tf32", False):
        raise ValueError("configurations here compute in float32, TF32 off")

    def since_start(t_perf: float) -> float:
        return time.time() - (time.perf_counter() - t_perf) - t0

    phases = harness.Phases(since_start)
    torch.zeros(1, device=dev)
    phases.mark("device")
    ctx = {"config": cfg, "traffic": mix, "device": dev, "seed": args.seed,
           "seconds": args.seconds, "trace": bool(args.trace),
           "cell": args.workload, "t_window": since_start, "phases": phases,
           "limits": lim}
    rec = harness.driver(mix["kind"]).run(ctx)
    found = harness.forbidden_modules()
    if found:
        raise RuntimeError(f"JAX modules loaded: {found}")

    metrics = {}
    for m in harness.metrics_for(spec, args.workload, bool(args.trace)):
        value = harness.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    chk = checks(rec["readings"], lim)
    out = {"correct": correct(chk), "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": int(cell.get("chips", 1)),
                   "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    if args.trace:
        device_info["busy_s"] = rec["profile"]["busy_s"]
        device_info["window_s"] = rec["profile"]["window_s"]
        out["breakdown"] = harness.breakdown(rec["profile"])
    out["device"] = device_info
    out["samples"] = {"window_items": rec["attempted"],
                      "item_ms": _item_ms(rec),
                      "checked": rec.get("checked"),
                      "setup_phases_s": rec.get("setup_phases"),
                      "detail": rec.get("detail")}
    out["checks"] = chk
    return out


def main(argv=None) -> int:
    args = _args(argv)
    import torch

    torch.set_num_threads(THREADS)
    spec = harness.spec()
    try:
        cell = harness.cell(spec, args.workload)
    except KeyError as e:
        return _fail(str(e))
    if not torch.cuda.is_available():
        return _fail("no CUDA device; the benchmark runs only on the card")
    if torch.cuda.device_count() < int(cell.get("chips", 1)):
        return _fail(f"{args.workload} needs {cell['chips']} cards, "
                     f"{torch.cuda.device_count()} visible")
    try:
        out = run(args)
    except Exception as e:                      # noqa: BLE001
        import traceback

        traceback.print_exc()
        return _fail(f"run failed: {e}")
    found = harness.forbidden_modules()
    if found:
        return _fail(f"JAX modules loaded: {found}")
    print(f"window: {out['attempted']} items, set-up phases "
          f"{out['samples']['setup_phases_s']}", file=sys.stderr)
    for name, v in (out["samples"]["detail"] or {}).items():
        print(f"reported {name} {v!r}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
