"""Readings that the limits of a cell are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \\
        [--twin-seeds 4 5 6] [--control-seeds 7 8 9] \\
        [--fault-seeds 7 8 9] [--out path.json]

For each seed the program does, in one process, what a run of that seed
checks (a coding cell codes its frames up to the last one checked; a
training cell takes its checked steps) and the reference reads the
cell's numbers. For each control seed the reference itself, computed in
TF32 (the precision below the configurations' float32), takes the
program's place. For each twin seed of a coding cell the reference takes
it with every dense convolution accumulated in float64 and rounded to
float32: another exact order of the same sums, which has to pass. For
each fault seed a training cell's program leaves half of each batch out,
and a coding cell's program runs once with each of its faults
(``faults.py``). A limit must let every sound seed pass and fail the
control. Prints one JSON line per reading and writes them all to
``--out``. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import faults, harness  # noqa: E402
from benchmark.run import checks, correct  # noqa: E402


def read_seed(cell: str, seed: int, device, mode: str = "program",
              traffic=None) -> dict:
    spec = harness.spec()
    c = harness.cell(spec, cell)
    cfg = harness.config(c["config"])
    mix = traffic or harness.traffic(c["traffic"])
    ctx = {"config": cfg, "traffic": mix, "device": device, "seed": seed,
           "limits": harness.limits(cell)}
    t = time.time()
    out = harness.driver(mix["kind"]).calibrate(ctx, mode)
    return {"cell": cell, "seed": seed, "mode": mode,
            "seconds": time.time() - t, **out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--twin-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from dcvc_tpu_torch.device import exact_numerics

    exact_numerics()
    dev = torch.device("cuda")
    c = harness.cell(harness.spec(), args.workload)
    lim = harness.limits(args.workload)
    kind = harness.traffic(c["traffic"])["kind"]
    # a coding cell's faults are planted in the program; the training
    # driver leaves half of each batch out itself
    planted = ({} if kind == "train_step" else
               {f.__name__[1:]: f for f in
                faults.coding(harness.config(c["config"]))})
    rows = []
    for seed, mode in ([(s, "program") for s in args.seeds]
                       + [(s, "twin") for s in args.twin_seeds]
                       + [(s, "control") for s in args.control_seeds]
                       + [(s, m) for s in args.fault_seeds
                          for m in planted or ["half_batch"]]):
        if mode in planted:
            with faults.applied(planted[mode]):
                row = dict(read_seed(args.workload, seed, dev), mode=mode)
        else:
            row = read_seed(args.workload, seed, dev, mode)
        row["correct"] = correct(checks(row, lim))
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).write_text(json.dumps(rows, indent=1))
    if harness.forbidden_modules():
        print(f"calibrate: JAX modules loaded {harness.forbidden_modules()}",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
