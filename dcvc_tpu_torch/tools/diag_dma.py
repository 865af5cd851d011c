"""Dynamic-offset band copy probe (K2) on the card.

Counterpart of ``tools/diag_dma.py``: per output row a ``[A, C, Wp]`` f32
band at a dynamic row start is staged on chip (``ops/band_copy.py``, the
CUDA kernel), at the probe's realistic tile-warp shape. Same shapes, the
same seeded ``by`` construction (a jitter of -8..7 rows around each row,
clipped to the frame) and the same timed loop over ``(by + 1) % (H - A)``.

    python -m dcvc_tpu_torch.tools.diag_dma [--device cuda|cpu] [--sweep]

prints the card's name and power limit, then the time of one call, the time
per band copy and the rate over the ``H * A * Wp * C * 4`` bytes requested,
and on the card the kernel's launch plan (``ops/band_copy.py:plan_band_copy``).
``--sweep`` (card only) also times the kernel alone under the plans of
``SWEEP`` (chunks per band, ring stages, chunk-boundary granularity) and
prints one JSON line per plan.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import card_line, resolve_device
from ..ops import band_copy as bc
from ..ops.band_copy import band_copy, plan_for

H, WP, C, A = 720, 1408, 16, 4
# (chunks per band, ring stages, chunk boundaries in bytes); None: the rule
# (the rule gives 7 x 4 stages / 128 B at the tool's shape)
SWEEP = [(None, None, None), (5, 3, 16), (5, 3, 128), (4, 2, 128),
         (6, 3, 128), (8, 4, 128), (11, 4, 128), (16, 4, 128)]


def make_inputs(H: int, Wp: int, C: int, A: int, device, seed: int = 0):
    """``src`` [H + A, C, Wp] f32 normal, ``by`` [H] int32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    src = torch.randn(H + A, C, Wp, generator=gen, device=device)
    rng = np.random.default_rng(seed + 1)
    by = np.clip(rng.integers(-8, 8, H) + np.arange(H), 0, H - 1)
    return src, torch.from_numpy(by.astype(np.int32)).to(device)


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Card time of one ``fn()``: ``iters`` calls captured in one CUDA graph
    and replayed ``reps`` times between two events, so the host's launch
    cost is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                 # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def sweep(H: int = H, Wp: int = WP, C: int = C, A: int = A,
          verbose: bool = True) -> list:
    """The kernel alone (``graph_ms``) under each plan of ``SWEEP``, each
    output checked against the plain version at atol 0. A last row runs
    the rule's plan with every ``by`` at 0: all 720 bands are the same
    four rows, so every requested byte comes from L2 (the L2 -> SM rate
    alone)."""
    src, by = make_inputs(H, Wp, C, A, "cuda")
    cases = [(v, by, "") for v in SWEEP]
    cases.append(((None, None, None), torch.zeros_like(by), ", by = 0"))
    rows = []
    for (n_chunks, stages, split), b, tag in cases:
        plain = bc.band_copy_plain(src, b)
        plan = bc.plan_band_copy(H, Wp, C, A, 8, bc.sm_count(src.device),
                                 n_chunks=n_chunks, stages=stages, split=split)
        out = bc._launch(src, b, A, 8, plan)
        err = (out - plain).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"band_copy plan {plan}: max abs err {err}")
        row = {"variant": ("rule" if n_chunks is None else
                           f"{n_chunks}x{stages}st/{split}B") + tag,
               "chunks_per_band": plan.n_chunks, "ring_stages": plan.NST,
               "split": plan.split, "chunk_bytes": plan.chunk(0)[1],
               "smem_bytes": plan.smem, "max_abs_err": err,
               "ms": graph_ms(lambda: bc._launch(src, b, A, 8, plan))}
        rows.append(row)
        if verbose:
            print(json.dumps(row), flush=True)
    return rows


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(H: int = H, Wp: int = WP, C: int = C, A: int = A, iters: int = 10,
        device=None, verbose: bool = True) -> dict:
    """One checked call, then ``iters`` timed calls. Returns the row."""
    dev = resolve_device(device)
    src, by = make_inputs(H, Wp, C, A, dev)
    out = band_copy(src, by, A)
    # one untimed turn of the loop: its elementwise ops load on first use
    band_copy(src, (by + 1) % (H - A), A, check_range=False)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        # (by + 1) % (H - A) stays inside [0, H - A), so every band fits
        out = band_copy(src, (by + 1) % (H - A), A, check_range=False)
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    nbytes = H * A * Wp * C * 4
    card = card_line() if dev.type == "cuda" else "cpu"
    row = {"card": card, "shape": {"H": H, "Wp": Wp, "C": C, "A": A},
           "ms": dt * 1e3, "ns_per_band": dt / H * 1e9,
           "requested_bytes": nbytes, "gbps": nbytes / dt / 1e9,
           "out_finite": bool(torch.isfinite(out).all())}
    if dev.type == "cuda":
        plan = plan_for(src, by, A, 8, out)
        row["plan"] = {"ctas": plan.grid, "chunks_per_band": plan.n_chunks,
                       "ring_stages": plan.NST, "bulk": plan.bulk}
    if verbose:
        print(f"{card}: {H} dynamic band copies of [{A},{C},{Wp}]f32: "
              f"{row['ms']:.3f} ms -> {row['ns_per_band']:.0f} ns/copy, "
              f"{row['gbps']:.0f} GB/s; plan {row.get('plan', 'cpu')}",
              flush=True)
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--H", type=int, default=H)
    p.add_argument("--Wp", type=int, default=WP)
    p.add_argument("--C", type=int, default=C)
    p.add_argument("--A", type=int, default=A)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--sweep", action="store_true")
    args = p.parse_args(argv)
    run(args.H, args.Wp, args.C, args.A, args.iters, args.device)
    if args.sweep:
        sweep(args.H, args.Wp, args.C, args.A)


if __name__ == "__main__":
    main()
