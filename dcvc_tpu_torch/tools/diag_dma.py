"""Dynamic-offset band copy probe (K2) on the card.

Counterpart of ``tools/diag_dma.py``: per output row a ``[A, C, Wp]`` f32
band at a dynamic row start is staged on chip (``ops/band_copy.py``, the
CUDA kernel), at the probe's realistic tile-warp shape. Same shapes, the
same seeded ``by`` construction (a jitter of -8..7 rows around each row,
clipped to the frame) and the same timed loop over ``(by + 1) % (H - A)``.

    python -m dcvc_tpu_torch.tools.diag_dma [--device cuda|cpu]

prints the card's name and power limit, then the time of one call, the time
per band copy and the rate over the ``H * A * Wp * C * 4`` bytes requested.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import card_line, resolve_device
from ..ops.band_copy import band_copy

H, WP, C, A = 720, 1408, 16, 4


def make_inputs(H: int, Wp: int, C: int, A: int, device, seed: int = 0):
    """``src`` [H + A, C, Wp] f32 normal, ``by`` [H] int32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    src = torch.randn(H + A, C, Wp, generator=gen, device=device)
    rng = np.random.default_rng(seed + 1)
    by = np.clip(rng.integers(-8, 8, H) + np.arange(H), 0, H - 1)
    return src, torch.from_numpy(by.astype(np.int32)).to(device)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(H: int = H, Wp: int = WP, C: int = C, A: int = A, iters: int = 10,
        device=None, verbose: bool = True) -> dict:
    """One checked call, then ``iters`` timed calls. Returns the row."""
    dev = resolve_device(device)
    src, by = make_inputs(H, Wp, C, A, dev)
    out = band_copy(src, by, A)
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
    if verbose:
        print(f"{card}: {H} dynamic band copies of [{A},{C},{Wp}]f32: "
              f"{row['ms']:.3f} ms -> {row['ns_per_band']:.0f} ns/copy, "
              f"{row['gbps']:.0f} GB/s", flush=True)
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--H", type=int, default=H)
    p.add_argument("--Wp", type=int, default=WP)
    p.add_argument("--C", type=int, default=C)
    p.add_argument("--A", type=int, default=A)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(args.H, args.Wp, args.C, args.A, args.iters, args.device)


if __name__ == "__main__":
    main()
