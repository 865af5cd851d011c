"""Runs of a cell on the CPU at a tiny frame size, for the tests."""

from __future__ import annotations

from types import SimpleNamespace

SEED = 2 ** 31 + 11


def shrink(monkeypatch, height=64, width=64, **extra):
    """Make every traffic mix code ``height`` x ``width`` frames and check
    frames 0, 1 and two of 2..4."""
    from benchmark import harness

    orig = harness.traffic

    def small(name):
        t = dict(orig(name))
        t.update(height=height, width=width, check=2, check_below=5,
                 trace=[1, 1], **extra)
        return t

    monkeypatch.setattr(harness, "traffic", small)


def run(cell: str, seconds: float = 0.5, trace: int = 0,
        seed: int = SEED) -> dict:
    from benchmark import run as brun

    args = SimpleNamespace(workload=cell, seed=seed, seconds=seconds,
                           trace=trace)
    return brun.run(args, device="cpu")
