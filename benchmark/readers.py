"""Arithmetic the metric readers share (``metrics/<metric>.py``). A run's
record says its kind ("video", "image" or "train"), and the readers take
the timed items of that kind from it; each returns None where the run
has nothing to read."""

from __future__ import annotations

from .harness import F32_FLOPS_PER_S, percentile


def items(rec: dict) -> list:
    """The timed items of the run: its frames (coding) or the seconds of
    its steps (training)."""
    return rec["step_s"] if rec["kind"] == "train" else rec["frames"]


def rate(rec: dict, per_item: int = 1):
    it = items(rec)
    return None if not it else len(it) * per_item / rec["window_s"]


def latency_ms(rec: dict, q: float):
    if rec["kind"] == "train" or not items(rec):
        return None
    return percentile([(f["encode_s"] + f["decode_s"]) * 1e3
                       for f in items(rec)], q)


def span_ms(rec: dict, span: str):
    """Host ms an item spends inside ``span``, over the window."""
    it = items(rec)
    if not it or span not in rec.get("spans", {}):
        return None
    return rec["spans"][span] / len(it) * 1e3


def mfu(rec: dict):
    """Convolution FLOPs of the window per second, as a share of the
    card's float32 peak: each frame kind counted once from shapes in
    set-up (coding), or forward + backward (3x the forward) a step."""
    it = items(rec)
    if not it:
        return None
    if rec["kind"] == "train":
        flops = rec["step_flops"] * len(it)
    else:
        flops = sum(rec["flops_by_kind"][f["kind"]] for f in it)
    return 100.0 * flops / rec["window_s"] / F32_FLOPS_PER_S


def idle_pct(rec: dict):
    prof = rec.get("profile")
    if not prof:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def peak_gib(rec: dict):
    return rec["window_peak_bytes"] / 2 ** 30
