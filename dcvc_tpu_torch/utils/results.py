"""Result aggregation to the reference's JSON schema.

The port's own copy of ``dcvc_tpu/utils/results.py`` (parity target:
generate_log_json / dump_json, DCVC-DC/src/utils/common.py:30-161): per
sequence and rate, I/P/all averages of bpp, PSNR, MS-SSIM and the encode /
decode times.
"""

from __future__ import annotations

import json
import os
from typing import Any


def _avg(values, idxs=None):
    if idxs is not None:
        values = [values[i] for i in idxs]
    return float(sum(values) / len(values)) if values else 0.0


def summarize_sequence(frame_results: list[dict], gop_structure: list[bool],
                       verbose: bool = False,
                       test_time: float | None = None) -> dict:
    """frame_results: per-frame dicts with bpp/psnr/(msssim)/enc_time/dec_time.
    gop_structure: per-frame is-I-frame flags. ``verbose`` adds the
    reference's per-frame arrays (generate_log_json verbose path,
    common.py:115-127)."""
    i_idx = [i for i, f in enumerate(gop_structure) if f]
    p_idx = [i for i, f in enumerate(gop_structure) if not f]
    keys = frame_results[0].keys()
    out: dict[str, Any] = {"frame_num": len(frame_results),
                           "i_frame_num": len(i_idx),
                           "p_frame_num": len(p_idx)}
    for k in keys:
        vals = [fr[k] for fr in frame_results]
        out[f"ave_all_frame_{k}"] = _avg(vals)
        out[f"ave_i_frame_{k}"] = _avg(vals, i_idx)
        if p_idx:
            out[f"ave_p_frame_{k}"] = _avg(vals, p_idx)
    if verbose:
        out["frame_type"] = [0 if f else 1 for f in gop_structure]
        for k in keys:
            out[f"frame_{k}"] = [fr[k] for fr in frame_results]
    if test_time is not None:
        out["test_time"] = test_time
    return out


def dump_json(obj, path: str, float_digits: int = 6):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def round_floats(o):
        if isinstance(o, float):
            return round(o, float_digits)
        if isinstance(o, dict):
            return {k: round_floats(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [round_floats(v) for v in o]
        return o

    with open(path, "w") as f:
        json.dump(round_floats(obj), f, indent=2)
