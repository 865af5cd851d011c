"""Published RD anchor numbers + Bjontegaard-delta comparison (the port's
own copy of ``dcvc_tpu/utils/rd_numbers.py``).

Anchors: the reference's checked-in Kodak RD points
(EVC/results/RD_numbers.py:3-46) — the only hard RD numbers in the repo.
bd_rate/bd_psnr implement the standard Bjontegaard metric (cubic fit of
PSNR over log-bpp, integrated over the overlapping range).
"""

from __future__ import annotations

import numpy as np

# EVC/results/RD_numbers.py — Kodak, PSNR (RGB), four rate points
EVC_KODAK = {
    "EncL_DecL": {"bpp": [0.328, 0.501, 0.732, 0.981],
                  "psnr": [32.48, 34.48, 36.42, 37.86]},
    "EncM_DecM": {"bpp": [0.333, 0.506, 0.738, 0.987],
                  "psnr": [32.47, 34.43, 36.35, 37.75]},
    "EncS_DecS": {"bpp": [0.339, 0.514, 0.750, 1.001],
                  "psnr": [32.32, 34.24, 36.09, 37.40]},
}


def _fit(bpp, psnr):
    lb = np.log(np.asarray(bpp, np.float64))
    return lb, np.polyfit(lb, np.asarray(psnr, np.float64), 3)


def bd_psnr(bpp_ref, psnr_ref, bpp_test, psnr_test) -> float:
    """Average PSNR delta (test - ref) over the overlapping bpp range, dB."""
    lr, pr = _fit(bpp_ref, psnr_ref)
    lt, pt = _fit(bpp_test, psnr_test)
    lo, hi = max(lr.min(), lt.min()), min(lr.max(), lt.max())
    if hi <= lo:
        raise ValueError("no overlapping bpp range")
    ir = np.polyint(pr)
    it = np.polyint(pt)
    return float(((np.polyval(it, hi) - np.polyval(it, lo))
                  - (np.polyval(ir, hi) - np.polyval(ir, lo))) / (hi - lo))


def bd_rate(bpp_ref, psnr_ref, bpp_test, psnr_test) -> float:
    """Average bitrate delta (test vs ref) at equal PSNR, percent."""
    pr = np.polyfit(np.asarray(psnr_ref, np.float64),
                    np.log(np.asarray(bpp_ref, np.float64)), 3)
    pt = np.polyfit(np.asarray(psnr_test, np.float64),
                    np.log(np.asarray(bpp_test, np.float64)), 3)
    lo = max(min(psnr_ref), min(psnr_test))
    hi = min(max(psnr_ref), max(psnr_test))
    if hi <= lo:
        raise ValueError("no overlapping PSNR range")
    ir = np.polyint(pr)
    it = np.polyint(pt)
    avg = ((np.polyval(it, hi) - np.polyval(it, lo))
           - (np.polyval(ir, hi) - np.polyval(ir, lo))) / (hi - lo)
    return float((np.exp(avg) - 1) * 100)
