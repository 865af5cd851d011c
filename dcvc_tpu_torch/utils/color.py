"""BT.709 color transforms (numpy, HWC layout).

The port's own copy of ``dcvc_tpu/utils/color.py`` (parity target:
DCVC-DC/src/transforms/functional.py:10-126): the same coefficients and 420
resampling rules (2x2 mean down, scipy-zoom order-0/1 up). Frames on the
host are HWC numpy arrays in [0, 1].
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage

# ITU-R BT.709: (K_r, K_g, K_b), K_g = 1 - K_r - K_b
KR, KG, KB = 0.2126, 0.7152, 0.0722


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """HWC RGB [0,1] -> HWC YCbCr [0,1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = KR * r + KG * g + KB * b
    cb = 0.5 * (b - y) / (1 - KB) + 0.5
    cr = 0.5 * (r - y) / (1 - KR) + 0.5
    return np.clip(np.stack([y, cb, cr], axis=-1), 0.0, 1.0)


def ycbcr_to_rgb(yuv: np.ndarray) -> np.ndarray:
    """HWC YCbCr [0,1] -> HWC RGB [0,1]."""
    y, cb, cr = yuv[..., 0], yuv[..., 1], yuv[..., 2]
    r = y + (2 - 2 * KR) * (cr - 0.5)
    b = y + (2 - 2 * KB) * (cb - 0.5)
    g = (y - KR * r - KB * b) / KG
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def _down420(c: np.ndarray) -> np.ndarray:
    h, w = c.shape
    return np.mean(c.reshape(h // 2, 2, w // 2, 2), axis=(1, 3))


def rgb_to_ycbcr420(rgb: np.ndarray):
    """HWC RGB [0,1] -> (y [H,W], uv [2,H/2,W/2])."""
    yuv = rgb_to_ycbcr(rgb)
    y = yuv[..., 0]
    uv = np.stack([_down420(yuv[..., 1]), _down420(yuv[..., 2])], axis=0)
    return np.clip(y, 0, 1), np.clip(uv, 0, 1)


def ycbcr420_to_444(y: np.ndarray, uv: np.ndarray, order: int = 1) -> np.ndarray:
    """(y [H,W], uv [2,H/2,W/2]) -> HWC YCbCr; order 0=nearest, 1=bilinear."""
    uv_up = scipy.ndimage.zoom(uv, (1, 2, 2), order=order)
    return np.stack([y, uv_up[0], uv_up[1]], axis=-1)


def ycbcr444_to_420(yuv: np.ndarray):
    """HWC YCbCr -> (y, uv) with 2x2-mean chroma downsampling."""
    y = yuv[..., 0]
    uv = np.stack([_down420(yuv[..., 1]), _down420(yuv[..., 2])], axis=0)
    return np.clip(y, 0, 1), np.clip(uv, 0, 1)


def ycbcr420_to_rgb(y: np.ndarray, uv: np.ndarray, order: int = 1) -> np.ndarray:
    return ycbcr_to_rgb(ycbcr420_to_444(y, uv, order))
