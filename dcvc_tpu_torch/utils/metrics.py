"""Distortion metrics: PSNR, SSIM, HM-style MS-SSIM (numpy / scipy).

The port's own copy of ``dcvc_tpu/utils/metrics.py`` (parity target:
DCVC-DC/src/utils/metrics.py:9-92): fftconvolve SSIM with an 11x11
sigma-1.5 Gaussian, MS-SSIM with the HM level drop below 176 px, the 999.9
PSNR sentinel for near-zero MSE and the 6:1:1 YUV weighting.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage, signal


def _fspecial_gauss(size: int, sigma: float) -> np.ndarray:
    x, y = np.mgrid[-size // 2 + 1: size // 2 + 1, -size // 2 + 1: size // 2 + 1]
    g = np.exp(-((x ** 2 + y ** 2) / (2.0 * sigma ** 2)))
    return g / g.sum()


def calc_ssim(img1: np.ndarray, img2: np.ndarray, data_range: float = 255):
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _fspecial_gauss(11, 1.5)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    mu1 = signal.fftconvolve(window, img1, mode="valid")
    mu2 = signal.fftconvolve(window, img2, mode="valid")
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = signal.fftconvolve(window, img1 * img1, mode="valid") - mu1_sq
    sigma2_sq = signal.fftconvolve(window, img2 * img2, mode="valid") - mu2_sq
    sigma12 = signal.fftconvolve(window, img1 * img2, mode="valid") - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    cs_map = (2.0 * sigma12 + C2) / (sigma1_sq + sigma2_sq + C2)
    return ssim_map, cs_map


def calc_msssim(img1: np.ndarray, img2: np.ndarray, data_range: float = 255) -> float:
    """2D single-channel MS-SSIM with the HM level-drop rule."""
    level = 5
    weight = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])
    height, width = img1.shape
    if height < 176 or width < 176:
        level = 4
        weight = np.array([0.0517, 0.3295, 0.3462, 0.2726])
    if height < 88 or width < 88:
        raise ValueError("image too small for MS-SSIM")
    down = np.ones((2, 2)) / 4.0
    im1, im2 = img1.astype(np.float64), img2.astype(np.float64)
    mssim, mcs = [], []
    for _ in range(level):
        ssim_map, cs_map = calc_ssim(im1, im2, data_range)
        mssim.append(ssim_map.mean())
        mcs.append(cs_map.mean())
        im1 = ndimage.convolve(im1, down, mode="reflect")[::2, ::2]
        im2 = ndimage.convolve(im2, down, mode="reflect")[::2, ::2]
    mssim, mcs = np.asarray(mssim), np.asarray(mcs)
    return float(np.prod(mcs[: level - 1] ** weight[: level - 1])
                 * (mssim[level - 1] ** weight[level - 1]))


def calc_msssim_rgb(img1: np.ndarray, img2: np.ndarray,
                    data_range: float = 255) -> float:
    """HWC inputs; channel-averaged MS-SSIM."""
    return float(np.mean([calc_msssim(img1[..., i], img2[..., i], data_range)
                          for i in range(img1.shape[-1])]))


def calc_psnr(img1: np.ndarray, img2: np.ndarray, data_range: float = 255) -> float:
    mse = np.mean(np.square(img1.astype(np.float64) - img2.astype(np.float64)))
    if mse > 1e-10:
        return float(10 * np.log10(data_range * data_range / mse))
    return 999.9


def yuv_psnr_6_1_1(psnr_y: float, psnr_u: float, psnr_v: float) -> float:
    """Weighted YUV PSNR = (6*Y + U + V) / 8 (test_conditions.md)."""
    return (6 * psnr_y + psnr_u + psnr_v) / 8
