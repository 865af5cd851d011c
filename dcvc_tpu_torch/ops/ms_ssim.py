"""Differentiable MS-SSIM (NCHW), the fork's training distortion criterion.

Counterpart of ``dcvc_tpu/ops/ms_ssim.py``. Parity target: the fork trains
with ``pytorch_msssim.MS_SSIM(data_range=1., size_average=True,
channel=3)`` under ``--ssim`` (DCVC-HEM/src/train_CANFVC_DMC.py:74) on
``(1 - msssim) / 64`` (:199-200): a VALID separable 11-tap sigma-1.5
Gaussian as two depthwise convolutions, 2x2 average pooling between
levels (odd sizes zero-padded at the bottom / right, counted in the
mean), ReLU'd per-level cs and a weighted geometric mean.

The inference-side metric stays in ``utils/metrics.py`` (numpy); this one
exists for gradients.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# pytorch_msssim defaults
MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def gauss_kernel_1d(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur_valid(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable depthwise Gaussian, VALID padding: rows, then columns."""
    C, size = x.shape[1], win.shape[0]
    x = F.conv2d(x, win.view(1, 1, size, 1).expand(C, 1, size, 1), groups=C)
    return F.conv2d(x, win.view(1, 1, 1, size).expand(C, 1, 1, size),
                    groups=C)


def _ssim_per_channel(x, y, win, data_range, k1=0.01, k2=0.03):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu1 = _blur_valid(x, win)
    mu2 = _blur_valid(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur_valid(x * x, win) - mu1_sq
    sigma2_sq = _blur_valid(y * y, win) - mu2_sq
    sigma12 = _blur_valid(x * y, win) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    # mean over the spatial dims -> [B, C]
    return ssim_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool; an odd side is zero-padded at the bottom /
    right and the pad counted (pytorch_msssim's downsample)."""
    pad_h, pad_w = x.shape[2] % 2, x.shape[3] % 2
    if pad_h or pad_w:
        x = F.pad(x, (0, pad_w, 0, pad_h))
    return F.avg_pool2d(x, 2)


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
            win_size: int = 11, win_sigma: float = 1.5,
            weights=MS_WEIGHTS) -> torch.Tensor:
    """MS-SSIM over NCHW batches -> [B] (channel-averaged), differentiable.

    The smallest side must exceed (win_size - 1) * 2**(levels - 1), i.e. 160
    for the default 5 levels (pytorch_msssim's assert)."""
    levels = len(weights)
    min_side = min(x.shape[2], x.shape[3])
    need = (win_size - 1) * 2 ** (levels - 1)
    if min_side <= need:
        raise ValueError(
            f"image too small for {levels}-level MS-SSIM: min side {min_side}"
            f" must exceed {need}")
    win = torch.from_numpy(gauss_kernel_1d(win_size, win_sigma)).to(
        device=x.device, dtype=x.dtype)
    w = torch.tensor(weights, dtype=x.dtype, device=x.device)
    mcs = []
    ssim_pc = None
    for lvl in range(levels):
        ssim_pc, cs = _ssim_per_channel(x, y, win, data_range)
        if lvl < levels - 1:
            mcs.append(torch.relu(cs))
            x, y = _avg_pool2(x), _avg_pool2(y)
    stack = torch.stack(mcs + [torch.relu(ssim_pc)], dim=0)  # [L, B, C]
    out = torch.prod(stack ** w[:, None, None], dim=0)       # [B, C]
    return out.mean(dim=-1)


def ms_ssim_distortion(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """The fork's SSIM-mode distortion, (1 - MS-SSIM) / 64 per batch
    element. At the fork's 256 px crops this is the exact 5-level
    criterion; below 161 px the levels that do not fit are dropped and the
    kept weights renormalised (the JAX package's rule; pytorch_msssim
    asserts instead)."""
    weights = list(MS_WEIGHTS)
    min_side = min(x.shape[2], x.shape[3])
    while len(weights) > 1 and min_side <= 10 * 2 ** (len(weights) - 1):
        weights.pop()
    w = np.asarray(weights) / np.sum(weights)
    return (1.0 - ms_ssim(x, x_hat, data_range=1.0, weights=tuple(w))) / 64.0
