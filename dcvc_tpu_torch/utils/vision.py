"""Visualization / debug utilities (the port's own copy of
``dcvc_tpu/utils/vision.py``; numpy only).

Parity target: the fork's vis tools (DCVC-HEM/src/utils/vision.py): optical
flow to color wheel, heatmaps, pad-to-multiple alignment helpers.
"""

from __future__ import annotations

import numpy as np


def _make_color_wheel() -> np.ndarray:
    """Middlebury flow color wheel (55 x 3)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[:RY, 0] = 255
    wheel[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_color(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """[H, W, 2] flow -> [H, W, 3] uint8 color-wheel visualization."""
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max_flow if max_flow else max(rad.max(), 1e-6)
    u, v = u / maxrad, v / maxrad
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    wheel = _make_color_wheel()
    ncols = wheel.shape[0]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros((*u.shape, 3), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255
        col1 = wheel[k1, c] / 255
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., c] = np.floor(255 * col)
    return img


def heatmap(x: np.ndarray) -> np.ndarray:
    """[H, W] scalar map -> [H, W, 3] uint8 blue->red heatmap."""
    x = x.astype(np.float64)
    x = (x - x.min()) / max(x.max() - x.min(), 1e-9)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def ctu_crop(x_hwc: np.ndarray, ctu_size: int = 64,
             pad_if_needed: bool = False,
             padding_mode: str = "constant") -> np.ndarray:
    """CTU-align a frame: crop to a multiple of ``ctu_size`` (top-left
    anchored), or pad up to one when ``pad_if_needed`` (fork's CTUCrop
    transform, DCVC-HEM/src/utils/vision.py:74-137 — used to feed test
    sequences whose dims aren't codec-aligned into training/eval)."""
    h, w = x_hwc.shape[:2]
    if pad_if_needed:
        ph = (-h) % ctu_size
        pw = (-w) % ctu_size
        if not (ph or pw):
            return x_hwc
        mode = {"constant": "constant", "edge": "edge",
                "reflect": "reflect", "symmetric": "symmetric"}[padding_mode]
        pad = ((0, ph), (0, pw)) + ((0, 0),) * (x_hwc.ndim - 2)
        return np.pad(x_hwc, pad, mode=mode)
    return x_hwc[:h - h % ctu_size, :w - w % ctu_size]


_COLOR_RAMPS = {
    # fork gen_color color tables (DCVC-HEM/src/utils/vision.py:152-209)
    "RAINBOW": np.array([[255, 0, 0], [255, 127, 0], [240, 255, 0],
                         [0, 255, 0], [0, 30, 255], [75, 0, 130],
                         [148, 0, 211]]) / 255.0,
    "K": np.array([[0, 0, 0], [0, 0, 0]]) / 255.0,
    "G": np.array([[117, 249, 76], [117, 249, 76]]) / 255.0,
    "U": np.array([[0, 255, 0], [0, 0, 255]]) / 255.0,
    "V": np.array([[0, 255, 0], [255, 0, 0]]) / 255.0,
}


def gen_color(colors="RAINBOW", n: int = 10) -> np.ndarray:
    """[n, 3] float colormap ramp by linear interpolation through anchor
    colors (fork gen_color, vision.py:152-209; numpy instead of torch)."""
    if isinstance(colors, str):
        if colors == "RAINBOW2":
            anchors = _COLOR_RAMPS["RAINBOW"] * 0.5
        elif colors == "RB":
            assert n % 2 == 0
            r = np.array([[255, 0, 0], [255, 200, 200]]) / 255.0
            b = np.array([[0, 0, 255], [200, 200, 255]]) / 255.0
            return np.concatenate([gen_color(r, n // 2),
                                   gen_color(b, n // 2)])
        else:
            anchors = _COLOR_RAMPS[colors]
    else:
        anchors = np.asarray(colors, np.float64)
    c = len(anchors)
    ln = (n * 10 - 1) // (c - 1) + 1
    segs = []
    for i in range(c - 1):
        seg = np.linspace(anchors[i], anchors[i + 1], ln)
        segs.append(seg[1:] if i else seg)
    ramp = np.concatenate(segs, axis=0)
    idx = np.linspace(0, len(ramp) - 1, n).astype(int)
    return ramp[idx]


def plot_heatmap(x_hw: np.ndarray, color: str = "RAINBOW",
                 vmin: float = 0.0, vmax: float = 1.0) -> np.ndarray:
    """Scalar map -> [H, W, 3] uint8 via a gen_color ramp (fork PlotHeatMap,
    vision.py:211-238; values outside [vmin, vmax] clamp to the ramp ends)."""
    ramp = gen_color(color, n=64)
    t = np.clip((x_hw.astype(np.float64) - vmin) / max(vmax - vmin, 1e-9),
                0, 1) * (len(ramp) - 1)
    k0 = np.floor(t).astype(int)
    k1 = np.minimum(k0 + 1, len(ramp) - 1)
    f = (t - k0)[..., None]
    out = ramp[k0] * (1 - f) + ramp[k1] * f
    return (out * 255).astype(np.uint8)


def plot_yuv(y_hw: np.ndarray, u_hw: np.ndarray,
             v_hw: np.ndarray) -> np.ndarray:
    """Y as grayscale beside U/V chroma heatmaps (fork PlotYUV,
    vision.py:241-260): 444 inputs -> [H, 3W, 3]; 420 chroma (half-size
    U/V) -> [H, 2W, 3] with U over V."""
    y = (np.clip(y_hw, 0, 1)[..., None].repeat(3, -1) * 255).astype(np.uint8)
    u = plot_heatmap(u_hw, "U")
    v = plot_heatmap(v_hw, "V")
    if u_hw.shape == y_hw.shape:
        return np.concatenate([y, u, v], axis=1)
    return np.concatenate([y, np.concatenate([u, v], axis=0)], axis=1)


def feature_map_grid(fmap_chw: np.ndarray, nrow: int = 25,
                     pad: int = 1) -> np.ndarray:
    """[C, H, W] feature maps -> one [gh*(H+pad), gw*(W+pad)] grid image,
    each map min-max normalized (fork show_feature_map's
    save_image(..., normalize=True, scale_each=True), vision.py:148-150)."""
    C, H, W = fmap_chw.shape
    lo = fmap_chw.reshape(C, -1).min(axis=1)[:, None, None]
    hi = fmap_chw.reshape(C, -1).max(axis=1)[:, None, None]
    norm = (fmap_chw - lo) / np.maximum(hi - lo, 1e-9)
    gw = min(nrow, C)
    gh = (C + gw - 1) // gw
    grid = np.zeros((gh * (H + pad) - pad, gw * (W + pad) - pad), np.float32)
    for i in range(C):
        r, c = divmod(i, gw)
        grid[r * (H + pad):r * (H + pad) + H,
             c * (W + pad):c * (W + pad) + W] = norm[i]
    return grid


def compare_img(imgs, nrow: int = 25) -> np.ndarray:
    """Interleave N aligned [B, H, W, C] image sets into one [B*N, H, W, C]
    stack ordered set-major per batch row (fork compare_img,
    vision.py:317-326) — feed to ``feature_map_grid``-style tilers."""
    stack = np.stack(imgs, axis=1) if isinstance(imgs, list) else imgs
    return stack[:nrow].reshape(-1, *stack.shape[2:])


class Alignment:
    """Pad-to-multiple align/resume (fork's Alignment util)."""

    def __init__(self, divisor: int = 64):
        self.divisor = divisor
        self._shape = None

    def align(self, x_hwc: np.ndarray) -> np.ndarray:
        h, w = x_hwc.shape[:2]
        self._shape = (h, w)
        d = self.divisor
        ph = (h + d - 1) // d * d - h
        pw = (w + d - 1) // d * d - w
        return np.pad(x_hwc, ((0, ph), (0, pw), (0, 0)), mode="edge")

    def resume(self, x_hwc: np.ndarray) -> np.ndarray:
        h, w = self._shape
        return x_hwc[:h, :w]
