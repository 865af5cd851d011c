"""Plain warps and resizes, float32, NCHW.

* ``flow_warp``: bilinear backward warp with border padding at absolute
  pixel positions (DCVC-DC video_net.py:8-38, ``grid_sample`` with
  ``align_corners=True``).
* ``block_warp``: the approximate block warp that the program runs as a
  CUDA kernel at the OffsetDiversity site, in plain arithmetic. Each
  ``BH x BW`` output block takes one integer base, the rounded median of
  its flow (``median4``: of a 4x4-strided subsample), clamped so that its
  window stays inside the edge-padded frame; each pixel's residual from
  that base is clamped to ``[-Dh, Dh) x [-Rv, Rv)`` and resolved by a
  4-tap bilinear read.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def flow_warp(im, flow):
    B, _, H, W = im.shape
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device)
    gx = (xs.view(1, 1, W) + flow[:, 0]) * (2.0 / (W - 1)) - 1.0
    gy = (ys.view(1, H, 1) + flow[:, 1]) * (2.0 / (H - 1)) - 1.0
    grid = torch.stack([gx, gy], dim=-1)
    return F.grid_sample(im, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)


def _ceil_to(x, m):
    return -(-x // m) * m


def _median_midpoint(x):
    """Median over the last dim; the mean of the two middle values of an
    even count."""
    s, _ = torch.sort(x, dim=-1)
    n = x.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def _block_prep(flow, BH, BW, Dh, Rv, base_mode, pad):
    M, _, H, W = flow.shape
    Hb, Wb = _ceil_to(H, BH), _ceil_to(W, BW)
    if (Hb, Wb) != (H, W):
        flow = F.pad(flow, (0, Wb - W, 0, Hb - H), mode="replicate")
    nby, nbx = Hb // BH, Wb // BW
    fb = flow.reshape(M, 2, nby, BH, nbx, BW)
    if base_mode == "mean":
        base = torch.round(fb.mean(dim=(3, 5)))
    else:
        if base_mode == "median4":
            fb = fb[:, :, :, ::4, :, ::4]
        sub = fb.permute(0, 1, 2, 4, 3, 5).reshape(M, 2, nby, nbx, -1)
        base = torch.round(_median_midpoint(sub))       # half to even
    Py, Px = Rv + 1 + pad, Dh + 1 + pad
    BHD_u, KD_u = BH + 2 * Rv + 2, BW + 2 * Dh + 2
    Hp, Wp = Hb + 2 * Py, Wb + 2 * Px
    dev = flow.device
    i0 = (torch.arange(nby, device=dev) * BH).view(1, nby, 1)
    j0 = (torch.arange(nbx, device=dev) * BW).view(1, 1, nbx)
    sy_raw = i0 + base[:, 1].to(torch.int32) + pad
    sx_raw = j0 + base[:, 0].to(torch.int32) + pad
    sy = sy_raw.clamp(0, Hp - BHD_u)
    sx = sx_raw.clamp(0, Wp - KD_u)
    eff_by = base[:, 1] - (sy_raw - sy).to(base.dtype)
    eff_bx = base[:, 0] - (sx_raw - sx).to(base.dtype)
    return sy.to(torch.int32), sx.to(torch.int32), eff_by, eff_bx, Py, Px


def block_warp(im, flow, Dh=8, Rv=2, BH=8, BW=512, base_mode="median",
               pad=16):
    M, C, H, W = im.shape
    BH, BW = min(BH, _ceil_to(H, 8)), min(BW, _ceil_to(W, 128))
    flow = flow.float()
    sy, sx, eby, ebx, Py, Px = _block_prep(flow, BH, BW, Dh, Rv, base_mode,
                                           pad)
    dev = im.device
    ii = torch.arange(H, device=dev)
    jj = torch.arange(W, device=dev)
    bi, bj = ii // BH, jj // BW

    def per_block(t):                       # [M,nby,nbx] -> [M,H,W]
        return t[:, bi][:, :, bj]

    def taps(f, eff, start, local, R, P, n):
        r = torch.clamp(f - per_block(eff), -R, R - 1e-4)
        f0 = torch.floor(r)
        w = r - f0
        p0 = per_block(start) + local + f0.to(torch.int32) + R + 1 - P
        return p0.clamp(0, n - 1), (p0 + 1).clamp(0, n - 1), w

    y0, y1, wy = taps(flow[:, 1], eby, sy, ii.view(1, H, 1) % BH, Rv, Py, H)
    x0, x1, wx = taps(flow[:, 0], ebx, sx, jj.view(1, 1, W) % BW, Dh, Px, W)
    flat = im.reshape(M, C, H * W)

    def gather(yy, xx):
        idx = (yy * W + xx).reshape(M, 1, H * W).expand(M, C, H * W)
        return torch.gather(flat, 2, idx.long()).reshape(M, C, H, W)

    wx, wy = wx[:, None], wy[:, None]
    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def warp_fn(mode: str):
    """``exact`` or ``block:Dh,Rv,BH,BW,base`` -> ``(im, flow) -> warped``."""
    if mode == "exact":
        return flow_warp
    if not mode.startswith("block:"):
        raise ValueError(f"unknown warp mode {mode!r}")
    Dh, Rv, BH, BW, base = mode.split(":", 1)[1].split(",")
    return lambda im, flow: block_warp(im, flow, int(Dh), int(Rv), int(BH),
                                       int(BW), base)


def up2(x):
    return F.interpolate(x, size=(x.shape[2] * 2, x.shape[3] * 2),
                         mode="bilinear", align_corners=False)


def down2(x):
    return F.interpolate(x, size=(x.shape[2] // 2, x.shape[3] // 2),
                         mode="bilinear", align_corners=False)


def pad_to(x, p):
    """Edge-replicate pad right and bottom to a multiple of ``p``; the
    amounts (left, right, top, bottom)."""
    H, W = x.shape[2], x.shape[3]
    pads = (0, _ceil_to(W, p) - W, 0, _ceil_to(H, p) - H)
    return (F.pad(x, pads, mode="replicate") if any(pads) else x), pads


def crop(x, pads):
    l, r, t, b = pads
    H, W = x.shape[2], x.shape[3]
    return x[:, :, t:H - b, l:W - r]
