"""Backward warping and resize primitives (NCHW).

Counterpart of ``dcvc_tpu/ops/warp.py``. Parity targets:
  * flow_warp (reference DCVC-DC/src/models/video_net.py:8-38): grid_sample
    with bilinear interpolation, border padding and align_corners=True,
    i.e. sampling at absolute pixel position (j + fx, i + fy) with clamped
    bilinear taps. The exact warp is an XLA gather in the JAX package, not a
    Pallas kernel, so the library call is the port here.
  * bilinearupsacling / bilineardownsacling (video_net.py:41-55):
    F.interpolate(align_corners=False).

``grid_sample`` normalises coordinates to [-1, 1] and back, which costs
about ``W * 2**-24`` px of position error (about 1e-4 px at 1920 wide); the
encoder and the decoder both warp through it, so coding stays in step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .block_warp import _median_midpoint

# The OffsetDiversity warp that the JAX package ships as its accelerator
# inference default (dcvc_tpu/ops/warp.py: RD_GATED_BLOCK_MODE); the port
# treats the card the same way.
RD_GATED_BLOCK_MODE = "block:4,4,64,128,median4"


def flow_warp(im: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``im`` [B,C,H,W] by ``flow`` [B,2,H,W] (fx, fy) px."""
    B, _, H, W = im.shape
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device)
    gx = (xs.view(1, 1, W) + flow[:, 0]) * (2.0 / (W - 1)) - 1.0
    gy = (ys.view(1, H, 1) + flow[:, 1]) * (2.0 / (H - 1)) - 1.0
    grid = torch.stack([gx, gy], dim=-1).to(im.dtype)
    return F.grid_sample(im, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)


def default_od_warp_mode(device: torch.device) -> str:
    """OffsetDiversity warp default: the block kernel on the card, the
    exact warp on the CPU."""
    return RD_GATED_BLOCK_MODE if device.type == "cuda" else "exact"


def default_coding_warp_modes(device: torch.device) -> tuple:
    """(od, mc, me) warp modes of the coding runtimes: the block kernel at
    the OffsetDiversity site and exact mc / me warps on the card, exact
    everywhere on the CPU (None means exact)."""
    return default_od_warp_mode(device), None, None


# maps per tile-warp chunk: the per-pixel int64 tap indexes are built for
# one chunk of maps at a time, not for all 32 OffsetDiversity maps at once
_TILE_CHUNK = 4


def _tile_warp_batched(im, flow, T: int, R: int, base_mode: str):
    """Row-tile warp core, NCHW f32; W a multiple of T.

    Same arithmetic as ``dcvc_tpu/ops/warp.py:_tile_warp_batched``: each
    1 x T run of a row takes an integer base (the rounded median or mean of
    its flow), its window origin (ys, xs) is clamped into the edge-padded
    frame and the clamp is folded back into an effective base; each
    pixel's residual from that base is clamped to [-R, R - 1e-4) and
    resolved by a 4-tap bilinear read inside the run's window of 2R + 2
    packed rows (ys .. ys + 2R + 1) by K = T + 2R + 2 columns. The JAX
    package gathers the whole window per run (one gather slice, its TPU
    fast path) and weights it with one-hot rows; here each pixel gathers
    only its 4 taps, horizontal combine first, as there."""
    M, C, H, W = im.shape
    nt = W // T
    K = T + 2 * R + 2
    pads = R + 1
    Wp = W + pads + K
    offt = flow.reshape(M, 2, H, nt, T)
    if base_mode == "mean":
        base = torch.round(offt.mean(dim=4))
    elif base_mode == "median":
        base = torch.round(_median_midpoint(offt))     # half to even
    else:
        raise ValueError(f"unknown tile base mode {base_mode!r}")
    dev = im.device
    bx, by = base[:, 0], base[:, 1]                     # [M, H, nt]
    ys_raw = torch.arange(H, device=dev).view(1, H, 1) + by.to(torch.int32)
    xs_raw = (torch.arange(nt, device=dev).view(1, 1, nt) * T
              + bx.to(torch.int32) - R + pads)
    ys = ys_raw.clamp(0, H - 1)
    xs = xs_raw.clamp(0, Wp - K)
    eff_x = bx - (xs_raw - xs).to(base.dtype)
    eff_y = by - (ys_raw - ys).to(base.dtype)

    def taps(f, eff):
        r = torch.clamp(f - eff[..., None], -R, R - 1e-4)   # [M, H, nt, T]
        f0 = torch.floor(r)
        return (f0 + R).to(torch.int64), r - f0

    ax, wx = taps(offt[:, 0], eff_x)
    ay, wy = taps(offt[:, 1], eff_y)
    j = torch.arange(T, device=dev)
    # padded-frame coordinates of the top-left tap, then back into im
    py = ys[..., None].to(torch.int64) + ay
    px = xs[..., None].to(torch.int64) + j + ax
    y0, y1 = (py - R).clamp(0, H - 1), (py + 1 - R).clamp(0, H - 1)
    x0, x1 = (px - pads).clamp(0, W - 1), (px + 1 - pads).clamp(0, W - 1)
    flat = im.reshape(M, C, H * W)

    def gather(yy, xx):
        idx = (yy * W + xx).reshape(M, 1, H * W).expand(M, C, H * W)
        return torch.gather(flat, 2, idx).reshape(M, C, H, W)

    wx = wx.reshape(M, 1, H, W)
    wy = wy.reshape(M, 1, H, W)
    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def tile_warp(im: torch.Tensor, flow: torch.Tensor, tile: int = 16,
              residual: int = 2, base_mode: str = "median",
              chunk: int | None = None) -> torch.Tensor:
    """APPROXIMATE backward warp of ``im`` [M,C,H,W] by ``flow`` [M,2,H,W]
    with one integer base per 1 x ``tile`` run of a row
    (``dcvc_tpu/ops/warp.py:tile_warp``). It equals ``flow_warp`` wherever
    every pixel's flow lies within ``residual`` of its run's base in both
    axes; elsewhere the residual clamps. Computes in f32 (bf16 inputs are
    cast up and the result back); the width is edge-padded to a multiple
    of ``tile``; ``chunk`` maps at a time (default ``_TILE_CHUNK``) when
    that divides M. The JAX tile warp is XLA, not Pallas, so plain PyTorch
    is its port on every device."""
    M, _, H, W = im.shape
    out_dtype = im.dtype
    im, flow = im.float(), flow.float()
    pad_w = (-W) % tile
    if pad_w:
        im = F.pad(im, (0, pad_w, 0, 0), mode="replicate")
        flow = F.pad(flow, (0, pad_w, 0, 0), mode="replicate")
    if chunk is None:
        chunk = _TILE_CHUNK
    if chunk and M > chunk and M % chunk == 0:
        out = torch.cat([_tile_warp_batched(a, b, tile, residual, base_mode)
                         for a, b in zip(im.split(chunk), flow.split(chunk))])
    else:
        out = _tile_warp_batched(im, flow, tile, residual, base_mode)
    out = out.to(out_dtype)
    return out[..., :W] if pad_w else out


def resolve_warp_fn(mode: str):
    """Map a warp-mode string to an NCHW ``(im, flow) -> warped`` callable.

    Modes: "exact" (flow_warp);
    "tile[:T[,R[,mean|median]]]" — the row-tile approximation (tile_warp);
    "block[:Dh[,Rv[,BH[,BW[,mean|median|median4]]]]]" — the block warp
    (ops/block_warp.py: the CUDA kernel for CUDA tensors, its plain PyTorch
    version for CPU tensors).
    """
    if mode.startswith("tile"):
        spec = mode.split(":", 1)[1].split(",") if ":" in mode else []
        T = int(spec[0]) if len(spec) >= 1 and spec[0] else 16
        R = int(spec[1]) if len(spec) >= 2 else 2
        base = spec[2] if len(spec) >= 3 else "median"
        return lambda a, b: tile_warp(a, b, T, R, base)
    if mode.startswith("block"):
        from . import block_warp as bw

        spec = mode.split(":", 1)[1].split(",") if ":" in mode else []
        Dh = int(spec[0]) if len(spec) >= 1 and spec[0] else 8
        Rv = int(spec[1]) if len(spec) >= 2 else 2
        BH = int(spec[2]) if len(spec) >= 3 else 8
        BW = int(spec[3]) if len(spec) >= 4 else 512
        base = spec[4] if len(spec) >= 5 else "median"
        return lambda a, b: bw.block_warp_nchw(a, b, Dh, Rv, BH, BW, base)
    if mode != "exact":
        raise ValueError(f"unknown warp mode {mode!r}")
    return flow_warp


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel-centred bilinear resize, NCHW (align_corners=False)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False)


def bilinear_up2(x: torch.Tensor) -> torch.Tensor:
    return bilinear_resize(x, x.shape[2] * 2, x.shape[3] * 2)


def bilinear_down2(x: torch.Tensor) -> torch.Tensor:
    return bilinear_resize(x, x.shape[2] // 2, x.shape[3] // 2)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    return F.pixel_shuffle(x, r)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    return F.pixel_unshuffle(x, r)


def replicate_pad(x: torch.Tensor, pad_lrtb) -> torch.Tensor:
    """Edge-replicate pad, NCHW; pad = (left, right, top, bottom)."""
    if not any(pad_lrtb):
        return x
    return F.pad(x, tuple(pad_lrtb), mode="replicate")


def crop_lrtb(x: torch.Tensor, pad_lrtb) -> torch.Tensor:
    """Inverse of replicate_pad given the same (l, r, t, b)."""
    l, r, t, b = pad_lrtb
    H, W = x.shape[2], x.shape[3]
    return x[:, :, t:H - b, l:W - r]


def get_padding_size(height: int, width: int, p: int = 64):
    """Pad-to-multiple amounts (left, right, top, bottom); pad right/bottom."""
    new_h = (height + p - 1) // p * p
    new_w = (width + p - 1) // p * p
    return 0, new_w - width, 0, new_h - height


def get_downsampled_shape(height: int, width: int, p: int):
    new_h = (height + p - 1) // p * p
    new_w = (width + p - 1) // p * p
    return new_h // p, new_w // p
