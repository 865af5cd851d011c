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


def resolve_warp_fn(mode: str):
    """Map a warp-mode string to an NCHW ``(im, flow) -> warped`` callable.

    Modes: "exact" (flow_warp);
    "block[:Dh[,Rv[,BH[,BW[,mean|median|median4]]]]]" — the block warp
    (ops/block_warp.py: the CUDA kernel for CUDA tensors, its plain PyTorch
    version for CPU tensors).
    """
    if mode.startswith("tile"):
        raise NotImplementedError(
            "tile: warps are not ported yet (ROADMAP Queue 1, "
            "'tile: warps and aligned_enc')")
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
