"""Block warp: approximate bilinear backward warp, as a CUDA kernel.

Replaces the Pallas TPU kernel ``dcvc_tpu/ops/block_warp.py:_kernel``
(launched by ``pl.pallas_call`` from ``_block_warp_jit``); semantics are
those of its oracle ``block_warp_ref``. Each ``BH x BW`` output block takes
a base: the rounded median / mean / ``median4`` (median of a 4x4-strided
subsample) of its flow, clamped so that its window stays inside the
edge-padded frame. Each pixel's residual from that base is clamped to
``[-Dh, Dh) x [-Rv, Rv)`` and resolved by a 4-tap bilinear read inside the
block's window. It equals ``flow_warp`` wherever the residuals fit.

What bounds it on the card: bytes. Per output value it does ~10 flops on
data it reads once (``im``, ``flow``) and writes once (``out``); at the
OffsetDiversity site (32 maps x 3 channels x 1088 x 1920, f32) that is
about 0.80 + 0.53 + 0.80 GB, i.e. ~0.64 ms at 3.35 TB/s.

What the design does about it (``csrc/block_warp.cu``): the per-block base
and window origin are a few KB and stay in PyTorch (``_block_prep``); the
kernel reads ``flow`` once per pixel and computes the taps and weights in
registers, so no per-pixel index or weight plane ever reaches device memory
(materialising them would add ~1 GB at 1080p). The edge-replicated source
is never built either: a padded coordinate ``p`` reads
``im[clamp(p - P, 0, H - 1)]`` while a CTA stages its block's window in
shared memory. One CTA per (map, block, channel group). The TPU version's
8/128 alignment residuals, lane rotate, scalar prefetch, live-tap bitmasks
and DMA ring are TPU workarounds and have no counterpart here.

The wrapper takes the plain PyTorch version (``block_warp_plain``) only for
CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

from ._build import build_shared, nvcc_path

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "block_warp.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# shared memory one CTA may stage (the card allows 227 KB; a smaller share
# keeps several CTAs resident per SM)
SMEM_BUDGET = 48 * 1024
SMEM_MAX = 227 * 1024

_LOCK = threading.Lock()
_LIB = None
build_log = ""


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def load_kernel():
    """Build (first use) and load the CUDA library; returns the ctypes lib."""
    global _LIB, build_log
    with _LOCK:
        if _LIB is None:
            path, build_log = build_shared(_SRC, "block_warp",
                                           [nvcc_path(), *NVCC_FLAGS])
            lib = ctypes.CDLL(str(path))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.block_warp_launch.restype = ctypes.c_int
            lib.block_warp_launch.argtypes = [
                p, p, p, p, p, p, p,           # im flow out sy sx ey ex
                i, i, i, i, i, i, i, i,        # M C H W nby nbx BH BW
                i, i, i, i, f, f, i, i, i,     # Dh Rv Py Px hy hx Cg bf16 smem
                p]                             # stream
            _LIB = lib
    return _LIB


def _median_midpoint(x: torch.Tensor) -> torch.Tensor:
    """Median over the last dim as jnp.median computes it: the mean of the
    two middle values of an even count (torch.median returns the lower)."""
    s, _ = torch.sort(x, dim=-1)
    n = x.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def _block_prep(flow, BH, BW, Dh, Rv, base_mode, pad):
    """Per-block clamped window origin and effective base.

    ``flow`` [M,2,H,W] f32. Returns (sy, sx) int32 window starts in padded
    coordinates and (eff_by, eff_bx) f32 effective bases, each [M,nby,nbx]
    (``dcvc_tpu/ops/block_warp.py:_prep`` lines 64-132)."""
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
        elif base_mode != "median":
            raise ValueError(f"unknown base mode {base_mode!r}")
        sub = fb.permute(0, 1, 2, 4, 3, 5).reshape(M, 2, nby, nbx, -1)
        base = torch.round(_median_midpoint(sub))       # half to even
    # window extents and edge pad exactly as the TPU kernel's clamp uses
    # them: the unaligned window and a `pad` margin beyond the tap reach
    BHD_u, KD_u = BH + 2 * Rv + 2, BW + 2 * Dh + 2
    Py, Px = Rv + 1 + pad, Dh + 1 + pad
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
    return (sy.to(torch.int32), sx.to(torch.int32), eff_by, eff_bx, Py, Px)


def _plain_nchw(im, flow, Dh, Rv, BH, BW, base_mode, pad):
    """Plain PyTorch version (f32 math, output in the input dtype)."""
    M, C, H, W = im.shape
    out_dtype = im.dtype
    im = im.float()
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
    return (top * (1 - wy) + bot * wy).to(out_dtype)


def _launch(im, flow, Dh, Rv, BH, BW, base_mode, pad):
    M, C, H, W = im.shape
    if flow.shape != (M, 2, H, W):
        raise ValueError(f"flow {tuple(flow.shape)} does not match im "
                         f"{tuple(im.shape)}")
    out_dtype = im.dtype
    if im.dtype not in (torch.float32, torch.bfloat16):
        im = im.float()
    im = im.contiguous()
    flow = flow.float().contiguous()
    sy, sx, eby, ebx, Py, Px = _block_prep(flow, BH, BW, Dh, Rv, base_mode,
                                           pad)
    sy, sx = sy.contiguous(), sx.contiguous()
    eby, ebx = eby.float().contiguous(), ebx.float().contiguous()
    nby, nbx = sy.shape[1], sy.shape[2]
    win = (BH + 2 * Rv + 2) * (BW + 2 * Dh + 2) * 4
    if win > SMEM_MAX:
        raise ValueError(f"block window of {win} B exceeds shared memory")
    Cg = C
    while Cg > 1 and (C % Cg or Cg * win > max(SMEM_BUDGET, win)):
        Cg -= 1
    out = torch.empty_like(im)
    lib = load_kernel()
    with torch.cuda.device(im.device):
        stream = torch.cuda.current_stream(im.device).cuda_stream
        err = lib.block_warp_launch(
            im.data_ptr(), flow.data_ptr(), out.data_ptr(), sy.data_ptr(),
            sx.data_ptr(), eby.data_ptr(), ebx.data_ptr(),
            M, C, H, W, nby, nbx, BH, BW, Dh, Rv, Py, Px,
            float(Rv - 1e-4), float(Dh - 1e-4), Cg,
            int(im.dtype == torch.bfloat16), Cg * win, stream)
    if err != 0:
        raise RuntimeError(f"block_warp kernel launch failed: CUDA error "
                           f"{err}")
    block_warp_nchw.launches += 1
    return out.to(out_dtype)


def _block_dims(H, W, BH, BW):
    """The TPU kernel's block grid: BH <= ceil8(H), BW <= ceil128(W)."""
    return min(BH, _ceil_to(H, 8)), min(BW, _ceil_to(W, 128))


def block_warp_nchw(im: torch.Tensor, flow: torch.Tensor, Dh: int = 8,
                    Rv: int = 2, BH: int = 8, BW: int = 512,
                    base_mode: str = "median", pad: int = 16) -> torch.Tensor:
    """Block warp of ``im`` [M,C,H,W] by ``flow`` [M,2,H,W] (fx, fy px).

    CUDA tensors launch the kernel (``block_warp_nchw.launches`` counts
    them); CPU tensors take the plain version."""
    BH, BW = _block_dims(im.shape[2], im.shape[3], BH, BW)
    if im.device.type == "cuda":
        if flow.device != im.device:
            raise ValueError("im and flow must be on the same device")
        return _launch(im, flow, Dh, Rv, BH, BW, base_mode, pad)
    if im.device.type != "cpu" or flow.device.type != "cpu":
        raise ValueError(f"unsupported devices {im.device}, {flow.device}")
    return _plain_nchw(im, flow.float(), Dh, Rv, BH, BW, base_mode, pad)


block_warp_nchw.launches = 0


def block_warp_plain_nchw(im: torch.Tensor, flow: torch.Tensor, Dh: int = 8,
                          Rv: int = 2, BH: int = 8, BW: int = 512,
                          base_mode: str = "median",
                          pad: int = 16) -> torch.Tensor:
    """The plain PyTorch version with ``block_warp_ref``'s semantics, on any
    device, NCHW (what the kernel is held against)."""
    BH, BW = _block_dims(im.shape[2], im.shape[3], BH, BW)
    return _plain_nchw(im, flow.float(), Dh, Rv, BH, BW, base_mode, pad)


def block_warp(im: torch.Tensor, flow: torch.Tensor, Dh: int = 8,
               Rv: int = 2, BH: int = 8, BW: int = 512,
               base_mode: str = "median", pad: int = 16) -> torch.Tensor:
    """The JAX package's public signature: ``im`` [M,H,W,C], ``flow``
    [M,H,W,2] -> [M,H,W,C]."""
    out = block_warp_nchw(im.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2),
                          Dh, Rv, BH, BW, base_mode, pad)
    return out.permute(0, 2, 3, 1)


def block_warp_plain(im: torch.Tensor, flow: torch.Tensor, Dh: int = 8,
                     Rv: int = 2, BH: int = 8, BW: int = 512,
                     base_mode: str = "median", pad: int = 16) -> torch.Tensor:
    """``block_warp_plain_nchw`` with the JAX oracle's [M,H,W,C] /
    [M,H,W,2] signature."""
    out = block_warp_plain_nchw(im.permute(0, 3, 1, 2),
                                flow.permute(0, 3, 1, 2), Dh, Rv, BH, BW,
                                base_mode, pad)
    return out.permute(0, 2, 3, 1)
