"""Block warp: approximate bilinear backward warp, as CUDA kernels (K1).

Replaces the Pallas TPU kernel ``dcvc_tpu/ops/block_warp.py:_kernel``
(launched by ``pl.pallas_call`` from ``_block_warp_jit``); semantics are
those of its oracle ``block_warp_ref``. Each ``BH x BW`` output block takes
a base: the rounded median / mean / ``median4`` (median of a 4x4-strided
subsample) of its flow, clamped so that its window stays inside the
edge-padded frame. Each pixel's residual from that base is clamped to
``[-Dh, Dh) x [-Rv, Rv)`` and resolved by a 4-tap bilinear read inside the
block's window. It equals ``flow_warp`` wherever the residuals fit.

What bounds it on the card: bytes. Per output value it does ~13 flops on
data it reads once (``im``, ``flow``) and writes once (``out``); at the
OffsetDiversity site (32 maps x 3 channels x 1088 x 1920, f32) that is
about 0.80 + 0.53 + 0.80 GB, i.e. ~0.64 ms at 3.35 TB/s.

What the design does about it (``csrc/block_warp.cu``, whose note gives
the details and the occupancy):
  * the block prep runs on the card for ``median`` and ``median4``: one
    kernel sorts each block's flow samples (in a warp's registers up to 512
    of them, else in shared memory) and writes the window origins and
    effective bases, in one launch instead of ~25 PyTorch ops. ``mean``
    keeps the PyTorch prep (``_block_prep``): another summation order moves
    the mean's last ulp, and with it a base that rounds at .5.
  * one CTA per (map, block) covers every channel, so each pixel's flow is
    read once and its taps and weights are computed once, in registers;
  * the window is staged in chunks of rows through a ring in shared memory
    with ``cp.async``, so the next chunk loads while the current strip of
    output rows resolves (the TPU kernel's depth-2 DMA ring, per CTA);
  * flow reads and output writes are 16 (f32) or 8 (bf16) bytes per thread
    where rows are 16-byte aligned (``W % 4 == 0`` f32, ``W % 8 == 0``
    bf16), one pixel per thread elsewhere;
  * the edge-replicated source is never built: a staged row is
    ``im[clamp(y)]``, and a block whose window leaves the frame sideways
    clamps each tap's column.
The launch plan (strip rows, ring stages, channel groups, staged columns,
which instance) is Python below (``plan_warp``, ``staged_columns``,
``edge_classes``), so the CPU tests check it.

The wrapper takes the plain PyTorch version (``block_warp_plain``) only for
CPU tensors; for CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.nn.functional as F

from ._build import build_shared, nvcc_path

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "block_warp.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
THREADS = 256            # per CTA, both kernels
# shared memory the warp kernel's ring may take: registers hold it to 4 CTAs
# of 256 threads per SM anyway; more channels go in groups
SMEM_BUDGET = 48 * 1024
SMEM_MAX = 227 * 1024    # what one CTA may have on the card
# chunks in flight beyond those a strip reads (2 was slower on an H100)
AHEAD = 1

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
            ints = ctypes.POINTER(ctypes.c_int)
            lib.block_warp_launch.restype = ctypes.c_int
            lib.block_warp_launch.argtypes = [
                p, p, p, p, p, p, p,     # im flow out sy sx ey ex
                ints, f, f,              # geometry (_geometry) hy hx
                i, i, i, p]              # bf16 px smem stream
            lib.block_prep_launch.restype = ctypes.c_int
            lib.block_prep_launch.argtypes = [
                p, p, p, p, p,           # flow sy sx ey ex
                ints, i, p]              # geometry (_prep_card) M stream
            _LIB = lib
    return _LIB


def _median_midpoint(x: torch.Tensor) -> torch.Tensor:
    """Median over the last dim as jnp.median computes it: the mean of the
    two middle values of an even count (torch.median returns the lower)."""
    s, _ = torch.sort(x, dim=-1)
    n = x.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def _pad_extents(BH, BW, Dh, Rv, pad):
    """(Py, Px) edge pad and (BHD_u, KD_u) window extents, as the TPU
    kernel's clamp uses them: the unaligned window and a ``pad`` margin
    beyond the tap reach."""
    return Rv + 1 + pad, Dh + 1 + pad, BH + 2 * Rv + 2, BW + 2 * Dh + 2


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
    Py, Px, BHD_u, KD_u = _pad_extents(BH, BW, Dh, Rv, pad)
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


@dataclass(frozen=True)
class WarpPlan:
    """How the warp kernel stages a block (``csrc/block_warp.cu``)."""
    px: int        # output pixels per thread: 4 (16-byte rows) or 1
    align: int     # staged columns start at multiples of this many elements
    S: int         # output rows per strip, a power of two
    D: int         # a strip reads its own chunk of S window rows and D more
    NST: int       # ring stages, one chunk each
    NS: int        # strips per block
    Cg: int        # channels staged together; a CTA loops over the groups
    span: int      # staged columns per (row, channel) line
    itemsize: int  # bytes per staged element

    @property
    def ring_rows(self) -> int:
        return self.NST * self.S

    @property
    def smem(self) -> int:
        return self.ring_rows * self.Cg * self.span * self.itemsize


def vector_rows(W: int, BW: int, itemsize: int, *tensors) -> bool:
    """Whether the 4-pixel instance runs: every row of ``im``, ``flow`` and
    ``out`` starts 16-byte aligned and blocks hold whole groups of 4."""
    return (W * itemsize % 16 == 0 and BW % 4 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def plan_warp(C: int, BH: int, BW: int, Dh: int, Rv: int, itemsize: int,
              px: int) -> WarpPlan:
    """Strip rows, ring stages, staged columns and channel groups of one
    launch. A strip of S rows gives the 256 threads one work unit each where
    the block is tall enough; its taps reach window rows s S + 1 ..
    s S + S + 2 Rv, i.e. chunks s .. s + ceil(2 Rv / S), and AHEAD more
    chunks are in flight."""
    if Dh < 1 or Rv < 1:
        # the TPU kernel's tap passes start at 1 too
        raise ValueError(f"block warp needs Dh, Rv >= 1 (got {Dh}, {Rv})")
    align = 16 // itemsize if px == 4 else 1
    per_row = BW // px
    S = 1
    while S < BH and S * per_row < THREADS:
        S *= 2
    D = -(-2 * Rv // S)
    NST = D + 1 + AHEAD
    span = _ceil_to(BW + 2 * Dh + align - 1, align)
    per_channel = NST * S * span * itemsize
    if per_channel > SMEM_MAX:
        raise ValueError(f"block warp ring of {per_channel} B per channel "
                         f"exceeds shared memory")
    Cg = max(1, min(C, SMEM_BUDGET // per_channel))
    return WarpPlan(px, align, S, D, NST, -(-BH // S), Cg, span, itemsize)


def edge_classes(sy, sx, H, W, BH, BW, Dh, Rv, Py, Px):
    """(rows, cols) [M, nby, nbx] bool: blocks whose taps reach outside the
    frame vertically (their staged rows repeat the edge row) and sideways
    (the kernel clamps their tap columns). Taps reach window rows
    1 .. BH + 2 Rv and columns 1 .. BW + 2 Dh from the window origin
    (sy - Py, sx - Px)."""
    y0, x0 = sy - Py, sx - Px
    return ((y0 + 1 < 0) | (y0 + BH + 2 * Rv > H - 1),
            (x0 + 1 < 0) | (x0 + BW + 2 * Dh > W - 1))


def staged_columns(sx, W, BW, Dh, Px, align):
    """First staged column and number of staged columns per block: the tap
    columns clamped into the frame, widened to whole ``align``-element
    copies (``sx`` a tensor)."""
    x_lo = (sx - Px + 1).clamp(0, W - 1)
    x_hi = (sx - Px + BW + 2 * Dh).clamp(0, W - 1)
    xs = x_lo // align * align
    return xs, (x_hi - xs + align) // align * align


def _geometry(M, C, H, W, nby, nbx, BH, BW, Dh, Rv, Py, Px, plan):
    """The kernel's ``Geo`` ints, in its field order."""
    per_row = BW // plan.px
    shift = per_row.bit_length() - 1 if per_row & (per_row - 1) == 0 else -1
    vals = [M, C, H, W, nby, nbx, BH, BW, Dh, Rv, Py, Px, plan.S, plan.D,
            plan.NST, plan.NS, plan.Cg, plan.span, shift]
    return (ctypes.c_int * len(vals))(*vals)


SORT_MAX = 32768   # flow samples one prep CTA sorts in shared memory (128 KiB)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _prep_card(flow, BH, BW, Dh, Rv, base_mode, pad):
    """``_block_prep`` for CUDA ``flow`` [M,2,H,W] f32: the prep kernel for
    ``median`` and ``median4``; ``mean`` (and a median over more than
    SORT_MAX samples per block) takes ``_block_prep`` itself."""
    M, _, H, W = flow.shape
    step = 4 if base_mode == "median4" else 1
    ny, nx = -(-BH // step), -(-BW // step)
    npow2 = max(32, 1 << (ny * nx - 1).bit_length())   # a warp at least
    if base_mode not in ("median", "median4") or npow2 > SORT_MAX:
        return _block_prep(flow, BH, BW, Dh, Rv, base_mode, pad)
    Py, Px, BHD_u, KD_u = _pad_extents(BH, BW, Dh, Rv, pad)
    Hb, Wb = _ceil_to(H, BH), _ceil_to(W, BW)
    nby, nbx = Hb // BH, Wb // BW
    dev = flow.device
    sy = torch.empty((M, nby, nbx), dtype=torch.int32, device=dev)
    sx = torch.empty_like(sy)
    eby = torch.empty((M, nby, nbx), dtype=torch.float32, device=dev)
    ebx = torch.empty_like(eby)
    vals = [H, W, nby, nbx, BH, BW, step, ny, nx, npow2, pad,
            Hb + 2 * Py - BHD_u, Wb + 2 * Px - KD_u]
    lib = load_kernel()
    with torch.cuda.device(dev):
        err = lib.block_prep_launch(
            flow.data_ptr(), sy.data_ptr(), sx.data_ptr(), eby.data_ptr(),
            ebx.data_ptr(), (ctypes.c_int * len(vals))(*vals), M,
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"block_prep kernel launch failed: CUDA error "
                           f"{err}")
    return sy, sx, eby, ebx, Py, Px


def _warp_card(im, flow, prep, Dh, Rv, BH, BW):
    """The warp kernel alone: ``im`` [M,C,H,W] f32/bf16 and ``flow``
    [M,2,H,W] f32, both contiguous on the card, and ``prep`` as
    ``_block_prep`` returns it."""
    M, C, H, W = im.shape
    sy, sx, eby, ebx, Py, Px = prep
    sy, sx = sy.contiguous(), sx.contiguous()
    eby, ebx = eby.float().contiguous(), ebx.float().contiguous()
    out = torch.empty_like(im)
    px = 4 if vector_rows(W, BW, im.element_size(), im, flow, out) else 1
    plan = plan_warp(C, BH, BW, Dh, Rv, im.element_size(), px)
    geo = _geometry(M, C, H, W, sy.shape[1], sy.shape[2], BH, BW, Dh, Rv,
                    Py, Px, plan)
    lib = load_kernel()
    with torch.cuda.device(im.device):
        err = lib.block_warp_launch(
            im.data_ptr(), flow.data_ptr(), out.data_ptr(), sy.data_ptr(),
            sx.data_ptr(), eby.data_ptr(), ebx.data_ptr(), geo,
            float(Rv - 1e-4), float(Dh - 1e-4),
            int(im.dtype == torch.bfloat16), px, plan.smem,
            _stream(im.device))
    if err != 0:
        raise RuntimeError(f"block_warp kernel launch failed: CUDA error "
                           f"{err}")
    return out


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
    prep = _prep_card(flow, BH, BW, Dh, Rv, base_mode, pad)
    out = _warp_card(im, flow, prep, Dh, Rv, BH, BW)
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
    them); CPU tensors take the plain version. The kernel has no backward,
    as the TPU kernel has none: on the card it refuses inputs that need a
    gradient rather than return a result cut off from the graph (training
    takes the exact warp)."""
    BH, BW = _block_dims(im.shape[2], im.shape[3], BH, BW)
    if im.device.type == "cuda":
        if flow.device != im.device:
            raise ValueError("im and flow must be on the same device")
        if torch.is_grad_enabled() and (im.requires_grad
                                        or flow.requires_grad):
            raise RuntimeError(
                "block_warp: the CUDA kernel has no backward; build the "
                "model with exact warps (warp mode 'exact') to train it")
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
