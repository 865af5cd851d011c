"""Band copy: the dynamic-offset row-band copy probe, as a CUDA kernel.

Replaces the Pallas TPU kernel ``tools/diag_dma.py:make_bench.kernel``
(launched by ``pl.pallas_call`` in ``make_bench``). It measured whether a
per-row dynamic-offset band copy could carry the row-tile warp
(``ops/warp.py:tile_warp``). For each output row ``r`` the whole band
``src[by[r] : by[r] + A]`` (``[A, C, Wp]`` f32) is staged on chip, then
``out[r] = band[0, 0, :]``; so ``out[r] = src[by[r], 0, :]``.

What bounds it on the card: bytes. It does no arithmetic. Counted once, the
inputs are the ``src`` rows that the bands of this ``by`` touch, plus ``by``,
and the output is ``H x Wp`` f32; at the tool's shape (H=720, Wp=1408,
C=16, A=4) about 69.3 MB, 20.7 us at 3.35 TB/s. The probe requests
``H * A * C * Wp * 4`` B = 259.5 MB of band copies (77.5 us), and
overlapping bands may come from the 50 MB L2.

What the design does about it (``csrc/band_copy.cu``): one CTA per
``rows_per_step`` rows, as the TPU grid (90 CTAs at the tool's shape on 132
SMs). A band is 352 KiB there, more than the 227 KB of shared memory a CTA
may have (the TPU's VMEM held it whole), so the kernel streams it through
two 64 KiB buffers with ``cp.async`` (16-byte copies when the row pitch
``C * Wp * 4`` and ``src`` are 16-byte aligned, else 4-byte), keeping the
next chunk in flight while the current one is waited on.

The wrapper takes the plain PyTorch version (``band_copy_plain``) only for
CPU tensors; for CUDA tensors it launches the kernel or raises. The TPU
kernel's preconditions are errors here: ``H % rows_per_step == 0`` (the TPU
grid floors ``H // 8`` and leaves the remaining rows unwritten) and
``0 <= by[r]``, ``by[r] + A <= Hs``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ._build import build_shared, nvcc_path
from .block_warp import NVCC_FLAGS

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "band_copy.cu"
_LOCK = threading.Lock()
_LIB = None
build_log = ""


def load_kernel():
    """Build (first use) and load the CUDA library; returns the ctypes lib."""
    global _LIB, build_log
    with _LOCK:
        if _LIB is None:
            path, build_log = build_shared(_SRC, "band_copy",
                                           [nvcc_path(), *NVCC_FLAGS])
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.band_copy_launch.restype = ctypes.c_int
            lib.band_copy_launch.argtypes = [
                p, p, p,                          # src by out
                i, i, ctypes.c_longlong, i, i,    # H Wp row_pitch A rows
                i, p]                             # vec16 stream
            _LIB = lib
    return _LIB


def _check(src, by, A, rows_per_step, check_range):
    if src.dim() != 3 or by.dim() != 1:
        raise ValueError(f"src must be [Hs, C, Wp] and by [H], got "
                         f"{tuple(src.shape)} and {tuple(by.shape)}")
    if src.dtype != torch.float32 or by.dtype != torch.int32:
        raise TypeError(f"src must be float32 and by int32, got {src.dtype} "
                        f"and {by.dtype}")
    if src.device != by.device:
        raise ValueError("src and by must be on the same device")
    H = by.shape[0]
    if rows_per_step < 1 or H % rows_per_step:
        raise ValueError(f"H={H} is not a multiple of rows_per_step="
                         f"{rows_per_step}")
    if check_range and H:
        lo, hi = (int(v) for v in torch.aminmax(by))
        if lo < 0 or hi + A > src.shape[0]:
            raise ValueError(f"band rows [{lo}, {hi + A}) leave src rows "
                             f"[0, {src.shape[0]})")


def _launch(src, by, A, rows_per_step):
    if not src.is_contiguous() or not by.is_contiguous():
        raise ValueError("src and by must be contiguous")
    Hs, C, Wp = src.shape
    H = by.shape[0]
    out = torch.empty(H, Wp, dtype=torch.float32, device=src.device)
    if H == 0:
        return out
    row_pitch = C * Wp
    vec16 = int(row_pitch % 4 == 0 and src.data_ptr() % 16 == 0)
    lib = load_kernel()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.band_copy_launch(src.data_ptr(), by.data_ptr(),
                                   out.data_ptr(), H, Wp, row_pitch, A,
                                   rows_per_step, vec16, stream)
    if err != 0:
        raise RuntimeError(f"band_copy kernel launch failed: CUDA error {err}")
    band_copy.launches += 1
    return out


def band_copy(src: torch.Tensor, by: torch.Tensor, A: int,
              rows_per_step: int = 8, check_range: bool = True
              ) -> torch.Tensor:
    """``out[r] = src[by[r], 0, :]`` after staging ``src[by[r]:by[r]+A]``.

    ``src`` [Hs, C, Wp] f32 contiguous, ``by`` [H] int32 -> [H, Wp] f32.
    CUDA tensors launch the kernel (``band_copy.launches`` counts them);
    CPU tensors take the plain version. ``check_range=False`` skips the
    band-range check (a host read of ``by``'s extremes) for callers whose
    ``by`` is in range by construction."""
    _check(src, by, A, rows_per_step, check_range)
    if src.device.type == "cuda":
        return _launch(src, by, A, rows_per_step)
    if src.device.type != "cpu":
        raise ValueError(f"unsupported device {src.device}")
    return band_copy_plain(src, by)


band_copy.launches = 0


def band_copy_plain(src: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, on any device (what the kernel is held
    against)."""
    return src[by.long(), 0, :]
