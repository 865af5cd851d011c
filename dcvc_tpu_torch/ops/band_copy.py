"""Band copy: the dynamic-offset row-band copy probe, as a CUDA kernel (K2).

Replaces the Pallas TPU kernel ``tools/diag_dma.py:make_bench.kernel``
(launched by ``pl.pallas_call`` in ``make_bench``). It measured whether a
per-row dynamic-offset band copy could carry the row-tile warp
(``ops/warp.py:tile_warp``). For each output row ``r`` the whole band
``src[by[r] : by[r] + A]`` (``[A, C, Wp]`` f32) is staged on chip, then
``out[r] = band[0, 0, :]``; so ``out[r] = src[by[r], 0, :]``. Every
requested band byte is copied into shared memory: that staging is what the
probe times.

What bounds it on the card: bytes. It does no arithmetic. Counted once, the
inputs are the ``src`` rows that the bands of this ``by`` touch, plus ``by``,
and the output is ``H x Wp`` f32; at the tool's shape (H=720, Wp=1408,
C=16, A=4) about 68.6 MB, 20.5 us at 3.35 TB/s. The probe requests
``H * A * C * Wp * 4`` B = 259.5 MB of band copies (77.5 us at the HBM
rate); overlapping bands come from the 50 MB L2, so the requested bytes are
bound by the L2 -> SM rate, not by HBM.

What the design does about it (``csrc/band_copy.cu``):
  * every SM is busy: the ``H * n_chunks`` (row, chunk) stages go
    round-robin over ``min(stages, SMs)`` persistent CTAs, so the CTAs copy
    neighbouring, overlapping bands at the same time and share them in L2
    (the TPU's sequential grid of ``H / rows_per_step`` steps filled 90 of
    132 SMs); ``rows_per_step`` stays a precondition of the API only;
  * the copy engine moves the bytes: one thread issues each chunk as one
    TMA bulk copy (``cp.async.bulk``) that completes on the full barrier of
    a 4-stage ring (``mbarrier``), so up to four chunks (~200 KB at the
    tool's shape) are in flight per SM and no thread spends time issuing
    16-byte copies;
  * chunk boundaries fall on 128-byte lines, and a band takes the fewest
    chunks a ring slot holds, as equal as that allows (7 of 51,584 /
    51,456 B at the tool's shape); 16-byte boundaries cost a fifth of the
    rate there;
  * bands that are not 16-byte aligned (``C * Wp * 4 % 16 != 0`` or ``src``
    misaligned) take a second instance: the issuing warp's lanes make 4-byte
    ``cp.async`` copies that arrive on the same full barriers.
The launch plan (chunks, ring, grid, each CTA's stages) is Python below
(``plan_band_copy``), so the CPU tests check it.

The wrapper takes the plain PyTorch version (``band_copy_plain``) only for
CPU tensors; for CUDA tensors it launches the kernel or raises. The TPU
kernel's preconditions are errors here: ``H % rows_per_step == 0`` (the TPU
grid floors ``H // 8`` and leaves the remaining rows unwritten) and
``0 <= by[r]``, ``by[r] + A <= Hs``.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from pathlib import Path

import torch

from ._build import build_shared, nvcc_path
from .block_warp import NVCC_FLAGS

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "band_copy.cu"
SMEM_MAX = 227 * 1024    # what one CTA may have on the card
BARRIER_BYTES = 128      # full[NST] and empty[NST] mbarriers before the ring
STAGES, MAX_STAGES = 4, 4  # ring slots: the plan's, the most the kernel holds
SLOT_ALIGN = 128         # ring slots start at multiples of this many bytes
SPLIT_BYTES = 128        # bulk chunks begin at multiples of this many bytes

_LOCK = threading.Lock()
_LIB = None
_SMS: dict = {}
build_log = ""


def load_kernel():
    """Build (first use) and load the CUDA library; returns the ctypes lib."""
    global _LIB, build_log
    with _LOCK:
        if _LIB is None:
            path, build_log = build_shared(_SRC, "band_copy",
                                           [nvcc_path(), *NVCC_FLAGS])
            lib = ctypes.CDLL(str(path))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.band_copy_launch.restype = ctypes.c_int
            lib.band_copy_launch.argtypes = [
                p, p, p,                 # src by out
                i, i, ll,                # H Wp row_bytes
                i, i, i, i, i,           # n_chunks split q rem tail
                i, i, i,                 # NST slot_bytes vec_out
                i, i, i, p]              # grid smem bulk stream
            _LIB = lib
    return _LIB


@dataclass(frozen=True)
class BandCopyPlan:
    """How the kernel stages the bands of one call (``csrc/band_copy.cu``).

    Chunk ``k`` of a band starts ``k * q + min(k, rem)`` split units in and
    holds ``q + (k < rem)`` of them, the last chunk ``tail`` bytes more;
    local stage ``j`` of a CTA uses ring slot ``j % NST``."""
    H: int
    Wp: int
    unit: int        # copy granularity, bytes: 16 (bulk copies) or 4
    split: int       # chunk boundaries fall at multiples of this many bytes
    row_bytes: int   # C * Wp * 4: one src row, the stride between band starts
    band_bytes: int  # A * row_bytes
    n_chunks: int    # chunks per band
    q: int           # split units in each of the shorter chunks
    rem: int         # chunks that take one split unit more
    tail: int        # band_bytes % split, added to the last chunk
    NST: int         # ring stages
    slot_bytes: int  # ring slot stride: the longest chunk, to SLOT_ALIGN
    vec_out: bool    # 16-byte stores of the output row
    grid: int        # CTAs

    @property
    def bulk(self) -> bool:
        return self.unit == 16

    @property
    def stages(self) -> int:
        """(row, chunk) stages of the whole call, row-major."""
        return self.H * self.n_chunks

    @property
    def smem(self) -> int:
        return BARRIER_BYTES + self.NST * self.slot_bytes

    def chunk(self, k: int) -> tuple[int, int]:
        """(byte offset in the band, bytes) of chunk ``k``."""
        return ((k * self.q + min(k, self.rem)) * self.split,
                (self.q + (k < self.rem)) * self.split
                + (self.tail if k == self.n_chunks - 1 else 0))

    def cta_stages(self, b: int) -> range:
        """Stages of CTA ``b``: ``b, b + grid, b + 2 grid, ...``, so that the
        CTAs move over the bands together."""
        return range(b, self.stages, self.grid)

    def ring(self, b: int):
        """CTA ``b``'s walk as the kernel makes it: per local stage ``j``,
        (stage, row, chunk, slot, parity of the full barrier's phase that
        the consumers wait for, parity of the empty barrier's phase that the
        issuing thread waits for before it refills the slot, or None)."""
        for j, s in enumerate(self.cta_stages(b)):
            empty = (j // self.NST - 1) & 1 if j >= self.NST else None
            yield (s, s // self.n_chunks, s % self.n_chunks, j % self.NST,
                   (j // self.NST) & 1, empty)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=256)
def plan_band_copy(H: int, Wp: int, C: int, A: int, rows_per_step: int,
                   sms: int, aligned: bool = True, out_aligned: bool = True,
                   n_chunks: int | None = None, stages: int | None = None,
                   split: int | None = None) -> BandCopyPlan:
    """Chunks, ring and grid of one launch. ``aligned``: ``src`` starts
    16-byte aligned (the row pitch is checked here); ``out_aligned``: so
    does ``out``. ``n_chunks``, ``stages`` and ``split`` override the rule
    below (the probe tool's plan sweep times the alternatives).

    The rule: bulk chunks begin at multiples of 128 B (``SPLIT_BYTES``), a
    line of the memory system: on the H100, chunks of 16-byte but not
    128-byte granularity cost the kernel a fifth of its rate at the tool's
    shape (PERF.md, the plan sweep). A band takes the fewest chunks that a
    ring of ``STAGES`` slots holds in one CTA's shared memory, as equal as
    that granularity allows. The grid is one persistent CTA per SM (fewer when
    there are fewer stages)."""
    if H < 1 or Wp < 1 or C < 1 or A < 1 or sms < 1:
        raise ValueError(f"band copy needs positive sizes, got H={H} Wp={Wp} "
                         f"C={C} A={A} sms={sms}")
    if rows_per_step < 1 or H % rows_per_step:
        raise ValueError(f"H={H} is not a multiple of rows_per_step="
                         f"{rows_per_step}")
    row_bytes = C * Wp * 4
    unit = 16 if aligned and row_bytes % 16 == 0 else 4
    split = split or (SPLIT_BYTES if unit == 16 else unit)
    if split % unit:
        raise ValueError(f"split={split} is not a multiple of the {unit}-byte "
                         f"copy unit")
    NST = stages or STAGES
    if not 1 <= NST <= MAX_STAGES:
        raise ValueError(f"{NST} ring stages, the kernel holds 1 to "
                         f"{MAX_STAGES}")
    band_bytes = A * row_bytes
    units, tail = divmod(band_bytes, split)
    cap = (SMEM_MAX - BARRIER_BYTES) // NST // SLOT_ALIGN * SLOT_ALIGN
    n = n_chunks or -(-band_bytes // cap)
    while True:
        n = max(1, min(n, units))   # no chunk is empty
        q, rem = divmod(units, n)
        slot_bytes = _ceil_to(max((q + (rem > 0)) * split,
                                  (q + (n - 1 < rem)) * split + tail),
                              SLOT_ALIGN)
        if (n_chunks or BARRIER_BYTES + NST * slot_bytes <= SMEM_MAX
                or n == units):
            break
        n += 1
    vec_out = unit == 16 and Wp % 4 == 0 and out_aligned
    return BandCopyPlan(H, Wp, unit, split, row_bytes, band_bytes, n, q, rem,
                        tail, NST, slot_bytes, vec_out, min(H * n, sms))


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


def sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def plan_for(src: torch.Tensor, by: torch.Tensor, A: int, rows_per_step: int,
             out: torch.Tensor | None = None) -> BandCopyPlan:
    """The plan the wrapper launches for these CUDA tensors."""
    _, C, Wp = src.shape
    return plan_band_copy(by.shape[0], Wp, C, A, rows_per_step,
                          sm_count(src.device), src.data_ptr() % 16 == 0,
                          out is None or out.data_ptr() % 16 == 0)


def _launch(src, by, A, rows_per_step, plan: BandCopyPlan | None = None):
    if not src.is_contiguous() or not by.is_contiguous():
        raise ValueError("src and by must be contiguous")
    Hs, C, Wp = src.shape
    H = by.shape[0]
    out = torch.empty(H, Wp, dtype=torch.float32, device=src.device)
    if H == 0:
        return out
    if plan is None:
        plan = plan_for(src, by, A, rows_per_step, out)
    lib = load_kernel()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.band_copy_launch(
            src.data_ptr(), by.data_ptr(), out.data_ptr(), H, Wp,
            plan.row_bytes, plan.n_chunks, plan.split, plan.q, plan.rem,
            plan.tail, plan.NST,
            plan.slot_bytes, int(plan.vec_out), plan.grid, plan.smem,
            int(plan.bulk), stream)
    if err != 0:
        raise RuntimeError(f"band_copy kernel launch failed: CUDA error {err} "
                           f"(grid {plan.grid}, {plan.smem} B shared memory)")
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
