"""Spatial tiles of the H axis: the halo exchange that GSPMD inserted.

Under a (data, tile) mesh (``parallel/mesh.py``) the rank at position r
of the 'tile' axis holds rows [r * h, (r + 1) * h) of every frame-shaped
tensor, h = H / tile at that tensor's scale. The calling runtime enters
``context(mesh, height)`` once for a frame of ``height`` rows; the ops
that read other rows than their own consult ``current()``:

* convolutions (``layers/blocks.py``) pad H with ``halo`` rows from the
  neighbour ranks and use their own zero padding only at the global edges;
* bilinear resizes (``ops/warp.py``) take halo rows and global
  coordinates; the warps sample this rank's output rows from the source
  map gathered over the tile axis (``gather_rows``);
* the priors' phase and checkerboard masks take the global row parity
  (``row_offset``);
* below the scale where the rows stop dividing, a model gathers the rows,
  runs the rest ``whole()`` (replicated over the tile axis) and cuts its
  own rows again (``own_rows``); per-sample sums are ``sum_tiles``.

With one rank on the tile axis the same code runs with only global edges.
Nothing here is differentiable (inference only), and nothing falls back:
a collective that fails raises, and rows that do not divide raise.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dcvc_tpu_torch.parallel.mesh import all_gather_parts, slab, unslab

_STATE = threading.local()


class TileContext:
    """The tile subgroup, the frame's global H and this rank's place."""

    def __init__(self, group, rank: int, size: int, height: int):
        if height % size:
            raise ValueError(f"{height} rows do not divide over {size} tiles")
        self.group, self.rank, self.size = group, rank, size
        self.height = height
        self.rows = height // size          # this rank's rows, frame scale

    def scale_of(self, rows: int) -> int:
        """The scale (1, 2, 4, ...) of a slab of ``rows`` local rows."""
        s = self.rows // rows if rows else 0
        if not s or s * rows != self.rows:
            raise ValueError(f"a slab of {rows} rows is at no scale of "
                             f"this rank's {self.rows} frame rows")
        return s

    def row_offset(self, scale: int = 1) -> int:
        """Global index of this rank's first row at 1 / ``scale``."""
        return self.rank * (self.rows // scale)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's slab ``x`` (NCHW, H)."""
        return unslab(x, 2, self.group, self.size)

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slab of a whole (replicated) tensor ``x``."""
        return slab(x, 2, self.rank, self.size).contiguous()

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks of the tile axis."""
        if self.size == 1:
            return x
        x = x.clone()
        dist.all_reduce(x, group=self.group)
        return x

    def halo(self, x: torch.Tensor, top: int, bottom: int,
             fill: str | None = "zeros") -> torch.Tensor:
        """``x`` with ``top`` rows above and ``bottom`` below taken from
        the neighbour ranks. Past a global edge the rows are ``fill``:
        "zeros" (a convolution's padding), or None, which adds no row
        there (the op clamps at the edge itself; ``min(top, offset)`` rows
        are then added above)."""
        if not top and not bottom:
            return x
        h = x.shape[2]
        off = self.rank * h
        if self.size == 1:
            up = down = x[:, :, :0]
        elif top <= h and bottom <= h:
            # every rank sends its first `bottom` and last `top` rows
            parts = all_gather_parts(torch.cat(
                [x[:, :, :bottom], x[:, :, h - top:]], dim=2), self.group,
                self.size)
            up = (parts[self.rank - 1][:, :, bottom:] if self.rank > 0
                  else x[:, :, :0])
            down = (parts[self.rank + 1][:, :, :bottom]
                    if self.rank < self.size - 1 else x[:, :, :0])
        else:                               # a halo wider than a slab
            whole = self.gather_rows(x)
            up = whole[:, :, max(off - top, 0):off]
            down = whole[:, :, off + h:off + h + bottom]
        mid = torch.cat([up, x, down], dim=2)
        if fill is None:
            return mid
        if fill != "zeros":
            raise ValueError(f"unknown halo fill {fill!r}")
        return F.pad(mid, (0, 0, top - up.shape[2], bottom - down.shape[2]))

    def conv_rows(self, x, kernel: int, stride: int, padding: int, conv):
        """A convolution over H (``kernel``, ``stride``, zero ``padding``)
        of this rank's rows: ``conv`` runs on ``x`` with its halo and no H
        padding of its own."""
        h = x.shape[2]
        if h % stride:
            raise ValueError(f"{h} local rows do not divide by stride "
                             f"{stride}; gather the rows first")
        y = conv(self.halo(x, padding, max(kernel - stride - padding, 0)))
        if y.shape[2] != h // stride:
            raise AssertionError(f"{y.shape[2]} rows out of a {kernel}/"
                                 f"{stride} convolution of {h} rows")
        return y

    def conv_transpose_rows(self, x, kernel: int, stride: int, padding: int,
                            output_padding: int, conv):
        """A transposed convolution over H whose whole output has
        ``stride`` times the input's rows, of this rank's rows: ``conv``
        runs on ``x`` with its halo and its own H padding."""
        if kernel + output_padding - 2 * padding != stride:
            raise ValueError("a sharded transposed convolution must map H "
                             "rows to stride * H")
        top = (kernel - 1 - padding) // stride
        bottom = (padding + stride - 1) // stride
        y = conv(self.halo(x, top, bottom, "zeros"))
        h = x.shape[2]
        return y[:, :, stride * top:stride * (top + h)]


def current() -> TileContext | None:
    """The tile context of this thread, None outside a mesh."""
    return getattr(_STATE, "ctx", None)


def _enter(ctx):
    prev = current()
    _STATE.ctx = ctx
    return prev


@contextlib.contextmanager
def context(mesh, height: int):
    """Run the ops inside on this rank's slabs of a frame of ``height``
    rows, tiled over ``mesh``'s 'tile' axis; ``mesh`` None is no mesh."""
    if mesh is None:
        yield None
        return
    ctx = TileContext(mesh.get_group("tile"), mesh.get_local_rank("tile"),
                      mesh.size(mesh.mesh_dim_names.index("tile")), height)
    prev = _enter(ctx)
    try:
        yield ctx
    finally:
        _STATE.ctx = prev


@contextlib.contextmanager
def whole():
    """Suspend the context: the ops inside run on whole tensors (rows
    gathered with ``gather_rows``), replicated over the tile axis."""
    prev = _enter(None)
    try:
        yield
    finally:
        _STATE.ctx = prev


def tiles(mesh) -> int:
    """Ranks on ``mesh``'s tile axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index("tile"))


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    ctx = current()
    return x if ctx is None else ctx.gather_rows(x)


def own_rows(x: torch.Tensor) -> torch.Tensor:
    ctx = current()
    return x if ctx is None else ctx.own_rows(x)


def sum_tiles(x: torch.Tensor) -> torch.Tensor:
    ctx = current()
    return x if ctx is None else ctx.sum(x)


def global_rows(rows: int) -> int:
    """Rows of the whole tensor whose slab has ``rows`` rows."""
    ctx = current()
    return rows if ctx is None else rows * ctx.size


def offset_of(rows: int) -> int:
    """Global index of the first row of this rank's slab of ``rows``
    rows (0 without a context)."""
    ctx = current()
    return 0 if ctx is None else ctx.row_offset(ctx.scale_of(rows))
