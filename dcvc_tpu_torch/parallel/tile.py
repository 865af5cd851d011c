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
Nothing falls back: a collective that fails raises, and rows that do not
divide raise.

Gradients (the transpose GSPMD inserted for the JAX package's training).
Every tile rank holds the same loss, built from its own rows; each rank's
backward gives its *partial* parameter gradient, and the sum over the
tile axis is the gradient of the whole frame (``mesh.reduce_gradients``
takes that sum). Under this convention:

* ``halo`` sends each halo row's gradient back to the rank that owns the
  row, which adds it onto its edge rows; zero-fill rows drop;
* ``gather_rows`` sums every rank's gradient of the whole tensor over the
  tile axis and keeps this rank's rows; ``own_rows`` passes its rows'
  gradient back with zeros elsewhere (a plain slice, no communication);
* ``sum_tiles`` passes the gradient through unchanged: each rank's own
  rows enter the replicated sum once;
* ``once`` marks a term computed whole on every tile rank that enters the
  loss (a hyper latent's bits, MS-SSIM on gathered rows): it passes
  1 / tile of the gradient back, so the sum over the tile axis counts the
  term once.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dcvc_tpu_torch.parallel.mesh import all_gather_parts, slab, unslab

_STATE = threading.local()


class _GatherRows(torch.autograd.Function):
    """All-gather of the H slabs; backward: every rank's gradient of the
    whole tensor summed over the tile axis, this rank's rows kept."""

    @staticmethod
    def forward(fctx, x, tctx):
        fctx.tctx = tctx
        return unslab(x, 2, tctx.group, tctx.size)

    @staticmethod
    def backward(fctx, g):
        t = fctx.tctx
        g = g.contiguous().clone()
        dist.all_reduce(g, group=t.group)
        return slab(g, 2, t.rank, t.size).contiguous(), None


class _SumTiles(torch.autograd.Function):
    """All-reduce over the tile axis; backward: the identity."""

    @staticmethod
    def forward(fctx, x, tctx):
        x = x.clone()
        dist.all_reduce(x, group=tctx.group)
        return x

    @staticmethod
    def backward(fctx, g):
        return g, None


class _Once(torch.autograd.Function):
    """The identity; backward: 1 / ``n`` of the gradient."""

    @staticmethod
    def forward(fctx, x, n):
        fctx.n = n
        return x.clone()

    @staticmethod
    def backward(fctx, g):
        return g / fctx.n, None


class _Halo(torch.autograd.Function):
    """``x`` with the last ``top`` rows of the rank above and the first
    ``bottom`` rows of the rank below (none past a global edge); both
    widths at most a slab. Backward: the halo rows' gradients go back to
    their owners, which add them onto their edge rows."""

    @staticmethod
    def forward(fctx, x, tctx, top, bottom):
        r, n, h = tctx.rank, tctx.size, x.shape[2]
        # every rank sends its first `bottom` and last `top` rows
        parts = all_gather_parts(torch.cat(
            [x[:, :, :bottom], x[:, :, h - top:]], dim=2), tctx.group, n)
        up = parts[r - 1][:, :, bottom:] if r > 0 else x[:, :, :0]
        down = parts[r + 1][:, :, :bottom] if r < n - 1 else x[:, :, :0]
        fctx.tctx, fctx.top, fctx.bottom = tctx, top, bottom
        fctx.up, fctx.h = up.shape[2], h
        return torch.cat([up, x, down], dim=2)

    @staticmethod
    def backward(fctx, g):
        t, top, bottom, up, h = (fctx.tctx, fctx.top, fctx.bottom, fctx.up,
                                 fctx.h)
        r, n = t.rank, t.size
        gx = g[:, :, up:up + h].clone()
        # every rank sends the gradient of the rows it took from above
        # (zeros at the top edge) and from below (zeros at the bottom edge)
        send = g.new_zeros(g.shape[:2] + (top + bottom,) + g.shape[3:])
        send[:, :, top - up:top] = g[:, :, :up]
        send[:, :, top:top + g.shape[2] - up - h] = g[:, :, up + h:]
        parts = all_gather_parts(send, t.group, n)
        if r < n - 1:                   # the rank below took my last rows
            gx[:, :, h - top:] += parts[r + 1][:, :, :top]
        if r > 0:                       # the rank above took my first rows
            gx[:, :, :bottom] += parts[r - 1][:, :, top:]
        return gx, None, None, None


class TileContext:
    """The tile subgroup, the frame's global H and this rank's place."""

    def __init__(self, group, rank: int, size: int, height: int,
                 data_rank: int = 0, data_size: int = 1):
        if height % size:
            raise ValueError(f"{height} rows do not divide over {size} tiles")
        self.group, self.rank, self.size = group, rank, size
        self.data_rank, self.data_size = data_rank, data_size
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
        return x if self.size == 1 else _GatherRows.apply(x, self)

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slab of a whole (replicated) tensor ``x``."""
        return slab(x, 2, self.rank, self.size).contiguous()

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks of the tile axis."""
        return x if self.size == 1 else _SumTiles.apply(x, self)

    def once(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, computed whole on every rank, counted once by the sum of
        the ranks' gradients: 1 / tile of the gradient passes back."""
        return x if self.size == 1 else _Once.apply(x, self.size)

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
            mid = x
        elif top <= h and bottom <= h:
            mid = _Halo.apply(x, self, top, bottom)
        else:                               # a halo wider than a slab
            whole = self.gather_rows(x)
            mid = whole[:, :, max(off - top, 0):off + h + bottom]
        up = min(top, off) if self.size > 1 else 0
        down = mid.shape[2] - h - up
        if fill is None:
            return mid
        if fill != "zeros":
            raise ValueError(f"unknown halo fill {fill!r}")
        return F.pad(mid, (0, 0, top - up, bottom - down))

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


@contextlib.contextmanager
def use(ctx: TileContext | None):
    """Run the ops inside under ``ctx`` (None: no context). A function
    that autograd recomputes in backward (``torch.utils.checkpoint``), on
    another thread or after its caller's ``context`` has exited, enters
    the context it was made under with this."""
    prev = current()
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev


@contextlib.contextmanager
def context(mesh, height: int):
    """Run the ops inside on this rank's slabs of a frame of ``height``
    rows, tiled over ``mesh``'s 'tile' axis; ``mesh`` None is no mesh."""
    if mesh is None:
        yield None
        return
    ctx = TileContext(mesh.get_group("tile"), mesh.get_local_rank("tile"),
                      mesh.size(mesh.mesh_dim_names.index("tile")), height,
                      mesh.get_local_rank("data"),
                      mesh.size(mesh.mesh_dim_names.index("data")))
    with use(ctx):
        yield ctx


def whole():
    """Suspend the context: the ops inside run on whole tensors (rows
    gathered with ``gather_rows``), replicated over the tile axis."""
    return use(None)


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


def once(x: torch.Tensor) -> torch.Tensor:
    """A term computed whole on every tile rank, counted once in the
    gradient (``TileContext.once``); ``x`` itself without a context."""
    ctx = current()
    return x if ctx is None else ctx.once(x)


def rand(x: torch.Tensor, generator: torch.Generator,
         rows: bool = True) -> torch.Tensor:
    """U[0, 1) draws in ``x``'s shape, dtype and device from
    ``generator``. Under a context the whole tensor's draws are made and
    this rank's slab is kept: the batch over the data axis and, with
    ``rows``, H over the tile axis (``rows=False``: ``x`` holds every row,
    as a hyper latent does), so a mesh draws what one device draws."""
    ctx = current()
    kw = {"generator": generator, "dtype": x.dtype, "device": x.device}
    if ctx is None:
        return torch.rand(x.shape, **kw)
    B, C, H, W = x.shape
    u = torch.rand((B * ctx.data_size, C, H * ctx.size if rows else H, W),
                   **kw)
    u = slab(u, 0, ctx.data_rank, ctx.data_size)
    return (slab(u, 2, ctx.rank, ctx.size) if rows else u).contiguous()


def global_rows(rows: int) -> int:
    """Rows of the whole tensor whose slab has ``rows`` rows."""
    ctx = current()
    return rows if ctx is None else rows * ctx.size


def offset_of(rows: int) -> int:
    """Global index of the first row of this rank's slab of ``rows``
    rows (0 without a context)."""
    ctx = current()
    return 0 if ctx is None else ctx.row_offset(ctx.scale_of(rows))
