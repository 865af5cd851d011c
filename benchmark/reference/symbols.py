"""The symbols of one coded frame, plane by plane, and how they compare
with the reference's own rounding.

A codec rounds residuals ``r`` (``y / q_step - mean``, or ``z``) to
integer symbols, and its decoder rebuilds everything from those symbols.
Two correct float32 programs that sum in other orders compute ``r`` a few
ulps apart, so a residual within that distance of a rounding boundary
(``|frac(|r|) - 0.5|`` tiny) can round either way. The reference follows
the symbols a decoder produced (``planes``), so that one such symbol
moves nothing else, and judges each one against its own rounding:

* equal: sound;
* the other integer beside a boundary where ``|frac(|r|) - 0.5| <=
  delta``: a **tie**, a rounding ambiguity of float32 arithmetic;
* anything else, or a plane missing or misshapen: a **fault**.

Without ``planes`` the reference rounds its own residuals and keeps them,
with its symbols, in the stream's layout (a control in the program's
place). Planes travel as flat host tensors, in the order and NHWC layout
of the stream.
"""

from __future__ import annotations

import torch


NEAR = 1e-3       # how far from a boundary a flip's distance is kept


def flat_nhwc(t):
    """``t`` [N, C, H, W] flat in NHWC order, on the host."""
    return t.detach().permute(0, 2, 3, 1).reshape(-1).cpu()


def tally(r, q, delta: float) -> tuple:
    """(ties, faults, distances) of symbols ``q`` against the rounding of
    residuals ``r`` (same shape). A tie is the other integer beside the
    boundary nearest ``r``, ``floor(r)`` or ``floor(r) + 1`` (whichever
    ``round(r)`` is not), within ``delta`` of it; ``distances`` are
    ``|frac(|r|) - 0.5|`` of every symbol that is that other integer
    within ``NEAR`` of the boundary, tie or not (for calibration)."""
    r, q = r.double(), q.double()
    low = torch.floor(r)
    dist = (r - low - 0.5).abs()
    off = q != torch.round(r)
    other = off & ((q == low) | (q == low + 1))
    tie = other & (dist <= delta)
    return (int(tie.sum().item()), int((off & ~tie).sum().item()),
            dist[other & (dist <= NEAR)].cpu().tolist())


class Symbols:
    """One frame's symbol planes by name (``names``: the stream's order).

    ``planes``: the decoder's flat planes in stream order, to follow and
    judge; None: round the reference's own residuals. ``residuals``: the
    same frame's residual planes from a control, flat in stream order, to
    measure how far the reference's residuals lie from them (calibration
    only)."""

    def __init__(self, names, planes=None, delta: float = 0.0,
                 residuals=None):
        self.names = tuple(names)
        self.delta = delta
        self.given = None if planes is None else dict(zip(names, planes))
        self.ctrl = None if residuals is None else dict(zip(names,
                                                            residuals))
        self.ties = 0
        self.faults = 0
        if planes is not None and len(planes) != len(self.names):
            # a plane the stream does not have, or one it lacks (counted
            # where the reference asks for it)
            self.faults += sum(p.numel() for p in planes[len(self.names):])
        self.own: dict = {}
        self.res: dict = {}
        self.gaps: list = []
        self.distances: list = []

    def round(self, name: str, r):
        """The symbols of plane ``name`` whose residuals are ``r``
        [N, C, H, W]: the decoder's where given, else ``round(r)``."""
        own = torch.round(r)
        if self.ctrl is not None and name in self.ctrl:
            c = self.ctrl[name]
            if c.numel() == r.numel():
                self.gaps.append((flat_nhwc(r).double() - c.double()).abs())
        if self.given is None:
            self.own[name] = flat_nhwc(own)
            self.res[name] = flat_nhwc(r)
            return own
        q = self.given.get(name)
        if q is None or q.numel() != r.numel():
            self.faults += r.numel()
            return own
        n, c, h, w = r.shape
        # a fresh NCHW tensor: a permuted view keeps channels-last strides,
        # and a convolution of it may sum in another order
        q = torch.empty(r.shape, dtype=r.dtype, device=r.device).copy_(
            q.reshape(n, h, w, c).permute(0, 3, 1, 2))
        ties, faults, dist = tally(r, q, self.delta)
        self.ties += ties
        self.faults += faults
        self.distances += dist
        return q

    def stream(self) -> list:
        """The reference's own symbols, flat, in stream order."""
        return [self.own[n] for n in self.names]

    def residuals(self) -> list:
        """The reference's own residuals, flat, in stream order."""
        return [self.res[n] for n in self.names]
