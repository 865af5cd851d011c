"""Small differentiable math ops shared across codecs.

Counterpart of ``dcvc_tpu/ops/math.py``.
"""

from __future__ import annotations

import torch


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # pass-through when above the bound OR when the gradient pushes x
        # upward (parity: LowerBound autograd op, EVC/src/models/layers.py:21-36)
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``max(x, bound)`` whose gradient passes where x >= bound or where
    the incoming gradient is negative."""
    return _LowerBound.apply(x, bound)
