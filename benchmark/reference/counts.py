"""Operation and byte counts from shapes: the yardstick of the roofline
and utilization metrics.

``conv_flops`` is the arithmetic of the program's complexity tool, copied
so that a change to the program cannot move it: 2 x output elements x
(input channels / groups) x kh x kw for a convolution, 2 x input elements
x (output channels / groups) x kh x kw for a transposed one.
``k1_bytes`` is the bytes bound of the block warp: its input map and its
output map once each, and its f32 flow once.
"""

from __future__ import annotations

import torch.nn as nn


def conv_flops(module: nn.Module, fn) -> float:
    """FLOPs of every ``nn.Conv2d`` / ``nn.ConvTranspose2d`` of ``module``
    that ``fn()`` runs, from the shapes it runs them at."""
    total = [0.0]

    def hook(conv, inputs, out):
        kh, kw = conv.kernel_size
        if isinstance(conv, nn.ConvTranspose2d):
            total[0] += (2.0 * inputs[0].numel() * conv.out_channels
                         / conv.groups * kh * kw)
        else:
            total[0] += (2.0 * out.numel() * conv.in_channels / conv.groups
                         * kh * kw)

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def k1_bytes(M: int, C: int, H: int, W: int, itemsize: int) -> int:
    """Bytes the block warp of ``M`` maps of ``C`` x ``H`` x ``W`` must
    move: the map read and the output written (``itemsize`` bytes each)
    and the two-channel f32 flow read."""
    return 2 * M * C * H * W * itemsize + M * 2 * H * W * 4
