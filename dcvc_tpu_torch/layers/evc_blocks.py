"""EVC-generation layer variants (NCHW ``nn.Module``s).

Counterpart of ``dcvc_tpu/layers/evc_blocks.py`` (parity target:
EVC/src/models/layers.py:160-253 and EVC/src/models/hyperprior.py:7-78).
Where they differ from the DC blocks of ``layers/blocks.py``: EVC's
DepthConv activates after each of its three convs (slope 0.01), its ConvFFN
is a plain ReLU 4x expansion, and with stride 2 the adaptor is a 2x2/s2
VALID conv. The EVC DepthConv wraps each conv in a ``Sequential`` with its
activation, so its ``state_dict`` keys are ``conv1.0``, ``depth_conv.0``
and ``conv2.0`` (the ``seq=True`` naming of ``port_dc._Mapper.dcb``).
"""

from __future__ import annotations

import torch.nn as nn

from .blocks import ConvFFN, DepthConv


class EvcDepthConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, depth_kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(in_ch, in_ch, 1, stride=stride),
                                   nn.LeakyReLU(0.01))
        self.depth_conv = nn.Sequential(
            nn.Conv2d(in_ch, in_ch, depth_kernel, padding=depth_kernel // 2,
                      groups=in_ch),
            nn.LeakyReLU(0.01))
        self.conv2 = nn.Sequential(nn.Conv2d(in_ch, out_ch, 1),
                                   nn.LeakyReLU(0.01))
        if stride != 1:
            self.adaptor = nn.Conv2d(in_ch, out_ch, 2, stride=2)
        elif in_ch != out_ch:
            self.adaptor = nn.Conv2d(in_ch, out_ch, 1)
        else:
            self.adaptor = None

    def forward(self, x):
        identity = self.adaptor(x) if self.adaptor is not None else x
        return self.conv2(self.depth_conv(self.conv1(x))) + identity


class EvcConvFFN(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_ch, in_ch * 4, 1), nn.ReLU(),
            nn.Conv2d(in_ch * 4, in_ch, 1), nn.ReLU())

    def forward(self, x):
        return x + self.conv(x)


class EvcDepthConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, depth_kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.block = nn.Sequential(
            EvcDepthConv(in_ch, out_ch, depth_kernel, stride),
            EvcConvFFN(out_ch))

    def forward(self, x):
        return self.block(x)


class EvcDepthConvBlockUpsample(nn.Module):
    """EVC DepthConvBlock + subpel upsample; keys as DepthConvBlockUpsample's
    (``block.0`` / ``block.1`` the block, ``block.2`` the subpel conv)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.block = nn.Sequential(
            EvcDepthConv(in_ch, out_ch), EvcConvFFN(out_ch),
            nn.Conv2d(out_ch, out_ch * 4, 1), nn.PixelShuffle(2))

    def forward(self, x):
        return self.block(x)


class DepthConvBlockUpsample(nn.Module):
    """DC-style DepthConvBlock + subpel upsample
    (EVC/src/models/hyperprior.py:66-74): keys ``block.0`` (DepthConv),
    ``block.1`` (ConvFFN), ``block.2`` (the subpel conv)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.block = nn.Sequential(
            DepthConv(in_ch, out_ch), ConvFFN(out_ch),
            nn.Conv2d(out_ch, out_ch * 4, 1), nn.PixelShuffle(2))

    def forward(self, x):
        return self.block(x)
