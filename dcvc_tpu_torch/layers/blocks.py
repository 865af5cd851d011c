"""The DCVC-DC layer zoo (NCHW ``nn.Module``s).

Counterpart of ``dcvc_tpu/layers/blocks.py``. Topologies, activation
slopes and child names follow the reference (DCVC-DC/src/models/layers.py:
18-223, video_net.py:58-214), so a reference ``state_dict`` loads with
``load_state_dict(strict=True)``. Unlike flax, torch needs each block's
input width, so every constructor takes ``in_ch`` first.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv(in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2)


def deconv(in_ch: int, out_ch: int, kernel: int = 3,
           stride: int = 2) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(in_ch, out_ch, kernel, stride=stride,
                              padding=kernel // 2, output_padding=stride - 1)


def subpel_conv(in_ch: int, out_ch: int, r: int = 2,
                kernel: int = 1) -> nn.Sequential:
    """conv(k) producing out*r^2 channels + pixel shuffle (keys ``.0``)."""
    return nn.Sequential(conv(in_ch, out_ch * r ** 2, kernel), nn.PixelShuffle(r))


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, slope)


class ResidualBlockWithStride(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 2):
        super().__init__()
        self.conv1 = conv(in_ch, out_ch, 3, stride)
        self.conv2 = conv(out_ch, out_ch, 3)
        self.downsample = conv(in_ch, out_ch, 1, stride) if stride != 1 else None

    def forward(self, x):
        out = leaky_relu(self.conv1(x))
        out = leaky_relu(self.conv2(out), 0.1)
        identity = self.downsample(x) if self.downsample is not None else x
        return out + identity


class ResidualBlockUpsample(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, upsample: int = 2):
        super().__init__()
        self.subpel_conv = subpel_conv(in_ch, out_ch, upsample)
        self.conv = conv(out_ch, out_ch, 3)
        self.upsample = subpel_conv(in_ch, out_ch, upsample)

    def forward(self, x):
        out = leaky_relu(self.subpel_conv(x))
        out = leaky_relu(self.conv(out), 0.1)
        return out + self.upsample(x)


class ResidualBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, slope: float = 0.01):
        super().__init__()
        self.slope = slope
        self.conv1 = conv(in_ch, out_ch, 3)
        self.conv2 = conv(out_ch, out_ch, 3)
        self.adaptor = conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        identity = self.adaptor(x) if self.adaptor is not None else x
        out = leaky_relu(self.conv1(x), self.slope)
        out = leaky_relu(self.conv2(out), self.slope)
        return out + identity


class ResBlock(nn.Module):
    """Pre-activation residual block (video_net.py:58-76)."""

    def __init__(self, channel: int, slope: float = 0.01,
                 end_with_relu: bool = False, bottleneck: bool = False):
        super().__init__()
        inner = channel // 2 if bottleneck else channel
        self.slope = slope
        self.end_with_relu = end_with_relu
        self.conv1 = conv(channel, inner, 3)
        self.conv2 = conv(inner, channel, 3)

    def forward(self, x):
        out = leaky_relu(x, self.slope)
        out = leaky_relu(self.conv1(out), self.slope)
        out = self.conv2(out)
        if self.end_with_relu:
            out = leaky_relu(out, self.slope)
        return x + out


class DepthConv(nn.Module):
    """1x1 -> depthwise kxk -> 1x1 with adaptor shortcut (layers.py:135-163)."""

    def __init__(self, in_ch: int, out_ch: int, depth_kernel: int = 3,
                 stride: int = 1, slope: float = 0.01):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(in_ch, in_ch, 1, stride=stride),
                                   nn.LeakyReLU(slope))
        self.depth_conv = nn.Conv2d(in_ch, in_ch, depth_kernel,
                                    padding=depth_kernel // 2, groups=in_ch)
        self.conv2 = nn.Conv2d(in_ch, out_ch, 1)
        if stride != 1:
            self.adaptor = nn.Conv2d(in_ch, out_ch, 2, stride=2)
        elif in_ch != out_ch:
            self.adaptor = nn.Conv2d(in_ch, out_ch, 1)
        else:
            self.adaptor = None

    def forward(self, x):
        identity = self.adaptor(x) if self.adaptor is not None else x
        out = self.conv2(self.depth_conv(self.conv1(x)))
        return out + identity


class ConvFFN(nn.Module):
    def __init__(self, in_ch: int, slope: float = 0.1):
        super().__init__()
        internal = max(min(in_ch * 4, 1024), in_ch * 2)
        self.conv = nn.Sequential(
            nn.Conv2d(in_ch, internal, 1), nn.LeakyReLU(slope),
            nn.Conv2d(internal, in_ch, 1), nn.LeakyReLU(slope))

    def forward(self, x):
        return x + self.conv(x)


class ConvFFN2(nn.Module):
    """Gated FFN: x1 * LeakyReLU(x2) (layers.py:182-196)."""

    def __init__(self, in_ch: int, slope: float = 0.1):
        super().__init__()
        internal = in_ch * 2
        self.slope = slope
        self.conv = nn.Conv2d(in_ch, internal * 2, 1)
        self.conv_out = nn.Conv2d(internal, in_ch, 1)

    def forward(self, x):
        x1, x2 = self.conv(x).chunk(2, 1)
        return x + self.conv_out(x1 * leaky_relu(x2, self.slope))


class DepthConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, depth_kernel: int = 3,
                 stride: int = 1, slope_depth_conv: float = 0.01,
                 slope_ffn: float = 0.1):
        super().__init__()
        self.block = nn.Sequential(
            DepthConv(in_ch, out_ch, depth_kernel, stride, slope_depth_conv),
            ConvFFN(out_ch, slope_ffn))

    def forward(self, x):
        return self.block(x)


class DepthConvBlock2(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, depth_kernel: int = 3,
                 stride: int = 1, slope_depth_conv: float = 0.01,
                 slope_ffn: float = 0.1):
        super().__init__()
        self.block = nn.Sequential(
            DepthConv(in_ch, out_ch, depth_kernel, stride, slope_depth_conv),
            ConvFFN2(out_ch, slope_ffn))

    def forward(self, x):
        return self.block(x)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 2, 2)


class UNet(nn.Module):
    """3-level UNet of DepthConvBlocks (video_net.py:129-214); ``block2``
    selects DepthConvBlock2 (the DC intra refinement's UNet2)."""

    def __init__(self, in_ch: int = 64, out_ch: int = 64, block2: bool = False):
        super().__init__()
        Block = DepthConvBlock2 if block2 else DepthConvBlock
        self.conv1 = Block(in_ch, 32)
        self.conv2 = Block(32, 64)
        self.conv3 = Block(64, 128)
        self.context_refine = nn.Sequential(*[Block(128, 128) for _ in range(4)])
        self.up3 = subpel_conv(128, 64, 2)
        self.up_conv3 = Block(128, 64)
        self.up2 = subpel_conv(64, 32, 2)
        self.up_conv2 = Block(64, out_ch)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(max_pool2(x1))
        x3 = self.context_refine(self.conv3(max_pool2(x2)))
        d3 = self.up_conv3(torch.cat([x2, self.up3(x3)], dim=1))
        return self.up_conv2(torch.cat([x1, self.up2(d3)], dim=1))
