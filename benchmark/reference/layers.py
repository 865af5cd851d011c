"""Plain layers of the DCVC-DC and EVC networks, float32, NCHW.

A frozen copy of the arithmetic the published models define
(DCVC-DC/src/models/layers.py, video_net.py; EVC/src/models/layers.py,
hyperprior.py), written with ``torch.nn`` modules and ``torch.nn.functional``
only. Child names follow the published checkpoints, so one ``state_dict``
loads into these modules and into the program under test. No compute-dtype
option, no row sharding, no kernels.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv(in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1):
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2)


def subpel_conv(in_ch: int, out_ch: int, r: int = 2, kernel: int = 1):
    return nn.Sequential(conv(in_ch, out_ch * r ** 2, kernel),
                         nn.PixelShuffle(r))


def leaky(x, slope=0.01):
    return F.leaky_relu(x, slope)


def max_pool2(x):
    return F.max_pool2d(x, 2, 2)


def avg_pool2(x):
    return F.avg_pool2d(x, 2, 2)


class ResidualBlockWithStride(nn.Module):
    def __init__(self, in_ch, out_ch, stride=2):
        super().__init__()
        self.conv1 = conv(in_ch, out_ch, 3, stride)
        self.conv2 = conv(out_ch, out_ch, 3)
        self.downsample = conv(in_ch, out_ch, 1, stride) if stride != 1 else None

    def forward(self, x):
        out = leaky(self.conv1(x))
        out = leaky(self.conv2(out), 0.1)
        identity = self.downsample(x) if self.downsample is not None else x
        return out + identity


class ResidualBlockUpsample(nn.Module):
    def __init__(self, in_ch, out_ch, upsample=2):
        super().__init__()
        self.subpel_conv = subpel_conv(in_ch, out_ch, upsample)
        self.conv = conv(out_ch, out_ch, 3)
        self.upsample = subpel_conv(in_ch, out_ch, upsample)

    def forward(self, x):
        out = leaky(self.subpel_conv(x))
        out = leaky(self.conv(out), 0.1)
        return out + self.upsample(x)


class ResBlock(nn.Module):
    """Pre-activation residual block (DCVC-DC video_net.py:58-76)."""

    def __init__(self, channel, slope=0.01, end_with_relu=False,
                 bottleneck=False):
        super().__init__()
        inner = channel // 2 if bottleneck else channel
        self.slope = slope
        self.end_with_relu = end_with_relu
        self.conv1 = conv(channel, inner, 3)
        self.conv2 = conv(inner, channel, 3)

    def forward(self, x):
        out = leaky(x, self.slope)
        out = leaky(self.conv1(out), self.slope)
        out = self.conv2(out)
        if self.end_with_relu:
            out = leaky(out, self.slope)
        return x + out


class DepthConv(nn.Module):
    """1x1 -> depthwise kxk -> 1x1 with adaptor shortcut (layers.py:135-163)."""

    def __init__(self, in_ch, out_ch, depth_kernel=3, stride=1, slope=0.01):
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
        return self.conv2(self.depth_conv(self.conv1(x))) + identity


class ConvFFN(nn.Module):
    def __init__(self, in_ch, slope=0.1):
        super().__init__()
        internal = max(min(in_ch * 4, 1024), in_ch * 2)
        self.conv = nn.Sequential(
            nn.Conv2d(in_ch, internal, 1), nn.LeakyReLU(slope),
            nn.Conv2d(internal, in_ch, 1), nn.LeakyReLU(slope))

    def forward(self, x):
        return x + self.conv(x)


class ConvFFN2(nn.Module):
    """Gated FFN: x1 * LeakyReLU(x2) (layers.py:182-196)."""

    def __init__(self, in_ch, slope=0.1):
        super().__init__()
        internal = in_ch * 2
        self.slope = slope
        self.conv = nn.Conv2d(in_ch, internal * 2, 1)
        self.conv_out = nn.Conv2d(internal, in_ch, 1)

    def forward(self, x):
        x1, x2 = self.conv(x).chunk(2, 1)
        return x + self.conv_out(x1 * leaky(x2, self.slope))


class DepthConvBlock(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.block = nn.Sequential(DepthConv(in_ch, out_ch), ConvFFN(out_ch))

    def forward(self, x):
        return self.block(x)


class DepthConvBlock2(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.block = nn.Sequential(DepthConv(in_ch, out_ch), ConvFFN2(out_ch))

    def forward(self, x):
        return self.block(x)


class UNet(nn.Module):
    """3-level UNet of depth-conv blocks (video_net.py:129-214)."""

    def __init__(self, in_ch=64, out_ch=64, block2=False):
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


# EVC variants (EVC/src/models/layers.py:160-253, hyperprior.py:7-78)

class EvcDepthConv(nn.Module):
    def __init__(self, in_ch, out_ch, depth_kernel=3, stride=1):
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
    def __init__(self, in_ch):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_ch, in_ch * 4, 1), nn.ReLU(),
            nn.Conv2d(in_ch * 4, in_ch, 1), nn.ReLU())

    def forward(self, x):
        return x + self.conv(x)


class EvcDepthConvBlock(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.block = nn.Sequential(EvcDepthConv(in_ch, out_ch),
                                   EvcConvFFN(out_ch))

    def forward(self, x):
        return self.block(x)


class DepthConvBlockUpsample(nn.Module):
    """DC-style depth-conv block + subpel upsample (hyperprior.py:66-74)."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.block = nn.Sequential(
            DepthConv(in_ch, out_ch), ConvFFN(out_ch),
            nn.Conv2d(out_ch, out_ch * 4, 1), nn.PixelShuffle(2))

    def forward(self, x):
        return self.block(x)


# learned factorized prior over hyper-latents (entropy_models.py:58-200)

class Bitparm(nn.Module):
    def __init__(self, channel, final=False):
        super().__init__()
        self.final = final
        self.h = nn.Parameter(torch.zeros(1, channel, 1, 1))
        self.b = nn.Parameter(torch.zeros(1, channel, 1, 1))
        if not final:
            self.a = nn.Parameter(torch.zeros(1, channel, 1, 1))

    def forward(self, x):
        x = x * F.softplus(self.h) + self.b
        if self.final:
            return x
        return x + torch.tanh(x) * torch.tanh(self.a)


class BitEstimator(nn.Module):
    def __init__(self, channel):
        super().__init__()
        self.f1 = Bitparm(channel)
        self.f2 = Bitparm(channel)
        self.f3 = Bitparm(channel)
        self.f4 = Bitparm(channel, True)

    def forward(self, x):
        return torch.sigmoid(self.f4(self.f3(self.f2(self.f1(x)))))


# the float64-accumulated twin (a calibration control)

def accumulate_f64(module: nn.Module) -> nn.Module:
    """Makes every dense convolution of ``module`` (``groups`` 1)
    accumulate in float64 and round its output, bias added, once to
    float32: another exact order of the same sums, as a faster kernel
    would bring. Returns ``module``."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d) and m.groups == 1:
            w64 = m.weight.detach().double()
            b64 = None if m.bias is None else m.bias.detach().double()

            def forward(x, m=m, w64=w64, b64=b64):
                return F.conv2d(x.double(), w64, b64, m.stride, m.padding,
                                m.dilation, m.groups).to(x.dtype)

            m.forward = forward
    return module
