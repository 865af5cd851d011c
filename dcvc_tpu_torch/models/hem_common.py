"""Networks shared by the HEM generation and the CANF-VC hybrid (NCHW).

Counterpart of ``dcvc_tpu/models/hem_common.py`` (parity targets:
DCVC-HEM/src/models/video_net.py:226-276 for the enc / dec and hyper
factories, :149-223 for SELayer / ConvBlockResidual / UNet, :279-307 for
DeQuantizationModule, and the conv3 prior stacks of video_model.py:150-213
and image_model.py:25-39). Child names are the reference checkpoint's
(``dcvc_tpu/utils/port_hem.py:16-114``): the enc / dec stacks are
Sequentials ``0``..``6`` / ``0``..``7``, the hyper stacks keep their convs
at ``0, 2, 4, 6, 8``, the prior stacks at ``0, 2, 4``, ConvBlockResidual is
``conv.0`` / ``conv.2`` / SE ``conv.3.fc.0`` / ``conv.3.fc.2`` + ``up_dim``,
and the UNet's ReLU ResBlocks are ``context_refine.{i}``.

The hyper encoders are DC's (``video_net.HyperEnc`` /
``HyperEncReduced``: same layers, same keys), and so are the HEM feature
pyramid and context fusion (``FeatureExtractor`` /
``MultiScaleContextFusion`` at one width).

``dtype`` (None = f32, or ``torch.bfloat16``) is the compute dtype of
``layers/blocks.py``, given to every layer here as the JAX constructors
give it; parameters stay f32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..layers.blocks import (
    LeakyReLU,
    Linear,
    ResBlock,
    ResidualBlock,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    conv,
    max_pool2,
    set_compute_dtype,
    subpel_conv,
)


class HemEncoder(nn.Sequential):
    """get_enc_dec_models' encoder: 16x down residual stack."""

    def __init__(self, in_ch: int, channel: int, dtype=None):
        ch = channel
        super().__init__(
            ResidualBlockWithStride(in_ch, ch, 2), ResidualBlock(ch, ch),
            ResidualBlockWithStride(ch, ch, 2), ResidualBlock(ch, ch),
            ResidualBlockWithStride(ch, ch, 2), ResidualBlock(ch, ch),
            conv(ch, ch, 3, 2))
        set_compute_dtype(self, dtype)


class HemDecoder(nn.Sequential):
    def __init__(self, channel: int, out_ch: int, dtype=None):
        ch = channel
        super().__init__(
            ResidualBlock(ch, ch), ResidualBlockUpsample(ch, ch, 2),
            ResidualBlock(ch, ch), ResidualBlockUpsample(ch, ch, 2),
            ResidualBlock(ch, ch), ResidualBlockUpsample(ch, ch, 2),
            ResidualBlock(ch, ch), subpel_conv(ch, out_ch, 2))
        set_compute_dtype(self, dtype)


def HemHyperDec(z_ch: int, y_ch: int, dtype=None) -> nn.Sequential:
    """z -> 2 * y_ch prior features (video_net.py:264-274)."""
    y, y15 = y_ch, y_ch * 3 // 2
    return set_compute_dtype(nn.Sequential(
        conv(z_ch, y, 3), LeakyReLU(), subpel_conv(y, y, 2),
        LeakyReLU(), conv(y, y15, 3), LeakyReLU(),
        subpel_conv(y15, y15, 2), LeakyReLU(), conv(y15, y * 2, 3)), dtype)


def Conv3Stack(in_ch: int, features: Sequence[int],
               dtype=None) -> nn.Sequential:
    """conv3x3 layers with LeakyReLU(0.2) between (prior fusion / spatial
    prior)."""
    layers, c = [], in_ch
    for i, f in enumerate(features):
        if i:
            layers.append(LeakyReLU(0.2))
        layers.append(conv(c, f, 3))
        c = f
    return set_compute_dtype(nn.Sequential(*layers), dtype)


class SELayer(nn.Module):
    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        hidden = max(channel // reduction, 1)
        self.fc = nn.Sequential(Linear(channel, hidden, bias=False),
                                nn.ReLU(),
                                Linear(hidden, channel, bias=False),
                                nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class ConvBlockResidual(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Sequential(
            conv(in_ch, out_ch, 3), LeakyReLU(0.01), conv(out_ch, out_ch, 3),
            SELayer(out_ch))
        self.up_dim = conv(in_ch, out_ch, 1)

    def forward(self, x):
        return self.conv(x) + self.up_dim(x)


class HemUNet(nn.Module):
    """UNet of ConvBlockResidual with a ReLU ResBlock bottleneck
    (video_net.py:182)."""

    def __init__(self, in_ch: int = 64, out_ch: int = 64, dtype=None):
        super().__init__()
        self.conv1 = ConvBlockResidual(in_ch, 32)
        self.conv2 = ConvBlockResidual(32, 64)
        self.conv3 = ConvBlockResidual(64, 128)
        self.context_refine = nn.Sequential(
            *[ResBlock(128, slope=0.0) for _ in range(4)])
        self.up3 = subpel_conv(128, 64, 2)
        self.up_conv3 = ConvBlockResidual(128, 64)
        self.up2 = subpel_conv(64, 32, 2)
        self.up_conv2 = ConvBlockResidual(64, out_ch)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(max_pool2(x1))
        x3 = self.context_refine(self.conv3(max_pool2(x2)))
        d3 = self.up_conv3(torch.cat([x2, self.up3(x3)], dim=1))
        return self.up_conv2(torch.cat([x1, self.up2(d3)], dim=1))


class DeQuantizationModule(nn.Module):
    """Post-filter of the CANF-VC fork (video_net.py:291-307)."""

    def __init__(self, in_ch: int = 3, out_ch: int = 3, num_filters: int = 64,
                 num_layers: int = 8, dtype=None):
        super().__init__()
        nf = num_filters
        self.conv1 = conv(in_ch, nf, 3)
        self.resblock = nn.ModuleList(
            nn.Sequential(conv(nf, nf, 3), LeakyReLU(0.2), conv(nf, nf, 3))
            for _ in range(num_layers))
        self.conv2 = conv(nf, nf, 3)
        self.conv3 = conv(nf, out_ch, 3)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        c1 = self.conv1(x)
        h = c1
        for block in self.resblock:
            h = h + block(h)
        return self.conv3(self.conv2(h) + c1) + x
