"""The CompressAI-style intra zoo: the I-frame codecs of gen-1 DCVC and
DCVC-TCM (NCHW).

Counterpart of ``dcvc_tpu/models/intra_zoo.py`` (parity targets:
DCVC/src/models/priors.py:110-718 FactorizedPrior, ScaleHyperprior,
MeanScaleHyperprior, JointAutoregressiveHierarchicalPriors;
DCVC/src/models/waseda.py:28-95 Cheng2020Anchor; the registry
DCVC/src/zoo/image.py:26-31). Child names are the reference's
(``dcvc_tpu/utils/port_zoo.py``): a published ``state_dict`` loads once its
baked buffers (CDF tables, scale table, bounds, pedestals, masks) are
dropped, as ``utils/checkpoint.py`` does.

Each model has the methods its runtime calls: ``analyze``, ``synthesize``
and, by family, ``scales_from_z`` / ``params_from_z`` / ``hyper_from_z``;
``forward`` is the estimated-bits pass.

``dtype`` (None = f32, or ``torch.bfloat16``) reaches the layers the JAX
constructors give it to: the analysis and synthesis transforms (for
Cheng2020 their residual blocks, not the last layers) and the entropy
parameter net; the hyper transforms, the GDNs, the masked convolution and
the bottleneck stay f32. ``mbt2018`` takes no dtype (ROADMAP R4).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..device import resolve_device
from ..entropy.bottleneck import EntropyBottleneck
from ..layers.blocks import (ResidualBlock, conv, deconv, leaky_relu,
                             set_compute_dtype, subpel_conv)
from ..layers.gdn import GDN
from . import priors
from .video_dcvc import EntropyParams1x1, MaskedConv2d

SCALES_MIN = 0.11
_LOG2 = math.log(2.0)


def _probs_to_bits(likelihood):
    return -torch.log(torch.clamp_min(likelihood, 1e-9)) / _LOG2


def _gaussian_bits(y_q, scales):
    """CompressAI GaussianConditional._likelihood (DCVC/src/entropy_models/
    entropy_models.py:439-460): abs-folded, scale floor 0.11, likelihood
    floor 1e-9. A bf16 latent is widened before the subtraction and its
    bits come back in bf16, as in the JAX package."""
    scales = torch.clamp_min(scales, SCALES_MIN)
    v = torch.abs(y_q)
    wide = torch.promote_types(v.dtype, torch.float32)
    v32, s32 = v.to(wide), scales.to(wide)
    probs = (torch.special.ndtr((0.5 - v32) / s32)
             - torch.special.ndtr((-0.5 - v32) / s32))
    return -torch.log2(torch.clamp_min(probs, 1e-9)).to(v.dtype)


def _zoo_quant(quant_mode: str, generator):
    """The quantizer of both the recon and the rate paths: under
    ``"noise"`` the CompressAI training convention adds noise to both
    (entropy_models.py quantize(..., "noise")), unlike the DMC
    generations' STE recon with a noisy rate."""
    if quant_mode == "noise":
        return lambda t: priors.quant_noise(t, generator)
    return priors.resolve_quant(quant_mode)


def _g_a(N: int, M: int, dtype=None) -> nn.Sequential:
    """conv5x5-s2 + GDN, three times, then conv5x5-s2 to M."""
    return set_compute_dtype(nn.Sequential(
        conv(3, N, 5, 2), GDN(N), conv(N, N, 5, 2), GDN(N),
        conv(N, N, 5, 2), GDN(N), conv(N, M, 5, 2)), dtype)


def _g_s(N: int, M: int, dtype=None) -> nn.Sequential:
    return set_compute_dtype(nn.Sequential(
        deconv(M, N, 5, 2), GDN(N, inverse=True), deconv(N, N, 5, 2),
        GDN(N, inverse=True), deconv(N, N, 5, 2), GDN(N, inverse=True),
        deconv(N, 3, 5, 2)), dtype)


class FactorizedPrior(nn.Module):
    def __init__(self, N: int = 128, M: int = 192, dtype=None):
        super().__init__()
        self.N, self.M = N, M
        self.entropy_bottleneck = EntropyBottleneck(M)
        self.g_a = _g_a(N, M, dtype)
        self.g_s = _g_s(N, M, dtype)

    def forward(self, x, quant_mode: str = "round", generator=None):
        y = self.g_a(x)
        y_hat, y_lik = self.entropy_bottleneck(
            y, _zoo_quant(quant_mode, generator))
        pixel_num = x.shape[2] * x.shape[3]
        bpp_y = _probs_to_bits(y_lik).sum(dim=(1, 2, 3)) / pixel_num
        return {"x_hat": self.g_s(y_hat), "bpp": bpp_y, "bpp_y": bpp_y,
                "bit": bpp_y.sum() * pixel_num}

    def analyze(self, x):
        return self.g_a(x)

    def synthesize(self, y_hat):
        return torch.clamp(self.g_s(y_hat), 0.0, 1.0)


class _HyperBase(nn.Module):
    """g_a / g_s and an EntropyBottleneck over z; subclasses build
    ``h_a`` / ``h_s`` and say how y is quantized given h_s(z_hat)."""

    def __init__(self, N: int, M: int, dtype=None):
        super().__init__()
        self.N, self.M = N, M
        self.entropy_bottleneck = EntropyBottleneck(N)
        self.g_a = _g_a(N, M, dtype)
        self.g_s = _g_s(N, M, dtype)

    def _y_hat(self, y, hyper, quant):
        """(y_q, y_hat, scales) of ``y`` given the hyper decoder's output."""
        raise NotImplementedError

    def forward(self, x, quant_mode: str = "round", generator=None):
        quant = _zoo_quant(quant_mode, generator)
        y, z = self.analyze(x)
        z_hat, z_lik = self.entropy_bottleneck(z, quant)
        y_q, y_hat, scales = self._y_hat(y, self.h_s(z_hat), quant)
        pixel_num = x.shape[2] * x.shape[3]
        bpp_y = _gaussian_bits(y_q, scales).sum(dim=(1, 2, 3)) / pixel_num
        bpp_z = _probs_to_bits(z_lik).sum(dim=(1, 2, 3)) / pixel_num
        return {"x_hat": self.g_s(y_hat), "bpp": bpp_y + bpp_z,
                "bpp_y": bpp_y, "bpp_z": bpp_z,
                "bit": (bpp_y + bpp_z).sum() * pixel_num}

    def analyze(self, x):
        y = self.g_a(x)
        return y, self.h_a(y)

    def synthesize(self, y_hat):
        return torch.clamp(self.g_s(y_hat), 0.0, 1.0)


class ScaleHyperprior(_HyperBase):
    def __init__(self, N: int = 128, M: int = 192, dtype=None):
        super().__init__(N, M, dtype)
        self.h_a = nn.Sequential(
            conv(M, N, 3), nn.ReLU(), conv(N, N, 5, 2), nn.ReLU(),
            conv(N, N, 5, 2))
        self.h_s = nn.Sequential(
            deconv(N, N, 5, 2), nn.ReLU(), deconv(N, N, 5, 2), nn.ReLU(),
            conv(N, M, 3), nn.ReLU())

    def analyze(self, x):
        y = self.g_a(x)
        return y, self.h_a(torch.abs(y))

    def _y_hat(self, y, hyper, quant):
        y_q = quant(y)
        return y_q, y_q, hyper

    def scales_from_z(self, z_hat):
        return self.h_s(z_hat)


class MeanScaleHyperprior(_HyperBase):
    def __init__(self, N: int = 128, M: int = 192, dtype=None):
        super().__init__(N, M, dtype)
        self.h_a = nn.Sequential(
            conv(M, N, 3), nn.LeakyReLU(), conv(N, N, 5, 2), nn.LeakyReLU(),
            conv(N, N, 5, 2))
        self.h_s = nn.Sequential(
            deconv(N, M, 5, 2), nn.LeakyReLU(), deconv(M, M * 3 // 2, 5, 2),
            nn.LeakyReLU(), conv(M * 3 // 2, M * 2, 3))

    def _y_hat(self, y, hyper, quant):
        scales, means = hyper.chunk(2, dim=1)
        y_q = quant(y - means)
        return y_q, y_q + means, scales

    def params_from_z(self, z_hat):
        """(scales, means)."""
        return self.h_s(z_hat).chunk(2, dim=1)


class JointAutoregressiveHierarchicalPriors(MeanScaleHyperprior):
    def __init__(self, N: int = 192, M: int = 192, dtype=None):
        super().__init__(N, M, dtype)
        self.context_prediction = MaskedConv2d(M, 2 * M, 5)
        self.entropy_parameters = EntropyParams1x1(M * 4, M, dtype)

    def _y_hat(self, y, hyper, quant):
        # the context sees the means-unaware quantization, as the JAX
        # package's estimated-bits pass does
        ctx = self.context_prediction(quant(y))
        gp = self.entropy_parameters(torch.cat([hyper, ctx], dim=1))
        return super()._y_hat(y, gp, quant)

    def hyper_from_z(self, z_hat):
        return self.h_s(z_hat)


class ResidualBlockStrideGDN(nn.Module):
    """gen-1 ResidualBlockWithStride (DCVC/src/layers/layers.py:67-99):
    conv3x3 (stride) - LeakyReLU - conv3x3 - GDN, a strided 1x1 skip."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 2, dtype=None):
        super().__init__()
        self.conv1 = conv(in_ch, out_ch, 3, stride)
        self.conv2 = conv(out_ch, out_ch, 3)
        self.gdn = GDN(out_ch)
        self.downsample = conv(in_ch, out_ch, 1, stride)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        out = self.gdn(self.conv2(leaky_relu(self.conv1(x))))
        return out + self.downsample(x)


class ResidualBlockUpsampleGDN(nn.Module):
    """gen-1 ResidualBlockUpsample (DCVC/src/layers/layers.py:101-128):
    subpel3x3 - LeakyReLU - conv3x3 - IGDN, a subpel3x3 skip."""

    def __init__(self, in_ch: int, out_ch: int, upsample: int = 2,
                 dtype=None):
        super().__init__()
        self.subpel_conv = subpel_conv(in_ch, out_ch, upsample, 3)
        self.conv = conv(out_ch, out_ch, 3)
        self.igdn = GDN(out_ch, inverse=True)
        self.upsample = subpel_conv(in_ch, out_ch, upsample, 3)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        out = self.igdn(self.conv(leaky_relu(self.subpel_conv(x))))
        return out + self.upsample(x)


class Cheng2020Anchor(JointAutoregressiveHierarchicalPriors):
    """M = N (waseda.py:41); the gen-1 GDN residual blocks. ``dtype``
    reaches the blocks of g_a / g_s and the entropy parameters, not g_a's
    and g_s's last layers nor h_a / h_s (``intra_zoo.py:345-352``)."""

    def __init__(self, N: int = 192, dtype=None):
        # its own transforms throughout: skip the parent's constructors
        nn.Module.__init__(self)
        self.N = self.M = N
        self.entropy_bottleneck = EntropyBottleneck(N)
        self.context_prediction = MaskedConv2d(N, 2 * N, 5)
        self.entropy_parameters = EntropyParams1x1(N * 4, N, dtype)
        self.g_a = nn.Sequential(
            ResidualBlockStrideGDN(3, N, dtype=dtype),
            ResidualBlock(N, N, dtype=dtype),
            ResidualBlockStrideGDN(N, N, dtype=dtype),
            ResidualBlock(N, N, dtype=dtype),
            ResidualBlockStrideGDN(N, N, dtype=dtype),
            ResidualBlock(N, N, dtype=dtype), conv(N, N, 3, 2))
        self.h_a = nn.Sequential(
            conv(N, N, 3), nn.LeakyReLU(), conv(N, N, 3), nn.LeakyReLU(),
            conv(N, N, 3, 2), nn.LeakyReLU(), conv(N, N, 3), nn.LeakyReLU(),
            conv(N, N, 3, 2))
        self.h_s = nn.Sequential(
            conv(N, N, 3), nn.LeakyReLU(), subpel_conv(N, N, 2, 3),
            nn.LeakyReLU(), conv(N, N * 3 // 2, 3), nn.LeakyReLU(),
            subpel_conv(N * 3 // 2, N * 3 // 2, 2, 3), nn.LeakyReLU(),
            conv(N * 3 // 2, N * 2, 3))
        self.g_s = nn.Sequential(
            ResidualBlock(N, N, dtype=dtype),
            ResidualBlockUpsampleGDN(N, N, dtype=dtype),
            ResidualBlock(N, N, dtype=dtype),
            ResidualBlockUpsampleGDN(N, N, dtype=dtype),
            ResidualBlock(N, N, dtype=dtype),
            ResidualBlockUpsampleGDN(N, N, dtype=dtype),
            ResidualBlock(N, N, dtype=dtype), subpel_conv(N, 3, 2, 3))


# the registry of DCVC/src/zoo/image.py, at the JAX registry's widths
model_architectures = {
    "bmshj2018-factorized": FactorizedPrior,
    "bmshj2018-hyperprior": ScaleHyperprior,
    "mbt2018-mean": MeanScaleHyperprior,
    "mbt2018": JointAutoregressiveHierarchicalPriors,
    "cheng2020-anchor": Cheng2020Anchor,
}


def build_zoo(name: str, seed: int = 0, device=None, **kwargs) -> nn.Module:
    """Zoo model ``name`` with seeded random weights (the same for any
    ``dtype``) on ``device`` (the card unless ``device="cpu"``), in eval
    mode; ``kwargs`` (``dtype`` among them) go to its constructor."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = model_architectures[name](**kwargs)
    return module.to(dev).eval()
