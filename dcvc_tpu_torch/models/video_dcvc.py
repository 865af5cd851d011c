"""DCVC_net: the gen-1 conditional-coding P-frame codec (NCHW).

Counterpart of ``dcvc_tpu/models/video_dcvc.py`` (parity target:
DCVC/src/models/DCVC_net.py:15-487): GDN transforms, mv and contextual
latents each with a hyper prior and a type-A masked-conv pixel-AR context
model, a single-scale warped context with refinement; the DPB is the bare
reference frame. Child names are the reference's
(``dcvc_tpu/utils/port_gen1.py``), so its ``state_dict`` loads once the
masks' buffers are dropped.

The estimated-bits forward runs the masked convs on the device; real
coding runs the AR loop on the host by wavefronts (``ar_coding.py``), so
the runtime calls the device halves below around it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..entropy import bits
from ..entropy.bit_estimator import BitEstimator
from ..layers.blocks import conv, deconv, subpel_conv
from ..layers.gdn import GDN
from ..ops.warp import resolve_warp_fn
from . import priors
from .ar_coding import ArNets, masked_conv_mask_a
from .video_net import MESpynet


class Gen1ResBlock(nn.Module):
    """Pre-activation ReLU residual block (DCVC/src/models/video_net.py:
    159-187), in = out channels."""

    def __init__(self, channel: int, kernel: int = 3):
        super().__init__()
        self.conv1 = conv(channel, channel, kernel)
        self.conv2 = conv(channel, channel, kernel)

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(torch.relu(x))))


class ResBlockLeaky01(nn.Module):
    """ResBlock_LeakyReLU_0_Point_1: keys ``conv.0`` / ``conv.2``."""

    def __init__(self, channel: int):
        super().__init__()
        self.conv = nn.Sequential(conv(channel, channel, 3), nn.LeakyReLU(0.1),
                                  conv(channel, channel, 3), nn.LeakyReLU(0.1))

    def forward(self, x):
        return x + self.conv(x)


class MaskedConv2d(nn.Conv2d):
    """Type-A causal conv (the AR context model). The mask multiplies the
    weight at each call; it is not part of the ``state_dict``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 5):
        super().__init__(in_ch, out_ch, kernel, padding=kernel // 2)
        mask = torch.from_numpy(masked_conv_mask_a(kernel))
        self.register_buffer("mask", mask[None, None], persistent=False)

    def forward(self, x):
        return F.conv2d(x, self.weight * self.mask, self.bias,
                        padding=self.padding)


def EntropyParams1x1(in_ch: int, channel: int) -> nn.Sequential:
    """Three 1x1 convs with LeakyReLU between (DCVC_net.py:147-169):
    in -> 10M/3 -> 8M/3 -> 2M."""
    M = channel
    return nn.Sequential(conv(in_ch, M * 10 // 3, 1), nn.LeakyReLU(),
                         conv(M * 10 // 3, M * 8 // 3, 1), nn.LeakyReLU(),
                         conv(M * 8 // 3, M * 2, 1))


def _gdn_stack(convs, gdns):
    """conv, GDN, conv, GDN, ..., conv."""
    layers = []
    for i, c in enumerate(convs):
        layers.append(c)
        if i < len(gdns):
            layers.append(gdns[i])
    return nn.Sequential(*layers)


class DCVCNet(nn.Module):
    """``mc_warp_mode`` (the context warp): None is exact; "block:..."
    launches K1 on CUDA tensors (``ops/warp.resolve_warp_fn``)."""

    def __init__(self, channel_mv: int = 128, channel_N: int = 64,
                 channel_M: int = 96, mc_warp_mode: str | None = None):
        super().__init__()
        mv, N, M = channel_mv, channel_N, channel_M
        self.channel_mv, self.channel_N, self.channel_M = mv, N, M
        self.mc_warp_mode = mc_warp_mode
        self.opticFlow = MESpynet()
        self.bitEstimator_z = BitEstimator(N)
        self.bitEstimator_z_mv = BitEstimator(N)

        self.feature_extract = nn.Sequential(conv(3, N, 3), Gen1ResBlock(N))
        self.context_refine = nn.Sequential(Gen1ResBlock(N), conv(N, N, 3))

        self.mvEncoder = _gdn_stack(
            [conv(2, mv, 3, 2)] + [conv(mv, mv, 3, 2) for _ in range(3)],
            [GDN(mv) for _ in range(3)])
        self.mvDecoder_part1 = _gdn_stack(
            [deconv(mv, mv, 3, 2) for _ in range(3)] + [deconv(mv, 2, 3, 2)],
            [GDN(mv, inverse=True) for _ in range(3)])
        refine = [conv(5, 64, 3)]
        for _ in range(5):
            refine += [nn.LeakyReLU(0.1), conv(64, 64, 3)]
        self.mvDecoder_part2 = nn.Sequential(*refine, nn.LeakyReLU(0.1),
                                             conv(64, 2, 3))

        self.contextualEncoder = nn.Sequential(
            conv(N + 3, N, 5, 2), GDN(N), ResBlockLeaky01(N),
            conv(N, N, 5, 2), GDN(N), ResBlockLeaky01(N),
            conv(N, N, 5, 2), GDN(N), conv(N, M, 5, 2))
        self.contextualDecoder_part1 = nn.Sequential(
            subpel_conv(M, N, 2, 3), GDN(N, inverse=True),
            subpel_conv(N, N, 2, 3), GDN(N, inverse=True), ResBlockLeaky01(N),
            subpel_conv(N, N, 2, 3), GDN(N, inverse=True), ResBlockLeaky01(N),
            subpel_conv(N, N, 2, 3))
        self.contextualDecoder_part2 = nn.Sequential(
            conv(N * 2, N, 3), Gen1ResBlock(N), Gen1ResBlock(N), conv(N, 3, 3))

        self.priorEncoder = nn.Sequential(
            conv(M, N, 3), nn.LeakyReLU(), conv(N, N, 5, 2), nn.LeakyReLU(),
            conv(N, N, 5, 2))
        self.priorDecoder = nn.Sequential(
            deconv(N, M, 5, 2), nn.LeakyReLU(), deconv(M, M, 5, 2),
            nn.LeakyReLU(), deconv(M, M, 3, 1))
        self.mvpriorEncoder = nn.Sequential(
            conv(mv, N, 3), nn.LeakyReLU(), conv(N, N, 5, 2), nn.LeakyReLU(),
            conv(N, N, 5, 2))
        self.mvpriorDecoder = nn.Sequential(
            deconv(N, N, 5, 2), nn.LeakyReLU(), deconv(N, N * 3 // 2, 5, 2),
            nn.LeakyReLU(), deconv(N * 3 // 2, mv * 2, 3, 1))
        self.temporalPriorEncoder = _gdn_stack(
            [conv(N, N, 5, 2) for _ in range(3)] + [conv(N, M, 5, 2)],
            [GDN(N) for _ in range(3)])

        self.auto_regressive = MaskedConv2d(M, 2 * M, 5)
        self.auto_regressive_mv = MaskedConv2d(mv, 2 * mv, 5)
        self.entropy_parameters = EntropyParams1x1(M * 4, M)
        self.entropy_parameters_mv = EntropyParams1x1(mv * 4, mv)

    # ---- sub-nets ----

    def mv_refine(self, ref, mv):
        return self.mvDecoder_part2(torch.cat([mv, ref], dim=1)) + mv

    def motion_compensation(self, ref, mv):
        warp = resolve_warp_fn(self.mc_warp_mode or "exact")
        return self.context_refine(warp(self.feature_extract(ref), mv))

    def contextual_decoder(self, y_hat, context):
        feat = self.contextualDecoder_part1(y_hat)
        return self.contextualDecoder_part2(torch.cat([feat, context], dim=1))

    # ---- the estimated-bits forward ----

    def forward(self, referframe, input_image, quant_mode: str = "round",
                generator=None):
        """Estimated bits. Under ``quant_mode="noise"`` they come from
        noise-added residuals drawn from ``generator`` (y, mv, z, mv_z)."""
        quant = priors.resolve_quant(quant_mode)
        mv_feature = self.mvEncoder(self.opticFlow(input_image, referframe))
        mv_z = self.mvpriorEncoder(mv_feature)
        mv_z_hat = quant(mv_z)
        params_mv = self.mvpriorDecoder(mv_z_hat)
        quant_mv = quant(mv_feature)
        gp_mv = self.entropy_parameters_mv(
            torch.cat([params_mv, self.auto_regressive_mv(quant_mv)], dim=1))
        means_mv, scales_mv = gp_mv.chunk(2, dim=1)

        mv_refined = self.mv_refine(referframe,
                                    self.mvDecoder_part1(quant_mv))
        context = self.motion_compensation(referframe, mv_refined)
        temporal_prior = self.temporalPriorEncoder(context)

        y = self.contextualEncoder(torch.cat([input_image, context], dim=1))
        z = self.priorEncoder(y)
        z_hat = quant(z)
        params = self.priorDecoder(z_hat)
        y_hat = quant(y)
        gp = self.entropy_parameters(torch.cat(
            [temporal_prior, params, self.auto_regressive(y_hat)], dim=1))
        means, scales = gp.chunk(2, dim=1)
        recon = self.contextual_decoder(y_hat, context)

        if quant_mode == "noise":
            # training rate surrogate: bits from noise-quantized residuals
            # while the recon path stays STE (HEM video_model.py:466-471)
            y_for_bit = priors.quant_noise(y - means, generator)
            mv_for_bit = priors.quant_noise(mv_feature - means_mv, generator)
            z_hat = priors.quant_noise(z, generator)
            mv_z_hat = priors.quant_noise(mv_z, generator)
        else:
            y_for_bit, mv_for_bit = y_hat - means, quant_mv - means_mv
        pixel_num = input_image.shape[0] * input_image.shape[2] * \
            input_image.shape[3]
        bpp_y = bits.y_laplace_bits(y_for_bit, scales).sum() / pixel_num
        bpp_mv_y = bits.y_laplace_bits(mv_for_bit, scales_mv).sum() / pixel_num
        bpp_z = bits.z_bits(z_hat, self.bitEstimator_z).sum() / pixel_num
        bpp_mv_z = bits.z_bits(mv_z_hat, self.bitEstimator_z_mv).sum() / \
            pixel_num
        bpp = bpp_y + bpp_z + bpp_mv_y + bpp_mv_z
        return {"bpp_mv_y": bpp_mv_y, "bpp_mv_z": bpp_mv_z, "bpp_y": bpp_y,
                "bpp_z": bpp_z, "bpp": bpp,
                "recon_image": torch.clamp(recon, 0.0, 1.0),
                "context": context, "bit": bpp * pixel_num}

    # ---- device halves for real coding (the AR loops run on the host) ----

    def encode_analysis(self, referframe, input_image):
        """Everything before the mv AR loop: (mv latent, its z_hat, the mv
        hyper parameters)."""
        mv_feature = self.mvEncoder(self.opticFlow(input_image, referframe))
        mv_z_hat = torch.round(self.mvpriorEncoder(mv_feature))
        return mv_feature, mv_z_hat, self.mvpriorDecoder(mv_z_hat)

    def motion_and_context(self, referframe, mv_y_hat):
        """(context, temporal prior) from the decoded mv latent."""
        mv_refined = self.mv_refine(referframe,
                                    self.mvDecoder_part1(mv_y_hat))
        context = self.motion_compensation(referframe, mv_refined)
        return context, self.temporalPriorEncoder(context)

    def residual_analysis(self, input_image, context):
        """(y, z_hat, the y hyper parameters)."""
        y = self.contextualEncoder(torch.cat([input_image, context], dim=1))
        z_hat = torch.round(self.priorEncoder(y))
        return y, z_hat, self.priorDecoder(z_hat)

    def mv_prior_decoder(self, z_hat):
        return self.mvpriorDecoder(z_hat)

    def prior_decoder(self, z_hat):
        return self.priorDecoder(z_hat)

    def synthesis(self, y_hat, context):
        return torch.clamp(self.contextual_decoder(y_hat, context), 0.0, 1.0)


def extract_ar_nets(module: DCVCNet, which: str) -> ArNets:
    """The host AR loop's weights (``"mv"`` or ``"y"``), from the port
    module's parameters."""
    if which == "mv":
        return ArNets.from_modules(module.auto_regressive_mv,
                                   module.entropy_parameters_mv)
    return ArNets.from_modules(module.auto_regressive,
                               module.entropy_parameters)


def build_dcvc_gen1(seed: int = 0, device=None, **kwargs) -> DCVCNet:
    """DCVCNet with seeded random weights on ``device`` (the card unless
    ``device="cpu"``), in eval mode; ``kwargs`` go to ``DCVCNet``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = DCVCNet(**kwargs)
    return module.to(dev).eval()
