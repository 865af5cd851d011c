"""DMC of the HEM generation: the hybrid spatial-temporal entropy model
P-frame codec (NCHW).

Counterpart of ``dcvc_tpu/models/video_hem.py`` (parity target:
DCVC-HEM/src/models/video_model.py:131-519): dual-part checkerboard priors
on both latents, latent temporal priors from ``ref_y`` / ``ref_mv_y``
(zero-filled when absent), a scalar continuous rate q (``LowerBound(q_basic,
0.5) * q_scale``) per latent, laplace y-latents. Child names are the
reference's (``port_hem.convert_dmc_hem``).

DPB contract: ``{ref_frame, ref_feature, ref_y, ref_mv_y}`` of NCHW
tensors; all but ``ref_frame`` may be None after an I-frame.

``HemTrunk`` holds what DMCHem and the CANF-VC hybrid (``video_canf.py``)
share (the fork's ``CANFVC_DMC`` subclasses ``DMC``): the flow, the mv
codec, the feature pyramid and context fusion, the hyper codecs, both
priors and the estimated-bits / compress / decode passes. A subclass codes
the current frame given the contexts: ``_analysis`` and ``_synthesis``.

``dtype`` (None = f32, or ``torch.bfloat16``) is the JAX modules' compute
dtype, given to every network as ``DMCHem(dtype=...)`` /
``CANFVCDmc(dtype=...)`` give it (the bit estimators and the q parameters
take none); parameters stay f32 and ``DMCHem``'s DPB dtypes are a fixed
point of the P-frame step (``tests/test_dtype_consistency.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..device import resolve_device
from ..entropy import bits
from ..entropy.bit_estimator import BitEstimator
from ..layers.blocks import LeakyReLU, ResBlock, conv, subpel_conv
from ..ops.math import lower_bound
from ..ops.warp import bilinear_down2, resolve_warp_fn
from . import priors
from .hem_common import Conv3Stack, HemDecoder, HemEncoder, HemHyperDec, HemUNet
from .video_net import (FeatureExtractor, HyperEnc, HyperEncReduced, MESpynet,
                        MultiScaleContextFusion)


class HemContextualEncoder(nn.Module):
    def __init__(self, channel_N: int = 64, channel_M: int = 96, dtype=None):
        super().__init__()
        N, M = channel_N, channel_M
        self.conv1 = conv(N + 3, N, 3, 2, dtype=dtype)
        self.res1 = ResBlock(N * 2, slope=0.1, end_with_relu=True,
                             bottleneck=True, dtype=dtype)
        self.conv2 = conv(N * 2, N, 3, 2, dtype=dtype)
        self.res2 = ResBlock(N * 2, slope=0.1, end_with_relu=True,
                             bottleneck=True, dtype=dtype)
        self.conv3 = conv(N * 2, N, 3, 2, dtype=dtype)
        self.conv4 = conv(N, M, 3, 2, dtype=dtype)

    def forward(self, x, context1, context2, context3):
        f = self.conv1(torch.cat([x, context1], dim=1))
        f = self.res1(torch.cat([f, context2], dim=1))
        f = self.res2(torch.cat([self.conv2(f), context3], dim=1))
        return self.conv4(self.conv3(f))


class HemContextualDecoder(nn.Module):
    def __init__(self, channel_N: int = 64, channel_M: int = 96, dtype=None):
        super().__init__()
        N, M = channel_N, channel_M
        self.up1 = subpel_conv(M, N, 2, 3, dtype=dtype)
        self.up2 = subpel_conv(N, N, 2, 3, dtype=dtype)
        self.res1 = ResBlock(N * 2, slope=0.1, end_with_relu=True,
                             bottleneck=True, dtype=dtype)
        self.up3 = subpel_conv(N * 2, N, 2, 3, dtype=dtype)
        self.res2 = ResBlock(N * 2, slope=0.1, end_with_relu=True,
                             bottleneck=True, dtype=dtype)
        self.up4 = subpel_conv(N * 2, 32, 2, 3, dtype=dtype)

    def forward(self, x, context2, context3):
        f = self.up2(self.up1(x))
        f = self.res1(torch.cat([f, context3], dim=1))
        f = self.res2(torch.cat([self.up3(f), context2], dim=1))
        return self.up4(f)


class HemReconGeneration(nn.Module):
    def __init__(self, channel: int = 64, dtype=None):
        super().__init__()
        self.first_conv = conv(32 + channel, channel, 3, dtype=dtype)
        self.unet_1 = HemUNet(channel, channel, dtype)
        self.unet_2 = HemUNet(channel, channel, dtype)
        self.recon_conv = conv(channel, 3, 3, dtype=dtype)

    def forward(self, ctx, res):
        """``ctx``: the contextual decoder's output; ``res``: context1."""
        feature = self.unet_2(self.unet_1(self.first_conv(
            torch.cat([ctx, res], dim=1))))
        return feature, self.recon_conv(feature)


class HemTrunk(nn.Module):
    """The DMC machinery of the HEM generation, without the contextual
    coder of the current frame (``_analysis`` / ``_synthesis``)."""

    def __init__(self, anchor_num: int, channel_mv: int, channel_N: int,
                 channel_M: int, mc_warp_mode: str | None, dtype=None):
        super().__init__()
        mv, N, M = channel_mv, channel_N, channel_M
        self.channel_mv, self.channel_N, self.channel_M = mv, N, M
        self.mc_warp_mode = mc_warp_mode
        self.optic_flow = MESpynet(dtype=dtype)
        self.mv_encoder = HemEncoder(2, mv, dtype)
        self.mv_decoder = HemDecoder(mv, 2, dtype)
        self.mv_hyper_prior_encoder = HyperEnc(mv, N, dtype)
        self.mv_hyper_prior_decoder = HemHyperDec(N, mv, dtype)
        self.mv_y_prior_fusion = Conv3Stack(mv * 3, (mv * 3, mv * 3, mv * 3),
                                            dtype)
        self.mv_y_spatial_prior = Conv3Stack(mv * 4, (mv * 3, mv * 3, mv * 2),
                                             dtype)
        self.feature_adaptor_I = conv(3, N, 3, dtype=dtype)
        self.feature_extractor = FeatureExtractor((N, N, N), dtype)
        self.context_fusion_net = MultiScaleContextFusion((N, N, N), dtype)
        self.contextual_hyper_prior_encoder = HyperEncReduced(M, N, dtype)
        self.contextual_hyper_prior_decoder = HemHyperDec(N, M, dtype)
        self.temporal_prior_encoder = nn.Sequential(
            conv(N, M * 3 // 2, 3, 2, dtype=dtype), LeakyReLU(0.1),
            conv(M * 3 // 2, M * 2, 3, 2, dtype=dtype))
        self.y_prior_fusion = Conv3Stack(M * 5, (M * 4, M * 3, M * 3), dtype)
        self.y_spatial_prior = Conv3Stack(M * 4, (M * 3, M * 3, M * 2), dtype)
        self.bit_estimator_z = BitEstimator(N)
        self.bit_estimator_z_mv = BitEstimator(N)
        self.mv_y_q_basic = nn.Parameter(torch.ones(1, mv, 1, 1))
        self.y_q_basic = nn.Parameter(torch.ones(1, M, 1, 1))
        self.mv_y_q_scale = nn.Parameter(torch.ones(anchor_num, 1, 1, 1))
        self.y_q_scale = nn.Parameter(torch.ones(anchor_num, 1, 1, 1))

    # ---- the coder of the current frame (subclasses) ----

    def _analysis(self, x, contexts):
        """``(y, state)``: the latent of ``x`` and what ``_synthesis``
        needs of the analysis for the estimated-bits terms."""
        raise NotImplementedError

    def _synthesis(self, y_hat, contexts, state=None):
        """``(x_hat in [0, 1], ref_feature or None, extra outputs)``."""
        raise NotImplementedError

    def _ref_feature(self, dpb):
        return self.feature_adaptor_I(dpb["ref_frame"])

    # ---- pieces ----

    def get_curr_mv_y_q(self, q_scale):
        return lower_bound(self.mv_y_q_basic, 0.5) * q_scale

    def get_curr_y_q(self, q_scale):
        return lower_bound(self.y_q_basic, 0.5) * q_scale

    def mv_spatial_chunks(self, params):
        return self.mv_y_spatial_prior(params).chunk(4, dim=1)

    def y_spatial_chunks(self, params):
        return self.y_spatial_prior(params).chunk(4, dim=1)

    def motion_compensation(self, dpb, mv):
        """``((context1, context2, context3), warped frame)``."""
        warp = resolve_warp_fn(self.mc_warp_mode or "exact")
        warpframe = warp(dpb["ref_frame"], mv)
        mv2 = bilinear_down2(mv) / 2
        mv3 = bilinear_down2(mv2) / 2
        f1, f2, f3 = self.feature_extractor(self._ref_feature(dpb))
        contexts = self.context_fusion_net(warp(f1, mv), warp(f2, mv2),
                                           warp(f3, mv3))
        return contexts, warpframe

    def mv_prior(self, mv_z_hat, ref_mv_y, mv_y_shape):
        p = self.mv_hyper_prior_decoder(mv_z_hat)
        if ref_mv_y is None:
            ref_mv_y = torch.zeros(mv_y_shape, dtype=p.dtype, device=p.device)
        return priors.separate_prior(
            self.mv_y_prior_fusion(torch.cat([p, ref_mv_y], dim=1)))

    def y_prior(self, z_hat, ref_y, context3, y_shape):
        hier = self.contextual_hyper_prior_decoder(z_hat)
        t = self.temporal_prior_encoder(context3)
        if ref_y is None:
            ref_y = torch.zeros(y_shape, dtype=t.dtype, device=t.device)
        return priors.separate_prior(
            self.y_prior_fusion(torch.cat([t, hier, ref_y], dim=1)))

    def _encode_mv(self, x, dpb, curr_mv_q, quant):
        """The mv latent (divided by its q), its hyper-latent, that
        quantised, and the mv prior's (q_step, scales, means)."""
        mv_y = self.mv_encoder(self.optic_flow(x, dpb["ref_frame"])) / curr_mv_q
        mv_z = self.mv_hyper_prior_encoder(mv_y)
        mv_z_hat = quant(mv_z)
        return mv_y, mv_z, mv_z_hat, self.mv_prior(mv_z_hat, dpb["ref_mv_y"],
                                                   mv_y.shape)

    # ---- full paths ----

    def forward(self, x, dpb, mv_y_q_scale, y_q_scale,
                quant_mode: str = "round", generator=None):
        """Estimated-bits P-frame (video_model.py:415-519). Under
        ``quant_mode="noise"`` the bits come from noise-added residuals
        drawn from ``generator`` (y, mv_y, z, mv_z)."""
        quant = priors.resolve_quant(quant_mode)
        curr_mv_q = self.get_curr_mv_y_q(mv_y_q_scale)
        curr_y_q = self.get_curr_y_q(y_q_scale)

        mv_y, mv_z, mv_z_hat, (mv_q_step, mv_scales, mv_means) = \
            self._encode_mv(x, dpb, curr_mv_q, quant)
        mv_y_res, mv_y_q, mv_y_hat, mv_scales_hat = priors.forward_dual_prior(
            mv_y, mv_means, mv_scales, mv_q_step, self.mv_spatial_chunks,
            quant=quant)
        mv_y_hat = mv_y_hat * curr_mv_q
        contexts, warp_frame = self.motion_compensation(
            dpb, self.mv_decoder(mv_y_hat))

        y, state = self._analysis(x, contexts)
        y = y / curr_y_q
        z = self.contextual_hyper_prior_encoder(y)
        z_hat = quant(z)
        q_step, scales, means = self.y_prior(z_hat, dpb["ref_y"], contexts[2],
                                             y.shape)
        y_res, y_q, y_hat, scales_hat = priors.forward_dual_prior(
            y, means, scales, q_step, self.y_spatial_chunks, quant=quant)
        y_hat = y_hat * curr_y_q
        x_hat, feature, extra = self._synthesis(y_hat, contexts, state)

        if quant_mode == "noise":
            # training rate surrogate: bits from noise-quantized residuals
            # while the recon path stays STE (video_model.py:466-471)
            y_q = priors.quant_noise(y_res, generator)
            mv_y_q = priors.quant_noise(mv_y_res, generator)
            z_hat = priors.quant_noise(z, generator)
            mv_z_hat = priors.quant_noise(mv_z, generator)
        pixel_num = x.shape[2] * x.shape[3]

        def bpp(b):
            return b.sum(dim=(1, 2, 3)) / pixel_num

        bpp_y = bpp(bits.y_laplace_bits(y_q, scales_hat))
        bpp_mv_y = bpp(bits.y_laplace_bits(mv_y_q, mv_scales_hat))
        bpp_z = bpp(bits.z_bits(z_hat, self.bit_estimator_z))
        bpp_mv_z = bpp(bits.z_bits(mv_z_hat, self.bit_estimator_z_mv))
        total = bpp_y + bpp_z + bpp_mv_y + bpp_mv_z
        return {
            "bpp_mv_y": bpp_mv_y, "bpp_mv_z": bpp_mv_z,
            "bpp_y": bpp_y, "bpp_z": bpp_z, "bpp": total,
            # sum over CHW / (H * W): the reference convention
            # (video_model.py:463-465), 3x the all-axis mean
            "me_mse": bpp((x - warp_frame) ** 2),
            "bit": total.sum() * pixel_num,
            **extra,
            "dpb": {"ref_frame": x_hat, "ref_feature": feature,
                    "ref_y": y_hat, "ref_mv_y": mv_y_hat},
        }

    def compress_device(self, x, dpb, mv_y_q_scale, y_q_scale):
        """Device half of compress: the z planes, the symbol and scale
        planes of both dual priors, and the encoder's DPB."""
        curr_mv_q = self.get_curr_mv_y_q(mv_y_q_scale)
        curr_y_q = self.get_curr_y_q(y_q_scale)

        mv_y, _, mv_z_hat, (mv_q_step, mv_scales, mv_means) = \
            self._encode_mv(x, dpb, curr_mv_q, torch.round)
        mv_w0, mv_w1, mv_s0, mv_s1, mv_y_hat = priors.forward_dual_prior(
            mv_y, mv_means, mv_scales, mv_q_step, self.mv_spatial_chunks,
            write=True)
        mv_y_hat = mv_y_hat * curr_mv_q
        contexts, _ = self.motion_compensation(dpb, self.mv_decoder(mv_y_hat))

        y, _ = self._analysis(x, contexts)
        y = y / curr_y_q
        z_hat = torch.round(self.contextual_hyper_prior_encoder(y))
        q_step, scales, means = self.y_prior(z_hat, dpb["ref_y"], contexts[2],
                                             y.shape)
        y_w0, y_w1, s0, s1, y_hat = priors.forward_dual_prior(
            y, means, scales, q_step, self.y_spatial_chunks, write=True)
        y_hat = y_hat * curr_y_q
        x_hat, feature, _ = self._synthesis(y_hat, contexts)
        return {
            "mv_z_hat": mv_z_hat,
            "z_hat": z_hat,
            "mv_y_q_planes": (mv_w0, mv_w1),
            "mv_scales_planes": (mv_s0, mv_s1),
            "y_q_planes": (y_w0, y_w1),
            "scales_planes": (s0, s1),
            "dpb": {"ref_frame": x_hat, "ref_feature": feature,
                    "ref_y": y_hat, "ref_mv_y": mv_y_hat},
        }

    # ---- decode-side stages (host rANS between them) ----

    def decode_mv_prior(self, mv_z_hat, ref_mv_y, y_height: int, y_width: int):
        shape = (mv_z_hat.shape[0], self.channel_mv, y_height, y_width)
        return self.mv_prior(mv_z_hat, ref_mv_y, shape)

    def decode_motion_stage(self, mv_y_hat, mv_y_q_scale, dpb, z_hat,
                            y_height: int, y_width: int):
        """``(y prior (q_step, scales, means), contexts, mv_y_hat times
        its q)``."""
        mv_y_hat = mv_y_hat * self.get_curr_mv_y_q(mv_y_q_scale)
        contexts, _ = self.motion_compensation(dpb, self.mv_decoder(mv_y_hat))
        shape = (z_hat.shape[0], self.channel_M, y_height, y_width)
        return (self.y_prior(z_hat, dpb["ref_y"], contexts[2], shape),
                contexts, mv_y_hat)

    def decode_recon_stage(self, y_hat, y_q_scale, contexts):
        """``(x_hat, ref_feature, y_hat times its q)``."""
        y_hat = y_hat * self.get_curr_y_q(y_q_scale)
        x_hat, feature, _ = self._synthesis(y_hat, contexts)
        return x_hat, feature, y_hat

    def mv_dual_scales_step1(self, q_step, scales, means, half0, half1):
        return priors.dual_decode_scales(means, scales, q_step, half0, half1,
                                         self.mv_spatial_chunks, 1)

    def y_dual_scales_step1(self, q_step, scales, means, half0, half1):
        return priors.dual_decode_scales(means, scales, q_step, half0, half1,
                                         self.y_spatial_chunks, 1)


class DMCHem(HemTrunk):
    """``mc_warp_mode`` (the frame and context warps): None is exact;
    "block:..." launches K1 on CUDA tensors (``ops/warp.resolve_warp_fn``)."""

    def __init__(self, anchor_num: int = 4, channel_mv: int = 64,
                 channel_N: int = 64, channel_M: int = 96,
                 mc_warp_mode: str | None = None, dtype=None):
        super().__init__(anchor_num, channel_mv, channel_N, channel_M,
                         mc_warp_mode, dtype)
        N, M = channel_N, channel_M
        self.feature_adaptor_P = conv(N, N, 1, dtype=dtype)
        self.contextual_encoder = HemContextualEncoder(N, M, dtype)
        self.contextual_decoder = HemContextualDecoder(N, M, dtype)
        self.recon_generation_net = HemReconGeneration(N, dtype)

    def _ref_feature(self, dpb):
        if dpb["ref_feature"] is None:
            return self.feature_adaptor_I(dpb["ref_frame"])
        return self.feature_adaptor_P(dpb["ref_feature"])

    def _analysis(self, x, contexts):
        return self.contextual_encoder(x, *contexts), None

    def _synthesis(self, y_hat, contexts, state=None):
        context1, context2, context3 = contexts
        res = self.contextual_decoder(y_hat, context2, context3)
        feature, recon = self.recon_generation_net(res, context1)
        return torch.clamp(recon, 0.0, 1.0), feature, {}


def build_dmc_hem(seed: int = 0, device=None, **kwargs) -> DMCHem:
    """DMCHem with seeded random weights (the same for any ``dtype``) on
    ``device`` (the card unless ``device="cpu"``), in eval mode; ``kwargs``
    (``dtype`` among them) go to ``DMCHem``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = DMCHem(**kwargs)
    return module.to(dev).eval()
