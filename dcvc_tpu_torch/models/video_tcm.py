"""DMC of the TCM generation: temporal context mining, no spatial prior
(NCHW).

Counterpart of ``dcvc_tpu/models/video_tcm.py`` (parity target:
DCVC-TCM/src/models/video_net_dmc.py:165-509): GDN conditional transforms,
a temporal prior encoder over the three context scales, one-shot latent
coding (scales / means from the entropy-parameter net), the DPB
(ref_frame, ref_feature), per-rate checkpoints (no q). Child names are
the reference's (``dcvc_tpu/utils/port_tcm.py``). The feature pyramid and
context fusion are DC's (``video_net.FeatureExtractor`` /
``MultiScaleContextFusion`` at one width: same layers, same keys).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..device import resolve_device
from ..entropy import bits
from ..entropy.bit_estimator import BitEstimator
from ..layers.blocks import ResBlock, conv, deconv, subpel_conv
from ..layers.gdn import GDN
from ..ops.warp import bilinear_down2, resolve_warp_fn
from . import priors
from .video_net import FeatureExtractor, MESpynet, MultiScaleContextFusion


def _res_bottleneck(channel: int) -> ResBlock:
    """The contextual coders' ResBlock: bottleneck, slope 0.1, no ReLU
    before, one after."""
    return ResBlock(channel, slope=0.1, start_from_relu=False,
                    end_with_relu=True, bottleneck=True)


class TcmMvEncoder(nn.Sequential):
    """(conv-s2, GDN, ResBlock, LeakyReLU(0.1)) x 3, conv-s2."""

    def __init__(self, channel_mv: int = 128):
        ch = channel_mv
        layers = []
        for i in range(3):
            layers += [conv(2 if i == 0 else ch, ch, 3, 2), GDN(ch),
                       ResBlock(ch), nn.LeakyReLU(0.1)]
        super().__init__(*layers, conv(ch, ch, 3, 2))


class TcmMvDecoder(nn.Sequential):
    def __init__(self, channel_mv: int = 128):
        ch = channel_mv
        super().__init__(
            deconv(ch, ch, 3, 2), nn.LeakyReLU(0.1), ResBlock(ch),
            GDN(ch, inverse=True), deconv(ch, ch, 3, 2), GDN(ch, inverse=True),
            deconv(ch, ch, 3, 2), GDN(ch, inverse=True), deconv(ch, 2, 3, 2))


class TcmContextualEncoder(nn.Module):
    def __init__(self, channel_N: int = 64, channel_M: int = 96):
        super().__init__()
        N, M = channel_N, channel_M
        self.conv1 = conv(N + 3, N, 3, 2)
        self.gdn1 = GDN(N)
        self.res1 = _res_bottleneck(N * 2)
        self.conv2 = conv(N * 2, N, 3, 2)
        self.gdn2 = GDN(N)
        self.res2 = _res_bottleneck(N * 2)
        self.conv3 = conv(N * 2, N, 3, 2)
        self.gdn3 = GDN(N)
        self.conv4 = conv(N, M, 3, 2)

    def forward(self, x, context1, context2, context3):
        f = self.gdn1(self.conv1(torch.cat([x, context1], dim=1)))
        f = self.res1(torch.cat([f, context2], dim=1))
        f = self.gdn2(self.conv2(f))
        f = self.res2(torch.cat([f, context3], dim=1))
        f = self.gdn3(self.conv3(f))
        return self.conv4(f)


class TcmContextualDecoder(nn.Module):
    def __init__(self, channel_N: int = 64, channel_M: int = 96):
        super().__init__()
        N, M = channel_N, channel_M
        self.up1 = subpel_conv(M, N, 2, 3)
        self.gdn1 = GDN(N, inverse=True)
        self.up2 = subpel_conv(N, N, 2, 3)
        self.gdn2 = GDN(N, inverse=True)
        self.res1 = _res_bottleneck(N * 2)
        self.up3 = subpel_conv(N * 2, N, 2, 3)
        self.gdn3 = GDN(N, inverse=True)
        self.res2 = _res_bottleneck(N * 2)
        self.up4 = subpel_conv(N * 2, 32, 2, 3)

    def forward(self, y_hat, context2, context3):
        f = self.gdn2(self.up2(self.gdn1(self.up1(y_hat))))
        f = self.res1(torch.cat([f, context3], dim=1))
        f = self.gdn3(self.up3(f))
        f = self.res2(torch.cat([f, context2], dim=1))
        return self.up4(f)


class TcmTemporalPriorEncoder(nn.Module):
    def __init__(self, channel_N: int = 64, channel_M: int = 96):
        super().__init__()
        N, M = channel_N, channel_M
        self.conv1 = conv(N, N, 3, 2)
        self.gdn1 = GDN(N)
        self.conv2 = conv(N * 2, M, 3, 2)
        self.gdn2 = GDN(M)
        self.conv3 = conv(M + N, M * 3 // 2, 3, 2)
        self.gdn3 = GDN(M * 3 // 2)
        self.conv4 = conv(M * 3 // 2, M * 2, 3, 2)

    def forward(self, context1, context2, context3):
        f = self.gdn1(self.conv1(context1))
        f = self.gdn2(self.conv2(torch.cat([f, context2], dim=1)))
        f = self.gdn3(self.conv3(torch.cat([f, context3], dim=1)))
        return self.conv4(f)


class TcmReconGeneration(nn.Module):
    """``feature_conv``: conv + 2 ResBlocks (keys ``.0`` ``.1`` ``.2``)."""

    def __init__(self, channel: int = 64):
        super().__init__()
        self.feature_conv = nn.Sequential(conv(32 + channel, channel, 3),
                                          ResBlock(channel), ResBlock(channel))
        self.recon_conv = conv(channel, 3, 3)

    def forward(self, ctx, res):
        """``ctx``: the contextual decoder's output; ``res``: context1."""
        feature = self.feature_conv(torch.cat([ctx, res], dim=1))
        return feature, self.recon_conv(feature)


def _hyper_enc(in_ch: int, N: int) -> nn.Sequential:
    return nn.Sequential(conv(in_ch, N, 3), nn.LeakyReLU(), conv(N, N, 3, 2),
                         nn.LeakyReLU(), conv(N, N, 3, 2))


def _hyper_dec(N: int, mid: int, out: int) -> nn.Sequential:
    """z -> 2 * out prior features through transposed convs."""
    return nn.Sequential(
        deconv(N, mid, 3, 2), nn.LeakyReLU(), deconv(mid, mid * 3 // 2, 3, 2),
        nn.LeakyReLU(), deconv(mid * 3 // 2, out * 2, 3, 1))


def _entropy_parameter(M: int) -> nn.Sequential:
    return nn.Sequential(
        conv(M * 4, M * 10 // 3, 3), nn.LeakyReLU(),
        conv(M * 10 // 3, M * 8 // 3, 3), nn.LeakyReLU(),
        conv(M * 8 // 3, M * 2, 3))


class DMCTcm(nn.Module):
    """``mc_warp_mode`` (the frame and context warps): None is exact;
    "block:..." launches K1 on CUDA tensors (``ops/warp.resolve_warp_fn``)."""

    def __init__(self, channel_mv: int = 128, channel_N: int = 64,
                 channel_M: int = 96, mc_warp_mode: str | None = None):
        super().__init__()
        mv, N, M = channel_mv, channel_N, channel_M
        self.channel_mv, self.channel_N, self.channel_M = mv, N, M
        self.mc_warp_mode = mc_warp_mode
        self.optic_flow = MESpynet()
        self.mv_encoder = TcmMvEncoder(mv)
        self.mv_prior_encoder = _hyper_enc(mv, N)
        self.mv_prior_decoder = _hyper_dec(N, mv, mv)
        self.mv_decoder = TcmMvDecoder(mv)

        self.feature_adaptor_I = conv(3, N, 3)
        self.feature_adaptor_P = conv(N, N, 1)
        self.feature_extractor = FeatureExtractor((N, N, N))
        self.context_fusion_net = MultiScaleContextFusion((N, N, N))

        self.contextual_encoder = TcmContextualEncoder(N, M)
        self.contextual_hyper_prior_encoder = _hyper_enc(M, N)
        self.contextual_hyper_prior_decoder = _hyper_dec(N, M, M)
        self.temporal_prior_encoder = TcmTemporalPriorEncoder(N, M)
        self.contextual_entropy_parameter = _entropy_parameter(M)
        self.contextual_decoder = TcmContextualDecoder(N, M)
        self.recon_generation_net = TcmReconGeneration(N)

        self.bit_estimator_z = BitEstimator(N)
        self.bit_estimator_z_mv = BitEstimator(N)

    def motion_compensation(self, ref_frame, ref_feature, mv):
        """(context1, context2, context3, the warped frame)."""
        warp = resolve_warp_fn(self.mc_warp_mode or "exact")
        warpframe = warp(ref_frame, mv)
        mv2 = bilinear_down2(mv) / 2
        mv3 = bilinear_down2(mv2) / 2
        feature = (self.feature_adaptor_I(ref_frame) if ref_feature is None
                   else self.feature_adaptor_P(ref_feature))
        f1, f2, f3 = self.feature_extractor(feature)
        contexts = self.context_fusion_net(warp(f1, mv), warp(f2, mv2),
                                           warp(f3, mv3))
        return (*contexts, warpframe)

    def y_gaussian_params(self, z_hat, c1, c2, c3):
        """(scales, means) of y."""
        hier = self.contextual_hyper_prior_decoder(z_hat)
        temporal = self.temporal_prior_encoder(c1, c2, c3)
        gp = self.contextual_entropy_parameter(torch.cat([temporal, hier], 1))
        return gp.chunk(2, dim=1)

    def _code(self, x, ref_frame, ref_feature, quant):
        """The encoder's pass: latents, their quantization and the recon."""
        mv_y = self.mv_encoder(self.optic_flow(x, ref_frame))
        mv_z = self.mv_prior_encoder(mv_y)
        mv_z_hat = quant(mv_z)
        mv_scales, mv_means = self.decode_mv_params(mv_z_hat)
        mv_y_q = quant(mv_y - mv_means)
        mv_hat = self.mv_decoder(mv_y_q + mv_means)
        c1, c2, c3, warp_frame = self.motion_compensation(ref_frame,
                                                          ref_feature, mv_hat)
        y = self.contextual_encoder(x, c1, c2, c3)
        z = self.contextual_hyper_prior_encoder(y)
        z_hat = quant(z)
        scales, means = self.y_gaussian_params(z_hat, c1, c2, c3)
        y_q = quant(y - means)
        res = self.contextual_decoder(y_q + means, c2, c3)
        feature, recon = self.recon_generation_net(res, c1)
        return {"mv_z_hat": mv_z_hat, "z_hat": z_hat, "mv_y_q": mv_y_q,
                "mv_scales": mv_scales, "y_q": y_q, "scales": scales,
                "x_hat": torch.clamp(recon, 0.0, 1.0), "feature": feature,
                "warp_frame": warp_frame,
                "noise_inputs": (y - means, mv_y - mv_means, z, mv_z)}

    def forward(self, x, ref_frame, ref_feature, quant_mode: str = "round",
                generator=None):
        """Estimated-bits P-frame (video_net_dmc.py:417-509). Under
        ``quant_mode="noise"`` the bits come from noise-added residuals
        drawn from ``generator`` (y, mv_y, z, mv_z)."""
        out = self._code(x, ref_frame, ref_feature,
                         priors.resolve_quant(quant_mode))
        if quant_mode == "noise":
            # training rate surrogate: bits from noise-quantized residuals
            # while the recon path stays STE (HEM video_model.py:466-471)
            out["y_q"], out["mv_y_q"], out["z_hat"], out["mv_z_hat"] = (
                priors.quant_noise(t, generator) for t in out["noise_inputs"])
        pixel_num = x.shape[0] * x.shape[2] * x.shape[3]
        bpp_y = bits.y_laplace_bits(out["y_q"], out["scales"]).sum() / pixel_num
        bpp_mv_y = bits.y_laplace_bits(out["mv_y_q"],
                                       out["mv_scales"]).sum() / pixel_num
        bpp_z = bits.z_bits(out["z_hat"], self.bit_estimator_z).sum() / pixel_num
        bpp_mv_z = bits.z_bits(out["mv_z_hat"],
                               self.bit_estimator_z_mv).sum() / pixel_num
        bpp = bpp_y + bpp_z + bpp_mv_y + bpp_mv_z
        recon = out["x_hat"]
        return {"bpp_mv_y": bpp_mv_y, "bpp_mv_z": bpp_mv_z, "bpp_y": bpp_y,
                "bpp_z": bpp_z, "bpp": bpp,
                # sum over CHW / (H * W): the reference convention
                "me_mse": ((x - out["warp_frame"]) ** 2).sum() / pixel_num,
                "mse_loss": ((x - recon) ** 2).sum() / pixel_num,
                "recon_image": recon, "feature": out["feature"],
                "bit": bpp * pixel_num}

    def compress_device(self, x, ref_frame, ref_feature):
        """Device half of compress: the z planes, the symbol and scale
        planes of mv_y and y, the encoder's recon and feature."""
        out = self._code(x, ref_frame, ref_feature, torch.round)
        del out["warp_frame"], out["noise_inputs"]
        return out

    # ---- decode-side stages (host rANS between them) ----

    def decode_mv_params(self, mv_z_hat):
        """(mv scales, mv means)."""
        return self.mv_prior_decoder(mv_z_hat).chunk(2, dim=1)

    def decode_motion_stage(self, mv_y_hat, ref_frame, ref_feature, z_hat):
        """(y scales, y means, the contexts)."""
        c1, c2, c3, _ = self.motion_compensation(
            ref_frame, ref_feature, self.mv_decoder(mv_y_hat))
        scales, means = self.y_gaussian_params(z_hat, c1, c2, c3)
        return scales, means, (c1, c2, c3)

    def decode_recon_stage(self, y_hat, contexts):
        """(x_hat, feature)."""
        c1, c2, c3 = contexts
        feature, recon = self.recon_generation_net(
            self.contextual_decoder(y_hat, c2, c3), c1)
        return torch.clamp(recon, 0.0, 1.0), feature


def build_dmc_tcm(seed: int = 0, device=None, **kwargs) -> DMCTcm:
    """DMCTcm with seeded random weights on ``device`` (the card unless
    ``device="cpu"``), in eval mode; ``kwargs`` go to ``DMCTcm``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = DMCTcm(**kwargs)
    return module.to(dev).eval()
