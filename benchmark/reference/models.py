"""Plain DCVC-DC (IntraNoAR + DMC) and EVC (EVCIntra) networks, float32.

Frozen copies of the published models' arithmetic
(DCVC-DC/src/models/image_model.py:16-252, video_model.py:26-628,
video_net.py; EVC/src/models/image_model.py:16-258), encoder side: what a
frame codes to and the reconstruction a correct decoder derives from it.
The OffsetDiversity warp of DMC takes ``warp.block_warp`` or
``warp.flow_warp`` as the configuration says. Child names follow the
published checkpoints.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from . import priors
from .layers import (BitEstimator, DepthConvBlock, DepthConvBlock2,
                     DepthConvBlockUpsample, EvcDepthConvBlock, ResBlock,
                     ResidualBlockUpsample, ResidualBlockWithStride, UNet,
                     avg_pool2, conv, subpel_conv)
from .warp import crop, down2, flow_warp, pad_to, up2, warp_fn


def fine_q(anchors, index: int) -> float:
    """Entry ``index`` of the 64-point log-interpolated q table
    (image_model.py:158-167), as float32."""
    a = anchors.detach().float().cpu().numpy().reshape(-1)
    return float(np.float32(np.exp(np.linspace(np.log(a[0]), np.log(a[-1]),
                                               64))[index]))


# ---------------------------------------------------------------- IntraNoAR

class IntraNoAR(nn.Module):
    STREAM = ("z", "y0", "y1", "y2", "y3")     # the planes in stream order

    def __init__(self, N=256, anchor_num=4, ch_a=128, ch_b=192):
        super().__init__()
        self.N = N
        self.enc = nn.Module()
        self.enc.enc_1 = nn.Sequential(ResidualBlockWithStride(3, ch_a, 2),
                                       DepthConvBlock2(ch_a, ch_a))
        self.enc.enc_2 = nn.Sequential(
            ResidualBlockWithStride(ch_a, ch_b, 2), DepthConvBlock2(ch_b, ch_b),
            ResidualBlockWithStride(ch_b, N, 2), DepthConvBlock2(N, N),
            conv(N, N, 3, 2))
        self.hyper_enc = nn.Sequential(
            DepthConvBlock2(N, N), conv(N, N, 3, 2), nn.LeakyReLU(),
            conv(N, N, 3, 2))
        self.hyper_dec = nn.Sequential(
            ResidualBlockUpsample(N, N, 2), ResidualBlockUpsample(N, N, 2),
            DepthConvBlock2(N, N))
        self.y_prior_fusion = nn.Sequential(DepthConvBlock2(N, N * 2),
                                            DepthConvBlock2(N * 2, N * 3))
        for i in (1, 2, 3):
            setattr(self, f"y_spatial_prior_adaptor_{i}", conv(N * 4, N * 3, 1))
        self.y_spatial_prior = nn.Sequential(
            DepthConvBlock2(N * 3, N * 3), DepthConvBlock2(N * 3, N * 2),
            DepthConvBlock2(N * 2, N * 2))
        self.dec = nn.Module()
        self.dec.dec_1 = nn.Sequential(
            DepthConvBlock2(N, N), ResidualBlockUpsample(N, N, 2),
            DepthConvBlock2(N, N), ResidualBlockUpsample(N, ch_b, 2),
            DepthConvBlock2(ch_b, ch_b), ResidualBlockUpsample(ch_b, ch_a, 2))
        self.dec.dec_2 = nn.Sequential(DepthConvBlock2(ch_a, ch_a),
                                       ResidualBlockUpsample(ch_a, 16, 2))
        self.refine = nn.Sequential(UNet(16, 16, block2=True), conv(16, 3, 3))
        self.bit_estimator_z = BitEstimator(N)
        self.q_basic_enc = nn.Parameter(torch.ones(1, ch_a, 1, 1))
        self.q_scale_enc = nn.Parameter(torch.ones(anchor_num, 1, 1, 1))
        self.q_basic_dec = nn.Parameter(torch.ones(1, ch_a, 1, 1))
        self.q_scale_dec = nn.Parameter(torch.ones(anchor_num, 1, 1, 1))

    def _spatial_fns(self):
        return [lambda p, a=getattr(self, f"y_spatial_prior_adaptor_{i}"):
                self.y_spatial_prior(a(p)).chunk(8, 1) for i in (1, 2, 3)]

    @torch.no_grad()
    def code(self, x, q_index: int, sym=None):
        """The reconstruction of I-frame ``x`` [1, 3, H, W] at fine q
        ``q_index``, clamped to [0, 1]; ``sym`` (``symbols.Symbols``, the
        planes of ``STREAM``) gives or takes the symbols."""
        dev = x.device
        qe = torch.tensor(fine_q(self.q_scale_enc, q_index), device=dev)
        qd = torch.tensor(fine_q(self.q_scale_dec, q_index), device=dev)
        y = self.enc.enc_2(self.enc.enc_1(x) * (self.q_basic_enc * qe))
        y_pad, pads = pad_to(y, 4)
        z = self.hyper_enc(y_pad)
        z_hat = torch.round(z) if sym is None else sym.round("z", z)
        params = crop(self.y_prior_fusion(self.hyper_dec(z_hat)), pads)
        y_hat = priors.four_part(y, params, self._spatial_fns(),
                                 sym=sym)[2]
        f = self.dec.dec_2(self.dec.dec_1(y_hat) * (self.q_basic_dec * qd))
        return torch.clamp(self.refine(f), 0.0, 1.0)


# ---------------------------------------------------------------------- DMC

G_CH = {"1x": 48, "2x": 64, "4x": 96, "8x": 96, "16x": 128}
CH_MV = 64


class MEBasic(nn.Module):
    def __init__(self):
        super().__init__()
        for i, (a, b) in enumerate(((8, 32), (32, 64), (64, 32), (32, 16),
                                    (16, 2)), 1):
            setattr(self, f"conv{i}", conv(a, b, 7))

    def forward(self, x):
        for i in range(1, 5):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        return self.conv5(x)


class MESpynet(nn.Module):
    def __init__(self, levels=4):
        super().__init__()
        self.levels = levels
        self.moduleBasic = nn.ModuleList([MEBasic() for _ in range(levels)])

    def forward(self, im1, im2):
        im1_list, im2_list = [im1], [im2]
        for _ in range(self.levels - 1):
            im1_list.append(avg_pool2(im1_list[-1]))
            im2_list.append(avg_pool2(im2_list[-1]))
        B, _, Hc, Wc = im2_list[-1].shape
        flow = torch.zeros(B, 2, Hc // 2, Wc // 2, dtype=im1.dtype,
                           device=im1.device)
        for level in range(self.levels):
            flow_up = up2(flow) * 2.0
            idx = self.levels - 1 - level
            inp = torch.cat([im1_list[idx], flow_warp(im2_list[idx], flow_up),
                             flow_up], dim=1)
            flow = flow_up + self.moduleBasic[level](inp)
        return flow


class OffsetDiversity(nn.Module):
    """G groups x O offsets with masks; map ``k = o*G + g`` warps feature
    group ``g`` (video_model.py:26-63)."""

    def __init__(self, in_channel=48, aux_feature_num=48 + 3 + 2,
                 offset_num=2, group_num=16, max_residue_magnitude=40.0):
        super().__init__()
        self.offset_num = offset_num
        self.group_num = group_num
        self.max_residue_magnitude = max_residue_magnitude
        self.warp = flow_warp
        self.conv_offset = nn.Sequential(
            nn.Conv2d(aux_feature_num, 64, 3, 2, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(64, 64, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(64, 3 * group_num * offset_num, 3, 1, 1))
        self.fusion = nn.Conv2d(in_channel * offset_num, in_channel, 1, 1,
                                groups=group_num)

    def forward(self, x, aux_feature, flow):
        B, C, H, W = x.shape
        G, O = self.group_num, self.offset_num
        out = up2(self.conv_offset(aux_feature))
        o1, o2, mask = out.chunk(3, dim=1)
        mask = torch.sigmoid(mask)
        offset = self.max_residue_magnitude * torch.tanh(torch.cat([o1, o2], 1))
        offset = offset + flow.repeat(1, G * O, 1, 1)
        off = offset.reshape(B * G * O, 2, H, W)
        xg = x.reshape(B, 1, G, C // G, H, W).expand(B, O, G, C // G, H, W)
        xg = xg.reshape(B * O * G, C // G, H, W)
        m = mask.reshape(B * G * O, 1, H, W)
        warped = (self.warp(xg, off) * m).reshape(B, G * O * (C // G), H, W)
        return self.fusion(warped)


class FeatureExtractor(nn.Module):
    def __init__(self, ch=(48, 64, 96)):
        super().__init__()
        c1, c2, c3 = ch
        self.conv1 = conv(c1, c1, 3)
        self.res_block1 = ResBlock(c1)
        self.conv2 = conv(c1, c2, 3, 2)
        self.res_block2 = ResBlock(c2)
        self.conv3 = conv(c2, c3, 3, 2)
        self.res_block3 = ResBlock(c3)

    def forward(self, feature):
        layer1 = self.res_block1(self.conv1(feature))
        layer2 = self.res_block2(self.conv2(layer1))
        return layer1, layer2, self.res_block3(self.conv3(layer2))


class MultiScaleContextFusion(nn.Module):
    def __init__(self, ch=(48, 64, 96)):
        super().__init__()
        c1, c2, c3 = ch
        self.conv3_up = subpel_conv(c3, c2, 2, 3)
        self.res_block3_up = ResBlock(c2)
        self.conv3_out = conv(c3, c3, 3)
        self.res_block3_out = ResBlock(c3)
        self.conv2_up = subpel_conv(c2 * 2, c1, 2, 3)
        self.res_block2_up = ResBlock(c1)
        self.conv2_out = conv(c2 * 2, c2, 3)
        self.res_block2_out = ResBlock(c2)
        self.conv1_out = conv(c1 * 2, c1, 3)
        self.res_block1_out = ResBlock(c1)

    def forward(self, context1, context2, context3):
        c3_up = self.res_block3_up(self.conv3_up(context3))
        c3_out = self.res_block3_out(self.conv3_out(context3))
        cat32 = torch.cat([c3_up, context2], dim=1)
        c2_up = self.res_block2_up(self.conv2_up(cat32))
        c2_out = self.res_block2_out(self.conv2_out(cat32))
        cat21 = torch.cat([c2_up, context1], dim=1)
        c1_out = self.res_block1_out(self.conv1_out(cat21))
        return context1 + c1_out, context2 + c2_out, context3 + c3_out


def hyper_enc(y_ch, z_ch):
    return nn.Sequential(
        conv(y_ch, z_ch, 3), nn.LeakyReLU(), conv(z_ch, z_ch, 3),
        nn.LeakyReLU(), conv(z_ch, z_ch, 3, 2), nn.LeakyReLU(),
        conv(z_ch, z_ch, 3), nn.LeakyReLU(), conv(z_ch, z_ch, 3, 2))


def hyper_enc_reduced(y_ch, z_ch):
    return nn.Sequential(
        conv(y_ch, z_ch, 3), nn.LeakyReLU(), conv(z_ch, z_ch, 3, 2),
        nn.LeakyReLU(), conv(z_ch, z_ch, 3, 2))


def hyper_dec(z_ch, y_ch):
    return nn.Sequential(
        conv(z_ch, y_ch, 3), nn.LeakyReLU(), subpel_conv(y_ch, y_ch, 2),
        nn.LeakyReLU(), conv(y_ch, y_ch, 3), nn.LeakyReLU(),
        subpel_conv(y_ch, y_ch, 2), nn.LeakyReLU(), conv(y_ch, y_ch, 3))


class MvEnc(nn.Module):
    def __init__(self, ch=64):
        super().__init__()
        self.enc_1 = nn.Sequential(ResidualBlockWithStride(2, ch, 2),
                                   DepthConvBlock(ch, ch))
        self.enc_2 = ResidualBlockWithStride(ch, ch, 2)
        self.adaptor_0 = DepthConvBlock(ch, ch)
        self.adaptor_1 = DepthConvBlock(ch * 2, ch)
        self.enc_3 = nn.Sequential(ResidualBlockWithStride(ch, ch, 2),
                                   DepthConvBlock(ch, ch), conv(ch, ch, 3, 2))

    def forward(self, x, context, quant_step):
        out = self.enc_2(self.enc_1(x) * quant_step)
        if context is None:
            out = self.adaptor_0(out)
        else:
            out = self.adaptor_1(torch.cat([out, context], dim=1))
        return self.enc_3(out)


class MvDec(nn.Module):
    def __init__(self, ch=64):
        super().__init__()
        self.dec_1 = nn.Sequential(
            DepthConvBlock(ch, ch), ResidualBlockUpsample(ch, ch, 2),
            DepthConvBlock(ch, ch), ResidualBlockUpsample(ch, ch, 2),
            DepthConvBlock(ch, ch))
        self.dec_2 = ResidualBlockUpsample(ch, ch, 2)
        self.dec_3 = nn.Sequential(DepthConvBlock(ch, ch),
                                   subpel_conv(ch, 2, 2))

    def forward(self, x, quant_step):
        feature = self.dec_1(x)
        return self.dec_3(self.dec_2(feature) * quant_step), feature


class ContextualEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        c1, c2, c4, c8, c16 = (G_CH[k] for k in ("1x", "2x", "4x", "8x", "16x"))
        self.conv1 = conv(c1 + 3, c2, 3, 2)
        self.res1 = ResBlock(c2 * 2, 0.1, True, True)
        self.conv2 = conv(c2 * 2, c4, 3, 2)
        self.res2 = ResBlock(c4 * 2, 0.1, True, True)
        self.conv3 = conv(c4 * 2, c8, 3, 2)
        self.conv4 = conv(c8, c16, 3, 2)

    def forward(self, x, context1, context2, context3, quant_step):
        f = self.conv1(torch.cat([x, context1], dim=1))
        f = self.res1(torch.cat([f, context2], dim=1)) * quant_step
        f = self.res2(torch.cat([self.conv2(f), context3], dim=1))
        return self.conv4(self.conv3(f))


class ContextualDecoder(nn.Module):
    def __init__(self):
        super().__init__()
        c2, c4, c8, c16 = (G_CH[k] for k in ("2x", "4x", "8x", "16x"))
        self.up1 = subpel_conv(c16, c8, 2, 3)
        self.up2 = subpel_conv(c8, c4, 2, 3)
        self.res1 = ResBlock(c4 * 2, 0.1, True, True)
        self.up3 = subpel_conv(c4 * 2, c2, 2, 3)
        self.res2 = ResBlock(c2 * 2, 0.1, True, True)
        self.up4 = subpel_conv(c2 * 2, 32, 2, 3)

    def forward(self, x, context2, context3, quant_step):
        f = self.res1(torch.cat([self.up2(self.up1(x)), context3], dim=1))
        f = self.res2(torch.cat([self.up3(f) * quant_step, context2], dim=1))
        return self.up4(f)


class ReconGeneration(nn.Module):
    def __init__(self):
        super().__init__()
        c1 = G_CH["1x"]
        self.first_conv = conv(32 + c1, c1, 3)
        self.unet_1 = UNet(c1, c1)
        self.unet_2 = UNet(c1, c1)
        self.recon_conv = conv(c1, 3, 3)

    def forward(self, ctx, res):
        feature = self.unet_2(self.unet_1(self.first_conv(
            torch.cat([ctx, res], dim=1))))
        return feature, self.recon_conv(feature)


Q_SCALE_NAMES = ("mv_y_q_scale_enc", "mv_y_q_scale_dec", "y_q_scale_enc",
                 "y_q_scale_dec")


class DMC(nn.Module):
    """The P-frame codec; ``warps["od"]`` is the OffsetDiversity warp mode
    (``exact`` or ``block:...``); motion compensation and estimation warp
    exactly, and ``warps`` has to say so."""

    WARPED = True
    STREAM = ("mv_z", "z", "mv_y0", "mv_y1", "mv_y2", "mv_y3", "y0", "y1",
              "y2", "y3")

    def __init__(self, warps: dict | None = None, anchor_num: int = 4):
        super().__init__()
        warps = warps or {"od": "exact"}
        for k in ("mc", "me"):
            if warps.get(k, "exact") != "exact":
                raise ValueError(f"the reference warps {k} exactly, not "
                                 f"{warps[k]!r}")
        od_warp = warps["od"]
        c1, c16 = G_CH["1x"], G_CH["16x"]
        ch_mv = CH_MV
        self.optic_flow = MESpynet()
        self.align = OffsetDiversity(in_channel=c1)
        self.align.warp = warp_fn(od_warp)
        self.mv_encoder = MvEnc(ch_mv)
        self.mv_hyper_prior_encoder = hyper_enc(ch_mv, 64)
        self.mv_hyper_prior_decoder = hyper_dec(64, ch_mv)
        self.mv_y_prior_fusion_adaptor_0 = DepthConvBlock(ch_mv, ch_mv * 2)
        self.mv_y_prior_fusion_adaptor_1 = DepthConvBlock(ch_mv * 2, ch_mv * 2)
        self.mv_y_prior_fusion = nn.Sequential(
            DepthConvBlock(ch_mv * 2, ch_mv * 3),
            DepthConvBlock(ch_mv * 3, ch_mv * 3))
        for i in (1, 2, 3):
            setattr(self, f"mv_y_spatial_prior_adaptor_{i}",
                    conv(ch_mv * 4, ch_mv * 3, 1))
        self.mv_y_spatial_prior = nn.Sequential(
            DepthConvBlock(ch_mv * 3, ch_mv * 3),
            DepthConvBlock(ch_mv * 3, ch_mv * 3),
            DepthConvBlock(ch_mv * 3, ch_mv * 2))
        self.mv_decoder = MvDec(ch_mv)
        self.feature_adaptor_I = conv(3, c1, 3)
        self.feature_adaptor = nn.ModuleList([conv(c1, c1, 1) for _ in range(3)])
        self.feature_extractor = FeatureExtractor()
        self.context_fusion_net = MultiScaleContextFusion()
        self.contextual_encoder = ContextualEncoder()
        self.contextual_hyper_prior_encoder = hyper_enc_reduced(c16, c16)
        self.contextual_hyper_prior_decoder = hyper_dec(c16, c16)
        self.temporal_prior_encoder = nn.Sequential(
            conv(G_CH["4x"], G_CH["8x"], 3, 2), nn.LeakyReLU(0.1),
            conv(G_CH["8x"], c16, 3, 2))
        self.y_prior_fusion_adaptor_0 = DepthConvBlock(c16 * 2, c16 * 3)
        self.y_prior_fusion_adaptor_1 = DepthConvBlock(c16 * 3, c16 * 3)
        self.y_prior_fusion = nn.Sequential(DepthConvBlock(c16 * 3, c16 * 3),
                                            DepthConvBlock(c16 * 3, c16 * 3))
        for i in (1, 2, 3):
            setattr(self, f"y_spatial_prior_adaptor_{i}",
                    conv(c16 * 4, c16 * 3, 1))
        self.y_spatial_prior = nn.Sequential(
            DepthConvBlock(c16 * 3, c16 * 3), DepthConvBlock(c16 * 3, c16 * 3),
            DepthConvBlock(c16 * 3, c16 * 2))
        self.contextual_decoder = ContextualDecoder()
        self.recon_generation_net = ReconGeneration()
        self.bit_estimator_z = BitEstimator(c16)
        self.bit_estimator_z_mv = BitEstimator(64)
        self.mv_y_q_basic_enc = nn.Parameter(torch.ones(1, ch_mv, 1, 1))
        self.mv_y_q_scale_enc = nn.Parameter(torch.ones(anchor_num, 1, 1, 1))
        self.mv_y_q_basic_dec = nn.Parameter(torch.ones(1, ch_mv, 1, 1))
        self.mv_y_q_scale_dec = nn.Parameter(torch.ones(anchor_num, 1, 1, 1))
        self.y_q_basic_enc = nn.Parameter(torch.ones(1, G_CH["2x"] * 2, 1, 1))
        self.y_q_scale_enc = nn.Parameter(torch.ones(anchor_num, 1, 1, 1))
        self.y_q_basic_dec = nn.Parameter(torch.ones(1, G_CH["2x"], 1, 1))
        self.y_q_scale_dec = nn.Parameter(torch.ones(anchor_num, 1, 1, 1))

    def _spatial_fns(self, prefix):
        net = getattr(self, f"{prefix}y_spatial_prior")
        return [lambda p, a=getattr(self, f"{prefix}y_spatial_prior_adaptor_{i}"):
                net(a(p)).chunk(8, 1) for i in (1, 2, 3)]

    def q_scales(self, q_index: int, device) -> dict:
        """The four fine q scales of ``q_index`` (mv_enc, mv_dec, y_enc,
        y_dec), as scalars on ``device``."""
        keys = ("mv_enc", "mv_dec", "y_enc", "y_dec")
        return {k: torch.tensor(fine_q(getattr(self, n), q_index),
                                device=device)
                for k, n in zip(keys, Q_SCALE_NAMES)}

    def _contexts(self, dpb, mv, index):
        warpframe = flow_warp(dpb["ref_frame"], mv)
        mv2 = down2(mv) / 2
        mv3 = down2(mv2) / 2
        if dpb["ref_feature"] is None:
            feature = self.feature_adaptor_I(dpb["ref_frame"])
        else:
            feature = self.feature_adaptor[(0, 1, 0, 2)[index % 4]](
                dpb["ref_feature"])
        ref_f1, ref_f2, ref_f3 = self.feature_extractor(feature)
        context1 = self.align(
            ref_f1, torch.cat([flow_warp(ref_f1, mv), warpframe, mv], dim=1),
            mv)
        return self.context_fusion_net(context1, flow_warp(ref_f2, mv2),
                                       flow_warp(ref_f3, mv3))

    def forward(self, x, dpb, qs, frame_idx: int = 0, mode: str = "round",
                sym=None):
        """One P-frame: the DPB the decoder holds after it and, for the
        training loss, the estimated bits per pixel of each sample.
        ``sym`` (``symbols.Symbols``, the planes of ``STREAM``) gives or
        takes the symbols."""
        mv_q_enc = self.mv_y_q_basic_enc * qs["mv_enc"]
        mv_q_dec = self.mv_y_q_basic_dec * qs["mv_dec"]
        y_q_enc = self.y_q_basic_enc * qs["y_enc"]
        y_q_dec = self.y_q_basic_dec * qs["y_dec"]

        est_mv = self.optic_flow(x, dpb["ref_frame"])
        mv_y = self.mv_encoder(est_mv, dpb["ref_mv_feature"], mv_q_enc)
        mv_y_pad, pads = pad_to(mv_y, 4)
        mv_z = self.mv_hyper_prior_encoder(mv_y_pad)
        mv_z_hat = (priors.quant(mv_z, mode) if sym is None
                    else sym.round("mv_z", mv_z))
        p = crop(self.mv_hyper_prior_decoder(mv_z_hat), pads)
        if dpb["ref_mv_y"] is None:
            p = self.mv_y_prior_fusion_adaptor_0(p)
        else:
            p = self.mv_y_prior_fusion_adaptor_1(
                torch.cat([p, dpb["ref_mv_y"]], 1))
        mv_params = self.mv_y_prior_fusion(p)
        _, mv_y_q, mv_y_hat, mv_scales = priors.four_part(
            mv_y, mv_params, self._spatial_fns("mv_"), mode, sym, "mv_y")
        mv_hat, mv_feature = self.mv_decoder(mv_y_hat, mv_q_dec)
        context1, context2, context3 = self._contexts(dpb, mv_hat, frame_idx)

        y = self.contextual_encoder(x, context1, context2, context3, y_q_enc)
        y_pad, pads = pad_to(y, 4)
        z = self.contextual_hyper_prior_encoder(y_pad)
        z_hat = priors.quant(z, mode) if sym is None else sym.round("z", z)
        hier = crop(self.contextual_hyper_prior_decoder(z_hat), pads)
        t = self.temporal_prior_encoder(context3)
        if dpb["ref_y"] is None:
            p = self.y_prior_fusion_adaptor_0(torch.cat([t, hier], dim=1))
        else:
            p = self.y_prior_fusion_adaptor_1(
                torch.cat([t, hier, dpb["ref_y"]], 1))
        params = self.y_prior_fusion(p)
        _, y_q, y_hat, scales = priors.four_part(
            y, params, self._spatial_fns(""), mode, sym)
        res = self.contextual_decoder(y_hat, context2, context3, y_q_dec)
        feature, x_hat = self.recon_generation_net(res, context1)
        dpb_out = {"ref_frame": torch.clamp(x_hat, 0.0, 1.0),
                   "ref_feature": feature, "ref_mv_feature": mv_feature,
                   "ref_y": y_hat, "ref_mv_y": mv_y_hat}
        pixels = x.shape[2] * x.shape[3]
        bpp = sum(b.sum(dim=(1, 2, 3)) for b in (
            priors.laplace_bits(y_q, scales),
            priors.laplace_bits(mv_y_q, mv_scales),
            priors.z_bits(z_hat, self.bit_estimator_z),
            priors.z_bits(mv_z_hat, self.bit_estimator_z_mv))) / pixels
        return dpb_out, bpp


# ---------------------------------------------------------------------- EVC

EVC_CHANNELS = {"L": (192, 192, 192, 192), "M": (128, 128, 192, 192),
                "S": (64, 64, 128, 192)}


class EVCIntra(nn.Module):
    """EVC image codec, encoder size X and decoder size Y of ``variant``."""

    STREAM = ("z", "y0", "y1")

    def __init__(self, variant: str = "LL", N: int = 192, anchor_num: int = 4):
        super().__init__()
        e2, e4, e8, e16 = EVC_CHANNELS[variant[0]]
        d2, d4, d8, d16 = EVC_CHANNELS[variant[1]]
        self.N = N
        self.enc = nn.Sequential(
            ResidualBlockWithStride(3, e2, 2), EvcDepthConvBlock(e2, e2),
            ResidualBlockWithStride(e2, e4, 2), EvcDepthConvBlock(e4, e4),
            ResidualBlockWithStride(e4, e8, 2), EvcDepthConvBlock(e8, e8),
            conv(e8, e16, 3, 2))
        self.dec = nn.Sequential(
            EvcDepthConvBlock(d16, d16), ResidualBlockUpsample(d16, d8, 2),
            EvcDepthConvBlock(d8, d8), ResidualBlockUpsample(d8, d4, 2),
            EvcDepthConvBlock(d4, d4), ResidualBlockUpsample(d4, d2, 2),
            EvcDepthConvBlock(d2, d2), subpel_conv(d2, 3, 2))
        self.hyper_enc = nn.Sequential(DepthConvBlock(N, N), conv(N, N, 3, 2),
                                       nn.LeakyReLU(0.01), conv(N, N, 3, 2))
        self.hyper_dec = nn.Sequential(DepthConvBlockUpsample(N, N),
                                       DepthConvBlockUpsample(N, N),
                                       DepthConvBlock(N, N))
        self.y_prior_fusion = nn.Sequential(DepthConvBlock(N, N * 2),
                                            DepthConvBlock(N * 2, N * 3))
        self.y_spatial_prior = nn.Sequential(DepthConvBlock(N * 4, N * 3),
                                             DepthConvBlock(N * 3, N * 2),
                                             DepthConvBlock(N * 2, N * 2))
        self.bit_estimator_z = BitEstimator(N)
        self.q_basic = nn.Parameter(torch.ones(1, N, 1, 1))
        self.q_scale = nn.Parameter(torch.ones(anchor_num, 1, 1, 1))

    @torch.no_grad()
    def code(self, x, q_scale: float, sym=None):
        """The reconstruction of image ``x`` [1, 3, H, W] (H, W multiples
        of 64) at ``q_scale``, clamped to [0, 1]; ``sym`` as in
        ``IntraNoAR.code``."""
        curr_q = torch.clamp_min(self.q_basic, 0.5) * torch.tensor(
            q_scale, dtype=torch.float32, device=x.device)
        y = self.enc(x) / curr_q
        z = self.hyper_enc(y)
        z_hat = torch.round(z) if sym is None else sym.round("z", z)
        params = self.y_prior_fusion(self.hyper_dec(z_hat))
        q_step, scales, means = params.chunk(3, dim=1)
        y_hat = priors.dual_part(
            y, means, scales, q_step,
            lambda p: self.y_spatial_prior(p).chunk(4, dim=1), sym=sym)[2]
        return torch.clamp(self.dec(y_hat * curr_q), 0.0, 1.0)
