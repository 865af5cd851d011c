"""DMC — the DCVC-DC P-frame conditional video codec (NCHW).

Counterpart of ``dcvc_tpu/models/video_dc.py`` (parity target:
DCVC-DC/src/models/video_model.py:26-628): dual latent branches (motion +
contextual), each with a four-part quad-tree prior, latent temporal priors
(ref_y / ref_mv_y), offset-diversity motion compensation, feature-adaptor
cycling (frame_idx % 4 -> [0, 1, 0, 2]) and enc/dec-side vector quant steps
with 64-point fine q tables. Child names follow the reference.

DPB contract (video_model.py:616-622): a dict {ref_frame, ref_feature,
ref_mv_feature, ref_y, ref_mv_y} of NCHW tensors (entries may be None on
the first P-frame after an I-frame). ``dtype`` (None = f32, or
``torch.bfloat16``) is the compute dtype of ``layers/blocks.py``;
parameters stay f32 and the DPB's dtypes are a fixed point of the P-frame
step, as in the JAX package (``tests/test_dtype_consistency.py``).

Under a tile context (``parallel/tile.py``) every tensor is this rank's
slab of H rows; the hyper paths (z at 1/64 of the frame, where the rows
stop dividing) gather the latent's rows and run whole, replicated over the
tile axis, and the prior parameters are cut to this rank's rows again;
the per-sample bits of the latents are summed over the tile axis, and
the hyper latents' bits, whole on every rank, are counted once in the
gradient (``tile.once``). Under ``quant_mode="noise"`` each rank draws the
whole tensors' noise and keeps its slab (``priors.quant_noise``), so a
mesh draws what one device draws.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..device import resolve_device
from ..entropy import bits
from ..entropy.bit_estimator import BitEstimator
from ..layers.blocks import (
    DepthConvBlock,
    LeakyReLU,
    ResBlock,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    UNet,
    conv,
    set_compute_dtype,
    subpel_conv,
)
from ..ops.warp import bilinear_down2, crop_lrtb, get_padding_size, resolve_warp_fn
from ..parallel import tile
from . import priors
from .intra_dc import build_fine_q_tables, pad_for_y
from .video_net import (
    FeatureExtractor,
    HyperDec,
    HyperEnc,
    HyperEncReduced,
    MESpynet,
    MultiScaleContextFusion,
    OffsetDiversity,
)

# channel plan (video_model.py:19-23)
G_CH = {"1x": 48, "2x": 64, "4x": 96, "8x": 96, "16x": 128}
CH_MV = 64
Q_SCALE_NAMES = ("mv_y_q_scale_enc", "mv_y_q_scale_dec",
                 "y_q_scale_enc", "y_q_scale_dec")


class MvEnc(nn.Module):
    def __init__(self, input_channel: int = 2, channel: int = 64,
                 dtype=None):
        super().__init__()
        ch = channel
        self.enc_1 = nn.Sequential(ResidualBlockWithStride(input_channel, ch, 2),
                                   DepthConvBlock(ch, ch))
        self.enc_2 = ResidualBlockWithStride(ch, ch, 2)
        self.adaptor_0 = DepthConvBlock(ch, ch)
        self.adaptor_1 = DepthConvBlock(ch * 2, ch)
        self.enc_3 = nn.Sequential(ResidualBlockWithStride(ch, ch, 2),
                                   DepthConvBlock(ch, ch), conv(ch, ch, 3, 2))
        set_compute_dtype(self, dtype)

    def forward(self, x, context, quant_step):
        out = self.enc_2(self.enc_1(x) * quant_step)
        if context is None:
            out = self.adaptor_0(out)
        else:
            out = self.adaptor_1(torch.cat([out, context], dim=1))
        return self.enc_3(out)


class MvDec(nn.Module):
    def __init__(self, output_channel: int = 2, channel: int = 64,
                 dtype=None):
        super().__init__()
        ch = channel
        self.dec_1 = nn.Sequential(
            DepthConvBlock(ch, ch), ResidualBlockUpsample(ch, ch, 2),
            DepthConvBlock(ch, ch), ResidualBlockUpsample(ch, ch, 2),
            DepthConvBlock(ch, ch))
        self.dec_2 = ResidualBlockUpsample(ch, ch, 2)
        self.dec_3 = nn.Sequential(DepthConvBlock(ch, ch),
                                   subpel_conv(ch, output_channel, 2))
        set_compute_dtype(self, dtype)

    def forward(self, x, quant_step):
        feature = self.dec_1(x)
        mv = self.dec_3(self.dec_2(feature) * quant_step)
        return mv, feature


class ContextualEncoder(nn.Module):
    def __init__(self, dtype=None):
        super().__init__()
        c1, c2, c4, c8, c16 = (G_CH[k] for k in ("1x", "2x", "4x", "8x", "16x"))
        self.conv1 = conv(c1 + 3, c2, 3, 2)
        self.res1 = ResBlock(c2 * 2, slope=0.1, end_with_relu=True,
                             bottleneck=True)
        self.conv2 = conv(c2 * 2, c4, 3, 2)
        self.res2 = ResBlock(c4 * 2, slope=0.1, end_with_relu=True,
                             bottleneck=True)
        self.conv3 = conv(c4 * 2, c8, 3, 2)
        self.conv4 = conv(c8, c16, 3, 2)
        set_compute_dtype(self, dtype)

    def forward(self, x, context1, context2, context3, quant_step):
        f = self.conv1(torch.cat([x, context1], dim=1))
        f = self.res1(torch.cat([f, context2], dim=1)) * quant_step
        f = self.res2(torch.cat([self.conv2(f), context3], dim=1))
        return self.conv4(self.conv3(f))


class ContextualDecoder(nn.Module):
    def __init__(self, dtype=None):
        super().__init__()
        c2, c4, c8, c16 = (G_CH[k] for k in ("2x", "4x", "8x", "16x"))
        self.up1 = subpel_conv(c16, c8, 2, 3)
        self.up2 = subpel_conv(c8, c4, 2, 3)
        self.res1 = ResBlock(c4 * 2, slope=0.1, end_with_relu=True,
                             bottleneck=True)
        self.up3 = subpel_conv(c4 * 2, c2, 2, 3)
        self.res2 = ResBlock(c2 * 2, slope=0.1, end_with_relu=True,
                             bottleneck=True)
        self.up4 = subpel_conv(c2 * 2, 32, 2, 3)
        set_compute_dtype(self, dtype)

    def forward(self, x, context2, context3, quant_step):
        f = self.up2(self.up1(x))
        f = self.res1(torch.cat([f, context3], dim=1))
        f = self.up3(f) * quant_step
        f = self.res2(torch.cat([f, context2], dim=1))
        return self.up4(f)


class ReconGeneration(nn.Module):
    def __init__(self, ctx_channel: int = 32, res_channel: int = G_CH["1x"],
                 dtype=None):
        super().__init__()
        c1 = G_CH["1x"]
        self.first_conv = conv(ctx_channel + res_channel, c1, 3)
        self.unet_1 = UNet(c1, c1)
        self.unet_2 = UNet(c1, c1)
        self.recon_conv = conv(c1, 3, 3)
        set_compute_dtype(self, dtype)

    def forward(self, ctx, res):
        feature = self.unet_2(self.unet_1(self.first_conv(
            torch.cat([ctx, res], dim=1))))
        return feature, self.recon_conv(feature)


class DMC(nn.Module):
    """``od_warp_mode`` None picks the device default (the block kernel on
    the card, exact on the CPU); ``mc_warp_mode`` / ``me_warp_mode`` None
    are exact."""

    def __init__(self, anchor_num: int = 4, od_warp_mode: str | None = None,
                 mc_warp_mode: str | None = None,
                 me_warp_mode: str | None = None, warp_chunks: int = 1,
                 dtype=None):
        super().__init__()
        c1, c16 = G_CH["1x"], G_CH["16x"]
        ch_mv = CH_MV
        self.mc_warp_mode = mc_warp_mode
        self.optic_flow = MESpynet(me_warp_mode)
        self.align = OffsetDiversity(in_channel=c1, warp_mode=od_warp_mode,
                                     warp_chunks=warp_chunks)

        self.mv_encoder = MvEnc(2, ch_mv)
        self.mv_hyper_prior_encoder = HyperEnc(ch_mv, 64)
        self.mv_hyper_prior_decoder = HyperDec(64, ch_mv)
        self.mv_y_prior_fusion_adaptor_0 = DepthConvBlock(ch_mv, ch_mv * 2)
        self.mv_y_prior_fusion_adaptor_1 = DepthConvBlock(ch_mv * 2, ch_mv * 2)
        self.mv_y_prior_fusion = nn.Sequential(
            DepthConvBlock(ch_mv * 2, ch_mv * 3),
            DepthConvBlock(ch_mv * 3, ch_mv * 3))
        self.mv_y_spatial_prior_adaptor_1 = conv(ch_mv * 4, ch_mv * 3, 1)
        self.mv_y_spatial_prior_adaptor_2 = conv(ch_mv * 4, ch_mv * 3, 1)
        self.mv_y_spatial_prior_adaptor_3 = conv(ch_mv * 4, ch_mv * 3, 1)
        self.mv_y_spatial_prior = nn.Sequential(
            DepthConvBlock(ch_mv * 3, ch_mv * 3),
            DepthConvBlock(ch_mv * 3, ch_mv * 3),
            DepthConvBlock(ch_mv * 3, ch_mv * 2))
        self.mv_decoder = MvDec(2, ch_mv)

        self.feature_adaptor_I = conv(3, c1, 3)
        self.feature_adaptor = nn.ModuleList([conv(c1, c1, 1) for _ in range(3)])
        self.feature_extractor = FeatureExtractor()
        self.context_fusion_net = MultiScaleContextFusion()

        self.contextual_encoder = ContextualEncoder()
        self.contextual_hyper_prior_encoder = HyperEncReduced(c16, c16)
        self.contextual_hyper_prior_decoder = HyperDec(c16, c16)
        self.temporal_prior_encoder = nn.Sequential(
            conv(G_CH["4x"], G_CH["8x"], 3, 2), LeakyReLU(0.1),
            conv(G_CH["8x"], c16, 3, 2))
        self.y_prior_fusion_adaptor_0 = DepthConvBlock(c16 * 2, c16 * 3)
        self.y_prior_fusion_adaptor_1 = DepthConvBlock(c16 * 3, c16 * 3)
        self.y_prior_fusion = nn.Sequential(DepthConvBlock(c16 * 3, c16 * 3),
                                            DepthConvBlock(c16 * 3, c16 * 3))
        self.y_spatial_prior_adaptor_1 = conv(c16 * 4, c16 * 3, 1)
        self.y_spatial_prior_adaptor_2 = conv(c16 * 4, c16 * 3, 1)
        self.y_spatial_prior_adaptor_3 = conv(c16 * 4, c16 * 3, 1)
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
        set_compute_dtype(self, dtype)

    # ---- prior plumbing ----

    def spatial_prior_fns(self, which: str):
        if which == "mv":
            net = self.mv_y_spatial_prior
            adaptors = [self.mv_y_spatial_prior_adaptor_1,
                        self.mv_y_spatial_prior_adaptor_2,
                        self.mv_y_spatial_prior_adaptor_3]
        else:
            net = self.y_spatial_prior
            adaptors = [self.y_spatial_prior_adaptor_1,
                        self.y_spatial_prior_adaptor_2,
                        self.y_spatial_prior_adaptor_3]
        return [lambda params, a=a: net(a(params)).chunk(8, 1) for a in adaptors]

    @staticmethod
    def _hyper(enc, y):
        """Hyper-latent of ``y`` (whole under a tile context) and the
        latent's padding."""
        y_pad, slice_shape = pad_for_y(tile.gather_rows(y))
        with tile.whole():
            return enc(y_pad), slice_shape

    @staticmethod
    def _hyper_params(dec, z_hat, slice_shape):
        """The hyper decoder's prior parameters, this rank's rows."""
        with tile.whole():
            p = crop_lrtb(dec(z_hat), slice_shape)
        return tile.own_rows(p)

    def mv_prior_param_decoder(self, mv_z_hat, ref_mv_y, slice_shape):
        p = self._hyper_params(self.mv_hyper_prior_decoder, mv_z_hat,
                               slice_shape)
        if ref_mv_y is None:
            p = self.mv_y_prior_fusion_adaptor_0(p)
        else:
            p = self.mv_y_prior_fusion_adaptor_1(torch.cat([p, ref_mv_y], 1))
        return self.mv_y_prior_fusion(p)

    def res_prior_param_decoder(self, z_hat, ref_y, context3, slice_shape):
        hier = self._hyper_params(self.contextual_hyper_prior_decoder, z_hat,
                                  slice_shape)
        t = self.temporal_prior_encoder(context3)
        if ref_y is None:
            p = self.y_prior_fusion_adaptor_0(torch.cat([t, hier], dim=1))
        else:
            p = self.y_prior_fusion_adaptor_1(torch.cat([t, hier, ref_y], 1))
        return self.y_prior_fusion(p)

    # ---- motion pipeline ----

    def multi_scale_feature_extractor(self, dpb, index: int):
        if dpb["ref_feature"] is None:
            feature = self.feature_adaptor_I(dpb["ref_frame"])
        else:
            feature = self.feature_adaptor[(0, 1, 0, 2)[index % 4]](
                dpb["ref_feature"])
        return self.feature_extractor(feature)

    def motion_compensation(self, dpb, mv, index: int):
        warp = resolve_warp_fn(self.mc_warp_mode or "exact")
        warpframe = warp(dpb["ref_frame"], mv)
        mv2 = bilinear_down2(mv) / 2
        mv3 = bilinear_down2(mv2) / 2
        ref_f1, ref_f2, ref_f3 = self.multi_scale_feature_extractor(dpb, index)
        context1_init = warp(ref_f1, mv)
        context1 = self.align(
            ref_f1, torch.cat([context1_init, warpframe, mv], dim=1), mv)
        context2 = warp(ref_f2, mv2)
        context3 = warp(ref_f3, mv3)
        context1, context2, context3 = self.context_fusion_net(
            context1, context2, context3)
        return context1, context2, context3, warpframe

    def get_recon_and_feature(self, y_hat, context1, context2, context3,
                              y_q_dec):
        res = self.contextual_decoder(y_hat, context2, context3, y_q_dec)
        feature, x_hat = self.recon_generation_net(res, context1)
        return torch.clamp(x_hat, 0.0, 1.0), feature

    def _q(self, q_scales):
        return (self.mv_y_q_basic_enc * q_scales["mv_enc"],
                self.mv_y_q_basic_dec * q_scales["mv_dec"],
                self.y_q_basic_enc * q_scales["y_enc"],
                self.y_q_basic_dec * q_scales["y_dec"])

    def _mv_branch_analysis(self, x, dpb, mv_y_q_enc):
        est_mv = self.optic_flow(x, dpb["ref_frame"])
        mv_y = self.mv_encoder(est_mv, dpb["ref_mv_feature"], mv_y_q_enc)
        return (mv_y, *self._hyper(self.mv_hyper_prior_encoder, mv_y))

    # ---- full paths ----

    def forward(self, x, dpb, q_scales, frame_idx: int = 0,
                quant_mode: str = "round", generator=None):
        """forward_one_frame (video_model.py:559-628): estimated bits.
        ``q_scales`` maps mv_enc / mv_dec / y_enc / y_dec to scalars.
        Under ``quant_mode="noise"`` the bits come from noise-added
        residuals drawn from ``generator`` (y, mv_y, z, mv_z)."""
        quant = priors.resolve_quant(quant_mode)
        mv_y_q_enc, mv_y_q_dec, y_q_enc, y_q_dec = self._q(q_scales)

        mv_y, mv_z, slice_shape = self._mv_branch_analysis(x, dpb, mv_y_q_enc)
        mv_z_hat = quant(mv_z)
        mv_params = self.mv_prior_param_decoder(mv_z_hat, dpb["ref_mv_y"],
                                                slice_shape)
        mv_y_res, mv_y_q, mv_y_hat, mv_scales_hat = \
            priors.forward_four_part_prior(
                mv_y, mv_params, self.spatial_prior_fns("mv"), quant=quant)
        mv_hat, mv_feature = self.mv_decoder(mv_y_hat, mv_y_q_dec)
        context1, context2, context3, _ = self.motion_compensation(
            dpb, mv_hat, frame_idx)

        y = self.contextual_encoder(x, context1, context2, context3, y_q_enc)
        z, slice_shape = self._hyper(self.contextual_hyper_prior_encoder, y)
        z_hat = quant(z)
        params = self.res_prior_param_decoder(z_hat, dpb["ref_y"], context3,
                                              slice_shape)
        y_res, y_q, y_hat, scales_hat = priors.forward_four_part_prior(
            y, params, self.spatial_prior_fns("y"), quant=quant)
        x_hat, feature = self.get_recon_and_feature(
            y_hat, context1, context2, context3, y_q_dec)

        if quant_mode == "noise":
            # training rate surrogate: bits from noise-quantized residuals
            # while the recon path stays STE (HEM video_model.py:466-471)
            y_q = priors.quant_noise(y_res, generator)
            mv_y_q = priors.quant_noise(mv_y_res, generator)
            z_hat = priors.quant_noise(z, generator, rows=False)
            mv_z_hat = priors.quant_noise(mv_z, generator, rows=False)
        pixel_num = tile.global_rows(x.shape[2]) * x.shape[3]
        bpp = {}
        for k, b in (("bpp_y", bits.y_laplace_bits(y_q, scales_hat)),
                     ("bpp_mv_y", bits.y_laplace_bits(mv_y_q, mv_scales_hat))):
            bpp[k] = tile.sum_tiles(b.sum(dim=(1, 2, 3))) / pixel_num
        for k, b in (("bpp_z", bits.z_bits(z_hat, self.bit_estimator_z)),
                     ("bpp_mv_z", bits.z_bits(mv_z_hat,
                                              self.bit_estimator_z_mv))):
            # whole on every tile rank: counted once in the gradient
            bpp[k] = tile.once(b.sum(dim=(1, 2, 3))) / pixel_num
        total = bpp["bpp_y"] + bpp["bpp_z"] + bpp["bpp_mv_y"] + bpp["bpp_mv_z"]
        return {
            **bpp, "bpp": total, "bit": total.sum() * pixel_num,
            "dpb": {
                "ref_frame": x_hat,
                "ref_feature": feature,
                "ref_mv_feature": mv_feature,
                "ref_y": y_hat,
                "ref_mv_y": mv_y_hat,
            },
        }

    def compress_device(self, x, dpb, q_scales, frame_idx: int = 0):
        mv_y_q_enc, mv_y_q_dec, y_q_enc, y_q_dec = self._q(q_scales)

        mv_y, mv_z, slice_shape = self._mv_branch_analysis(x, dpb, mv_y_q_enc)
        mv_z_hat = torch.round(mv_z)
        mv_params = self.mv_prior_param_decoder(mv_z_hat, dpb["ref_mv_y"],
                                                slice_shape)
        mv_q_w, mv_s_w, mv_y_hat = priors.forward_four_part_prior(
            mv_y, mv_params, self.spatial_prior_fns("mv"), write=True)
        mv_hat, mv_feature = self.mv_decoder(mv_y_hat, mv_y_q_dec)
        context1, context2, context3, _ = self.motion_compensation(
            dpb, mv_hat, frame_idx)

        y = self.contextual_encoder(x, context1, context2, context3, y_q_enc)
        z, slice_shape = self._hyper(self.contextual_hyper_prior_encoder, y)
        z_hat = torch.round(z)
        params = self.res_prior_param_decoder(z_hat, dpb["ref_y"], context3,
                                              slice_shape)
        y_q_w, s_w, y_hat = priors.forward_four_part_prior(
            y, params, self.spatial_prior_fns("y"), write=True)
        x_hat, feature = self.get_recon_and_feature(
            y_hat, context1, context2, context3, y_q_dec)
        return {
            "mv_z_hat": mv_z_hat,
            "z_hat": z_hat,
            "mv_y_q_planes": tuple(mv_q_w),
            "mv_scales_planes": tuple(mv_s_w),
            "y_q_planes": tuple(y_q_w),
            "scales_planes": tuple(s_w),
            "dpb": {
                "ref_frame": x_hat,
                "ref_feature": feature,
                "ref_mv_feature": mv_feature,
                "ref_y": y_hat,
                "ref_mv_y": mv_y_hat,
            },
        }

    # ---- decode-side stages (host rANS between them) ----

    def decode_mv_prior(self, mv_z_hat, ref_mv_y, y_height: int, y_width: int):
        return self.mv_prior_param_decoder(
            mv_z_hat, ref_mv_y, get_padding_size(y_height, y_width, 4))

    def decode_scales_step(self, params, y_hat_so_far, step: int, which: str):
        return priors.four_part_decode_scales(
            params, y_hat_so_far, self.spatial_prior_fns(which), step)

    def decode_motion_stage(self, mv_params, mv_sofar, mv_q_dec_scale, dpb,
                            z_hat, frame_idx: int, y_height: int,
                            y_width: int):
        """mv latent -> contexts + y-branch prior params."""
        mv_y_hat = priors.four_part_finalize(mv_params, mv_sofar)
        mv_hat, mv_feature = self.mv_decoder(
            mv_y_hat, self.mv_y_q_basic_dec * mv_q_dec_scale)
        context1, context2, context3, _ = self.motion_compensation(
            dpb, mv_hat, frame_idx)
        params = self.res_prior_param_decoder(
            z_hat, dpb["ref_y"], context3,
            get_padding_size(y_height, y_width, 4))
        return params, (context1, context2, context3), mv_y_hat, mv_feature

    def decode_recon_stage(self, params, y_hat_so_far, contexts, y_q_dec_scale):
        y_hat = priors.four_part_finalize(params, y_hat_so_far)
        context1, context2, context3 = contexts
        x_hat, feature = self.get_recon_and_feature(
            y_hat, context1, context2, context3,
            self.y_q_basic_dec * y_q_dec_scale)
        return x_hat, feature, y_hat


def get_dmc_q_tables(module: DMC) -> dict:
    """Fine (64-point) q tables for all four q_scale vectors."""
    return {name: build_fine_q_tables(
        getattr(module, name).detach().cpu().numpy()) for name in Q_SCALE_NAMES}


def build_dmc(seed: int = 0, device=None, **kwargs) -> DMC:
    """DMC with seeded random weights (the same for any ``dtype``), on
    ``device`` (the card unless ``device="cpu"``), in eval mode;
    ``kwargs`` (``dtype`` among them) go to ``DMC``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = DMC(**kwargs)
    return module.to(dev).eval()
