"""IntraNoAR — the DCVC-DC I-frame codec (NCHW).

Counterpart of ``dcvc_tpu/models/intra_dc.py`` (parity target:
DCVC-DC/src/models/image_model.py:16-252): four-part quad-tree prior, UNet2
refinement, enc/dec-side vector quant steps with 64-point log-interpolated
fine q tables. Child names follow the reference, so its ``state_dict``
loads with ``strict=True``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..device import resolve_device
from ..entropy import bits
from ..entropy.bit_estimator import BitEstimator
from ..layers.blocks import (
    DepthConvBlock2,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    UNet,
    conv,
)
from ..ops.warp import crop_lrtb, get_padding_size, replicate_pad
from . import priors


def pad_for_y(y):
    """Replicate-pad latent to a multiple of 4 (common_model.py:70-86)."""
    pad = get_padding_size(y.shape[2], y.shape[3], 4)
    return replicate_pad(y, pad), pad


class IntraEncoder(nn.Module):
    def __init__(self, N: int, ch_a: int = 128, ch_b: int = 192):
        super().__init__()
        self.enc_1 = nn.Sequential(ResidualBlockWithStride(3, ch_a, 2),
                                   DepthConvBlock2(ch_a, ch_a))
        self.enc_2 = nn.Sequential(
            ResidualBlockWithStride(ch_a, ch_b, 2), DepthConvBlock2(ch_b, ch_b),
            ResidualBlockWithStride(ch_b, N, 2), DepthConvBlock2(N, N),
            conv(N, N, 3, 2))

    def forward(self, x, quant_step):
        return self.enc_2(self.enc_1(x) * quant_step)


class IntraDecoder(nn.Module):
    def __init__(self, N: int, ch_a: int = 128, ch_b: int = 192):
        super().__init__()
        self.dec_1 = nn.Sequential(
            DepthConvBlock2(N, N), ResidualBlockUpsample(N, N, 2),
            DepthConvBlock2(N, N), ResidualBlockUpsample(N, ch_b, 2),
            DepthConvBlock2(ch_b, ch_b), ResidualBlockUpsample(ch_b, ch_a, 2))
        self.dec_2 = nn.Sequential(DepthConvBlock2(ch_a, ch_a),
                                   ResidualBlockUpsample(ch_a, 16, 2))

    def forward(self, x, quant_step):
        return self.dec_2(self.dec_1(x) * quant_step)


class IntraNoAR(nn.Module):
    def __init__(self, N: int = 256, anchor_num: int = 4, ch_a: int = 128,
                 ch_b: int = 192):
        super().__init__()
        self.N = N
        self.enc = IntraEncoder(N, ch_a, ch_b)
        self.hyper_enc = nn.Sequential(
            DepthConvBlock2(N, N), conv(N, N, 3, 2), nn.LeakyReLU(),
            conv(N, N, 3, 2))
        self.hyper_dec = nn.Sequential(
            ResidualBlockUpsample(N, N, 2), ResidualBlockUpsample(N, N, 2),
            DepthConvBlock2(N, N))
        self.y_prior_fusion = nn.Sequential(DepthConvBlock2(N, N * 2),
                                            DepthConvBlock2(N * 2, N * 3))
        self.y_spatial_prior_adaptor_1 = conv(N * 4, N * 3, 1)
        self.y_spatial_prior_adaptor_2 = conv(N * 4, N * 3, 1)
        self.y_spatial_prior_adaptor_3 = conv(N * 4, N * 3, 1)
        self.y_spatial_prior = nn.Sequential(
            DepthConvBlock2(N * 3, N * 3), DepthConvBlock2(N * 3, N * 2),
            DepthConvBlock2(N * 2, N * 2))
        self.dec = IntraDecoder(N, ch_a, ch_b)
        self.refine = nn.Sequential(UNet(16, 16, block2=True), conv(16, 3, 3))
        self.bit_estimator_z = BitEstimator(N)
        self.q_basic_enc = nn.Parameter(torch.ones(1, ch_a, 1, 1))
        self.q_scale_enc = nn.Parameter(torch.ones(anchor_num, 1, 1, 1))
        self.q_basic_dec = nn.Parameter(torch.ones(1, ch_a, 1, 1))
        self.q_scale_dec = nn.Parameter(torch.ones(anchor_num, 1, 1, 1))

    # -- prior plumbing --

    def spatial_prior_fns(self):
        def chunks(adaptor):
            return lambda params: self.y_spatial_prior(adaptor(params)).chunk(8, 1)
        return [chunks(self.y_spatial_prior_adaptor_1),
                chunks(self.y_spatial_prior_adaptor_2),
                chunks(self.y_spatial_prior_adaptor_3)]

    def prior_params(self, z_hat, slice_shape):
        params = self.y_prior_fusion(self.hyper_dec(z_hat))
        return crop_lrtb(params, slice_shape)

    def synthesize(self, y_hat, q_dec):
        return self.refine(self.dec(y_hat, q_dec))

    # -- public paths --

    def forward(self, x, q_enc_scale, q_dec_scale, quant_mode: str = "round"):
        """Estimated-bits forward. ``x`` [B,3,H,W] in [0, 1]."""
        quant = priors.resolve_quant(quant_mode)
        curr_q_enc = self.q_basic_enc * q_enc_scale
        curr_q_dec = self.q_basic_dec * q_dec_scale
        y = self.enc(x, curr_q_enc)
        y_pad, pad = pad_for_y(y)
        z = self.hyper_enc(y_pad)
        z_hat = quant(z)
        params = self.prior_params(z_hat, pad)
        _, y_q, y_hat, scales_hat = priors.forward_four_part_prior(
            y, params, self.spatial_prior_fns(), quant=quant)
        x_hat = self.synthesize(y_hat, curr_q_dec)

        bits_y = bits.y_gaussian_bits(y_q, scales_hat)
        bits_z = bits.z_bits(z_hat, self.bit_estimator_z)
        pixel_num = x.shape[2] * x.shape[3]
        bpp_y = bits_y.sum(dim=(1, 2, 3)) / pixel_num
        bpp_z = bits_z.sum(dim=(1, 2, 3)) / pixel_num
        return {
            "x_hat": x_hat,
            "bit": (bpp_y + bpp_z).sum() * pixel_num,
            "bpp": bpp_y + bpp_z,
            "bpp_y": bpp_y,
            "bpp_z": bpp_z,
        }

    def compress_device(self, x, q_enc_scale, q_dec_scale):
        curr_q_enc = self.q_basic_enc * q_enc_scale
        curr_q_dec = self.q_basic_dec * q_dec_scale
        y = self.enc(x, curr_q_enc)
        y_pad, pad = pad_for_y(y)
        z_hat = torch.round(self.hyper_enc(y_pad))
        params = self.prior_params(z_hat, pad)
        y_q_w, s_w, y_hat = priors.forward_four_part_prior(
            y, params, self.spatial_prior_fns(), write=True)
        x_hat = torch.clamp(self.synthesize(y_hat, curr_q_dec), 0.0, 1.0)
        return {
            "z_hat": z_hat,
            "y_q_planes": tuple(y_q_w),
            "scales_planes": tuple(s_w),
            "x_hat": x_hat,
        }

    # decode-side steps (host rANS between them)

    def decode_prior(self, z_hat, y_height: int, y_width: int):
        return self.prior_params(z_hat, get_padding_size(y_height, y_width, 4))

    def decode_scales_step(self, params, y_hat_so_far, step: int):
        return priors.four_part_decode_scales(
            params, y_hat_so_far, self.spatial_prior_fns(), step)

    def decode_synthesis(self, params, y_hat_so_far, q_dec_scale):
        y_hat = priors.four_part_finalize(params, y_hat_so_far)
        curr_q_dec = self.q_basic_dec * q_dec_scale
        return torch.clamp(self.synthesize(y_hat, curr_q_dec), 0.0, 1.0)


def build_fine_q_tables(q_scale: np.ndarray, num: int = 64) -> np.ndarray:
    """64-point log-interpolated fine q table (image_model.py:158-167)."""
    q_scale = np.asarray(q_scale).reshape(-1)
    return np.exp(np.linspace(np.log(q_scale[0]), np.log(q_scale[-1]), num))


def build_intra_dc(N: int = 256, ch_a: int = 128, ch_b: int = 192,
                   seed: int = 0, device=None) -> IntraNoAR:
    """IntraNoAR with seeded random weights, on ``device`` (the card unless
    ``device="cpu"``), in eval mode."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = IntraNoAR(N, 4, ch_a, ch_b)
    return module.to(dev).eval()
