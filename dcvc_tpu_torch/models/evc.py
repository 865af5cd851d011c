"""EVC intra codec family: the L/M/S encoder x decoder grid + hyperprior
(NCHW).

Counterpart of ``dcvc_tpu/models/evc.py`` (parity targets:
EVC/src/models/image_model.py:16-258, layers.py:227-253 for the enc/dec
stacks, hyperprior.py:81-107 for the hyper and dual-prior nets,
common_model.py for the dual-prior steps and the quant step). Child names
are the reference EVC checkpoint's (``port_dc._evc_encoder`` /
``_evc_tail``): ``enc.0``..``enc.6``, ``dec.0``..``dec.7``, ``hyper_enc``,
``hyper_dec``, ``y_prior_fusion``, ``y_spatial_prior``,
``bit_estimator_z``, ``q_basic`` (1, N, 1, 1) and ``q_scale`` (4, 1, 1, 1),
so a published EVC ``.pth`` loads with ``load_state_dict(strict=True)``.
``dtype`` (None = f32, or ``torch.bfloat16``) is the compute dtype of
``layers/blocks.py``; parameters stay f32. Under a tile context
(``parallel/tile.py``) the hyperprior runs whole on the gathered rows of
y and the prior parameters are cut to this rank's rows again; the bits of
y are summed over the tile axis, and those of z (whole on every rank)
count once in the gradient.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..device import resolve_device
from ..entropy import bits
from ..entropy.bit_estimator import BitEstimator
from ..layers.blocks import (
    DepthConvBlock,
    LeakyReLU,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    conv,
    set_compute_dtype,
    subpel_conv,
)
from ..layers.evc_blocks import DepthConvBlockUpsample, EvcDepthConvBlock
from ..ops.math import lower_bound
from ..parallel import tile
from . import priors

EVC_CHANNEL_GRID = {
    "L": (192, 192, 192, 192),
    "M": (128, 128, 192, 192),
    "S": (64, 64, 128, 192),
}


class EvcEncoder(nn.Sequential):
    def __init__(self, channels: Sequence[int]):
        c2, c4, c8, c16 = channels
        super().__init__(
            ResidualBlockWithStride(3, c2, 2), EvcDepthConvBlock(c2, c2),
            ResidualBlockWithStride(c2, c4, 2), EvcDepthConvBlock(c4, c4),
            ResidualBlockWithStride(c4, c8, 2), EvcDepthConvBlock(c8, c8),
            conv(c8, c16, 3, 2))


class EvcDecoder(nn.Sequential):
    def __init__(self, channels: Sequence[int], out_ch: int = 3):
        c2, c4, c8, c16 = channels
        super().__init__(
            EvcDepthConvBlock(c16, c16), ResidualBlockUpsample(c16, c8, 2),
            EvcDepthConvBlock(c8, c8), ResidualBlockUpsample(c8, c4, 2),
            EvcDepthConvBlock(c4, c4), ResidualBlockUpsample(c4, c2, 2),
            EvcDepthConvBlock(c2, c2), subpel_conv(c2, out_ch, 2))


class EvcHyperEnc(nn.Sequential):
    # hyper / prior stacks use the DC-style DepthConvBlock
    # (EVC/src/models/hyperprior.py:7-74), not the enc/dec EVC variant
    def __init__(self, N: int):
        super().__init__(DepthConvBlock(N, N), conv(N, N, 3, 2),
                         LeakyReLU(0.01), conv(N, N, 3, 2))


class EvcHyperDec(nn.Sequential):
    def __init__(self, N: int):
        super().__init__(DepthConvBlockUpsample(N, N),
                         DepthConvBlockUpsample(N, N), DepthConvBlock(N, N))


class EvcPriorFusion(nn.Sequential):
    def __init__(self, N: int):
        super().__init__(DepthConvBlock(N, N * 2), DepthConvBlock(N * 2, N * 3))


class EvcSpatialPrior(nn.Sequential):
    """Input: cat(y_hat half 0, y_hat half 1, means, scales, quant_step),
    4N channels."""

    def __init__(self, N: int):
        super().__init__(DepthConvBlock(N * 4, N * 3),
                         DepthConvBlock(N * 3, N * 2),
                         DepthConvBlock(N * 2, N * 2))


class DualPriorCodec(nn.Module):
    """What the EVC codecs and IntraNoARHem (``intra_hem.py``) share: the
    quant step, the dual prior and the coding of a latent. A subclass
    builds ``hyper_enc``, ``hyper_dec``, ``y_prior_fusion``,
    ``y_spatial_prior``, ``bit_estimator_z``, ``q_basic``, ``q_scale`` and
    the synthesis ``reconstruct`` (of ``y_hat`` times the quant step);
    ``forward`` and ``compress_device`` code through one encoder ``enc``."""

    def get_curr_q(self, q_scale):
        return lower_bound(self.q_basic, 0.5) * q_scale

    def spatial_prior_chunks(self, params):
        # scales_0, means_0, scales_1, means_1
        return self.y_spatial_prior(params).chunk(4, dim=1)

    def prior_params(self, z_hat):
        """(q_step, scales, means) from the decoded hyper-latent (this
        rank's rows of them under a tile context)."""
        with tile.whole():
            params = self.y_prior_fusion(self.hyper_dec(z_hat))
        return priors.separate_prior(tile.own_rows(params))

    def hyper_latent(self, y):
        """z of latent ``y``, run whole on its gathered rows under a tile
        context."""
        y = tile.gather_rows(y)
        with tile.whole():
            return self.hyper_enc(y)

    def synthesize(self, y_hat, q_scale):
        return self.reconstruct(y_hat * self.get_curr_q(q_scale))

    def dual_scales_step1(self, q_step, scales, means, half0, half1):
        return priors.dual_decode_scales(means, scales, q_step, half0, half1,
                                         self.spatial_prior_chunks, 1)

    def _code(self, x, y, curr_q, quant, generator=None):
        """Hyperprior, dual prior, synthesis and bit costs of latent ``y``
        (already divided by the quant step) for input ``x``. With a
        ``generator`` the bits come from noise-added residuals (the
        training surrogate; y, then z)."""
        z = self.hyper_latent(y)
        z_hat = quant(z)
        q_step, scales, means = self.prior_params(z_hat)
        y_res, y_q, y_hat, scales_hat = priors.forward_dual_prior(
            y, means, scales, q_step, self.spatial_prior_chunks, quant=quant)
        x_hat = self.reconstruct(y_hat * curr_q)
        if generator is not None:
            # training rate surrogate (HEM common_model.py:47-50)
            y_q = priors.quant_noise(y_res, generator)
            z_hat = priors.quant_noise(z, generator, rows=False)
        bits_y = bits.y_gaussian_bits(y_q, torch.clamp(scales_hat, 0.11, 1e10))
        bits_z = bits.z_bits(z_hat, self.bit_estimator_z)
        pixel_num = tile.global_rows(x.shape[2]) * x.shape[3]
        bpp_y = tile.sum_tiles(bits_y.sum(dim=(1, 2, 3))) / pixel_num
        bpp_z = tile.once(bits_z.sum(dim=(1, 2, 3))) / pixel_num
        return x_hat, bpp_y, bpp_z, pixel_num

    def _compress_latent(self, y, curr_q):
        z_hat = torch.round(self.hyper_latent(y))
        q_step, scales, means = self.prior_params(z_hat)
        y_q_w0, y_q_w1, s_w0, s_w1, y_hat = priors.forward_dual_prior(
            y, means, scales, q_step, self.spatial_prior_chunks, write=True)
        return {
            "z_hat": z_hat,
            "y_q_planes": (y_q_w0, y_q_w1),
            "scales_planes": (s_w0, s_w1),
            "x_hat": torch.clamp(self.reconstruct(y_hat * curr_q), 0.0, 1.0),
        }

    def forward(self, x, q_scale, quant_mode: str = "round", generator=None):
        """Estimated-bits forward: x_hat + bit costs. ``x`` [B,3,H,W].
        ``quant_mode="noise"`` draws the rate surrogate from ``generator``."""
        quant = priors.resolve_quant(quant_mode)
        curr_q = self.get_curr_q(q_scale)
        y = self.enc(x) / curr_q
        if quant_mode == "noise" and generator is None:
            raise ValueError("quant_mode 'noise' needs a torch.Generator")
        x_hat, bpp_y, bpp_z, pixel_num = self._code(
            x, y, curr_q, quant, generator if quant_mode == "noise" else None)
        return {
            "x_hat": x_hat,
            "bit": (bpp_y + bpp_z).sum() * pixel_num,
            "bpp": bpp_y + bpp_z,
            "bpp_y": bpp_y,
            "bpp_z": bpp_z,
        }

    def compress_device(self, x, q_scale):
        """Device half of compress: everything up to the symbol planes."""
        curr_q = self.get_curr_q(q_scale)
        return self._compress_latent(self.enc(x) / curr_q, curr_q)


class _EvcCodec(DualPriorCodec):
    """The EVC nets: decoder, hyperprior and prior stacks."""

    def __init__(self, dec_channels: Sequence[int], N: int, anchor_num: int):
        super().__init__()
        self.N = N
        self.dec = EvcDecoder(dec_channels)
        self.hyper_enc = EvcHyperEnc(N)
        self.hyper_dec = EvcHyperDec(N)
        self.y_prior_fusion = EvcPriorFusion(N)
        self.y_spatial_prior = EvcSpatialPrior(N)
        self.bit_estimator_z = BitEstimator(N)
        self.q_basic = nn.Parameter(torch.ones(1, N, 1, 1))
        self.q_scale = nn.Parameter(torch.ones(anchor_num, 1, 1, 1))

    def reconstruct(self, y):
        return self.dec(y)


class EVCIntra(_EvcCodec):
    """Intra codec with independently sized encoder / decoder (e.g. EVC_SS)."""

    def __init__(self, enc_channels: Sequence[int] = EVC_CHANNEL_GRID["L"],
                 dec_channels: Sequence[int] = EVC_CHANNEL_GRID["L"],
                 N: int = 192, anchor_num: int = 4, dtype=None):
        super().__init__(dec_channels, N, anchor_num)
        self.enc = EvcEncoder(enc_channels)
        set_compute_dtype(self, dtype)


def make_evc(variant: str = "LL", N: int = 192, dtype=None) -> EVCIntra:
    """variant "XY": encoder size X, decoder size Y, X/Y in {L, M, S}."""
    return EVCIntra(EVC_CHANNEL_GRID[variant[0]], EVC_CHANNEL_GRID[variant[1]],
                    N, dtype=dtype)


def build_evc(variant: str = "LL", N: int = 192, seed: int = 0,
              device=None, dtype=None) -> EVCIntra:
    """EVCIntra with seeded random weights (``q_basic`` / ``q_scale`` at
    ones, as the JAX init; the same for any ``dtype``), on ``device`` (the
    card unless ``device="cpu"``), in eval mode."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = make_evc(variant, N, dtype)
    return module.to(dev).eval()
