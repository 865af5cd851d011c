"""EVC scalable encoder: a bank of small encoders + RD-cost encoder
selection (NCHW).

Counterpart of ``dcvc_tpu/models/evc_scalable.py`` (parity target:
EVC/src/models/scalable_encoder_model.py:15-285): the scalable_add running
mean of the bank's latents (detached prefix), the per-rate lambda table and
the argmin-cost encoder id chosen at encode time. The encoders are
``encs.{i}`` with the keys of EVCIntra's ``enc``; the rest is EVCIntra's,
``dtype`` included.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..device import resolve_device
from ..layers.blocks import set_compute_dtype
from . import priors
from .evc import EVC_CHANNEL_GRID, EvcEncoder, _EvcCodec

LMBDAS = (0.0022, 0.0050, 0.012, 0.027)


def scalable_add(ys: torch.Tensor) -> torch.Tensor:
    """[S, B, C, H, W] -> running mean with a detached prefix (:15-24); the
    prefix is summed left to right."""
    ys_detach = ys.detach()
    out = []
    prefix = None
    for i in range(ys.shape[0]):
        out.append((ys[i] if prefix is None else prefix + ys[i]) / (i + 1))
        prefix = ys_detach[i] if prefix is None else prefix + ys_detach[i]
    return torch.stack(out)


class ScalableEVC(_EvcCodec):
    """Scale_EVC: scalable encoder bank + one (large) decoder."""

    def __init__(self, enc_num: int = 4,
                 enc_channels=EVC_CHANNEL_GRID["S"],
                 dec_channels=EVC_CHANNEL_GRID["L"], N: int = 192,
                 anchor_num: int = 4, dtype=None):
        super().__init__(dec_channels, N, anchor_num)
        self.enc_num = enc_num
        self.encs = nn.ModuleList(EvcEncoder(enc_channels)
                                  for _ in range(enc_num))
        set_compute_dtype(self, dtype)

    def multi_encode(self, x, q_scale, forward_enc_id: int | None = None):
        curr_q = self.get_curr_q(q_scale)
        y_list = []
        for enc_id in range(self.enc_num):
            y_list.append(self.encs[enc_id](x))
            if forward_enc_id is not None and forward_enc_id == enc_id:
                break
        y_out = scalable_add(torch.stack(y_list))
        if forward_enc_id is not None:
            y, xs = y_out[forward_enc_id], x
        else:
            S, B, C, H, W = y_out.shape
            y = y_out.reshape(S * B, C, H, W)
            xs = torch.cat([x] * len(y_list), dim=0)
        return xs, y / curr_q, curr_q

    def forward(self, x, q_scale, forward_enc_id: int | None = None,
                quant_mode: str = "round"):
        """Estimated bits of every encoder of the bank (batch S * B) or of
        ``forward_enc_id``, with each recon's mse."""
        if quant_mode == "noise":
            # the JAX package's scalable EVC has no noise branch either
            raise ValueError("evc_scalable has no quant_mode 'noise'")
        quant = priors.resolve_quant(quant_mode)
        xs, y, curr_q = self.multi_encode(x, q_scale, forward_enc_id)
        x_hat, bpp_y, bpp_z, pixel_num = self._code(x, y, curr_q, quant)
        return {
            "x_hat": x_hat,
            "mse": ((xs - x_hat) ** 2).mean(dim=(1, 2, 3)),
            "bit": (bpp_y + bpp_z) * pixel_num,
            "bpp": bpp_y + bpp_z,
            "bpp_y": bpp_y,
            "bpp_z": bpp_z,
        }

    def compress_device(self, x, q_scale, forward_enc_id: int = 0):
        _, y, curr_q = self.multi_encode(x, q_scale, forward_enc_id)
        return self._compress_latent(y, curr_q)


def choose_encoder_id(mse, bpp, rate_idx: int) -> int:
    """RD-cost argmin over the encoder bank (:149-157)."""
    cost = (LMBDAS[rate_idx] * 255 * 255 * np.asarray(mse.detach().cpu())
            + np.asarray(bpp.detach().cpu()))
    return int(cost.argmin())


def build_evc_scalable(enc_num: int = 4, N: int = 192, seed: int = 0,
                       device=None, **kwargs) -> ScalableEVC:
    """ScalableEVC with seeded random weights (the same for any
    ``dtype``) on ``device`` (the card unless ``device="cpu"``), in eval
    mode; ``kwargs`` (``dtype`` among them) go to ``ScalableEVC``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = ScalableEVC(enc_num=enc_num, N=N, **kwargs)
    return module.to(dev).eval()
