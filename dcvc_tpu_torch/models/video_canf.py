"""CANFVC_DMC: the fork's conditional augmented normalizing flow hybrid
(NCHW).

Counterpart of ``dcvc_tpu/models/video_canf.py`` (parity target:
DCVC-HEM/src/models/video_model.py:523-840, a fork addition): the HEM DMC
with its contextual encoder / decoder / recon replaced by a 2-layer
conditional ANF ladder (``use_affine=False``: additive, location-only
flows; DCVC-HEM/src/layers/layers.py:131-335) and a DeQuantizationModule
post-filter with 6 residual layers. The DPB carries no ``ref_feature``
(the fork pins it to None, :655), so motion compensation always runs the
I-adaptor path. It codes on ``HemVideoRuntime``. Child names are the
reference's (``port_hem.convert_canf_dmc``):
``contextual_coder.analysis{i}.model``, ``.synthesis{i}.model_part1`` /
``model_part2`` and ``DQ``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..device import resolve_device
from .hem_common import DeQuantizationModule
from .video_hem import (HemContextualDecoder, HemContextualEncoder,
                        HemReconGeneration, HemTrunk)


class _Analysis(nn.Module):
    def __init__(self, N: int, M: int):
        super().__init__()
        self.model = HemContextualEncoder(N, M)


class _Synthesis(nn.Module):
    def __init__(self, N: int, M: int):
        super().__init__()
        self.model_part1 = HemContextualDecoder(N, M)
        self.model_part2 = HemReconGeneration(N)

    def forward(self, code, contexts):
        c1, c2, c3 = contexts
        return self.model_part2(self.model_part1(code, c2, c3), c1)[1]


class CanfMainCoder(nn.Module):
    """2-layer additive conditional ANF ladder; ``encode`` and ``decode``
    are exact inverses by construction (ContextualCANFMainCoder,
    :553-583)."""

    def __init__(self, num_layers: int = 2, channel_N: int = 64,
                 channel_M: int = 96):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"analysis{i}", _Analysis(channel_N, channel_M))
            setattr(self, f"synthesis{i}", _Synthesis(channel_N, channel_M))

    def _analyse(self, i, x, contexts):
        return getattr(self, f"analysis{i}").model(x, *contexts)

    def _synth(self, i, code, contexts):
        return getattr(self, f"synthesis{i}")(code, contexts)

    def encode(self, x, contexts):
        """x -> (x residual, latent code)."""
        code = None
        for i in range(self.num_layers):
            enc = self._analyse(i, x, contexts)
            code = enc if code is None else code + enc
            if i < self.num_layers - 1:
                x = x - self._synth(i, code, contexts)
        return x, code

    def decode(self, x0, contexts, code):
        """(zeros, latent) -> reconstruction; the inverse of ``encode``."""
        x = x0
        for i in range(self.num_layers - 1, -1, -1):
            x = x + self._synth(i, code, contexts)
            if i:
                code = code - self._analyse(i, x, contexts)
        return x

    def last_residual(self, x_res, contexts, code):
        """The fork's x2 regularizer target (video_model.py:785-789): the
        encode residual minus the last synthesis of the quantised latent."""
        return x_res - self._synth(self.num_layers - 1, code, contexts)


class CANFVCDmc(HemTrunk):
    """The HEM DMC with CANF contextual coding and the DQ post-filter."""

    def __init__(self, anchor_num: int = 4, channel_mv: int = 64,
                 channel_N: int = 64, channel_M: int = 96):
        super().__init__(anchor_num, channel_mv, channel_N, channel_M, None)
        self.contextual_coder = CanfMainCoder(2, channel_N, channel_M)
        self.DQ = DeQuantizationModule(3, 3, 64, 6)

    def _analysis(self, x, contexts):
        x2, y = self.contextual_coder.encode(x, contexts)
        return y, x2

    def _synthesis(self, y_hat, contexts, state=None):
        c1 = contexts[0]
        x0 = torch.zeros((c1.shape[0], 3, c1.shape[2], c1.shape[3]),
                         dtype=c1.dtype, device=c1.device)
        x_hat = self.contextual_coder.decode(x0, contexts, y_hat)
        x_hat = torch.clamp(self.DQ(x_hat), 0.0, 1.0)
        extra = {}
        if state is not None:
            # x2_mse, the ANF residual regularizer of the fork's loss: sum
            # over CHW / (H * W), the reference convention (:777-789)
            x2 = self.contextual_coder.last_residual(state, contexts, y_hat)
            extra["x2_mse"] = (x2 ** 2).sum(dim=(1, 2, 3)) / (
                x2.shape[2] * x2.shape[3])
        return x_hat, None, extra


def build_canf(seed: int = 0, device=None, **kwargs) -> CANFVCDmc:
    """CANFVCDmc with seeded random weights on ``device`` (the card unless
    ``device="cpu"``), in eval mode."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = CANFVCDmc(**kwargs)
    return module.to(dev).eval()
