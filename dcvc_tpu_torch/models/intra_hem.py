"""IntraNoAR of the HEM generation: residual enc / dec, dual prior, UNet
refinement (NCHW).

Counterpart of ``dcvc_tpu/models/intra_hem.py`` (parity target:
DCVC-HEM/src/models/image_model.py:15-171): one model for every rate, a
scalar q_scale (rounded to 1/100 in the stream header), gaussian
y-latents. It codes on ``EvcCodecRuntime``, as in the JAX registry, and
shares the EVC codecs' dual-prior machinery (``evc.DualPriorCodec``).
Child names are the reference's (``port_hem.convert_intra_hem``):
``enc``, ``dec``, ``refine.0`` (UNet) / ``refine.1`` (conv),
``hyper_enc``, ``hyper_dec``, ``y_prior_fusion``, ``y_spatial_prior``,
``bit_estimator_z``, ``q_basic`` (1, N, 1, 1), ``q_scale`` (4, 1, 1, 1).
``dtype`` (None = f32, or ``torch.bfloat16``) reaches every network, as
``IntraNoARHem(dtype=...)`` gives it; parameters stay f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..device import resolve_device
from ..entropy.bit_estimator import BitEstimator
from ..layers.blocks import conv
from .evc import DualPriorCodec
from .hem_common import Conv3Stack, HemDecoder, HemEncoder, HemHyperDec, HemUNet
from .video_net import HyperEnc

# the JAX init of q_scale (intra_hem.py:49-53), not ones
Q_SCALE_INIT = (1.541, 1.083, 0.729, 0.500)


class IntraNoARHem(DualPriorCodec):
    def __init__(self, N: int = 192, anchor_num: int = 4, dtype=None):
        super().__init__()
        self.N = N
        self.enc = HemEncoder(3, N, dtype)
        self.dec = HemDecoder(N, 16, dtype)
        self.refine = nn.Sequential(HemUNet(16, 16, dtype),
                                    conv(16, 3, 3, dtype=dtype))
        self.hyper_enc = HyperEnc(N, N, dtype)
        self.hyper_dec = HemHyperDec(N, N, dtype)
        self.y_prior_fusion = Conv3Stack(N * 2, (N * 3, N * 3, N * 3), dtype)
        self.y_spatial_prior = Conv3Stack(N * 4, (N * 3, N * 3, N * 2), dtype)
        self.bit_estimator_z = BitEstimator(N)
        self.q_basic = nn.Parameter(torch.ones(1, N, 1, 1))
        self.q_scale = nn.Parameter(
            torch.tensor(Q_SCALE_INIT).view(anchor_num, 1, 1, 1))

    def reconstruct(self, y):
        return self.refine(self.dec(y))


def build_intra_hem(N: int = 192, seed: int = 0, device=None,
                    dtype=None) -> IntraNoARHem:
    """IntraNoARHem with seeded random weights (the same for any
    ``dtype``), on ``device`` (the card unless ``device="cpu"``), in eval
    mode."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = IntraNoARHem(N, dtype=dtype)
    return module.to(dev).eval()
