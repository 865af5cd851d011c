"""Generalized Divisive Normalization (the TCM, gen-1 and zoo codecs).

Counterpart of ``dcvc_tpu/layers/gdn.py`` (parity target:
DCVC-TCM/src/layers/gdn.py:22-96 with CompressAI's NonNegativeParametrizer,
DCVC-TCM/src/ops/parametrizers.py:21): ``beta`` and ``gamma`` are stored as
sqrt(value + pedestal) and lower-bounded on use, so published checkpoints
load as they are. The ``einsum("bhwc,oc->bhwo", x * x, gamma)`` of the JAX
version is a 1x1 convolution here, as in the reference.

GDN has no compute dtype of its own, as in the JAX package: ``x * x`` (or
``|x|``) is taken in the input's dtype, rounded there, and the product with
the f32 ``gamma`` widens it, so a bf16 input gives an f32 output.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.math import lower_bound

PEDESTAL = 2.0 ** -18


def _reparam_get(param: torch.Tensor, minimum: float) -> torch.Tensor:
    bound = (minimum + PEDESTAL) ** 0.5
    return lower_bound(param, bound) ** 2 - PEDESTAL


class GDN(nn.Module):
    """y = x / sqrt(beta + gamma * x^2) (``inverse``: times the sqrt)."""

    squared = True

    def __init__(self, channels: int, inverse: bool = False,
                 beta_min: float = 1e-6, gamma_init: float = 0.1):
        super().__init__()
        self.inverse = inverse
        self.beta_min = beta_min
        self.beta = nn.Parameter(torch.full((channels,), (1.0 + PEDESTAL) ** 0.5))
        self.gamma = nn.Parameter(torch.sqrt(
            gamma_init * torch.eye(channels) + PEDESTAL))

    def forward(self, x):
        C = self.gamma.shape[0]
        beta = _reparam_get(self.beta, self.beta_min)
        gamma = _reparam_get(self.gamma, 0.0).view(C, C, 1, 1)
        if self.squared:
            norm = torch.sqrt(F.conv2d((x * x).to(gamma.dtype), gamma, beta))
        else:
            norm = F.conv2d(torch.abs(x).to(gamma.dtype), gamma, beta)
        return x * norm if self.inverse else x / norm


class GDN1(GDN):
    """Simplified GDN: |x| in place of x^2, no sqrt."""

    squared = False
