"""Differentiable bit-cost estimators (the estimated-bits forward path).

Counterpart of ``dcvc_tpu/entropy/bits.py`` (parity target:
CompressionModel.get_y_gaussian_bits / get_y_laplace_bits / get_z_bits,
reference DCVC-DC/src/models/common_model.py:39-61). Any layout.
"""

import math

import torch

_LOG2 = math.log(2.0)


def probs_to_bits(probs: torch.Tensor) -> torch.Tensor:
    bits = -torch.log(probs + 1e-5) / _LOG2
    return torch.clamp_min(bits, 0.0)


def laplace_cdf(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return 0.5 - 0.5 * torch.sign(x) * torch.expm1(-torch.abs(x) / scale)


def gaussian_cdf(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.special.ndtr((x / scale).float()).to(x.dtype)


def y_laplace_bits(y: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Bits for residual y under a zero-mean Laplace with scale sigma."""
    sigma = torch.clamp(sigma, 1e-5, 1e10)
    probs = laplace_cdf(y + 0.5, sigma) - laplace_cdf(y - 0.5, sigma)
    return probs_to_bits(probs)


def y_gaussian_bits(y: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Bits for residual y under a zero-mean Gaussian with std sigma."""
    sigma = torch.clamp(sigma, 1e-5, 1e10)
    probs = gaussian_cdf(y + 0.5, sigma) - gaussian_cdf(y - 0.5, sigma)
    return probs_to_bits(probs)


def z_bits(z: torch.Tensor, cdf_fn) -> torch.Tensor:
    """Bits for hyper-latent z under a learned factorized prior ``cdf_fn``."""
    probs = cdf_fn(z + 0.5) - cdf_fn(z - 0.5)
    return probs_to_bits(probs)
