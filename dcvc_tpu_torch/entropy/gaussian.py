"""Scale-indexed Gaussian/Laplace conditional coder for y-latents.

Counterpart of ``dcvc_tpu/entropy/gaussian.py`` (parity target:
GaussianEncoder, reference DCVC-DC/src/models/entropy_models.py:203-285): a
256-entry log-spaced scale table (laplace scales in [0.01, 64], gaussian in
[0.11, 64]), per-scale symmetric pmfs baked to quantized CDFs in float64
(byte-identical to the JAX package's tables), and ``build_indexes``, the
log-scale bucketing, on the device so only int16 planes reach the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
from scipy.stats import norm as _scipy_norm

from ..ops.rans import pmf_to_quantized_cdf
from .coder import CdfTable, EntropyCoder


def _laplace_cdf(x: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return 0.5 - 0.5 * np.sign(x) * np.expm1(-np.abs(x) / scale)


def _gaussian_cdf(x: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return _scipy_norm.cdf(x / scale)


@dataclass
class GaussianConditionalCoder:
    distribution: str = "laplace"
    scale_level: int = 256
    scale_max: float = 64.0
    scale_min: float = field(init=False)
    log_scale_min: float = field(init=False)
    log_scale_step: float = field(init=False)
    table: CdfTable | None = field(init=False, default=None)

    def __post_init__(self):
        if self.distribution not in ("laplace", "gaussian"):
            raise ValueError(f"unknown distribution {self.distribution!r}")
        self.scale_min = 0.01 if self.distribution == "laplace" else 0.11
        self.log_scale_min = math.log(self.scale_min)
        self.log_scale_step = (math.log(self.scale_max) - self.log_scale_min) / (
            self.scale_level - 1)

    @property
    def scale_table(self) -> np.ndarray:
        return np.exp(np.linspace(self.log_scale_min, math.log(self.scale_max),
                                  self.scale_level))

    def update(self, force: bool = False, precision: int = 16):
        if self.table is not None and not force:
            return
        scales = self.scale_table  # [S]
        cdf_fn = _laplace_cdf if self.distribution == "laplace" else _gaussian_cdf

        # per-scale symmetric support: smallest i in [2, 50] with CDF(i) > 0.9999
        iis = np.arange(2, 51, dtype=np.float64)
        probs = cdf_fn(iis[None, :], scales[:, None])  # [S, 49]
        hit = probs > 0.9999
        pmf_center = np.where(hit.any(axis=1),
                              iis[np.argmax(hit, axis=1).clip(0)],
                              50.0).astype(np.int32)

        pmf_length = 2 * pmf_center + 1
        max_length = int(pmf_length.max())
        samples = (np.arange(max_length, dtype=np.float64)[None, :]
                   - pmf_center[:, None])  # [S, L]
        upper = cdf_fn(samples + 0.5, scales[:, None])
        lower = cdf_fn(samples - 0.5, scales[:, None])
        pmf = upper - lower
        tail = 2.0 * lower[:, :1]

        quantized = np.zeros((self.scale_level, max_length + 2), dtype=np.int32)
        for s in range(self.scale_level):
            n = int(pmf_length[s])
            prob = np.concatenate([pmf[s, :n], tail[s]]).astype(np.float32)
            cdf = pmf_to_quantized_cdf(prob, precision)
            quantized[s, : cdf.size] = cdf
        self.table = CdfTable(quantized_cdf=quantized,
                              cdf_length=(pmf_length + 2).astype(np.int32),
                              offset=(-pmf_center).astype(np.int32))

    def build_indexes(self, scales: torch.Tensor) -> torch.Tensor:
        """Log-scale bucket ids as int16, on the scales' device (truncation
        toward zero, as the reference's .int())."""
        s = torch.clamp_min(scales.float(), 1e-5)
        idx = (torch.log(s) - self.log_scale_min) / self.log_scale_step
        return torch.clamp(idx, 0, self.scale_level - 1).to(torch.int16)

    def encode_with_indexes(self, coder: EntropyCoder, y_q, indexes):
        coder.encode_with_indexes(np.asarray(y_q).reshape(-1),
                                  np.asarray(indexes).reshape(-1), self.table)

    def decode_with_indexes(self, coder: EntropyCoder, indexes) -> np.ndarray:
        indexes = np.asarray(indexes)
        out = coder.decode_stream(indexes.reshape(-1), self.table)
        return out.reshape(indexes.shape).astype(np.float32)
