"""GaussianConditional: the CompressAI scale-table conditional Gaussian.

Counterpart of ``dcvc_tpu/entropy/gaussian_conditional.py`` (parity
target: the vendored GaussianConditional, DCVC-TCM/src/entropy_models/
entropy_models.py:395-500): a 64-entry log-spaced scale table in [0.11,
256] baked with ``scipy.stats.norm``, lower-bounded scales, mean-offset
symbols. The zoo codes its y-latents with it; the newer generations use
the 256-level ``gaussian.GaussianConditionalCoder``. Host numpy only, so
the tables and indexes are the JAX package's bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.stats import norm as _norm

from ..ops.rans import pmf_to_quantized_cdf
from .coder import CdfTable, EntropyCoder

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64


def default_scale_table() -> np.ndarray:
    return np.exp(np.linspace(math.log(SCALES_MIN), math.log(SCALES_MAX),
                              SCALES_LEVELS))


class GaussianConditional:
    def __init__(self, scale_table=None, tail_mass: float = 1e-9):
        self.scale_table = (np.asarray(scale_table) if scale_table is not None
                            else default_scale_table())
        self.tail_mass = tail_mass
        self.table: CdfTable | None = None

    def update(self, force: bool = False, precision: int = 16):
        if self.table is not None and not force:
            return
        multiplier = -_norm.ppf(self.tail_mass / 2)
        pmf_center = np.ceil(self.scale_table * multiplier).astype(np.int32)
        pmf_length = 2 * pmf_center + 1
        max_length = int(pmf_length.max())

        samples = np.abs(np.arange(max_length)[None, :] - pmf_center[:, None])
        upper = _norm.cdf((0.5 - samples) / self.scale_table[:, None])
        lower = _norm.cdf((-0.5 - samples) / self.scale_table[:, None])
        pmf = upper - lower
        tail = 2 * lower[:, :1]

        S = self.scale_table.size
        quantized = np.zeros((S, max_length + 2), dtype=np.int32)
        for s in range(S):
            n = int(pmf_length[s])
            prob = np.concatenate([pmf[s, :n], tail[s]]).astype(np.float32)
            cdf = pmf_to_quantized_cdf(prob, precision)
            quantized[s, : cdf.size] = cdf
        self.table = CdfTable(quantized_cdf=quantized,
                              cdf_length=(pmf_length + 2).astype(np.int32),
                              offset=(-pmf_center).astype(np.int32))

    def build_indexes_np(self, scales: np.ndarray) -> np.ndarray:
        """The first table entry >= each (lower-bounded) scale."""
        scales = np.maximum(np.asarray(scales), self.scale_table[0])
        return np.searchsorted(self.scale_table[:-1], scales,
                               side="left").astype(np.int32)

    def encode(self, coder: EntropyCoder, y, scales, means=None):
        """Symbols round(y - means) (or round(y)), NHWC host arrays."""
        y = np.asarray(y)
        symbols = np.round(y - means) if means is not None else np.round(y)
        idx = self.build_indexes_np(scales)
        coder.encode_with_indexes(symbols.reshape(-1), idx.reshape(-1),
                                  self.table)

    def decode(self, coder: EntropyCoder, scales, means=None) -> np.ndarray:
        idx = self.build_indexes_np(scales)
        out = coder.decode_stream(idx.reshape(-1), self.table)
        out = out.reshape(idx.shape).astype(np.float32)
        return out + means if means is not None else out
