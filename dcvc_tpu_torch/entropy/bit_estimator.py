"""Learned factorized prior over hyper-latents (BitEstimator).

Counterpart of ``dcvc_tpu/entropy/bit_estimator.py`` (parity target:
Bitparm / BitEstimator, reference DCVC-DC/src/models/entropy_models.py:
58-200): four stacked monotone layers ``x * softplus(h) + b (+ tanh(x) *
tanh(a))`` with a sigmoid CDF head, keeping the reference's parameter names
and (1, C, 1, 1) shapes, plus the table bake of ``update()``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.rans import pmf_to_quantized_cdf
from . import _xla_f32 as xf
from .coder import CdfTable, EntropyCoder


class Bitparm(nn.Module):
    def __init__(self, channel: int, final: bool = False):
        super().__init__()
        self.final = final
        self.h = nn.Parameter(torch.empty(1, channel, 1, 1).normal_(0, 0.01))
        self.b = nn.Parameter(torch.empty(1, channel, 1, 1).normal_(0, 0.01))
        if not final:
            self.a = nn.Parameter(torch.empty(1, channel, 1, 1).normal_(0, 0.01))

    def forward(self, x):
        x = x * F.softplus(self.h) + self.b
        if self.final:
            return x
        return x + torch.tanh(x) * torch.tanh(self.a)


class BitEstimator(nn.Module):
    """CDF of a per-channel learned univariate density, NCHW input."""

    def __init__(self, channel: int):
        super().__init__()
        self.f1 = Bitparm(channel)
        self.f2 = Bitparm(channel)
        self.f3 = Bitparm(channel)
        self.f4 = Bitparm(channel, True)
        self.channel = channel

    def forward(self, x):
        return torch.sigmoid(self.f4(self.f3(self.f2(self.f1(x)))))


def _cdf_channelwise(layers, samples: np.ndarray) -> np.ndarray:
    """CDF at ``samples`` [C, L] (f32); ``layers`` is [(h, b, a|None)] of
    [C] f32 arrays. Op by op as the JAX package evaluates it, with XLA:CPU's
    f32 softplus / tanh / sigmoid (see _xla_f32)."""
    x = samples
    for h, b, a in layers:
        x = x * xf.softplus(h)[:, None] + b[:, None]
        if a is not None:
            x = x + xf.tanh(x) * xf.tanh(a)[:, None]
    return xf.sigmoid(x)


def build_factorized_tables(est: BitEstimator, precision: int = 16) -> CdfTable:
    """Bake quantized CDF tables (the reference's update()), on the host.

    The CDF is evaluated in f32 exactly as the JAX package evaluates it and
    the pmf is taken to float64 before quantization, so the tables are
    byte-identical to ``dcvc_tpu``'s for the same parameters. Support scan
    (entropy_models.py:124-178): minima_c = smallest i in [2, 50] with
    CDF(-i) < 1e-4 (else 50), maxima_c likewise with CDF(i) > 0.9999."""
    def leaf(p):
        return p.detach().float().cpu().numpy().reshape(-1)

    layers = [(leaf(f.h), leaf(f.b), None if f.final else leaf(f.a))
              for f in (est.f1, est.f2, est.f3, est.f4)]
    C = est.channel
    iis = np.arange(2, 51, dtype=np.float32)
    grid = np.broadcast_to(iis[None, :], (C, 49))
    neg = _cdf_channelwise(layers, -grid)
    pos = _cdf_channelwise(layers, grid)
    big = np.float32(50.0)
    minima = np.where(neg < np.float32(1e-4), grid, big).min(axis=1).astype(np.int32)
    maxima = np.where(pos > np.float32(0.9999), grid, big).min(axis=1).astype(np.int32)

    offset = -minima
    pmf_length = maxima + minima + 1
    max_length = int(pmf_length.max())
    samples = (np.arange(max_length, dtype=np.float32)[None, :]
               - minima.astype(np.float32)[:, None])
    lower = _cdf_channelwise(layers, samples - np.float32(0.5))
    upper = _cdf_channelwise(layers, samples + np.float32(0.5))
    pmf = (upper - lower).astype(np.float64)
    tail = (lower[:, :1] + (np.float32(1.0) - upper[:, -1:])).astype(np.float64)

    quantized = np.zeros((C, max_length + 2), dtype=np.int32)
    for c in range(C):
        n = int(pmf_length[c])
        prob = np.concatenate([pmf[c, :n], tail[c]]).astype(np.float32)
        cdf = pmf_to_quantized_cdf(prob, precision)
        quantized[c, : cdf.size] = cdf
    return CdfTable(quantized_cdf=quantized,
                    cdf_length=(pmf_length + 2).astype(np.int32),
                    offset=offset.astype(np.int32))


def factorized_indexes(shape_nhwc) -> np.ndarray:
    """Per-element cdf index = channel id, in the stream's NHWC order."""
    n, h, w, c = shape_nhwc
    idx = np.arange(c, dtype=np.int16).reshape(1, 1, 1, c)
    return np.broadcast_to(idx, (n, h, w, c))


def encode_factorized(coder: EntropyCoder, z_nhwc: np.ndarray, table: CdfTable):
    z = np.asarray(z_nhwc)
    coder.encode_with_indexes(z.reshape(-1),
                              factorized_indexes(z.shape).reshape(-1), table)


def decode_factorized(coder: EntropyCoder, shape_nhwc, table: CdfTable) -> np.ndarray:
    idx = factorized_indexes(shape_nhwc)
    out = coder.decode_stream(idx.reshape(-1), table)
    return out.reshape(shape_nhwc).astype(np.float32)
