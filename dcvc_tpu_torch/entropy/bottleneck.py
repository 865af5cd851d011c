"""EntropyBottleneck: a learned univariate density with quantile anchors.

Counterpart of ``dcvc_tpu/entropy/bottleneck.py`` (parity target: the
CompressAI EntropyBottleneck vendored by the reference,
DCVC-TCM/src/entropy_models/entropy_models.py:212-394): a stacked monotone
MLP CDF per channel (filters (3, 3, 3, 3)), learned quantiles, median-offset
quantization and baked CDF tables. Parameter names are the reference's
(``_matrices.{i}``, ``_biases.{i}``, ``_factors.{i}``, ``quantiles``), so a
published ``state_dict`` loads once its baked buffers are dropped.

The zoo codes its z (and the factorized model its y) with it. The table
bake evaluates the CDF on the host with XLA:CPU's f32 softplus / tanh and
its batched matmul (``_xla_f32``), so the tables are the JAX package's byte
for byte.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.rans import pmf_to_quantized_cdf
from . import _xla_f32 as xf
from .coder import CdfTable, EntropyCoder


class EntropyBottleneck(nn.Module):
    def __init__(self, channels: int, filters=(3, 3, 3, 3),
                 init_scale: float = 10.0):
        super().__init__()
        self.channels = channels
        self.filters = tuple(filters)
        dims = (1,) + self.filters + (1,)
        scale = init_scale ** (1 / (len(self.filters) + 1))
        self._matrices = nn.ParameterList()
        self._biases = nn.ParameterList()
        self._factors = nn.ParameterList()
        for i in range(len(self.filters) + 1):
            init = math.log(math.expm1(1 / scale / dims[i + 1]))
            self._matrices.append(nn.Parameter(
                torch.full((channels, dims[i + 1], dims[i]), init)))
            self._biases.append(nn.Parameter(
                torch.empty(channels, dims[i + 1], 1).uniform_(-0.5, 0.5)))
            if i < len(self.filters):
                self._factors.append(nn.Parameter(
                    torch.zeros(channels, dims[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.tensor(
            [[[-init_scale, 0.0, init_scale]]]).repeat(channels, 1, 1))

    def logits_cumulative(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs [C, 1, N] -> logits [C, 1, N]."""
        logits = inputs
        for i, (m, b) in enumerate(zip(self._matrices, self._biases)):
            logits = torch.matmul(F.softplus(m), logits) + b
            if i < len(self._factors):
                logits = logits + torch.tanh(self._factors[i]) * torch.tanh(logits)
        return logits

    def medians(self) -> torch.Tensor:
        return self.quantiles[:, 0, 1]

    def likelihood(self, x: torch.Tensor) -> torch.Tensor:
        """Per-element probability of the quantized values ``x`` (NCHW;
        the caller takes the medians off, as the JAX package does)."""
        B, C, H, W = x.shape
        v = x.transpose(0, 1).reshape(C, 1, -1)
        lower = self.logits_cumulative(v - 0.5)
        upper = self.logits_cumulative(v + 0.5)
        sign = -torch.sign(lower + upper).detach()
        lik = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
        return lik.reshape(C, B, H, W).transpose(0, 1)

    def forward(self, x, quant):
        """(x_hat, likelihood) with ``quant`` the recon-path quantizer."""
        medians = self.medians().view(1, -1, 1, 1)
        x_hat = quant(x - medians) + medians
        return x_hat, self.likelihood(x_hat - medians)


def _logits_host(layers, v: np.ndarray) -> np.ndarray:
    """``logits_cumulative`` as the JAX package evaluates it eagerly on
    XLA:CPU: each op rounded to f32 on its own."""
    logits = v
    for m, b, f in layers:
        logits = xf.batched_matmul(xf.softplus(m), logits) + b
        if f is not None:
            logits = logits + xf.tanh(f) * xf.tanh(logits)
    return logits


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def build_bottleneck_tables(eb: EntropyBottleneck,
                            precision: int = 16) -> CdfTable:
    """Bake quantized CDF tables (the reference's ``update()``), on the
    host, byte-identical to ``dcvc_tpu``'s for the same parameters."""
    def leaf(p):
        return p.detach().float().cpu().numpy()

    factors = [leaf(f) for f in eb._factors] + [None]
    layers = [(leaf(m), leaf(b), f) for m, b, f in
              zip(eb._matrices, eb._biases, factors)]
    quantiles = leaf(eb.quantiles)
    q = quantiles[:, 0, 1]
    minima = np.ceil(q - quantiles[:, 0, 0]).astype(np.int32)
    maxima = np.ceil(quantiles[:, 0, 2] - q).astype(np.int32)
    minima = np.maximum(minima, 0)
    maxima = np.maximum(maxima, 0)

    offset = -minima
    pmf_length = maxima + minima + 1
    max_length = int(pmf_length.max())
    C = q.shape[0]

    # float64 sample positions rounded once to f32, as jnp.asarray does
    samples = (np.arange(max_length, dtype=np.float32)[None, :]
               - minima[:, None] + q[:, None])
    v = samples.reshape(C, 1, -1).astype(np.float32)
    lower = _logits_host(layers, v - np.float32(0.5)).reshape(C, -1)
    upper = _logits_host(layers, v + np.float32(0.5)).reshape(C, -1)
    sign = -np.sign(lower + upper)
    pmf = np.abs(_sigmoid(sign * upper) - _sigmoid(sign * lower))
    tail = (_sigmoid(lower[np.arange(C), 0])
            + _sigmoid(-upper[np.arange(C), pmf_length - 1]))

    quantized = np.zeros((C, max_length + 2), dtype=np.int32)
    for c in range(C):
        n = int(pmf_length[c])
        prob = np.concatenate([pmf[c, :n], [tail[c]]]).astype(np.float32)
        cdf = pmf_to_quantized_cdf(prob, precision)
        quantized[c, : cdf.size] = cdf
    return CdfTable(quantized_cdf=quantized,
                    cdf_length=(pmf_length + 2).astype(np.int32),
                    offset=offset.astype(np.int32))


def bottleneck_encode(coder: EntropyCoder, z: np.ndarray, medians: np.ndarray,
                      table: CdfTable):
    """Symbols round(z - medians) of an NHWC host plane, indexed by channel."""
    z = np.asarray(z)
    symbols = np.round(z - medians.reshape(1, 1, 1, -1))
    idx = np.broadcast_to(np.arange(z.shape[-1], dtype=np.int16), z.shape)
    coder.encode_with_indexes(symbols.reshape(-1), idx.reshape(-1), table)


def bottleneck_decode(coder: EntropyCoder, shape_nhwc, medians: np.ndarray,
                      table: CdfTable) -> np.ndarray:
    idx = np.broadcast_to(np.arange(shape_nhwc[-1], dtype=np.int16),
                          shape_nhwc)
    out = coder.decode_stream(idx.reshape(-1), table).reshape(shape_nhwc)
    return out.astype(np.float32) + medians.reshape(1, 1, 1, -1)
