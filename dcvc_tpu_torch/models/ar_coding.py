"""Wavefront autoregressive entropy coding (gen-1 DCVC, the zoo's joint
models).

Counterpart of ``dcvc_tpu/models/ar_coding.py``. The reference decodes a
pixel-AR latent with a per-pixel Python double loop (DCVC/src/models/
DCVC_net.py:257-328). With a type-A 5x5 causal mask, pixel (h, w) depends
only on pixels before it in raster order within the kernel's reach, so
pixel (h, w) is coded at wavefront t = 3h + w: its deepest dependency,
(h - 1, w + 2), lands at t - 1. All pixels of a wavefront are coded
together, 3H + W steps in place of H * W, and symbols are written in
wavefront order (the JAX package's stream format, not the reference's
raster order).

The loop runs on the host in float64 numpy, as in the JAX package (the
rANS decoder is on the host), so both packages compute the same contexts,
scales and symbols bit for bit on the same host.
"""

from __future__ import annotations

import numpy as np


def masked_conv_mask_a(kernel: int = 5) -> np.ndarray:
    """Type-A causal mask [kh, kw]: strictly before the centre in raster
    order."""
    m = np.zeros((kernel, kernel), np.float32)
    c = kernel // 2
    m[:c, :] = 1
    m[c, :c] = 1
    return m


def wavefronts(H: int, W: int, reach: int = 2):
    """The (h, w) pixels of each wavefront t = (reach + 1) * h + w."""
    k = reach + 1
    for t in range(k * (H - 1) + W):
        pixels = []
        h0 = max(0, (t - W + 1 + k - 1) // k)
        for h in range(h0, min(H, t // k + 1)):
            w = t - k * h
            if 0 <= w < W:
                pixels.append((h, w))
        if pixels:
            yield np.asarray(pixels, dtype=np.int64)


class ArNets:
    """Host weights of the AR context model and the entropy-parameter net.

    ctx_w: the masked conv's kernel [kh, kw, C, 2C] (HWIO; the mask is
    applied here), ctx_b: [2C]; ep_ws / ep_bs: 1x1 conv weights [Cin, Cout]
    and biases, LeakyReLU (slope ``ep_slope``) between layers.
    ``means_first``: the entropy parameters split as (means, scales)
    (gen-1) or (scales, means) (the zoo).
    """

    def __init__(self, ctx_w, ctx_b, ep_ws, ep_bs, ep_slope: float = 0.01,
                 means_first: bool = True):
        self.means_first = means_first
        mask = masked_conv_mask_a(ctx_w.shape[0])[:, :, None, None]
        self.kernel = ctx_w.shape[0]
        self.ctx_w = (np.asarray(ctx_w, np.float64) * mask).reshape(
            -1, ctx_w.shape[-1])  # [(kh * kw * C), 2C]
        self.ctx_b = np.asarray(ctx_b, np.float64)
        self.ep_ws = [np.asarray(w, np.float64) for w in ep_ws]
        self.ep_bs = [np.asarray(b, np.float64) for b in ep_bs]
        self.ep_slope = ep_slope

    @classmethod
    def from_modules(cls, masked_conv, entropy_parameters,
                     means_first: bool = True) -> "ArNets":
        """From a port ``MaskedConv2d`` and the Sequential of three 1x1
        convs (keys 0, 2, 4) that follows it."""
        def host(t):
            return t.detach().float().cpu().numpy()

        convs = [entropy_parameters[i] for i in (0, 2, 4)]
        return cls(host(masked_conv.weight).transpose(2, 3, 1, 0),
                   host(masked_conv.bias),
                   [host(c.weight)[:, :, 0, 0].T for c in convs],
                   [host(c.bias) for c in convs], means_first=means_first)

    def entropy_params(self, feats: np.ndarray) -> np.ndarray:
        x = feats
        for i, (w, b) in enumerate(zip(self.ep_ws, self.ep_bs)):
            x = x @ w + b
            if i + 1 < len(self.ep_ws):
                x = np.where(x >= 0, x, self.ep_slope * x)
        return x

    def split(self, gp: np.ndarray):
        """-> (means, scales)."""
        a, b = np.split(gp, 2, axis=-1)
        return (a, b) if self.means_first else (b, a)


def _gather_windows(y_hat_pad: np.ndarray, pixels: np.ndarray, k: int):
    """y_hat_pad [H + 2p, W + 2p, C] -> the [n, k * k * C] context windows
    whose top-left corners are ``pixels``."""
    r = np.arange(k)
    rows = pixels[:, 0, None, None] + r[None, :, None]
    cols = pixels[:, 1, None, None] + r[None, None, :]
    return y_hat_pad[rows, cols].reshape(pixels.shape[0], -1)


def _wavefront_params(y_hat_pad, pixels, hyper_params, nets: ArNets, k: int):
    ctx = _gather_windows(y_hat_pad, pixels, k) @ nets.ctx_w + nets.ctx_b
    hp = hyper_params[pixels[:, 0], pixels[:, 1]]
    return nets.split(nets.entropy_params(np.concatenate([hp, ctx], axis=-1)))


def ar_encode(y: np.ndarray, hyper_params: np.ndarray, nets: ArNets,
              gaussian, coder) -> np.ndarray:
    """Wavefront AR encode of host arrays y [H, W, C] and hyper_params
    [H, W, C*]: per wavefront the context matmul, the entropy parameters,
    the symbols round(y - means) appended in wavefront order. Returns
    y_hat [H, W, C] (float64)."""
    H, W, C = y.shape
    k = nets.kernel
    p = k // 2
    y = y.astype(np.float64)
    y_hat_pad = np.zeros((H + 2 * p, W + 2 * p, C), np.float64)
    hyper_params = hyper_params.astype(np.float64)

    all_syms, all_idx = [], []
    for pixels in wavefronts(H, W, p):
        means, scales = _wavefront_params(y_hat_pad, pixels, hyper_params,
                                          nets, k)
        y_q = np.round(y[pixels[:, 0], pixels[:, 1]] - means)
        y_hat_pad[pixels[:, 0] + p, pixels[:, 1] + p] = y_q + means
        all_syms.append(y_q.reshape(-1))
        all_idx.append(gaussian.build_indexes_np(scales).reshape(-1))

    coder.encode_with_indexes(
        np.concatenate(all_syms), np.concatenate(all_idx), gaussian.table)
    return y_hat_pad[p:H + p, p:W + p]


def ar_decode(shape_hwc, hyper_params: np.ndarray, nets: ArNets,
              gaussian, coder) -> np.ndarray:
    """Wavefront AR decode; mirrors ``ar_encode``'s symbol order exactly
    (one rANS call per wavefront)."""
    H, W, C = shape_hwc
    k = nets.kernel
    p = k // 2
    y_hat_pad = np.zeros((H + 2 * p, W + 2 * p, C), np.float64)
    hyper_params = hyper_params.astype(np.float64)

    for pixels in wavefronts(H, W, p):
        means, scales = _wavefront_params(y_hat_pad, pixels, hyper_params,
                                          nets, k)
        idx = gaussian.build_indexes_np(scales)
        y_q = coder.decode_stream(idx.reshape(-1), gaussian.table)
        y_q = y_q.reshape(means.shape).astype(np.float64)
        y_hat_pad[pixels[:, 0] + p, pixels[:, 1] + p] = y_q + means
    return y_hat_pad[p:H + p, p:W + p]
