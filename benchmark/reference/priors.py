"""Plain spatial priors: the four-part quad-tree prior of DCVC-DC
(common_model.py:88-321) and the dual-part checkerboard prior of EVC
(EVC common_model.py:58-164), encoder side. ``torch.round`` rounds half to
even. The decoder derives the same y_hat from the decoded symbols, so the
encoder's y_hat is what a correct decoder reconstructs from; given a
decoder's symbols (``symbols.Symbols``), y_hat is built from them.
"""

from __future__ import annotations

import math

import torch

FOUR_PART_PERM = ((0, 1, 2, 3), (3, 2, 1, 0), (2, 3, 0, 1), (1, 0, 3, 2))


class _STE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def quant(x, mode="round"):
    """Hard rounding, or rounding with a straight-through gradient."""
    return _STE.apply(x) if mode == "ste" else torch.round(x)


def phase_masks(ref):
    H, W = ref.shape[2], ref.shape[3]
    rows = torch.arange(H, device=ref.device) % 2
    cols = torch.arange(W, device=ref.device) % 2
    return [((rows[:, None] == p // 2) & (cols[None, :] == p % 2))
            .to(ref.dtype)[None, None] for p in range(4)]


def checkerboards(ref):
    H, W = ref.shape[2], ref.shape[3]
    hw = (torch.arange(H, device=ref.device)[:, None]
          + torch.arange(W, device=ref.device)[None, :]) % 2
    return ((hw == 0).to(ref.dtype)[None, None],
            (hw == 1).to(ref.dtype)[None, None])


def _masked(y, scales, means, mask, mode, q=None):
    """(y_res, y_q, y_hat, scales_hat) at ``mask``; ``q``: the step's
    symbol plane, where the symbols are given rather than rounded."""
    scales_hat = scales * mask
    means_hat = means * mask
    y_res = (y - means_hat) * mask
    y_q = quant(y_res, mode) if q is None else q * mask
    return y_res, y_q, y_q + means_hat, scales_hat


def _plane(y_parts, means_parts, masks) -> torch.Tensor:
    """A step's residual plane: part ``c``'s residuals at ``masks[c]``
    (the masks are disjoint)."""
    return sum((y - m * k) * k for y, m, k in zip(y_parts, means_parts,
                                                  masks))


def four_part(y, params, spatial_fns, mode="round", sym=None, name="y"):
    """(y_res, y_q, y_hat, scales_hat) of latent ``y`` under the four-part
    prior with common parameters ``params``; ``spatial_fns`` maps steps
    1..3 to callables from cat(y_hat so far, params) to 8 chunks. With
    ``sym`` (``symbols.Symbols``) step ``s`` takes its symbols from plane
    ``<name><s>``."""
    quant_step, scales, means = params.chunk(3, dim=1)
    masks = phase_masks(y)
    quant_step = torch.clamp_min(quant_step, 0.5)
    y = y / quant_step
    y_parts = y.chunk(4, dim=1)
    scales_parts = scales.chunk(4, dim=1)
    means_parts = means.chunk(4, dim=1)
    acc = [[0.0] * 4 for _ in range(4)]     # y_res, y_q, y_hat, scales_hat
    so_far = None
    for step, perm in enumerate(FOUR_PART_PERM):
        if step > 0:
            chunks = spatial_fns[step - 1](torch.cat([so_far, params], dim=1))
            scales_parts, means_parts = chunks[:4], chunks[4:]
        q = None
        if sym is not None:
            q = sym.round(f"{name}{step}", _plane(
                y_parts, means_parts, [masks[p] for p in perm]))
        hats = []
        for c in range(4):
            out = _masked(y_parts[c], scales_parts[c], means_parts[c],
                          masks[perm[c]], mode, q)
            for k in range(4):
                acc[k][c] = acc[k][c] + out[k]
            hats.append(out[2])
        cat = torch.cat(hats, dim=1)
        so_far = cat if so_far is None else so_far + cat
    y_res, y_q, y_hat, scales_hat = (torch.cat(a, dim=1) for a in acc)
    return y_res, y_q, y_hat * quant_step, scales_hat


def dual_part(y, means, scales, quant_step, spatial_fn, mode="round",
              sym=None, name="y"):
    """(y_res, y_q, y_hat, scales_hat) under the dual checkerboard prior;
    ``sym`` as in ``four_part`` (planes ``<name>0``, ``<name>1``)."""
    mask_0, mask_1 = checkerboards(y)
    quant_step = torch.clamp_min(quant_step, 0.5)
    y = y / quant_step
    y_0, y_1 = y.chunk(2, dim=1)
    scales_0, scales_1 = scales.chunk(2, dim=1)
    means_0, means_1 = means.chunk(2, dim=1)
    q = None
    if sym is not None:
        q = sym.round(f"{name}0", _plane((y_0, y_1), (means_0, means_1),
                                         (mask_0, mask_1)))
    r00, q00, h00, s00 = _masked(y_0, scales_0, means_0, mask_0, mode, q)
    r11, q11, h11, s11 = _masked(y_1, scales_1, means_1, mask_1, mode, q)
    params = torch.cat([h00, h11, means, scales, quant_step.expand_as(means)],
                       dim=1)
    scales_0, means_0, scales_1, means_1 = spatial_fn(params)
    if sym is not None:
        q = sym.round(f"{name}1", _plane((y_0, y_1), (means_0, means_1),
                                         (mask_1, mask_0)))
    r01, q01, h01, s01 = _masked(y_0, scales_0, means_0, mask_1, mode, q)
    r10, q10, h10, s10 = _masked(y_1, scales_1, means_1, mask_0, mode, q)
    y_hat = torch.cat([h00 + h01, h11 + h10], dim=1) * quant_step
    return (torch.cat([r00 + r01, r11 + r10], dim=1),
            torch.cat([q00 + q01, q11 + q10], dim=1), y_hat,
            torch.cat([s00 + s01, s11 + s10], dim=1))


# estimated bits (DCVC-DC common_model.py:39-61)

_LOG2 = math.log(2.0)


def _bits(probs):
    return torch.clamp_min(-torch.log(probs + 1e-5) / _LOG2, 0.0)


def laplace_bits(y, sigma):
    sigma = torch.clamp(sigma, 1e-5, 1e10)

    def cdf(v):
        return 0.5 - 0.5 * torch.sign(v) * torch.expm1(-torch.abs(v) / sigma)

    return _bits(cdf(y + 0.5) - cdf(y - 0.5))


def gaussian_bits(y, sigma):
    sigma = torch.clamp(sigma, 1e-5, 1e10)

    def cdf(v):
        return torch.special.ndtr(v / sigma)

    return _bits(cdf(y + 0.5) - cdf(y - 0.5))


def z_bits(z, cdf_fn):
    return _bits(cdf_fn(z + 0.5) - cdf_fn(z - 0.5))
