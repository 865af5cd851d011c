"""Four-part quad-tree spatial prior (NCHW, channel splits on dim=1).

Counterpart of ``dcvc_tpu/models/priors.py`` lines 33-195 (parity target:
forward/compress/decompress_four_part_prior, reference
DCVC-DC/src/models/common_model.py:88-321). ``torch.round`` rounds half to
even like ``jnp.round``. The decode path is a set of per-step functions so
the host rANS decoder sits between them.
"""

from __future__ import annotations

import torch

# step s codes channel-quarter c at spatial phase FOUR_PART_PERM[s][c]
FOUR_PART_PERM = (
    (0, 1, 2, 3),
    (3, 2, 1, 0),
    (2, 3, 0, 1),
    (1, 0, 3, 2),
)


def quant_round(x):
    return torch.round(x)


class _QuantSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def quant_ste(x):
    """Round with a straight-through gradient."""
    return _QuantSTE.apply(x)


def resolve_quant(quant_mode: str):
    """Recon-path quantizer for a quant_mode string ("round" | "ste")."""
    if quant_mode == "round":
        return quant_round
    if quant_mode == "ste":
        return quant_ste
    raise NotImplementedError(
        f"quant_mode {quant_mode!r}: training modes wait for a later slice")


def spatial_phase_mask(H: int, W: int, phase: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """[1, 1, H, W] mask selecting the 2x2 micro-phase ``phase`` (row-major)."""
    ph, pw = divmod(phase, 2)
    rows = torch.arange(H, device=device) % 2 == ph
    cols = torch.arange(W, device=device) % 2 == pw
    return (rows[:, None] & cols[None, :]).to(dtype)[None, None]


def _masks(ref: torch.Tensor):
    H, W = ref.shape[2], ref.shape[3]
    return [spatial_phase_mask(H, W, p, ref.dtype, ref.device) for p in range(4)]


def separate_prior(params: torch.Tensor):
    """(quant_step, scales, means) = 3-way channel split."""
    return params.chunk(3, dim=1)


def process_with_mask(y, scales, means, mask, quant):
    scales_hat = scales * mask
    means_hat = means * mask
    y_res = (y - means_hat) * mask
    y_q = quant(y_res)
    y_hat = y_q + means_hat
    return y_res, y_q, y_hat, scales_hat


def forward_four_part_prior(y, common_params, spatial_prior_fns, *,
                            write=False, quant=quant_round):
    """Four sequential (channel-quarter x spatial-phase) coding steps.

    ``spatial_prior_fns`` holds 3 callables (adaptor_i + spatial prior
    CNN), each mapping cat(y_hat_so_far, common_params) to 8 channel
    chunks (scales_0..3, means_0..3). With ``write=True`` returns the
    per-step symbol and scale planes and y_hat."""
    quant_step, scales, means = separate_prior(common_params)
    masks = _masks(y)

    quant_step = torch.clamp_min(quant_step, 0.5)
    y = y / quant_step
    y_parts = y.chunk(4, dim=1)
    scales_parts = scales.chunk(4, dim=1)
    means_parts = means.chunk(4, dim=1)

    y_res_acc = [0.0] * 4
    y_q_acc = [0.0] * 4
    y_hat_acc = [0.0] * 4
    s_hat_acc = [0.0] * 4
    write_q, write_s = [], []

    y_hat_so_far = None
    for step, perm in enumerate(FOUR_PART_PERM):
        if step > 0:
            params = torch.cat([y_hat_so_far, common_params], dim=1)
            chunks = spatial_prior_fns[step - 1](params)
            scales_parts, means_parts = chunks[:4], chunks[4:]
        step_hats = []
        step_q_plane = 0.0
        step_s_plane = 0.0
        for c in range(4):
            m = masks[perm[c]]
            y_res, y_q, y_hat, s_hat = process_with_mask(
                y_parts[c], scales_parts[c], means_parts[c], m, quant)
            y_res_acc[c] = y_res_acc[c] + y_res
            y_q_acc[c] = y_q_acc[c] + y_q
            y_hat_acc[c] = y_hat_acc[c] + y_hat
            s_hat_acc[c] = s_hat_acc[c] + s_hat
            step_hats.append(y_hat)
            if write:
                step_q_plane = step_q_plane + y_q
                step_s_plane = step_s_plane + s_hat
        step_cat = torch.cat(step_hats, dim=1)
        y_hat_so_far = step_cat if y_hat_so_far is None else y_hat_so_far + step_cat
        if write:
            write_q.append(step_q_plane)
            write_s.append(step_s_plane)

    y_hat = torch.cat(y_hat_acc, dim=1) * quant_step
    if write:
        return write_q, write_s, y_hat
    y_res = torch.cat(y_res_acc, dim=1)
    y_q = torch.cat(y_q_acc, dim=1)
    scales_hat = torch.cat(s_hat_acc, dim=1)
    return y_res, y_q, y_hat, scales_hat


def four_part_decode_scales(common_params, y_hat_so_far, spatial_prior_fns,
                            step: int):
    """Scales plane for decode step ``step`` and that step's means parts."""
    _, scales, means = separate_prior(common_params)
    masks = _masks(common_params)
    if step == 0:
        scales_parts = scales.chunk(4, dim=1)
        means_parts = means.chunk(4, dim=1)
    else:
        params = torch.cat([y_hat_so_far, common_params], dim=1)
        chunks = spatial_prior_fns[step - 1](params)
        scales_parts, means_parts = chunks[:4], chunks[4:]
    perm = FOUR_PART_PERM[step]
    scales_r = sum(scales_parts[c] * masks[perm[c]] for c in range(4))
    return scales_r, tuple(means_parts)


def four_part_decode_update(common_params, y_hat_so_far, y_q_r, means_parts,
                            step: int):
    """Scatter the decoded symbols of ``step`` into y_hat_so_far."""
    masks = _masks(common_params)
    perm = FOUR_PART_PERM[step]
    step_cat = torch.cat(
        [(y_q_r + means_parts[c]) * masks[perm[c]] for c in range(4)], dim=1)
    return step_cat if y_hat_so_far is None else y_hat_so_far + step_cat


def four_part_finalize(common_params, y_hat_so_far):
    quant_step, _, _ = separate_prior(common_params)
    return y_hat_so_far * torch.clamp_min(quant_step, 0.5)
