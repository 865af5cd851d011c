"""Training steps: rate-distortion loss, multi-rate batches, cascaded frames.

Counterpart of ``dcvc_tpu/training/step.py``. Parity target: the fork's
Lightning harness (DCVC-HEM/src/train_CANFVC_DMC.py): per-batch-element
q_level cycling with lambda in {85, 170, 380, 840} (:184-186), the
cascaded-frame loss with its detach policy (:188-210), gradient clamp +-5
and AdamW (:605-631).

Frames cross the API as NCHW tensors: ``x`` [B, 3, H, W], a clip
[B, T, 3, H, W]. The modules hold their parameters, so a step updates them
in place and returns ``(loss, aux)``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils.checkpoint

from ..models.intra_dc import IntraNoAR
from ..ops.ms_ssim import ms_ssim_distortion

# lambda per q_level (train_CANFVC_DMC.py:184-186)
TRAIN_LAMBDAS = (85.0, 170.0, 380.0, 840.0)


class ClipAdamW:
    """``optax.chain(optax.clip(grad_clamp), optax.adamw(lr,
    weight_decay))``: the raw gradient clamped elementwise to
    +-``grad_clamp``, then AdamW with optax's defaults (betas 0.9 / 0.999,
    eps 1e-8, decoupled decay on the parameter before the step).

    ``lr`` is a float or a function of the number of updates made so far
    (``optax``'s schedule count). A parameter with no gradient takes a zero
    gradient, as every leaf does under optax: its moments stay 0 and the
    decay still applies. Only the ``params`` given are updated (freezing
    leaves the others out)."""

    def __init__(self, params, lr=1e-4, weight_decay: float = 1e-2,
                 grad_clamp: float = 5.0):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = lr if callable(lr) else (lambda count: lr)
        self.grad_clamp = grad_clamp
        self.count = 0
        self.opt = torch.optim.AdamW(self.params, lr=self.schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay)

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch.nn.utils.clip_grad_value_(self.params, self.grad_clamp)
        for group in self.opt.param_groups:
            group["lr"] = float(self.schedule(self.count))
        self.opt.step()
        self.count += 1


def make_optimizer(params, lr=1e-4, weight_decay: float = 1e-2,
                   grad_clamp: float = 5.0) -> ClipAdamW:
    return ClipAdamW(params, lr, weight_decay, grad_clamp)


def piecewise_constant(init: float, boundaries_and_scales: dict):
    """``optax.piecewise_constant_schedule``: ``init`` times every scale
    whose boundary the update count has reached."""
    items = sorted(boundaries_and_scales.items())

    def schedule(count: int) -> float:
        v = init
        for boundary, scale in items:
            if count >= boundary:
                v = v * scale
        return v

    return schedule


def rd_loss(x, x_hat, bpp, lambdas, distortion: str = "mse"):
    """Mean over the batch of lambda * distortion + bpp, ``x`` in [0, 1].

    ``"mse"`` is the reference's sum over CHW / (H * W) (HEM
    video_model.py:464, 3x the all-axis mean), so the fork's lambdas give
    the same trade-off; ``"ssim"`` is the fork's --ssim criterion,
    (1 - MS-SSIM) / 64 (train_CANFVC_DMC.py:74, 199-200)."""
    if distortion == "ssim":
        d = ms_ssim_distortion(x, x_hat)
    else:
        d = ((x - x_hat) ** 2).sum(dim=(1, 2, 3)) / (x.shape[2] * x.shape[3])
    return (lambdas * d + bpp).mean()


def fold_in(seed: int, data: int) -> int:
    """A new seed from ``seed`` and ``data`` (the role of
    ``jax.random.fold_in``)."""
    return int(np.random.SeedSequence([seed, data]).generate_state(
        1, np.uint64)[0])


def noise_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def make_intra_train_step(module, optimizer, quant_mode: str = "ste",
                          distortion: str = "mse"):
    """Single-image RD step for the intra codecs (EVC / IntraNoAR /
    IntraNoARHem): ``train_step(x, q_scales, lambdas, seed=0)`` ->
    ``(loss, aux)``. ``quant_mode="noise"`` draws the rate surrogate from a
    generator seeded with ``seed`` (HEM common_model.py:47-50). IntraNoAR
    takes the q scale twice (encoder and decoder)."""
    two_q = isinstance(module, IntraNoAR)

    def train_step(x, q_scales, lambdas, seed: int = 0):
        gen = (noise_generator(seed, x.device) if quant_mode == "noise"
               else None)
        optimizer.zero_grad()
        if two_q:
            out = module(x, q_scales, q_scales, quant_mode, generator=gen)
        else:
            out = module(x, q_scales, quant_mode=quant_mode, generator=gen)
        loss = rd_loss(x, out["x_hat"], out["bpp"], lambdas, distortion)
        loss.backward()
        optimizer.step()
        loss = loss.detach()
        return loss, {"bpp": out["bpp"].detach().mean(), "loss": loss}

    return train_step


def cascade_loss(apply_frame, clip, lambdas, cascade_frames: int,
                 detach: bool = True, remat: bool = False,
                 quant_mode: str = "ste", distortion: str = "mse",
                 seed: int = 0):
    """The cascaded RD loss over a clip [B, T, 3, H, W], graph kept:
    ``(loss, mean bpp)``. ``apply_frame(x, dpb, t, quant_mode, generator)``
    codes frame ``t`` against the DPB. Frame 0 is the (already
    reconstructed) reference; frames 1..cascade_frames are coded in turn
    and the loss averages their RD terms. ``detach`` cuts the gradient
    between frames; ``remat`` recomputes each frame's activations in
    backward. Under ``"noise"`` frame ``t`` draws from a generator seeded
    ``fold_in(seed, t)`` and made inside the frame's function, so a
    rematerialised frame draws the same noise again."""
    dpb = {"ref_frame": clip[:, 0].contiguous(), "ref_feature": None,
           "ref_mv_feature": None, "ref_y": None, "ref_mv_y": None}
    total = 0.0
    bpps = []
    for t in range(1, cascade_frames + 1):
        x = clip[:, t].contiguous()

        def frame(x, dpb, t=t):
            gen = (noise_generator(fold_in(seed, t), x.device)
                   if quant_mode == "noise" else None)
            return apply_frame(x, dpb, t, quant_mode, gen)

        if remat:
            # recompute the frame's activations in backward (memory for
            # FLOPs)
            out = torch.utils.checkpoint.checkpoint(frame, x, dpb,
                                                    use_reentrant=False)
        else:
            out = frame(x, dpb)
        total = total + rd_loss(x, out["dpb"]["ref_frame"], out["bpp"],
                                lambdas, distortion)
        bpps.append(out["bpp"].detach().mean())
        dpb = dict(out["dpb"])
        if detach:
            dpb = {k: None if v is None else v.detach()
                   for k, v in dpb.items()}
    return total / cascade_frames, torch.stack(bpps).mean()


def make_dmc_cascade_loss(module, cascade_frames: int = 2,
                          detach_between_frames: bool = True,
                          remat: bool = False, quant_mode: str = "ste",
                          distortion: str = "mse"):
    """The cascaded RD loss of :func:`make_dmc_train_step` for DMC:
    ``loss_fn(clip, q_scales, lambdas, seed=0)`` -> ``(loss, aux)``, the
    graph kept for ``backward``."""

    def loss_fn(clip, q_scales, lambdas, seed: int = 0):
        loss, bpp = cascade_loss(
            lambda x, dpb, t, qm, gen: module(x, dpb, q_scales, t, qm,
                                              generator=gen),
            clip, lambdas, cascade_frames, detach_between_frames, remat,
            quant_mode, distortion, seed)
        return loss, {"bpp": bpp, "loss": loss.detach()}

    return loss_fn


def make_dmc_train_step(module, optimizer, cascade_frames: int = 2,
                        detach_between_frames: bool = True,
                        remat: bool = False, quant_mode: str = "ste",
                        distortion: str = "mse"):
    """Cascaded P-frame step of DMC over a clip [B, T, 3, H, W]:
    ``train_step(clip, q_scales, lambdas, seed=0)`` -> ``(loss, aux)``.

    Frame 0 is the (already reconstructed) reference; frames 1..cascade
    are coded in turn with the DPB threaded through, and the loss averages
    their RD terms. ``detach_between_frames`` cuts the gradient between
    frames (the fork's pre-fullgop stages, :190-191); ``remat`` recomputes
    each frame's activations in backward."""
    loss_fn = make_dmc_cascade_loss(module, cascade_frames,
                                    detach_between_frames, remat, quant_mode,
                                    distortion)

    def train_step(clip, q_scales, lambdas, seed: int = 0):
        optimizer.zero_grad()
        loss, aux = loss_fn(clip, q_scales, lambdas, seed)
        loss.backward()
        optimizer.step()
        return aux["loss"], aux

    return train_step


def q_levels_for_batch(batch_size: int, base_step: int = 0, device=None):
    """Cycle q levels 0..3 across batch elements (fork :184-186):
    ``(levels, lambdas)``."""
    levels = (torch.arange(batch_size, device=device) + base_step) % 4
    lambdas = torch.tensor(TRAIN_LAMBDAS, device=device)[levels]
    return levels, lambdas
