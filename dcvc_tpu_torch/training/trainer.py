"""Multi-stage P-frame training harness.

Counterpart of ``dcvc_tpu/training/trainer.py``. Parity target: the fork's
Lightning harness (DCVC-HEM/src/train_CANFVC_DMC.py):
  * an epoch-keyed stage schedule with per-stage freeze lists (:125-176);
  * per-batch-element q_level cycling over the lambda table (:184-186);
  * the cascaded-frame loss over growing frame counts with its detach
    policy (:188-210);
  * AdamW with a milestone decay and the gradient clamp +-5 (:605-631);
  * checkpoints each epoch, validation and resume.

Each stage builds a fresh optimizer (the JAX harness re-inits its
optimizer state per stage). The learning rate follows
``optax.piecewise_constant_schedule`` over the stage's updates, counted
from 0: ``lr_gamma`` applies from update ``milestone * steps_per_epoch``.
Freezing sets ``requires_grad=False`` and leaves the frozen tensors out of
the optimizer, as the fork does. (The JAX harness masks AdamW after the
clip with ``optax.masked``, which passes a masked leaf's clipped gradient
through as its update: its "frozen" leaves move by +clip(g). That is not
ported.)

Checkpoints are ``.pth`` ``state_dict``s under the reference's key names,
with ``history.json`` beside them; ``restore`` also reads the JAX
package's ``.npz``.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..utils import trace
from ..utils.checkpoint import load_state_dict
from .step import (ClipAdamW, cascade_loss, fold_in, piecewise_constant,
                   q_levels_for_batch)


@dataclass
class Stage:
    name: str
    epochs: int
    cascade_frames: int = 1
    detach: bool = True
    trainable_prefixes: tuple = ()  # empty = train everything
    lr: float = 1e-4
    # MultiStepLR-style decay (the fork's configure_optimizers,
    # lr_gamma=0.5): lr multiplies by lr_gamma at each epoch milestone of
    # the stage
    lr_milestones: tuple = ()
    lr_gamma: float = 0.5
    remat: bool = False  # recompute each frame's activations in backward


# the default schedule follows the fork's phase progression
DEFAULT_SCHEDULE = [
    Stage("train_2frames", epochs=5, cascade_frames=1, detach=True),
    Stage("train_cascade", epochs=3, cascade_frames=2, detach=True),
    Stage("train_fullgop", epochs=2, cascade_frames=4, detach=False,
          lr=1e-5),
]

# registry names of the trainable P-frame modules (checkpoint conversion)
_REGISTRY_NAMES = {"DMC": "dmc_dc", "DMCHem": "dmc_hem",
                   "CANFVCDmc": "canfvc_dmc", "DMCTcm": "dmc_tcm",
                   "DCVCNet": "dcvc_gen1"}


def build_train_module(name: str, seed: int = 0, device=None, **kwargs):
    """P-frame module ``name`` (a registry name) with seeded weights and
    exact warps: the block-warp kernel has no backward, and the JAX
    modules train with the exact warp (``dcvc_tpu/ops/warp.py:211-219``).
    Only DMC's OffsetDiversity defaults to the block warp on the card;
    every other warp of these modules defaults to the exact one."""
    from ..models.video_canf import build_canf
    from ..models.video_dc import build_dmc
    from ..models.video_dcvc import build_dcvc_gen1
    from ..models.video_hem import build_dmc_hem
    from ..models.video_tcm import build_dmc_tcm

    if name == "dmc_dc":
        kwargs = {"od_warp_mode": "exact", **kwargs}
    build = {"dmc_dc": build_dmc, "dmc_hem": build_dmc_hem,
             "canfvc_dmc": build_canf, "dmc_tcm": build_dmc_tcm,
             "dcvc_gen1": build_dcvc_gen1}[name]
    return build(seed=seed, device=device, **kwargs)


def frozen_names(module, prefixes) -> set:
    """Names of the parameters a stage freezes: all but those whose name
    contains one of ``prefixes`` (none when ``prefixes`` is empty)."""
    if not prefixes:
        return set()
    return {n for n, _ in module.named_parameters()
            if not any(p in n for p in prefixes)}


def _ones(x):
    return torch.ones((x.shape[0], 1, 1, 1), dtype=x.dtype, device=x.device)


def dmc_dc_adapter(module, x, dpb, lambdas, t, quant_mode="ste",
                   generator=None):
    """Frame apply for the DC generation's DMC signature."""
    q = _ones(x)
    qs = {k: q for k in ("mv_enc", "mv_dec", "y_enc", "y_dec")}
    return module(x, dpb, qs, t, quant_mode, generator=generator)


def hem_adapter(module, x, dpb, lambdas, t, quant_mode="ste",
                generator=None):
    """Frame apply for DMCHem / CANFVCDmc (scalar mv / y q_scales)."""
    q = _ones(x)
    return module(x, dpb, q, q, quant_mode, generator=generator)


class PFrameTrainer:
    """Trains a DMC-family module on clips [B, T, H, W, 3] (numpy, as the
    datasets yield them; moved to NCHW on the device)."""

    def __init__(self, module, schedule=None, grad_clamp: float = 5.0,
                 weight_decay: float = 1e-2, workdir: str = "out/train",
                 apply_adapter=None, distortion: str = "mse",
                 quant_mode: str = "ste", seed: int = 0, device=None):
        """``distortion="ssim"`` trains on (1 - MS-SSIM) / 64 (the fork's
        --ssim, train_CANFVC_DMC.py:74, 199-200); ``quant_mode="noise"``
        takes the fork's rate surrogate (HEM video_model.py:466-471).
        ``device`` None is the card."""
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.schedule = schedule or DEFAULT_SCHEDULE
        self.grad_clamp = grad_clamp
        self.weight_decay = weight_decay
        self.workdir = workdir
        self.apply_adapter = apply_adapter or dmc_dc_adapter
        self.distortion = distortion
        self.quant_mode = quant_mode
        self.seed = seed
        self.updates = 0     # every update this trainer made (noise seeds)
        os.makedirs(workdir, exist_ok=True)
        self.history: list[dict] = []
        self.best_val_loss: float | None = None

    def _clip(self, clip) -> torch.Tensor:
        """[B, T, H, W, 3] host clip -> fresh [B, T, 3, H, W] f32 tensor on
        the device (canonical strides)."""
        t = torch.from_numpy(np.asarray(clip, np.float32)).permute(
            0, 1, 4, 2, 3)
        return torch.empty(t.shape, device=self.device).copy_(t)

    def _apply(self):
        module, adapter = self.module, self.apply_adapter
        return lambda x, dpb, t, qm, gen: adapter(
            module, x, dpb, None, t, quant_mode=qm, generator=gen)

    def build_optimizer(self, stage: Stage, steps_per_epoch: int = 0):
        """Freeze what ``stage`` freezes and return a fresh optimizer over
        the rest, with the stage's learning-rate schedule."""
        frozen = frozen_names(self.module, stage.trainable_prefixes)
        for n, p in self.module.named_parameters():
            p.requires_grad_(n not in frozen)
        lr = stage.lr
        if stage.lr_milestones and steps_per_epoch:
            lr = piecewise_constant(
                stage.lr, {int(m) * steps_per_epoch: stage.lr_gamma
                           for m in stage.lr_milestones})
        return ClipAdamW(self.module.parameters(), lr, self.weight_decay,
                         self.grad_clamp)

    def loss(self, clip, lambdas, stage: Stage, key: int = 0,
             quant_mode: str | None = None):
        """The stage's cascaded loss on a device clip, graph kept."""
        qm = quant_mode or self.quant_mode
        loss, _ = cascade_loss(self._apply(), clip, lambdas,
                               stage.cascade_frames, stage.detach,
                               stage.remat, qm, self.distortion, key)
        return loss

    def train_step(self, opt: ClipAdamW, stage: Stage, clip,
                   lambdas) -> float:
        """One update on a device clip; its noise seed folds the update
        count into the trainer's seed."""
        with trace.span("train.step"):
            key = fold_in(self.seed, self.updates)
            opt.zero_grad()
            loss = self.loss(clip, lambdas, stage, key)
            loss.backward()
            opt.step()
            self.updates += 1
            with trace.span("train.readback"):
                return float(loss.detach())

    def fit(self, dataset, batch_size: int = 4, steps_per_epoch: int = 100,
            log_every: int = 20, save_every_epoch: bool = True,
            val_dataset=None, val_steps: int = 8, epoch_offset: int = 0,
            last_epoch_steps: int | None = None):
        """Runs the schedule. ``val_dataset`` adds a per-epoch validation
        pass with no updates (the fork validates each epoch on the first
        GOP of every test sequence, train_CANFVC_DMC.py:241-320) into
        ``history[..]["val_loss"]`` and keeps the best as ``best.pth``;
        ``last_epoch_steps`` shortens each stage's final epoch."""
        global_step = 0
        for stage in self.schedule:
            opt = self.build_optimizer(stage, steps_per_epoch)
            for epoch in range(stage.epochs):
                t0 = time.time()
                losses = []
                n_steps = (last_epoch_steps
                           if last_epoch_steps and epoch == stage.epochs - 1
                           else steps_per_epoch)
                for clip in dataset.batches(batch_size, n_steps):
                    _, lambdas = q_levels_for_batch(
                        clip.shape[0], global_step, self.device)
                    losses.append(self.train_step(opt, stage,
                                                  self._clip(clip), lambdas))
                    global_step += 1
                    if global_step % log_every == 0:
                        print(f"[{stage.name} ep{epoch}] step {global_step} "
                              f"loss {np.mean(losses[-log_every:]):.4f}")
                rec = {"stage": stage.name, "epoch": epoch,
                       "loss": float(np.mean(losses)),
                       "time": time.time() - t0}
                if val_dataset is not None:
                    rec["val_loss"] = self.validate(
                        val_dataset, stage, batch_size, val_steps)
                    # the fork's ModelCheckpoint(monitor='val/loss')
                    # (train_CANFVC_DMC.py:745-753)
                    if (self.best_val_loss is None
                            or rec["val_loss"] < self.best_val_loss):
                        self.best_val_loss = rec["val_loss"]
                        rec["best"] = True
                        self.save(os.path.join(self.workdir, "best.pth"))
                self.history.append(rec)
                if save_every_epoch:
                    # epoch_offset keeps global epoch indexes across
                    # relaunches after a crash
                    self.save(os.path.join(
                        self.workdir,
                        f"{stage.name}_ep{epoch + epoch_offset}.pth"))
        return self.module

    @torch.no_grad()
    def validate(self, dataset, stage: Stage | None = None,
                 batch_size: int = 4, steps: int = 8) -> float:
        """Average cascaded RD loss over ``steps`` batches with no update,
        in eval quantization (hard round, real bit estimate), as the
        fork's validation_step, whatever the training quant_mode."""
        stage = stage or self.schedule[0]
        losses = []
        for i, clip in enumerate(dataset.batches(batch_size, steps)):
            _, lambdas = q_levels_for_batch(clip.shape[0], i, self.device)
            losses.append(float(self.loss(self._clip(clip), lambdas, stage,
                                          quant_mode="round")))
        return float(np.mean(losses))

    def grad_norms(self, clip, lambdas=None) -> dict:
        """Gradient L2 norm per top-level child (or top-level parameter):
        the fork's plot_grad_flow diagnostic (vision.py:263). One frame,
        STE, MSE; no update."""
        clip = self._clip(clip)
        if lambdas is None:
            _, lambdas = q_levels_for_batch(clip.shape[0], 0, self.device)
        params = dict(self.module.named_parameters())
        for p in params.values():
            p.grad = None
        cascade_loss(self._apply(), clip, lambdas, 1)[0].backward()
        sq: dict = {}
        for n, p in params.items():
            top = n.split(".")[0]
            g = 0.0 if p.grad is None else float((p.grad.double() ** 2).sum())
            sq[top] = sq.get(top, 0.0) + g
            p.grad = None
        return {k: float(np.sqrt(v)) for k, v in sq.items()}

    def save(self, path: str):
        torch.save({k: v.detach().cpu()
                    for k, v in self.module.state_dict().items()}, path)
        with open(os.path.join(self.workdir, "history.json"), "w") as f:
            json.dump(self.history, f, indent=2)

    def restore(self, path: str):
        """Loads a ``.pth`` of this harness (or a published checkpoint) or
        the JAX package's ``.npz``."""
        name = _REGISTRY_NAMES[type(self.module).__name__]
        sd = load_state_dict(path, name)
        self.module.load_state_dict(sd, strict=True)
