"""Training steps of the P-frame codec through the program's trainer
(``PFrameTrainer.train_step``), one after another for the window's
seconds, on seeded clips made on the device in set-up.

The configuration names the model (``models["p"]``) and the warps it
trains with (``training_warps``); the reference is built from the same.

Traffic parameters (``traffic/<name>.json``): ``stage`` (the trainer's
stage name), ``lambdas`` (the rate points, cycled over the batch and the
steps), ``crop``, ``batch``,
``cascade`` (frames coded after the reference frame; the clip holds one
more), ``detach``, ``remat``, ``lr``, ``pool`` (distinct clips made in
set-up, cycled), ``steps_checked`` (set-up steps the reference follows)
and ``trace`` (the first step and the count of the profiled stretch).

Set-up builds one trainer (module and optimizer) and takes its first
``steps_checked`` steps, on clips that all differ, through the window's
own call; the same trainer runs the window. After the window the
reference takes those steps again from the same weights and clips and
compares each step's loss (``loss_gap``, relative), the first step's
gradient as the optimizer got it (read back from its first moment) by
the worst leaf (``grad_gap``), and each parameter's change after the
checked steps by the worst leaf (``update_gap``). A leaf's gap is the
difference of the two norms over the larger of the reference's norm and
the median leaf's; leaves whose reference gradient is under a thousandth
of the median leaf's move by round-off under Adam and are left out of
``update_gap``.
"""

from __future__ import annotations

import random
import time

import torch

from .. import harness
from ..inputs import make_weights, texture
from ..reference import build as build_reference
from ..reference import train as ref_train
from ..reference.counts import conv_flops

def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lambdas_for(mix: dict, step: int, device):
    """Per-sample lambda, the rate points cycling over the batch and the
    steps (train_CANFVC_DMC.py:184-186)."""
    lam = mix["lambdas"]
    return torch.tensor([lam[(b + step) % len(lam)]
                         for b in range(mix["batch"])],
                        device=device)


def make_clips(seed: int, mix: dict, device) -> torch.Tensor:
    """``pool`` distinct clips [pool, B, T, 3, crop, crop]: crops of a
    seeded texture at offsets drawn from the seed, panning 3 / 5 px a
    frame."""
    crop, T = mix["crop"], mix["cascade"] + 1
    side = crop * 4
    tex = texture(seed, side, side, device)
    rng = random.Random(seed)
    n = mix["pool"] * mix["batch"]
    out = torch.empty(n, T, 3, crop, crop, device=device)
    lim = side - crop - 5 * T
    for k in range(n):
        oy, ox = rng.randrange(lim), rng.randrange(lim)
        for t in range(T):
            out[k, t] = tex[0, :, oy + 3 * t:oy + 3 * t + crop,
                            ox + 5 * t:ox + 5 * t + crop]
    return out.view(mix["pool"], mix["batch"], T, 3, crop, crop)


def reference_module(cfg: dict):
    return build_reference(cfg["models"]["p"], cfg,
                           warps=cfg["training_warps"])


def layout(cfg: dict):
    with torch.device("meta"):
        return reference_module(cfg)


def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm().item()) for k, v in tensors.items()}


def _worst(prog: dict, ref: dict, keys) -> float:
    keys = list(keys)
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def reference_readings(cfg, mix, w, clips, losses, g1, p_after,
                       device) -> dict:
    """Follow the checked steps with the reference and compare."""
    ref = reference_module(cfg).to(device)
    ref.load_state_dict(w, strict=True)
    names = [n for n, _ in ref.named_parameters()]
    opt = ref_train.AdamW([p for _, p in ref.named_parameters()],
                          lr=mix["lr"])
    ref_losses, ref_g1 = [], None
    for s in range(len(losses)):
        loss = ref_train.cascade_loss(ref, clips[s % len(clips)],
                                      lambdas_for(mix, s, device),
                                      mix["cascade"], mix["remat"])
        loss.backward()
        ref_losses.append(float(loss.detach()))
        grads = opt.step()
        if s == 0:
            ref_g1 = _norms(dict(zip(names, grads)))
    params = dict(ref.named_parameters())
    ref_upd = _norms({n: params[n].detach() - w[n] for n in names})
    prog_upd = _norms({n: p_after[n] - w[n] for n in names})
    prog_g1 = _norms(g1)
    med = sorted(ref_g1.values())[len(ref_g1) // 2]
    moved = [n for n in names if ref_g1[n] >= 1e-3 * med]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                          ref_losses)),
        "grad_gap": _worst(prog_g1, ref_g1, names),
        "update_gap": _worst(prog_upd, ref_upd, moved),
        "_losses": list(losses), "_ref_losses": ref_losses,
        "_left_out": sorted(set(names) - set(moved)),
    }


class ProgramTrainer:
    """The program's trainer and optimizer for one stage."""

    def __init__(self, cfg, mix, w, device):
        from dcvc_tpu_torch.training.trainer import (PFrameTrainer, Stage,
                                                     build_train_module)

        warps = cfg["training_warps"]
        module = build_train_module(cfg["models"]["p"], device=device,
                                    od_warp_mode=warps["od"],
                                    mc_warp_mode=warps["mc"],
                                    me_warp_mode=warps["me"])
        module.load_state_dict(w, strict=True)
        self.stage = Stage(mix["stage"], epochs=1,
                           cascade_frames=mix["cascade"],
                           detach=mix["detach"], lr=mix["lr"],
                           remat=mix["remat"])
        self.trainer = PFrameTrainer(
            module, schedule=[self.stage], device=device,
            workdir=str(harness.ROOT / "out" / "benchmark_train"))
        self.opt = self.trainer.build_optimizer(self.stage)
        self.module = module

    def step(self, clip, lambdas) -> float:
        return self.trainer.train_step(self.opt, self.stage, clip, lambdas)

    def first_moment_grads(self) -> dict:
        """The gradient the optimizer took at its first step, from its
        first moment ((1 - beta1) * g after one step)."""
        state = self.opt.opt.state
        b1 = self.opt.opt.param_groups[0]["betas"][0]
        # a parameter the optimizer never stepped has no moment: it took
        # no gradient
        return {n: (state[p]["exp_avg"].detach() / (1 - b1)
                    if "exp_avg" in state.get(p, {}) else torch.zeros_like(p))
                for n, p in self.module.named_parameters()}

    def forward_flops(self, clip, lambdas) -> float:
        with torch.no_grad():
            return conv_flops(self.module, lambda: self.trainer.loss(
                clip, lambdas, self.stage))


class ReferenceTrainer:
    """The reference in the program's place (the control), in TF32 when
    ``tf32``: the precision below the configuration's float32."""

    def __init__(self, cfg, mix, w, device, tf32: bool = True):
        self.module = reference_module(cfg).to(device)
        self.module.load_state_dict(w, strict=True)
        self.opt = ref_train.AdamW(self.module.parameters(), lr=mix["lr"])
        self.mix, self.tf32 = mix, tf32

    def step(self, clip, lambdas) -> float:
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            loss = ref_train.cascade_loss(self.module, clip, lambdas,
                                          self.mix["cascade"],
                                          self.mix["remat"])
            loss.backward()
            self.opt.step()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
        return float(loss.detach())

    def first_moment_grads(self) -> dict:
        return {n: m / (1 - self.opt.b1) for (n, _), m in
                zip(self.module.named_parameters(), self.opt.m)}


def checked_steps(trainer, clips, mix, device, half_batch: bool = False):
    """The steps the reference follows, each on its own clip: the losses,
    the first step's gradient as the optimizer took it, and the
    parameters after the last. ``half_batch`` leaves half of each batch
    out (a fault the check must catch)."""
    losses, g1 = [], None
    B = mix["batch"]
    for s in range(mix["steps_checked"]):
        clip, lam = clips[s], lambdas_for(mix, s, device)
        if half_batch:
            clip, lam = clip[:B // 2], lam[:B // 2]
        losses.append(trainer.step(clip, lam))
        if s == 0:
            g1 = {k: v.clone() for k, v in trainer.first_moment_grads().items()}
    p_after = {n: p.detach().clone()
               for n, p in trainer.module.named_parameters()}
    return losses, g1, p_after


def calibrate(ctx: dict, mode: str) -> dict:
    """Readings of one seed with the program (``program``), the control
    (``control``) or the program with half of each batch left out
    (``half_batch``) taking the checked steps."""
    cfg, mix, dev, seed = (ctx["config"], ctx["traffic"], ctx["device"],
                           ctx["seed"])
    clips = make_clips(seed, mix, dev)
    w = make_weights(layout(cfg), seed * 8 + 1, dev)
    trainer = (ReferenceTrainer(cfg, mix, w, dev) if mode == "control"
               else ProgramTrainer(cfg, mix, w, dev))
    losses, g1, p_after = checked_steps(trainer, clips, mix, dev,
                                        half_batch=mode == "half_batch")
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return reference_readings(cfg, mix, w, clips, losses, g1, p_after, dev)


def run(ctx: dict) -> dict:
    cfg, mix, dev = ctx["config"], ctx["traffic"], ctx["device"]
    seed, trace = ctx["seed"], ctx["trace"]
    B = mix["batch"]
    phases = ctx["phases"]
    clips = make_clips(seed, mix, dev)
    w = make_weights(layout(cfg), seed * 8 + 1, dev)
    _sync(dev)
    phases.mark("inputs")
    prog = ProgramTrainer(cfg, mix, w, dev)
    phases.mark("program")
    spans = harness.Spans(trace)

    # set-up: the checked steps through the window's own call, each on
    # its own clip; the first moment after step 1 and the parameters
    # after the last are kept for the check
    losses, g1, p_after = checked_steps(prog, clips, mix, dev)
    n_check = mix["steps_checked"]
    _sync(dev)
    phases.mark("checked_steps")
    fwd = prog.forward_flops(clips[0], lambdas_for(mix, 0, dev))
    _sync(dev)
    phases.mark("flops")
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t_first, count = mix["trace"]
    prof = None
    excluded = 0.0
    step_s = []
    s = n_check
    t_start = time.perf_counter()
    while True:
        k = s - n_check
        if trace and k == t_first:
            from torch.profiler import ProfilerActivity, profile

            t = time.perf_counter()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            rf = torch.profiler.record_function("stretch")
            rf.__enter__()
            excluded += time.perf_counter() - t
        t0 = time.perf_counter()
        with spans.span("step"):
            prog.step(clips[s % len(clips)], lambdas_for(mix, s, dev))
        step_s.append(time.perf_counter() - t0)
        s += 1
        if trace and k == t_first + count - 1:
            t = time.perf_counter()
            _sync(dev)
            rf.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            excluded += time.perf_counter() - t
        elapsed = time.perf_counter() - t_start - excluded
        if elapsed >= ctx["seconds"] and (not trace or prof is not None
                                          and k >= t_first + count - 1):
            break
    window_s = time.perf_counter() - t_start - excluded
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    steps = s - n_check
    rec = {
        "setup_s": ctx["t_window"](t_start),
        "setup_phases": phases.done,
        "kind": "train", "batch": B,
        "window_s": window_s, "attempted": steps, "failed": 0,
        "step_s": step_s,
        "step_flops": 3.0 * fwd,
        "spans": dict(spans.total),
        "window_peak_bytes": window_peak,
        "memory_peak_bytes": max(setup_peak, window_peak),
    }
    if trace:
        rec["profile"] = harness.reduce_profile(prof, ("step",))
        prof = None
    del prog
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    r = reference_readings(cfg, mix, w, clips, losses, g1, p_after, dev)
    rec["readings"] = {k: v for k, v in r.items() if not k.startswith("_")}
    rec["detail"] = {k[1:]: v for k, v in r.items() if k.startswith("_")}
    return rec
