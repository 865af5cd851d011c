"""The port's optimizer, learning-rate schedule, freezing, RD loss and
MS-SSIM against ``dcvc_tpu`` on the CPU.

* Optimizer: the port's ``ClipAdamW`` as ``PFrameTrainer.build_optimizer``
  makes it, against the ``optax`` chain the JAX ``PFrameTrainer`` builds
  for the same ``Stage`` (clip +-5, AdamW, the milestone decay), over three
  updates on identical random gradients: each parameter tensor within
  1e-6 relative L2 of JAX's (the two apply the decay and the step in
  another order: an element differs by a few f32 ulps).
* Freezing: trainable tensors equal JAX's (1e-6 relative L2); the port
  leaves frozen tensors exactly unchanged, where the JAX harness moves them
  (its fault, not ported).
* MS-SSIM, ``ms_ssim_distortion`` and ``rd_loss(..., "ssim")`` with their
  gradients against ``jax.grad``, at 192 px (the full 5 levels) and at 64
  px (levels dropped, weights renormalised): rtol 1e-5, atol 1e-6;
  ``rd_loss(..., "mse")`` rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcvc_tpu.ops import ms_ssim as jssim
from dcvc_tpu.training import step as jstep
from dcvc_tpu.training import trainer as jtrainer
from dcvc_tpu_torch.ops import ms_ssim as tssim
from dcvc_tpu_torch.training import step as tstep
from dcvc_tpu_torch.training import trainer as ttrainer
from _flax_init import flax_param_checks  # noqa: F401 (autouse)

OPT_REL_L2 = 1e-6
SSIM_TOL = {"rtol": 1e-5, "atol": 1e-6}
SHAPES = {"enc": {"kernel": (3, 4)}, "dec": {"bias": (5,)},
          "hyper": {"scale": (2, 3)}}


class _Leaves(torch.nn.Module):
    """Parameters named as the JAX tree's paths (``a.kernel`` ...)."""

    def __init__(self, values):
        super().__init__()
        for mod, leaves in values.items():
            sub = torch.nn.Module()
            for leaf, v in leaves.items():
                sub.register_parameter(leaf, torch.nn.Parameter(
                    torch.from_numpy(v.copy())))
            self.add_module(mod, sub)


def _tree(rng):
    return {m: {k: rng.standard_normal(s).astype(np.float32)
                for k, s in leaves.items()} for m, leaves in SHAPES.items()}


def _close(a, b, what):
    rel = np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel <= OPT_REL_L2, (what, rel)


def _run_both(stage, steps_per_epoch, workdir, n_steps=3):
    """(port params, JAX params, initial params, the gradients) per step:
    the same start and the same gradients (some beyond the clamp)."""
    rng = np.random.default_rng(1)
    init = _tree(rng)
    grads = [{m: {k: (rng.standard_normal(s) * 4).astype(np.float32)
                  for k, s in leaves.items()}
              for m, leaves in SHAPES.items()} for _ in range(n_steps)]
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray, init)}
    jt = jtrainer.PFrameTrainer(None, jparams, schedule=[stage],
                                workdir=str(workdir / "jax"))
    tx, _ = jt._build_step(stage, steps_per_epoch)
    opt_state = tx.init(jparams)
    module = _Leaves(init)
    tt = ttrainer.PFrameTrainer(module, schedule=[stage],
                                workdir=str(workdir / "port"), device="cpu")
    opt = tt.build_optimizer(stage, steps_per_epoch)
    seen_port, seen_jax = [], []
    for g in grads:
        jg = {"params": jax.tree_util.tree_map(jnp.asarray, g)}
        updates, opt_state = tx.update(jg, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        for name, p in module.named_parameters():
            if p.requires_grad:
                m, k = name.split(".")
                p.grad = torch.from_numpy(g[m][k].copy())
        opt.step()
        seen_port.append({n: p.detach().numpy().copy()
                          for n, p in module.named_parameters()})
        seen_jax.append({f"{m}.{k}": np.asarray(v)
                         for m, leaves in jparams["params"].items()
                         for k, v in leaves.items()})
    return seen_port, seen_jax, init, grads


def test_clip_adamw_with_milestone_matches_optax(tmp_path):
    """Three updates with the stage's milestone at update 2 (epoch 2 of
    one step each): the decay applies from the third update, as optax's
    piecewise-constant schedule counts."""
    stage = ttrainer.Stage("s", epochs=3, lr=1e-3, lr_milestones=(2,),
                           lr_gamma=0.5)
    jstage = jtrainer.Stage("s", epochs=3, lr=1e-3, lr_milestones=(2,),
                            lr_gamma=0.5)
    assert stage == ttrainer.Stage(**vars(jstage))
    port, jx, init, _ = _run_both(jstage, 1, tmp_path)
    for step_p, step_j in zip(port, jx):
        for n in step_j:
            _close(step_p[n], step_j[n], n)
    sched = tstep.piecewise_constant(1e-3, {2: 0.5})
    assert [sched(c) for c in range(4)] == [1e-3, 1e-3, 5e-4, 5e-4]
    jsched = optax.piecewise_constant_schedule(1e-3, {2: 0.5})
    np.testing.assert_allclose([float(jsched(c)) for c in range(4)],
                               [sched(c) for c in range(4)], rtol=1e-7)
    # the first update moves each element by about lr * sign(g) (+ decay)
    moved = np.abs(port[0]["enc.kernel"] - init["enc"]["kernel"])
    assert np.all(moved < 2e-3) and np.all(moved > 5e-4)


def test_freezing_keeps_frozen_tensors_the_jax_harness_moves_them(tmp_path):
    """Fault 2 of the reference harness, not ported: ``PFrameTrainer``
    (``dcvc_tpu/training/trainer.py:122-126``) wraps AdamW in
    ``optax.masked`` after ``optax.clip``; ``optax.masked`` passes a
    masked-out leaf's incoming update through untouched, so every "frozen"
    leaf moves by +clip(g) per step (gradient ascent with no learning
    rate). The port freezes as the fork does (``requires_grad=False``,
    left out of the optimizer): trainable tensors take the same AdamW
    steps as JAX's, frozen ones stay exactly as they were."""
    stage = jtrainer.Stage("s", epochs=1, lr=1e-3,
                           trainable_prefixes=("enc",))
    port, jx, init, grads = _run_both(stage, 1, tmp_path)
    _close(port[-1]["enc.kernel"], jx[-1]["enc.kernel"], "enc.kernel")
    for m, k in (("dec", "bias"), ("hyper", "scale")):
        np.testing.assert_array_equal(port[-1][f"{m}.{k}"], init[m][k])
        clipped = sum(np.clip(g[m][k], -5, 5) for g in grads)
        np.testing.assert_allclose(jx[-1][f"{m}.{k}"], init[m][k] + clipped,
                                   rtol=1e-5, atol=1e-5)
    assert ttrainer.frozen_names(_Leaves(init), ("enc",)) == {
        "dec.bias", "hyper.scale"}
    assert ttrainer.frozen_names(_Leaves(init), ()) == set()


def _natural(rng, shape):
    from scipy import ndimage

    x = ndimage.gaussian_filter(rng.random(shape), sigma=(0, 3, 3, 0))
    x = x - x.min()
    return (x / x.max()).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("size", [192, 64])
def test_ms_ssim_and_ssim_loss_with_gradients_match_jax(size):
    rng = np.random.default_rng(size)
    x = _natural(rng, (2, size, size + 8, 3))
    y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(
        np.float32)
    bpp = np.asarray([0.1, 0.3], np.float32)
    lam = np.asarray([85.0, 840.0], np.float32)

    def jfn(yy):
        d = jssim.ms_ssim_distortion(jnp.asarray(x), yy)
        loss = jstep.rd_loss(jnp.asarray(x), yy, jnp.asarray(bpp),
                             jnp.asarray(lam), "ssim")
        return loss, d

    def jprogram(yy):
        out = jax.value_and_grad(jfn, has_aux=True)(yy)
        if size < 161:
            return out
        return out, jax.value_and_grad(
            lambda a: jssim.ms_ssim(jnp.asarray(x), a).sum())(yy)

    res = jax.jit(jprogram)(jnp.asarray(y))
    ((jl, jd), jg), full = (res, None) if size < 161 else res
    ty = _nchw(y).requires_grad_(True)
    td = tssim.ms_ssim_distortion(_nchw(x), ty)
    tl = tstep.rd_loss(_nchw(x), ty, torch.from_numpy(bpp),
                       torch.from_numpy(lam), "ssim")
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **SSIM_TOL)
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd),
                               **SSIM_TOL)
    np.testing.assert_allclose(ty.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jg), **SSIM_TOL)
    assert float(np.abs(np.asarray(jg)).max()) > 0
    if size >= 161:     # the full 5 levels: ms_ssim itself and its gradient
        jv, jgv = full
        ty2 = _nchw(y).requires_grad_(True)
        tv = tssim.ms_ssim(_nchw(x), ty2).sum()
        tv.backward()
        np.testing.assert_allclose(float(tv.detach()), float(jv), **SSIM_TOL)
        np.testing.assert_allclose(ty2.grad.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jgv), **SSIM_TOL)
    else:               # too small for 5 levels: both packages refuse
        with pytest.raises(ValueError):
            tssim.ms_ssim(_nchw(x), _nchw(y))


def test_mse_rd_loss_and_q_levels_match_jax():
    rng = np.random.default_rng(3)
    x = rng.random((4, 16, 24, 3)).astype(np.float32)
    y = rng.random((4, 16, 24, 3)).astype(np.float32)
    bpp = rng.random(4).astype(np.float32)
    levels, lam = tstep.q_levels_for_batch(4, base_step=3)
    jlevels, jlam = jstep.q_levels_for_batch(4, base_step=3)
    np.testing.assert_array_equal(levels.numpy(), np.asarray(jlevels))
    np.testing.assert_array_equal(lam.numpy(), np.asarray(jlam))
    assert tstep.TRAIN_LAMBDAS == jstep.TRAIN_LAMBDAS
    tl = tstep.rd_loss(_nchw(x), _nchw(y), torch.from_numpy(bpp), lam)
    jl = jstep.rd_loss(jnp.asarray(x), jnp.asarray(y), jnp.asarray(bpp),
                       jlam)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert [s.name for s in ttrainer.DEFAULT_SCHEDULE] == [
        s.name for s in jtrainer.DEFAULT_SCHEDULE]
    for a, b in zip(ttrainer.DEFAULT_SCHEDULE, jtrainer.DEFAULT_SCHEDULE):
        assert vars(a) == vars(b)
