"""Faults planted in the program under test, for the tests and for
``calibrate.py``: each breaks the timed path underneath in one way a cell
can go wrong, and a run with it in has to come out not correct.

A fault is a function of ``patch(obj, name, value)`` (pytest's
``monkeypatch.setattr``, or ``applied`` below) that replaces attributes
of the program's modules; the reference, a package of its own, is never
touched.
"""

from __future__ import annotations

import contextlib

import numpy as np


def _state_unchanged(patch):
    """A P-frame's decode returns the DPB it was given."""
    from dcvc_tpu_torch.models import runtime

    patch(runtime.DmcRuntime, "decompress",
          lambda self, dpb, *a, **k: {"dpb": dpb})


def _symbol_altered(patch):
    """One symbol of every stream altered where the encoder writes it."""
    from dcvc_tpu_torch.entropy import coder

    orig = coder.EntropyCoder.encode_with_indexes

    def altered(self, symbols, indexes, table):
        s = np.array(symbols, copy=True).reshape(-1)
        s[len(s) // 2] += 1
        return orig(self, s, indexes, table)

    patch(coder.EntropyCoder, "encode_with_indexes", altered)


def _symbol_moved(patch):
    """One symbol of each coded frame, whose residual lies more than 0.25
    from a rounding boundary, moved by 1 where the encoder's quantizer
    produces it: stream, decoder and reconstruction agree with it, and
    only the symbol is wrong."""
    from dcvc_tpu_torch.models import priors, runtime

    armed = []
    orig = priors.process_with_mask

    def first_moved(y, scales, means, mask, quant):
        if not armed:
            return orig(y, scales, means, mask, quant)
        armed.clear()

        def moved(r):
            q = quant(r).contiguous().clone()
            a = r.abs()
            far = ((a - a.floor() - 0.5).abs() > 0.25) & (
                mask.expand_as(r) > 0)
            idx = far.reshape(-1).nonzero()
            if len(idx):
                q.view(-1)[idx[0, 0]] += 1
            return q

        return orig(y, scales, means, mask, moved)

    patch(priors, "process_with_mask", first_moved)
    for cls in (runtime.IntraDcRuntime, runtime.DmcRuntime,
                runtime.EvcCodecRuntime):
        def arming(self, *a, _orig=cls.compress, **k):
            armed.append(True)
            return _orig(self, *a, **k)

        patch(cls, "compress", arming)


def _recon_altered(patch):
    """The decoder's reconstruction off by 1e-3 where it is produced."""
    from dcvc_tpu_torch.models import runtime

    for cls in (runtime.IntraDcRuntime, runtime.EvcCodecRuntime):
        orig = cls.decompress

        def shifted(self, *a, _orig=orig, **k):
            out = dict(_orig(self, *a, **k))
            out["x_hat"] = out["x_hat"] * 0.999
            return out

        patch(cls, "decompress", shifted)


def _update_skipped(patch):
    """A training step that returns its state unchanged: the optimizer
    takes no step."""
    from dcvc_tpu_torch.training import step

    patch(step.ClipAdamW, "step", lambda self: None)


def _half_batch(patch):
    """Half of each batch left out, the mean taken over the rest."""
    from dcvc_tpu_torch.training import trainer

    orig = trainer.PFrameTrainer.train_step

    def half(self, opt, stage, clip, lambdas):
        n = clip.shape[0] // 2
        return orig(self, opt, stage, clip[:n], lambdas[:n])

    patch(trainer.PFrameTrainer, "train_step", half)


def _loss_altered(patch):
    """The loss altered where it is produced (its distortion term off by
    a part in a thousand)."""
    from dcvc_tpu_torch.training import step

    orig = step.rd_loss
    patch(step, "rd_loss", lambda *a, **k: orig(*a, **k) * 1.001)


def coding(cfg: dict) -> list:
    """The faults a coding cell of configuration ``cfg`` can have."""
    video = [_state_unchanged] if cfg["models"].get("p") else []
    return video + [_symbol_altered, _symbol_moved, _recon_altered]


@contextlib.contextmanager
def applied(fault):
    """``fault`` planted for the ``with`` block, then taken out."""
    undo = []

    def patch(obj, name, value):
        undo.append((obj, name, obj.__dict__.get(name)))
        setattr(obj, name, value)

    fault(patch)
    try:
        yield
    finally:
        for obj, name, old in reversed(undo):
            if old is None:
                delattr(obj, name)
            else:
                setattr(obj, name, old)
