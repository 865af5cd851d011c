"""A run with the timed path broken underneath comes out not correct: for
each fault a coding cell can have, the whole run (the look for a card
skipped) on the CPU at a tiny size."""

import numpy as np
import pytest

from . import _tiny


def _state_unchanged(monkeypatch):
    """A P-frame's decode returns the DPB it was given."""
    from dcvc_tpu_torch.models import runtime

    monkeypatch.setattr(runtime.DmcRuntime, "decompress",
                        lambda self, dpb, *a, **k: {"dpb": dpb})


def _symbol_altered(monkeypatch):
    """One symbol of every stream altered where the encoder writes it."""
    from dcvc_tpu_torch.entropy import coder

    orig = coder.EntropyCoder.encode_with_indexes

    def altered(self, symbols, indexes, table):
        s = np.array(symbols, copy=True).reshape(-1)
        s[len(s) // 2] += 1
        return orig(self, s, indexes, table)

    monkeypatch.setattr(coder.EntropyCoder, "encode_with_indexes", altered)


def _recon_altered(monkeypatch):
    """The decoder's reconstruction off by 1e-3 where it is produced."""
    from dcvc_tpu_torch.models import runtime

    for cls in (runtime.IntraDcRuntime, runtime.EvcCodecRuntime):
        orig = cls.decompress

        def shifted(self, *a, _orig=orig, **k):
            out = dict(_orig(self, *a, **k))
            out["x_hat"] = out["x_hat"] * 0.999
            return out

        monkeypatch.setattr(cls, "decompress", shifted)


def _update_skipped(monkeypatch):
    """A training step that returns its state unchanged: the optimizer
    takes no step."""
    from dcvc_tpu_torch.training import step

    monkeypatch.setattr(step.ClipAdamW, "step", lambda self: None)


def _half_batch(monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    from dcvc_tpu_torch.training import trainer

    orig = trainer.PFrameTrainer.train_step

    def half(self, opt, stage, clip, lambdas):
        n = clip.shape[0] // 2
        return orig(self, opt, stage, clip[:n], lambdas[:n])

    monkeypatch.setattr(trainer.PFrameTrainer, "train_step", half)


def _loss_altered(monkeypatch):
    """The loss altered where it is produced (its distortion term off by
    a part in a thousand)."""
    from dcvc_tpu_torch.training import step

    orig = step.rd_loss
    monkeypatch.setattr(step, "rd_loss",
                        lambda *a, **k: orig(*a, **k) * 1.001)


FAULTS = {
    "dc_1080p_stream": [_state_unchanged, _symbol_altered, _recon_altered],
    "evc_ll_1080p_stream": [_symbol_altered, _recon_altered],
    "dc_train_256": [_update_skipped, _half_batch, _loss_altered],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs],
                         ids=lambda v: getattr(v, "__name__", v))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    _tiny.shrink(monkeypatch, crop=64, batch=2, pool=4, remat=False)
    fault(monkeypatch)
    out = _tiny.run(cell, seconds=0.3)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", ["dc_1080p_stream", "dc_train_256"])
def test_sound_run_is_correct(cell, monkeypatch):
    _tiny.shrink(monkeypatch, crop=64, batch=2, pool=4, remat=False)
    assert _tiny.run(cell, seconds=0.3)["correct"] is True
