"""A run with the timed path broken underneath comes out not correct: for
each fault a coding cell can have, the whole run (the look for a card
skipped) on the CPU at a tiny size."""

import pytest

from benchmark.faults import (_half_batch, _loss_altered, _recon_altered,
                              _state_unchanged, _symbol_altered,
                              _symbol_moved, _update_skipped)

from . import _tiny


FAULTS = {
    "dc_1080p_stream": [_state_unchanged, _symbol_altered, _symbol_moved,
                        _recon_altered],
    "evc_ll_1080p_stream": [_symbol_altered, _symbol_moved, _recon_altered],
    "dc_train_256": [_update_skipped, _half_batch, _loss_altered],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs],
                         ids=lambda v: getattr(v, "__name__", v))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    _tiny.shrink(monkeypatch, crop=64, batch=2, pool=4, remat=False)
    fault(monkeypatch.setattr)
    out = _tiny.run(cell, seconds=0.3)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", ["dc_1080p_stream", "dc_train_256",
                                  "evc_ll_1080p_stream"])
def test_sound_run_is_correct(cell, monkeypatch):
    _tiny.shrink(monkeypatch, crop=64, batch=2, pool=4, remat=False)
    out = _tiny.run(cell, seconds=0.3)
    assert out["correct"] is True
    if "symbol_faults" in out["checks"]:
        # today's program: the reference's own symbols and bits
        values = {k: c["value"] for k, c in out["checks"].items()}
        assert values == dict.fromkeys(values, 0.0)
        assert out["samples"]["detail"]["tie_symbols"] == 0
