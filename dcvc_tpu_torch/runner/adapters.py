"""Runtime adapters to the DC-shaped protocol the GOP runner drives
(``dcvc_tpu/runner/adapters.py:211-241``, the DC part).

The DC runtimes already speak that protocol, so adapting them is the
identity. The adapters of the other generations wait for them (ROADMAP
Queue 1 item 13).
"""

from __future__ import annotations

from ..models.runtime import DmcRuntime, IntraDcRuntime


def pad_for_model(model: str) -> int:
    """Pad-to-multiple contract per generation: DC pads to 16, older
    generations to 64. Real-coding containers desync if encoder and decoder
    disagree on it."""
    return 16 if model in ("intra_dc", "dmc_dc") else 64


def _not_ported(rt):
    return NotImplementedError(
        f"no adapter for {type(rt).__name__} yet (ROADMAP Queue 1 item 13, "
        f"the other generations)")


def adapt_i_runtime(rt):
    if isinstance(rt, IntraDcRuntime):
        return rt
    raise _not_ported(rt)


def adapt_p_runtime(rt):
    if rt is None or isinstance(rt, DmcRuntime):
        return rt
    raise _not_ported(rt)
