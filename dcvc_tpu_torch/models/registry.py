"""Model + runtime registry (``dcvc_tpu/models/registry.py``), DC models.

``build("intra_dc" | "dmc_dc", seed, device, state_dict=None, **kwargs)``
returns ``(module, runtime)``: the module with seeded random weights, or
``state_dict`` loaded with ``strict=True``, and its coding runtime (not yet
``update()``d). Every other name of the JAX registry waits for ROADMAP
Queue 1 item 13.
"""

from __future__ import annotations

from ..device import resolve_device

DC_MODELS = ("intra_dc", "dmc_dc")
MODEL_NAMES = [
    "evc_LL", "evc_LM", "evc_LS", "evc_ML", "evc_MM", "evc_MS", "evc_SL",
    "evc_SS", "evc_scalable",
    "intra_dc", "intra_hem",
    "bmshj2018-factorized", "bmshj2018-hyperprior", "mbt2018-mean", "mbt2018",
    "cheng2020-anchor",
    "dmc_dc", "dmc_hem", "dmc_tcm", "dcvc_gen1", "canfvc_dmc",
]


def build(name: str, seed: int = 0, device=None, state_dict=None, **kwargs):
    """Returns ``(module, runtime)`` on ``device`` (the card unless
    ``device="cpu"``)."""
    from .intra_dc import build_intra_dc
    from .runtime import DmcRuntime, IntraDcRuntime
    from .video_dc import build_dmc

    if name not in MODEL_NAMES:
        raise KeyError(f"unknown model {name}")
    if name not in DC_MODELS:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP Queue 1 item 13, the other "
            f"generations)")
    dev = resolve_device(device)
    build_fn, runtime_cls = ((build_intra_dc, IntraDcRuntime)
                             if name == "intra_dc" else (build_dmc, DmcRuntime))
    module = build_fn(seed=seed, device=dev, **kwargs)
    if state_dict is not None:
        module.load_state_dict(state_dict, strict=True)
    return module, runtime_cls(module, device=dev)
