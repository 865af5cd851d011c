"""Model + runtime registry (``dcvc_tpu/models/registry.py``): every
generation of the JAX package.

``build(name, seed, device, state_dict=None, **kwargs)`` returns
``(module, runtime)``: the module with seeded random weights, or
``state_dict`` loaded with ``strict=True``, and its coding runtime (not yet
``update()``d). ``evc_XY`` is the EVC grid (encoder size X, decoder size Y,
each L, M or S), ``evc_scalable`` the scalable encoder bank; ``intra_hem``
codes on ``EvcCodecRuntime`` and ``dmc_hem`` / ``canfvc_dmc`` on
``HemVideoRuntime``; the five CompressAI zoo names (the I-frame codecs of
TCM and gen-1) on ``IntraZooRuntime``, ``dmc_tcm`` on ``TcmVideoRuntime``
and ``dcvc_gen1`` on ``DcvcGen1Runtime``, as in the JAX registry.
"""

from __future__ import annotations

from ..device import resolve_device

EVC_MODELS = tuple(f"evc_{e}{d}" for e in "LMS" for d in "LMS")
ZOO_MODELS = ("bmshj2018-factorized", "bmshj2018-hyperprior", "mbt2018-mean",
              "mbt2018", "cheng2020-anchor")
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
    from .evc import build_evc
    from .evc_scalable import build_evc_scalable
    from .intra_dc import build_intra_dc
    from .intra_hem import build_intra_hem
    from .intra_zoo import build_zoo
    from .runtime import (DcvcGen1Runtime, DmcRuntime, EvcCodecRuntime,
                          HemVideoRuntime, IntraDcRuntime, IntraZooRuntime,
                          ScalableEvcRuntime, TcmVideoRuntime)
    from .video_canf import build_canf
    from .video_dc import build_dmc
    from .video_dcvc import build_dcvc_gen1
    from .video_hem import build_dmc_hem
    from .video_tcm import build_dmc_tcm

    if name not in MODEL_NAMES:
        raise KeyError(f"unknown model {name}")
    dev = resolve_device(device)
    if name in EVC_MODELS:
        module = build_evc(name.split("_")[1], seed=seed, device=dev, **kwargs)
        runtime_cls = EvcCodecRuntime
    elif name in ZOO_MODELS:
        module = build_zoo(name, seed=seed, device=dev, **kwargs)
        runtime_cls = IntraZooRuntime
    else:
        build_fn, runtime_cls = {
            "evc_scalable": (build_evc_scalable, ScalableEvcRuntime),
            "intra_dc": (build_intra_dc, IntraDcRuntime),
            "dmc_dc": (build_dmc, DmcRuntime),
            "intra_hem": (build_intra_hem, EvcCodecRuntime),
            "dmc_hem": (build_dmc_hem, HemVideoRuntime),
            "canfvc_dmc": (build_canf, HemVideoRuntime),
            "dmc_tcm": (build_dmc_tcm, TcmVideoRuntime),
            "dcvc_gen1": (build_dcvc_gen1, DcvcGen1Runtime)}[name]
        module = build_fn(seed=seed, device=dev, **kwargs)
    if state_dict is not None:
        module.load_state_dict(state_dict, strict=True)
    return module, runtime_cls(module, device=dev)
