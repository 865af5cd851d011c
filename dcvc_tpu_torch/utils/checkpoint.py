"""Checkpoint loading for every model of the registry: the
``load_params`` role of ``dcvc_tpu/utils/checkpoint.py``.

Two formats give a port ``state_dict``:
  * a published torch checkpoint (``.pth``, ``.pth.tar``, ``.pt``,
    ``.ckpt``): the port keeps the reference's key names, so it loads as it
    is (``weights_only=True``; a ``state_dict`` / ``net`` wrapper and a
    ``module.`` prefix are unwrapped, as the reference's get_state_dict
    does, DCVC-DC/src/utils/stream_helper.py:40-47); a plain EVC
    checkpoint loaded into ``evc_scalable`` has its one encoder ``enc.*``
    copied onto every ``encs.{i}.*``, as ``port_dc.convert_evc_scalable``
    and the reference's shape-tolerant load do
    (EVC/src/models/scalable_encoder_model.py:45-69); a CANF-VC checkpoint
    drops the ``feature_adaptor_P.*`` its DMC base class carries but never
    uses, as ``port_hem.convert_canf_dmc`` does; a zoo, TCM or gen-1
    checkpoint drops the buffers the port recomputes (CDF tables, the
    scale table, bounds, pedestals, AR masks), as ``port_zoo`` /
    ``port_gen1`` skip them;
  * the JAX package's native ``.npz`` (its ``save_params``: path-joined
    flax arrays), unflattened here and turned into a ``state_dict`` by
    ``utils/convert.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.registry import EVC_MODELS
from .convert import (ZOO_KINDS, canf_dmc_from_jax, dcvc_gen1_from_jax,
                      dmc_from_jax, dmc_hem_from_jax, dmc_tcm_from_jax,
                      evc_from_jax, evc_scalable_from_jax, intra_dc_from_jax,
                      intra_hem_from_jax, zoo_from_jax)

_FROM_JAX = {"intra_dc": intra_dc_from_jax, "dmc_dc": dmc_from_jax,
             "evc_scalable": evc_scalable_from_jax,
             "intra_hem": intra_hem_from_jax, "dmc_hem": dmc_hem_from_jax,
             "canfvc_dmc": canf_dmc_from_jax, "dmc_tcm": dmc_tcm_from_jax,
             "dcvc_gen1": dcvc_gen1_from_jax,
             **{name: evc_from_jax for name in EVC_MODELS},
             **{name: (lambda p, k=kind: zoo_from_jax(p, k))
                for name, kind in ZOO_KINDS.items()}}
TORCH_SUFFIXES = (".pth", ".pth.tar", ".pt", ".ckpt")
SCALABLE_ENC_NUM = 4
# buffers of the CompressAI-era checkpoints that the port recomputes
# (dcvc_tpu/utils/port_zoo.py:_BUFFER_SUFFIXES, port_gen1's masks)
_BUFFER_SUFFIXES = (
    "pedestal", "lower_bound.bound", "likelihood_lower_bound.bound",
    "lower_bound_scale.bound", "_offset", "_quantized_cdf", "_cdf_length",
    "scale_table", "scale_bound", "target", ".mask")
_BUFFERED = ("dmc_tcm", "dcvc_gen1", *ZOO_KINDS)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_state_dict(path: str, model: str) -> dict:
    """A port ``state_dict`` for registry model ``model`` from ``path``."""
    if model not in _FROM_JAX:
        raise KeyError(f"unknown model {model!r}")
    if path.endswith(TORCH_SUFFIXES):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        for wrapper in ("state_dict", "net"):
            if wrapper in ckpt:
                ckpt = ckpt[wrapper]
        sd = {k.removeprefix("module."): v for k, v in ckpt.items()}
        if model == "evc_scalable" and not any(k.startswith("encs.0.")
                                               for k in sd):
            enc = {k[len("enc."):]: sd.pop(k) for k in list(sd)
                   if k.startswith("enc.")}
            for i in range(SCALABLE_ENC_NUM):
                sd.update({f"encs.{i}.{k}": v.clone() for k, v in enc.items()})
        if model == "canfvc_dmc":
            sd = {k: v for k, v in sd.items()
                  if not k.startswith("feature_adaptor_P.")}
        if model in _BUFFERED:
            sd = {k: v for k, v in sd.items()
                  if not k.endswith(_BUFFER_SUFFIXES)}
        return sd
    with np.load(path) as data:
        tree = _unflatten({k: data[k] for k in data.files})
    return _FROM_JAX[model](tree)
