"""The benchmark's plain reference: float32 PyTorch, no kernels, nothing of
the program under test. ``build`` makes the reference module of a model
as its configuration file states it: ``reference`` maps each model to
``{"class": "<module>:<Class>", <arguments>}`` (a module of this package),
``widths`` adds its sizes, and a class that warps (``WARPED``) takes the
configuration's ``warps``, or ``warps`` where given (training states its
own)."""

from __future__ import annotations

import importlib


def build(name: str, cfg: dict, warps: dict | None = None):
    entry = dict(cfg["reference"][name])
    module, cls = entry.pop("class").split(":")
    cls = getattr(importlib.import_module(f"{__name__}.{module}"), cls)
    kwargs = {**entry, **cfg.get("widths", {}).get(name, {})}
    if getattr(cls, "WARPED", False):
        kwargs["warps"] = warps or cfg["warps"]
    return cls(**kwargs)
