"""dcvc_tpu_torch: the PyTorch/CUDA port of the DCVC-DC write-stream codec.

A package of its own beside ``dcvc_tpu`` (the JAX reference, which it never
imports). Modules keep the JAX package's names; inside they are NCHW
``nn.Module``s with the reference DCVC-DC torch child names, so published
``state_dict``s load with ``load_state_dict(strict=True)``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
