"""Device resolution and the numerics every coding path relies on.

Entry points (the runtimes, the model builders and ``block_warp``) run on
``cuda`` unless the caller asks for ``device="cpu"``. Without a card and
without that request they raise; they never carry on on the CPU.

On the card the f32 paths that compute coding indexes must run in full
f32 and deterministically: the encoder and the decoder derive their scale
indexes from the same convolutions, and one bucket that differs between the
two desynchronises the rANS stream. TF32 keeps about three decimal digits,
and cuDNN's autotuner may pick different algorithms for the two sides.
"""

from __future__ import annotations

import subprocess

import torch


def exact_numerics() -> None:
    """Full-f32, deterministic convolutions and matmuls on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them (every
    time on the card is reported beside it)."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        exact_numerics()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
