"""Model complexity report of the port: parity with
``tools/model_complexity.py`` (EVC/model_complexity.py: ptflops MACs and
parameters at 1920x1088).

    python -m dcvc_tpu_torch.tools.model_complexity --model evc_LL \\
        [--height 1088 --width 1920] [--device cuda|cpu]

Prints the parameter count of the module and the forward's convolution
FLOPs at ``--height`` x ``--width``, reckoned from the shapes of the
convolution modules the forward runs (``conv_flops``), with the
convolutions' MACs per pixel and the forward's wall time. The JAX tool's
MACs/pixel is XLA's count of every op, so the two figures differ by the
non-convolution ops; its XLA "bytes accessed" figure has no counterpart
here and is not reported. Runs on the card
unless ``--device cpu``; without a card it exits with the device message.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.nn as nn


def conv_flops(module: nn.Module, fn) -> float:
    """FLOPs of every ``nn.Conv2d`` / ``nn.ConvTranspose2d`` of ``module``
    that ``fn()`` runs, reckoned from the shapes: 2 x output elements x
    (input channels / groups) x kh x kw, and for a transposed convolution
    2 x input elements x (output channels / groups) x kh x kw. Functional
    convolutions (GDN's normaliser) are not counted."""
    total = [0.0]

    def hook(conv, inputs, out):
        kh, kw = conv.kernel_size
        if isinstance(conv, nn.ConvTranspose2d):
            total[0] += (2.0 * inputs[0].numel() * conv.out_channels
                         / conv.groups * kh * kw)
        else:
            total[0] += (2.0 * out.numel() * conv.in_channels / conv.groups
                         * kh * kw)

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def count_params(module: nn.Module) -> int:
    """The module's parameter count (its buffers aside)."""
    return sum(p.numel() for p in module.parameters())


def forward_fn(name: str, module: nn.Module, x: torch.Tensor):
    """The forward the JAX tool lowers for ``name``, on ``x`` [1, 3, H, W]."""
    one = torch.ones((), device=x.device)
    if name.startswith(("evc", "intra_hem")):
        return lambda: module(x, one)
    if name == "intra_dc":
        return lambda: module(x, one, one)
    if name.startswith("dmc_dc"):
        dpb = {"ref_frame": x, "ref_feature": None, "ref_mv_feature": None,
               "ref_y": None, "ref_mv_y": None}
        qs = {k: one for k in ("mv_enc", "mv_dec", "y_enc", "y_dec")}
        return lambda: module(x, dpb, qs, 0)
    return lambda: module(x)


def complexity(name: str, height: int = 1088, width: int = 1920,
               device=None) -> dict:
    """Parameters, convolution FLOPs and the wall time of one forward
    (after a warm-up one) of registry model ``name``."""
    from ..models.registry import build

    module, rt = build(name, device=device)
    dev = rt.device
    params = count_params(module)
    x = torch.zeros(1, 3, height, width, device=dev)
    fn = forward_fn(name, module, x)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        flops = conv_flops(module, fn)
        sync()
        t = time.time()
        fn()
        sync()
        wall_ms = (time.time() - t) * 1e3
    return {"model": name, "params": params, "conv_flops": flops,
            "conv_macs_per_pixel": flops / 2 / (height * width),
            "forward_ms": wall_ms, "height": height, "width": width}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="conv MACs/pixel counts the convolutions only, where the JAX "
               "tool's MACs/pixel is XLA's count of every op. The JAX "
               "tool's XLA 'bytes accessed' figure has no counterpart "
               "here; it is not reported.")
    p.add_argument("--model", default="evc_LL")
    p.add_argument("--height", type=int, default=1088)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"error: {e}")
    row = complexity(args.model, args.height, args.width, device)
    print(f"{args.model}: {row['params'] / 1e6:.3f} M params")
    print(f"forward @ {args.width}x{args.height}: "
          f"{row['conv_flops'] / 1e9:.2f} conv GFLOPs, "
          f"{row['forward_ms']:.1f} ms")
    print(f"conv MACs/pixel: {row['conv_macs_per_pixel'] / 1e3:.1f}K")
    return row


if __name__ == "__main__":
    main()
