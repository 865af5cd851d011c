"""Inputs made from ``--seed`` on the device: the weights and the frames.

Weights follow the distributions the published models start training from
(``torch.nn`` defaults): every convolution weight and bias uniform in
+-1/sqrt(fan_in), the factorized priors' parameters normal(0, 0.01), the
quantization steps and scales at 1. They are drawn in two calls of a
``torch.Generator`` on the device, one uniform and one normal, and cut
into leaves of the layout of a reference module (the published checkpoint
names, which the program loads with ``strict=True``).

Frames are a seeded smooth texture with fine detail (bicubic upsampling of
noise plus 8% noise), cropped at a moving offset: a pan of ``step`` pixels
a frame that wraps after ``period`` frames, edge-padded on the right and
bottom to a multiple of ``pad``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_ONES = ("q_basic", "q_scale")
_BITPARM = (".h", ".b", ".a")


def _rule(name: str, shape, fan_in: dict) -> tuple:
    """("ones" | "normal" | "uniform", scale) of leaf ``name``."""
    leaf = name.rsplit(".", 1)[-1]
    if any(p in leaf for p in _ONES):
        return "ones", 1.0
    if "bit_estimator" in name and any(name.endswith(s) for s in _BITPARM):
        return "normal", 0.01
    if leaf == "weight":
        n = shape[1] * math.prod(shape[2:])
        fan_in[name[:-len("weight")]] = n
        return "uniform", 1.0 / math.sqrt(n)
    if leaf == "bias":
        return "uniform", 1.0 / math.sqrt(fan_in[name[:-len("bias")]])
    raise KeyError(f"no initialisation rule for {name}")


def make_weights(layout, seed: int, device) -> dict:
    """A ``state_dict`` with the keys and shapes of module ``layout``."""
    fan_in: dict = {}
    rules = []
    for name, t in layout.state_dict().items():
        rules.append((name, tuple(t.shape), *_rule(name, t.shape, fan_in)))
    n_uni = sum(math.prod(s) for _, s, k, _ in rules if k == "uniform")
    n_norm = sum(math.prod(s) for _, s, k, _ in rules if k == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    uni = torch.rand(n_uni, generator=gen, device=device).mul_(2).sub_(1)
    norm = torch.randn(n_norm, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for name, shape, kind, scale in rules:
        n = math.prod(shape)
        if kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "uniform":
            out[name] = uni[iu:iu + n].view(shape).mul_(scale)
            iu += n
        else:
            out[name] = norm[inn:inn + n].view(shape).mul_(scale)
            inn += n
    return out


def texture(seed: int, height: int, width: int, device) -> torch.Tensor:
    """[1, 3, height, width] f32 in [0, 1]: smooth noise upsampled 16x
    (bicubic) plus 8% fine noise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.rand(1, 3, height // 16 + 8, width // 16 + 8, generator=gen,
                      device=device)
    big = F.interpolate(base, size=(height, width), mode="bicubic",
                        align_corners=False)
    detail = 0.08 * torch.rand(1, 3, height, width, generator=gen,
                               device=device)
    return (big + detail).clamp(0, 1)


class Frames:
    """Frame ``i`` of a seeded pan: [1, 3, Hp, Wp] f32 in [0, 1] on
    ``device``, ``height`` x ``width`` padded to a multiple of ``pad``."""

    def __init__(self, seed: int, height: int, width: int, pad: int,
                 step, period: int, device):
        self.h, self.w, self.pad = height, width, pad
        self.step, self.period = tuple(step), period
        self.canvas = texture(seed, height + self.step[0] * period,
                              width + self.step[1] * period, device)

    def __call__(self, i: int) -> torch.Tensor:
        k = i % self.period
        oy, ox = self.step[0] * k, self.step[1] * k
        x = self.canvas[:, :, oy:oy + self.h, ox:ox + self.w]
        ph = -self.h % self.pad
        pw = -self.w % self.pad
        return F.pad(x, (0, pw, 0, ph), mode="replicate").contiguous()
