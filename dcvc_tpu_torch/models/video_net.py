"""Motion and context networks of DCVC-DC (NCHW).

Counterpart of ``dcvc_tpu/models/video_net.py``. Parity targets:
  * ME_Spynet / MEBasic (DCVC-DC/src/models/video_net.py:79-126),
  * OffsetDiversity (video_model.py:26-63),
  * FeatureExtractor / MultiScaleContextFusion (video_model.py:66-118),
  * hyper enc/dec factories (video_net.py:217-251).
``dtype`` is the compute dtype of ``layers/blocks.py``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..layers.blocks import (Conv2d, LeakyReLU, ResBlock, avg_pool2, conv,
                             set_compute_dtype, subpel_conv)
from ..ops.warp import bilinear_up2, default_od_warp_mode, resolve_warp_fn


class MEBasic(nn.Module):
    def __init__(self, dtype=None):
        super().__init__()
        self.conv1 = conv(8, 32, 7)
        self.conv2 = conv(32, 64, 7)
        self.conv3 = conv(64, 32, 7)
        self.conv4 = conv(32, 16, 7)
        self.conv5 = conv(16, 2, 7)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        x = torch.relu(self.conv3(x))
        x = torch.relu(self.conv4(x))
        return self.conv5(x)


class MESpynet(nn.Module):
    """4-level coarse-to-fine optical flow (im1 = current, im2 = reference)."""

    def __init__(self, me_warp_mode: str | None = None, levels: int = 4,
                 dtype=None):
        super().__init__()
        self.levels = levels
        self.me_warp_mode = me_warp_mode
        self.moduleBasic = nn.ModuleList([MEBasic(dtype)
                                          for _ in range(levels)])

    def forward(self, im1, im2):
        warp = resolve_warp_fn(self.me_warp_mode or "exact")
        im1_list, im2_list = [im1], [im2]
        for _ in range(self.levels - 1):
            im1_list.append(avg_pool2(im1_list[-1]))
            im2_list.append(avg_pool2(im2_list[-1]))
        B, _, Hc, Wc = im2_list[-1].shape
        flow = torch.zeros(B, 2, Hc // 2, Wc // 2, dtype=im1.dtype,
                           device=im1.device)
        for level in range(self.levels):
            flow_up = bilinear_up2(flow) * 2.0
            idx = self.levels - 1 - level
            inp = torch.cat([im1_list[idx], warp(im2_list[idx], flow_up),
                             flow_up], dim=1)
            flow = flow_up + self.moduleBasic[level](inp)
        return flow


class OffsetDiversity(nn.Module):
    """Deformable-warp generalisation: G groups x O offsets with masks.

    All ``B*G*O`` warp maps go through ONE warp call; map ``k = o*G + g``
    warps feature group ``g``. ``warp_mode`` None picks the device default
    (the block kernel on the card, exact on the CPU). The fusion is the
    reference's ``groups=G`` 1x1 conv; with a compute dtype it convolves in
    that dtype and adds the f32 bias, so its output is f32, as the JAX
    package's bf16 ``jnp.dot(warped, dense) + b`` (video_net.py:159-162)."""

    compute_dtype = None

    def __init__(self, in_channel: int = 48, aux_feature_num: int = 48 + 3 + 2,
                 offset_num: int = 2, group_num: int = 16,
                 max_residue_magnitude: float = 40.0,
                 warp_mode: str | None = None, warp_chunks: int = 1,
                 dtype=None):
        super().__init__()
        self.in_channel = in_channel
        self.offset_num = offset_num
        self.group_num = group_num
        self.max_residue_magnitude = max_residue_magnitude
        self.warp_mode = warp_mode
        self.warp_chunks = warp_chunks
        self.conv_offset = nn.Sequential(
            Conv2d(aux_feature_num, 64, 3, 2, 1), LeakyReLU(0.1),
            Conv2d(64, 64, 3, 1, 1), LeakyReLU(0.1),
            Conv2d(64, 3 * group_num * offset_num, 3, 1, 1))
        self.fusion = nn.Conv2d(in_channel * offset_num, in_channel, 1, 1,
                                groups=group_num)
        set_compute_dtype(self, dtype)

    def forward(self, x, aux_feature, flow):
        B, C, H, W = x.shape
        G, O = self.group_num, self.offset_num
        out = bilinear_up2(self.conv_offset(aux_feature))
        o1, o2, mask = out.chunk(3, dim=1)
        mask = torch.sigmoid(mask)                          # [B, G*O, H, W]
        offset = self.max_residue_magnitude * torch.tanh(torch.cat([o1, o2], 1))
        offset = offset + flow.repeat(1, G * O, 1, 1)
        # maps ordered (b, o, g): channels (2k, 2k+1) of map k are (dx, dy)
        off = offset.reshape(B * G * O, 2, H, W)
        xg = x.reshape(B, 1, G, C // G, H, W).expand(B, O, G, C // G, H, W)
        xg = xg.reshape(B * O * G, C // G, H, W)
        m = mask.reshape(B * G * O, 1, H, W)
        warp = resolve_warp_fn(self.warp_mode or default_od_warp_mode(x.device))
        if self.warp_chunks > 1:  # sequential chunks cut peak memory
            warped = torch.cat([warp(a, b) for a, b in zip(
                xg.chunk(self.warp_chunks), off.chunk(self.warp_chunks))])
        else:
            warped = warp(xg, off)
        warped = (warped * m).reshape(B, G * O * (C // G), H, W)
        dt = self.compute_dtype
        if dt is None:
            return self.fusion(warped)
        f = self.fusion
        return (f._conv_forward(warped.to(dt), f.weight.to(dt), None)
                + f.bias.view(-1, 1, 1))


class FeatureExtractor(nn.Module):
    def __init__(self, ch=(48, 64, 96), dtype=None):
        super().__init__()
        c1, c2, c3 = ch
        self.conv1 = conv(c1, c1, 3)
        self.res_block1 = ResBlock(c1)
        self.conv2 = conv(c1, c2, 3, 2)
        self.res_block2 = ResBlock(c2)
        self.conv3 = conv(c2, c3, 3, 2)
        self.res_block3 = ResBlock(c3)
        set_compute_dtype(self, dtype)

    def forward(self, feature):
        layer1 = self.res_block1(self.conv1(feature))
        layer2 = self.res_block2(self.conv2(layer1))
        layer3 = self.res_block3(self.conv3(layer2))
        return layer1, layer2, layer3


class MultiScaleContextFusion(nn.Module):
    def __init__(self, ch=(48, 64, 96), dtype=None):
        super().__init__()
        c1, c2, c3 = ch
        self.conv3_up = subpel_conv(c3, c2, 2, 3)
        self.res_block3_up = ResBlock(c2)
        self.conv3_out = conv(c3, c3, 3)
        self.res_block3_out = ResBlock(c3)
        self.conv2_up = subpel_conv(c2 * 2, c1, 2, 3)
        self.res_block2_up = ResBlock(c1)
        self.conv2_out = conv(c2 * 2, c2, 3)
        self.res_block2_out = ResBlock(c2)
        self.conv1_out = conv(c1 * 2, c1, 3)
        self.res_block1_out = ResBlock(c1)
        set_compute_dtype(self, dtype)

    def forward(self, context1, context2, context3):
        c3_up = self.res_block3_up(self.conv3_up(context3))
        c3_out = self.res_block3_out(self.conv3_out(context3))
        cat32 = torch.cat([c3_up, context2], dim=1)
        c2_up = self.res_block2_up(self.conv2_up(cat32))
        c2_out = self.res_block2_out(self.conv2_out(cat32))
        cat21 = torch.cat([c2_up, context1], dim=1)
        c1_out = self.res_block1_out(self.conv1_out(cat21))
        return context1 + c1_out, context2 + c2_out, context3 + c3_out


def HyperEnc(y_ch: int, z_ch: int, dtype=None) -> nn.Sequential:
    """Full-depth hyper encoder (video_net.py:227-237)."""
    return set_compute_dtype(nn.Sequential(
        conv(y_ch, z_ch, 3), LeakyReLU(), conv(z_ch, z_ch, 3),
        LeakyReLU(), conv(z_ch, z_ch, 3, 2), LeakyReLU(),
        conv(z_ch, z_ch, 3), LeakyReLU(), conv(z_ch, z_ch, 3, 2)), dtype)


def HyperEncReduced(y_ch: int, z_ch: int, dtype=None) -> nn.Sequential:
    """reduce_enc_layer variant (video_net.py:218-226)."""
    return set_compute_dtype(nn.Sequential(
        conv(y_ch, z_ch, 3), LeakyReLU(), conv(z_ch, z_ch, 3, 2),
        LeakyReLU(), conv(z_ch, z_ch, 3, 2)), dtype)


def HyperDec(z_ch: int, y_ch: int, dtype=None) -> nn.Sequential:
    return set_compute_dtype(nn.Sequential(
        conv(z_ch, y_ch, 3), LeakyReLU(), subpel_conv(y_ch, y_ch, 2),
        LeakyReLU(), conv(y_ch, y_ch, 3), LeakyReLU(),
        subpel_conv(y_ch, y_ch, 2), LeakyReLU(), conv(y_ch, y_ch, 3)),
        dtype)
