"""Weights across: the JAX package's param trees -> port ``state_dict``s.

The exact inverse of ``dcvc_tpu/utils/port_dc.py``'s ``convert_intra_dc``
and ``convert_dmc``: flax HWIO kernels become torch OIHW, transposed-conv
kernels are flipped back, and OffsetDiversity's block-diagonal dense fusion
becomes the reference's ``groups=16`` 1x1 conv. The input is a nested dict
of arrays (``{"params": ...}`` or its inside); nothing of JAX is imported.
Every leaf must be used, and the result loads with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, (*prefix, k), out)
        else:
            out[(*prefix, k)] = v


def _key(t: str, name: str) -> str:
    return f"{t}.{name}" if t else name


class FlaxToTorch:
    """Walks a flax tree with the reference's module names (the calls of
    ``port_dc._Mapper`` in the other direction)."""

    def __init__(self, params):
        tree = params["params"] if "params" in params else params
        self.flat: dict = {}
        _flatten(tree, (), self.flat)
        self.used: set = set()
        self.sd: dict = {}

    def has(self, *path) -> bool:
        return tuple(path) in self.flat

    def _take(self, path) -> np.ndarray:
        self.used.add(tuple(path))
        return np.asarray(self.flat[tuple(path)])

    def _set(self, key: str, value: np.ndarray):
        if key in self.sd:
            raise KeyError(f"duplicate {key}")
        self.sd[key] = torch.from_numpy(np.array(value, copy=True))

    # ---- leaves ----

    def conv(self, t, *f):
        """flax [kh, kw, I/g, O] -> torch [O, I/g, kh, kw] (also depthwise)."""
        self._set(_key(t, "weight"), self._take((*f, "kernel")).transpose(3, 2, 0, 1))
        self._set(_key(t, "bias"), self._take((*f, "bias")))

    def deconv(self, t, *f):
        """flax ConvTranspose [kh, kw, I, O] -> torch [I, O, kh, kw], with
        the spatial flip torch's gradient-of-conv convention needs."""
        w = self._take((*f, "kernel")).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        self._set(_key(t, "weight"), w)
        self._set(_key(t, "bias"), self._take((*f, "bias")))

    def param(self, t, f_path, shape=None):
        v = self._take(f_path)
        self._set(t, v if shape is None else v.reshape(shape))

    def channel_param(self, t, f_path):
        """NHWC (1, 1, 1, C) -> torch (1, C, 1, 1)."""
        self._set(t, self._take(f_path).transpose(0, 3, 1, 2))

    # ---- blocks (layers/blocks.py names) ----

    def rbws(self, t, *f):
        self.conv(_key(t, "conv1"), *f, "conv1")
        self.conv(_key(t, "conv2"), *f, "conv2")
        if self.has(*f, "downsample", "kernel"):
            self.conv(_key(t, "downsample"), *f, "downsample")

    def rbu(self, t, *f):
        self.conv(_key(t, "subpel_conv.0"), *f, "subpel_conv", "conv")
        self.conv(_key(t, "conv"), *f, "conv")
        self.conv(_key(t, "upsample.0"), *f, "upsample", "conv")

    def resblock(self, t, *f):
        self.conv(_key(t, "conv1"), *f, "conv1")
        self.conv(_key(t, "conv2"), *f, "conv2")
        if self.has(*f, "adaptor", "kernel"):
            self.conv(_key(t, "adaptor"), *f, "adaptor")

    def subpel(self, t, *f):
        self.conv(_key(t, "0"), *f, "conv")

    def dcb(self, t, *f, two: bool):
        d = _key(t, "block.0")
        self.conv(f"{d}.conv1.0", *f, "depth_conv", "conv1")
        self.conv(f"{d}.depth_conv", *f, "depth_conv", "depth_conv")
        self.conv(f"{d}.conv2", *f, "depth_conv", "conv2")
        if self.has(*f, "depth_conv", "adaptor", "kernel"):
            self.conv(f"{d}.adaptor", *f, "depth_conv", "adaptor")
        ffn = _key(t, "block.1")
        if two:
            self.conv(f"{ffn}.conv", *f, "ffn", "conv")
            self.conv(f"{ffn}.conv_out", *f, "ffn", "conv_out")
        else:
            self.conv(f"{ffn}.conv.0", *f, "ffn", "conv1")
            self.conv(f"{ffn}.conv.2", *f, "ffn", "conv2")

    def unet(self, t, *f, two: bool):
        for name in ("conv1", "conv2", "conv3"):
            self.dcb(_key(t, name), *f, name, two=two)
        for i in range(4):
            self.dcb(_key(t, f"context_refine.{i}"), *f, f"context_refine_{i}",
                     two=two)
        self.subpel(_key(t, "up3"), *f, "up3")
        self.dcb(_key(t, "up_conv3"), *f, "up_conv3", two=two)
        self.subpel(_key(t, "up2"), *f, "up2")
        self.dcb(_key(t, "up_conv2"), *f, "up_conv2", two=two)

    def bit_estimator(self, t, *f):
        for i in range(4):
            names = ("h", "b", "a") if i < 3 else ("h", "b")
            for n in names:
                v = self._take((*f, f"{n}{i}"))
                self._set(f"{t}.f{i + 1}.{n}", v.reshape(1, -1, 1, 1))

    def finish(self) -> dict:
        unused = sorted(set(self.flat) - self.used)
        if unused:
            raise KeyError(f"unmapped flax params: {unused[:8]} "
                           f"(+{max(0, len(unused) - 8)} more)")
        return self.sd


def intra_dc_from_jax(params) -> dict:
    """IntraNoAR flax params -> port (= reference) state_dict."""
    m = FlaxToTorch(params)
    m.rbws("enc.enc_1.0", "enc", "enc1_rbs")
    m.dcb("enc.enc_1.1", "enc", "enc1_dcb", two=True)
    m.rbws("enc.enc_2.0", "enc", "enc2_rbs1")
    m.dcb("enc.enc_2.1", "enc", "enc2_dcb1", two=True)
    m.rbws("enc.enc_2.2", "enc", "enc2_rbs2")
    m.dcb("enc.enc_2.3", "enc", "enc2_dcb2", two=True)
    m.conv("enc.enc_2.4", "enc", "enc2_down")

    m.dcb("hyper_enc.0", "hyper_enc", "dcb", two=True)
    m.conv("hyper_enc.1", "hyper_enc", "down1")
    m.conv("hyper_enc.3", "hyper_enc", "down2")
    m.rbu("hyper_dec.0", "hyper_dec", "up1")
    m.rbu("hyper_dec.1", "hyper_dec", "up2")
    m.dcb("hyper_dec.2", "hyper_dec", "dcb", two=True)

    m.dcb("y_prior_fusion.0", "y_prior_fusion_1", two=True)
    m.dcb("y_prior_fusion.1", "y_prior_fusion_2", two=True)
    for i in (1, 2, 3):
        m.conv(f"y_spatial_prior_adaptor_{i}", f"y_spatial_prior_adaptor_{i}")
    for i in range(3):
        m.dcb(f"y_spatial_prior.{i}", f"y_spatial_prior_{i + 1}", two=True)

    m.dcb("dec.dec_1.0", "dec", "dec1_dcb1", two=True)
    m.rbu("dec.dec_1.1", "dec", "dec1_up1")
    m.dcb("dec.dec_1.2", "dec", "dec1_dcb2", two=True)
    m.rbu("dec.dec_1.3", "dec", "dec1_up2")
    m.dcb("dec.dec_1.4", "dec", "dec1_dcb3", two=True)
    m.rbu("dec.dec_1.5", "dec", "dec1_up3")
    m.dcb("dec.dec_2.0", "dec", "dec2_dcb", two=True)
    m.rbu("dec.dec_2.1", "dec", "dec2_up")
    m.unet("refine.0", "refine_unet", two=True)
    m.conv("refine.1", "refine_conv")

    m.bit_estimator("bit_estimator_z", "bit_estimator_z")
    m.channel_param("q_basic_enc", ("q_basic_enc",))
    m.channel_param("q_basic_dec", ("q_basic_dec",))
    m.param("q_scale_enc", ("q_scale_enc",))
    m.param("q_scale_dec", ("q_scale_dec",))
    return m.finish()


def dmc_from_jax(params) -> dict:
    """DMC flax params -> port (= reference) state_dict."""
    m = FlaxToTorch(params)
    for lvl in range(4):
        for j in range(1, 6):
            m.conv(f"optic_flow.moduleBasic.{lvl}.conv{j}",
                   "optic_flow", f"basic{lvl}", f"conv{j}")

    m.conv("align.conv_offset.0", "align", "offset1")
    m.conv("align.conv_offset.2", "align", "offset2")
    m.conv("align.conv_offset.4", "align", "offset3")
    # block-diagonal dense (G, in_per_g, out_per_g) -> grouped 1x1 conv
    # [G*out_per_g, in_per_g, 1, 1] with groups=G
    wg = m._take(("align", "fusion_kernel"))
    G, in_per_g, out_per_g = wg.shape
    m._set("align.fusion.weight", wg.transpose(0, 2, 1)
           .reshape(G * out_per_g, in_per_g)[:, :, None, None])
    m.param("align.fusion.bias", ("align", "fusion_bias"))

    m.rbws("mv_encoder.enc_1.0", "mv_encoder", "enc1_rbs")
    m.dcb("mv_encoder.enc_1.1", "mv_encoder", "enc1_dcb", two=False)
    m.rbws("mv_encoder.enc_2", "mv_encoder", "enc2")
    m.dcb("mv_encoder.adaptor_0", "mv_encoder", "adaptor_0", two=False)
    m.dcb("mv_encoder.adaptor_1", "mv_encoder", "adaptor_1", two=False)
    m.rbws("mv_encoder.enc_3.0", "mv_encoder", "enc3_rbs")
    m.dcb("mv_encoder.enc_3.1", "mv_encoder", "enc3_dcb", two=False)
    m.conv("mv_encoder.enc_3.2", "mv_encoder", "enc3_down")

    m.dcb("mv_decoder.dec_1.0", "mv_decoder", "dec1_dcb1", two=False)
    m.rbu("mv_decoder.dec_1.1", "mv_decoder", "dec1_up1")
    m.dcb("mv_decoder.dec_1.2", "mv_decoder", "dec1_dcb2", two=False)
    m.rbu("mv_decoder.dec_1.3", "mv_decoder", "dec1_up2")
    m.dcb("mv_decoder.dec_1.4", "mv_decoder", "dec1_dcb3", two=False)
    m.rbu("mv_decoder.dec_2", "mv_decoder", "dec2")
    m.dcb("mv_decoder.dec_3.0", "mv_decoder", "dec3_dcb", two=False)
    m.subpel("mv_decoder.dec_3.1", "mv_decoder", "dec3_up")

    enc = "mv_hyper_prior_encoder"
    for i, idx in enumerate((0, 2, 4, 6, 8)):
        m.conv(f"{enc}.{idx}", enc, f"c{i + 1}")
    _hyper_dec(m, "mv_hyper_prior_decoder")

    for i in (0, 1):
        m.dcb(f"mv_y_prior_fusion_adaptor_{i}",
              f"mv_y_prior_fusion_adaptor_{i}", two=False)
    m.dcb("mv_y_prior_fusion.0", "mv_y_prior_fusion_1", two=False)
    m.dcb("mv_y_prior_fusion.1", "mv_y_prior_fusion_2", two=False)
    for i in (1, 2, 3):
        m.conv(f"mv_y_spatial_prior_adaptor_{i}",
               f"mv_y_spatial_prior_adaptor_{i}")
    for i in range(3):
        m.dcb(f"mv_y_spatial_prior.{i}", f"mv_y_spatial_prior_{i + 1}",
              two=False)

    m.conv("feature_adaptor_I", "feature_adaptor_I")
    for i in range(3):
        m.conv(f"feature_adaptor.{i}", f"feature_adaptor_{i}")
    fe = "feature_extractor"
    for i in (1, 2, 3):
        m.conv(f"{fe}.conv{i}", fe, f"conv{i}")
        m.resblock(f"{fe}.res_block{i}", fe, f"res{i}")

    fuse = "context_fusion_net"
    m.subpel(f"{fuse}.conv3_up", fuse, "conv3_up")
    m.resblock(f"{fuse}.res_block3_up", fuse, "res3_up")
    m.conv(f"{fuse}.conv3_out", fuse, "conv3_out")
    m.resblock(f"{fuse}.res_block3_out", fuse, "res3_out")
    m.subpel(f"{fuse}.conv2_up", fuse, "conv2_up")
    m.resblock(f"{fuse}.res_block2_up", fuse, "res2_up")
    m.conv(f"{fuse}.conv2_out", fuse, "conv2_out")
    m.resblock(f"{fuse}.res_block2_out", fuse, "res2_out")
    m.conv(f"{fuse}.conv1_out", fuse, "conv1_out")
    m.resblock(f"{fuse}.res_block1_out", fuse, "res1_out")

    enc = "contextual_encoder"
    m.conv(f"{enc}.conv1", enc, "conv1")
    m.resblock(f"{enc}.res1", enc, "res1")
    m.conv(f"{enc}.conv2", enc, "conv2")
    m.resblock(f"{enc}.res2", enc, "res2")
    m.conv(f"{enc}.conv3", enc, "conv3")
    m.conv(f"{enc}.conv4", enc, "conv4")

    dec = "contextual_decoder"
    m.subpel(f"{dec}.up1", dec, "up1")
    m.subpel(f"{dec}.up2", dec, "up2")
    m.resblock(f"{dec}.res1", dec, "res1")
    m.subpel(f"{dec}.up3", dec, "up3")
    m.resblock(f"{dec}.res2", dec, "res2")
    m.subpel(f"{dec}.up4", dec, "up4")

    rg = "recon_generation_net"
    m.conv(f"{rg}.first_conv", rg, "first_conv")
    m.unet(f"{rg}.unet_1", rg, "unet_1", two=False)
    m.unet(f"{rg}.unet_2", rg, "unet_2", two=False)
    m.conv(f"{rg}.recon_conv", rg, "recon_conv")

    enc = "contextual_hyper_prior_encoder"
    for i, idx in enumerate((0, 2, 4)):
        m.conv(f"{enc}.{idx}", enc, f"c{i + 1}")
    _hyper_dec(m, "contextual_hyper_prior_decoder")
    m.conv("temporal_prior_encoder.0", "temporal_prior_encoder_1")
    m.conv("temporal_prior_encoder.2", "temporal_prior_encoder_2")

    for i in (0, 1):
        m.dcb(f"y_prior_fusion_adaptor_{i}", f"y_prior_fusion_adaptor_{i}",
              two=False)
    m.dcb("y_prior_fusion.0", "y_prior_fusion_1", two=False)
    m.dcb("y_prior_fusion.1", "y_prior_fusion_2", two=False)
    for i in (1, 2, 3):
        m.conv(f"y_spatial_prior_adaptor_{i}", f"y_spatial_prior_adaptor_{i}")
    for i in range(3):
        m.dcb(f"y_spatial_prior.{i}", f"y_spatial_prior_{i + 1}", two=False)

    m.bit_estimator("bit_estimator_z", "bit_estimator_z")
    m.bit_estimator("bit_estimator_z_mv", "bit_estimator_z_mv")
    for n in ("mv_y_q_basic_enc", "mv_y_q_basic_dec",
              "y_q_basic_enc", "y_q_basic_dec"):
        m.channel_param(n, (n,))
    for n in ("mv_y_q_scale_enc", "mv_y_q_scale_dec",
              "y_q_scale_enc", "y_q_scale_dec"):
        m.param(n, (n,))
    return m.finish()


def _hyper_dec(m: FlaxToTorch, t: str):
    """HyperDec: Sequential keys .0 .2(subpel) .4 .6(subpel) .8."""
    m.conv(f"{t}.0", t, "c1")
    m.subpel(f"{t}.2", t, "up1")
    m.conv(f"{t}.4", t, "c2")
    m.subpel(f"{t}.6", t, "up2")
    m.conv(f"{t}.8", t, "c3")
