"""Weights across: the JAX package's param trees -> port ``state_dict``s.

The exact inverse of ``dcvc_tpu/utils/port_dc.py``'s ``convert_intra_dc``,
``convert_dmc``, ``convert_evc`` and ``convert_evc_scalable``, of
``dcvc_tpu/utils/port_hem.py``'s ``convert_intra_hem``, ``convert_dmc_hem``
and ``convert_canf_dmc``, of ``port_tcm.convert_dmc_tcm``,
``port_gen1.convert_dcvc_gen1`` and ``port_zoo.convert_zoo`` (its five
kinds): flax HWIO kernels become torch OIHW, Dense
kernels are transposed, transposed-conv kernels are flipped back, and
OffsetDiversity's block-diagonal dense fusion becomes the reference's
``groups=16`` 1x1 conv. The input is a nested dict
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

    def dense(self, t, *f):
        """flax Dense [in, out] -> torch Linear [out, in] (no bias)."""
        self._set(_key(t, "weight"), self._take((*f, "kernel")).T)

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

    def dcb(self, t, *f, two: bool, seq: bool = False):
        """DepthConvBlock (two=False) / DepthConvBlock2 (two=True);
        ``seq=True``: the EVC enc/dec variant, whose depth_conv and conv2
        are Sequentials (keys ``.0``)."""
        d = _key(t, "block.0")
        sfx = ".0" if seq else ""
        self.conv(f"{d}.conv1.0", *f, "depth_conv", "conv1")
        self.conv(f"{d}.depth_conv{sfx}", *f, "depth_conv", "depth_conv")
        self.conv(f"{d}.conv2{sfx}", *f, "depth_conv", "conv2")
        if self.has(*f, "depth_conv", "adaptor", "kernel"):
            self.conv(f"{d}.adaptor", *f, "depth_conv", "adaptor")
        ffn = _key(t, "block.1")
        if two:
            self.conv(f"{ffn}.conv", *f, "ffn", "conv")
            self.conv(f"{ffn}.conv_out", *f, "ffn", "conv_out")
        else:
            self.conv(f"{ffn}.conv.0", *f, "ffn", "conv1")
            self.conv(f"{ffn}.conv.2", *f, "ffn", "conv2")

    def dcb_upsample(self, t, *f):
        """DepthConvBlockUpsample (EVC/src/models/hyperprior.py:66-74)."""
        self.dcb(t, *f, "block", two=False)
        self.conv(_key(t, "block.2"), *f, "subpel", "conv")

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

    def gdn(self, t, *f):
        self.param(f"{t}.beta", (*f, "beta"))
        self.param(f"{t}.gamma", (*f, "gamma"))

    def bottleneck(self, t, *f):
        """EntropyBottleneck: ``_matrices`` / ``_biases`` / ``_factors``."""
        self.param(f"{t}.quantiles", (*f, "quantiles"))
        for i in range(5):
            self.param(f"{t}._matrices.{i}", (*f, f"matrix{i}"))
            self.param(f"{t}._biases.{i}", (*f, f"bias{i}"))
            if i < 4:
                self.param(f"{t}._factors.{i}", (*f, f"factor{i}"))

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
    _spynet(m)
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

    _hyper_enc(m, "mv_hyper_prior_encoder")
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
    _feature_pyramid(m)
    _ctx_enc(m, "contextual_encoder", "contextual_encoder")
    _ctx_dec(m, "contextual_decoder", "contextual_decoder")

    rg = "recon_generation_net"
    m.conv(f"{rg}.first_conv", rg, "first_conv")
    m.unet(f"{rg}.unet_1", rg, "unet_1", two=False)
    m.unet(f"{rg}.unet_2", rg, "unet_2", two=False)
    m.conv(f"{rg}.recon_conv", rg, "recon_conv")

    _ctx_hyper_enc(m)
    _hyper_dec(m, "contextual_hyper_prior_decoder")
    _temporal_prior_encoder(m)

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


def _spynet(m: FlaxToTorch, t: str = "optic_flow"):
    for lvl in range(4):
        for j in range(1, 6):
            m.conv(f"{t}.moduleBasic.{lvl}.conv{j}",
                   "optic_flow", f"basic{lvl}", f"conv{j}")


def _feature_pyramid(m: FlaxToTorch):
    """feature_extractor and context_fusion_net (DC and HEM alike)."""
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


def _ctx_enc(m: FlaxToTorch, t: str, *f):
    """ContextualEncoder (DC and HEM alike)."""
    for name in ("conv1", "res1", "conv2", "res2", "conv3", "conv4"):
        (m.resblock if name.startswith("res") else m.conv)(
            f"{t}.{name}", *f, name)


def _ctx_dec(m: FlaxToTorch, t: str, *f):
    """ContextualDecoder (DC and HEM alike)."""
    for name in ("up1", "up2", "res1", "up3", "res2", "up4"):
        (m.resblock if name.startswith("res") else m.subpel)(
            f"{t}.{name}", *f, name)


def _hyper_enc(m: FlaxToTorch, t: str):
    """HyperEnc (DC and HEM alike): convs at 0, 2, 4, 6, 8."""
    for i, idx in enumerate((0, 2, 4, 6, 8)):
        m.conv(f"{t}.{idx}", t, f"c{i + 1}")


def _ctx_hyper_enc(m: FlaxToTorch):
    enc = "contextual_hyper_prior_encoder"
    for i, idx in enumerate((0, 2, 4)):
        m.conv(f"{enc}.{idx}", enc, f"c{i + 1}")


def _temporal_prior_encoder(m: FlaxToTorch):
    m.conv("temporal_prior_encoder.0", "temporal_prior_encoder_1")
    m.conv("temporal_prior_encoder.2", "temporal_prior_encoder_2")


def _hyper_dec(m: FlaxToTorch, t: str, up: str = "up"):
    """HyperDec: Sequential keys .0 .2(subpel) .4 .6(subpel) .8; the flax
    subpels are ``up1`` / ``up2`` (DC) or ``u1`` / ``u2`` (HEM)."""
    m.conv(f"{t}.0", t, "c1")
    m.subpel(f"{t}.2", t, f"{up}1")
    m.conv(f"{t}.4", t, "c2")
    m.subpel(f"{t}.6", t, f"{up}2")
    m.conv(f"{t}.8", t, "c3")


def _evc_encoder(m: FlaxToTorch, t: str, *f):
    m.rbws(f"{t}.0", *f, "down1")
    m.dcb(f"{t}.1", *f, "block1", two=False, seq=True)
    m.rbws(f"{t}.2", *f, "down2")
    m.dcb(f"{t}.3", *f, "block2", two=False, seq=True)
    m.rbws(f"{t}.4", *f, "down3")
    m.dcb(f"{t}.5", *f, "block3", two=False, seq=True)
    m.conv(f"{t}.6", *f, "down4")


def _evc_tail(m: FlaxToTorch):
    """Everything of an EVC tree except the encoder(s)."""
    for i in range(4):
        m.dcb(f"dec.{2 * i}", "dec", f"block{i}", two=False, seq=True)
    for i in range(3):
        m.rbu(f"dec.{2 * i + 1}", "dec", f"up{i + 1}")
    m.subpel("dec.7", "dec", "up4")

    m.dcb("hyper_enc.0", "hyper_enc", "block", two=False)
    m.conv("hyper_enc.1", "hyper_enc", "down1")
    m.conv("hyper_enc.3", "hyper_enc", "down2")
    m.dcb_upsample("hyper_dec.0", "hyper_dec", "up1")
    m.dcb_upsample("hyper_dec.1", "hyper_dec", "up2")
    m.dcb("hyper_dec.2", "hyper_dec", "block", two=False)

    m.dcb("y_prior_fusion.0", "y_prior_fusion", "block1", two=False)
    m.dcb("y_prior_fusion.1", "y_prior_fusion", "block2", two=False)
    for i in range(3):
        m.dcb(f"y_spatial_prior.{i}", "y_spatial_prior", f"block{i + 1}",
              two=False)

    m.bit_estimator("bit_estimator_z", "bit_estimator_z")
    m.channel_param("q_basic", ("q_basic",))
    m.param("q_scale", ("q_scale",))


def evc_from_jax(params) -> dict:
    """EVCIntra flax params (any grid) -> port (= reference EVC) state_dict."""
    m = FlaxToTorch(params)
    _evc_encoder(m, "enc", "enc")
    _evc_tail(m)
    return m.finish()


def evc_scalable_from_jax(params) -> dict:
    """ScalableEVC flax params -> port state_dict (``encs.{i}``)."""
    m = FlaxToTorch(params)
    i = 0
    while m.has(f"encs_{i}", "down4", "kernel"):
        _evc_encoder(m, f"encs.{i}", f"encs_{i}")
        i += 1
    _evc_tail(m)
    return m.finish()


# ---- the HEM generation and the CANF-VC hybrid (port_hem.py) ----


def _hem_enc(m: FlaxToTorch, t: str, *f):
    """HemEncoder: Sequential 0..6 -> d1 r1 d2 r2 d3 r3 d4."""
    for i, name in enumerate(("d1", "r1", "d2", "r2", "d3", "r3")):
        (m.rbws if name[0] == "d" else m.resblock)(f"{t}.{i}", *f, name)
    m.conv(f"{t}.6", *f, "d4")


def _hem_dec(m: FlaxToTorch, t: str, *f):
    """HemDecoder: Sequential 0..7 -> r0 u1 r1 u2 r2 u3 r3 u4."""
    for i, name in enumerate(("r0", "u1", "r1", "u2", "r2", "u3", "r3")):
        (m.rbu if name[0] == "u" else m.resblock)(f"{t}.{i}", *f, name)
    m.subpel(f"{t}.7", *f, "u4")


def _conv3(m: FlaxToTorch, t: str):
    for i, idx in enumerate((0, 2, 4)):
        m.conv(f"{t}.{idx}", t, f"c{i}")


def _cbr(m: FlaxToTorch, t: str, *f):
    """ConvBlockResidual: conv.0 / conv.2, SE Linears conv.3.fc.0 / .2,
    up_dim."""
    m.conv(f"{t}.conv.0", *f, "conv1")
    m.conv(f"{t}.conv.2", *f, "conv2")
    m.dense(f"{t}.conv.3.fc.0", *f, "se", "fc1")
    m.dense(f"{t}.conv.3.fc.2", *f, "se", "fc2")
    m.conv(f"{t}.up_dim", *f, "up_dim")


def _hem_unet(m: FlaxToTorch, t: str, *f):
    for name in ("conv1", "conv2", "conv3"):
        _cbr(m, f"{t}.{name}", *f, name)
    for i in range(4):
        m.resblock(f"{t}.context_refine.{i}", *f, f"context_refine_{i}")
    m.subpel(f"{t}.up3", *f, "up3")
    _cbr(m, f"{t}.up_conv3", *f, "up_conv3")
    m.subpel(f"{t}.up2", *f, "up2")
    _cbr(m, f"{t}.up_conv2", *f, "up_conv2")


def _recon_gen(m: FlaxToTorch, t: str, *f):
    m.conv(f"{t}.first_conv", *f, "first_conv")
    _hem_unet(m, f"{t}.unet_1", *f, "unet_1")
    _hem_unet(m, f"{t}.unet_2", *f, "unet_2")
    m.conv(f"{t}.recon_conv", *f, "recon_conv")


def intra_hem_from_jax(params) -> dict:
    """IntraNoARHem flax params -> port (= reference) state_dict."""
    m = FlaxToTorch(params)
    _hem_enc(m, "enc", "enc")
    _hem_dec(m, "dec", "dec")
    _hyper_enc(m, "hyper_enc")
    _hyper_dec(m, "hyper_dec", "u")
    _conv3(m, "y_prior_fusion")
    _conv3(m, "y_spatial_prior")
    _hem_unet(m, "refine.0", "refine_unet")
    m.conv("refine.1", "refine_conv")
    m.bit_estimator("bit_estimator_z", "bit_estimator_z")
    m.channel_param("q_basic", ("q_basic",))
    m.param("q_scale", ("q_scale",))
    return m.finish()


def _hem_trunk(m: FlaxToTorch):
    """What DMCHem and CANFVCDmc share (port_hem._map_dmc_trunk)."""
    _spynet(m)
    _hem_enc(m, "mv_encoder", "mv_encoder")
    _hem_dec(m, "mv_decoder", "mv_decoder")
    _hyper_enc(m, "mv_hyper_prior_encoder")
    _hyper_dec(m, "mv_hyper_prior_decoder", "u")
    _conv3(m, "mv_y_prior_fusion")
    _conv3(m, "mv_y_spatial_prior")
    m.conv("feature_adaptor_I", "feature_adaptor_I")
    _feature_pyramid(m)
    _ctx_hyper_enc(m)
    _hyper_dec(m, "contextual_hyper_prior_decoder", "u")
    _temporal_prior_encoder(m)
    _conv3(m, "y_prior_fusion")
    _conv3(m, "y_spatial_prior")
    m.bit_estimator("bit_estimator_z", "bit_estimator_z")
    m.bit_estimator("bit_estimator_z_mv", "bit_estimator_z_mv")
    for n in ("mv_y_q_basic", "y_q_basic"):
        m.channel_param(n, (n,))
    for n in ("mv_y_q_scale", "y_q_scale"):
        m.param(n, (n,))


def dmc_hem_from_jax(params) -> dict:
    """DMCHem flax params -> port (= reference) state_dict."""
    m = FlaxToTorch(params)
    _hem_trunk(m)
    m.conv("feature_adaptor_P", "feature_adaptor_P")
    _ctx_enc(m, "contextual_encoder", "contextual_encoder")
    _ctx_dec(m, "contextual_decoder", "contextual_decoder")
    _recon_gen(m, "recon_generation_net", "recon_generation_net")
    return m.finish()


def canf_dmc_from_jax(params) -> dict:
    """CANFVCDmc flax params -> port (= reference) state_dict, without the
    base class's unused ``feature_adaptor_P``."""
    m = FlaxToTorch(params)
    _hem_trunk(m)
    cc = "contextual_coder"
    for i in range(2):
        _ctx_enc(m, f"{cc}.analysis{i}.model", cc, f"analysis_{i}")
        _ctx_dec(m, f"{cc}.synthesis{i}.model_part1", cc, f"synthesis_dec_{i}")
        _recon_gen(m, f"{cc}.synthesis{i}.model_part2", cc,
                   f"synthesis_recon_{i}")
    m.conv("DQ.conv1", "dq", "conv1")
    for i in range(6):
        m.conv(f"DQ.resblock.{i}.0", "dq", f"res{i}_c1")
        m.conv(f"DQ.resblock.{i}.2", "dq", f"res{i}_c2")
    m.conv("DQ.conv2", "dq", "conv2")
    m.conv("DQ.conv3", "dq", "conv3")
    return m.finish()


# ---- the TCM generation, gen-1 DCVC and the zoo (port_tcm.py,
# port_gen1.py, port_zoo.py) ----


def dmc_tcm_from_jax(params) -> dict:
    """DMCTcm flax params -> port (= reference DCVC-TCM) state_dict."""
    m = FlaxToTorch(params)
    _spynet(m)
    for i, base in enumerate((0, 4, 8)):
        m.conv(f"mv_encoder.{base}", "mv_encoder", f"down{i}")
        m.gdn(f"mv_encoder.{base + 1}", "mv_encoder", f"gdn{i}")
        m.resblock(f"mv_encoder.{base + 2}", "mv_encoder", f"res{i}")
    m.conv("mv_encoder.12", "mv_encoder", "down3")
    dec = "mv_decoder"
    for idx, name in ((0, "up0"), (4, "up1"), (6, "up2"), (8, "up3")):
        m.deconv(f"{dec}.{idx}", dec, name)
    m.resblock(f"{dec}.2", dec, "res0")
    for idx, name in ((3, "igdn0"), (5, "igdn1"), (7, "igdn2")):
        m.gdn(f"{dec}.{idx}", dec, name)
    for t in ("mv_prior_encoder", "contextual_hyper_prior_encoder"):
        for i, idx in enumerate((0, 2, 4)):
            m.conv(f"{t}.{idx}", t, f"c{i + 1}")
    for t in ("mv_prior_decoder", "contextual_hyper_prior_decoder"):
        for i, idx in enumerate((0, 2, 4)):
            m.deconv(f"{t}.{idx}", t, f"d{i + 1}")
    m.conv("feature_adaptor_I", "feature_adaptor_I")
    m.conv("feature_adaptor_P", "feature_adaptor_P")
    _feature_pyramid(m)
    enc = "contextual_encoder"
    for i in (1, 2, 3):
        m.conv(f"{enc}.conv{i}", enc, f"conv{i}")
        m.gdn(f"{enc}.gdn{i}", enc, f"gdn{i}")
    m.conv(f"{enc}.conv4", enc, "conv4")
    m.resblock(f"{enc}.res1", enc, "res1")
    m.resblock(f"{enc}.res2", enc, "res2")
    dec = "contextual_decoder"
    for i in (1, 2, 3, 4):
        m.subpel(f"{dec}.up{i}", dec, f"up{i}")
    for i in (1, 2, 3):
        m.gdn(f"{dec}.gdn{i}", dec, f"igdn{i}")
    m.resblock(f"{dec}.res1", dec, "res1")
    m.resblock(f"{dec}.res2", dec, "res2")
    tpe = "temporal_prior_encoder"
    for i in (1, 2, 3):
        m.conv(f"{tpe}.conv{i}", tpe, f"conv{i}")
        m.gdn(f"{tpe}.gdn{i}", tpe, f"gdn{i}")
    m.conv(f"{tpe}.conv4", tpe, "conv4")
    for i, idx in enumerate((0, 2, 4)):
        m.conv(f"contextual_entropy_parameter.{idx}",
               "contextual_entropy_parameter", f"c{i + 1}")
    rg = "recon_generation_net"
    m.conv(f"{rg}.feature_conv.0", rg, "conv")
    m.resblock(f"{rg}.feature_conv.1", rg, "res1")
    m.resblock(f"{rg}.feature_conv.2", rg, "res2")
    m.conv(f"{rg}.recon_conv", rg, "recon_conv")
    m.bit_estimator("bit_estimator_z", "bit_estimator_z")
    m.bit_estimator("bit_estimator_z_mv", "bit_estimator_z_mv")
    return m.finish()


def _seq(m: FlaxToTorch, t: str, leaf, ours: str, indexes):
    """Sequential children ``t.{idx}`` <- flax ``{ours}_{i}``."""
    for i, idx in enumerate(indexes):
        leaf(f"{t}.{idx}", f"{ours}_{i}")


def _res_lrelu(m: FlaxToTorch, t: str, *f):
    """ResBlock_LeakyReLU_0_Point_1: ``conv.0`` / ``conv.2``."""
    m.conv(f"{t}.conv.0", *f, "conv1")
    m.conv(f"{t}.conv.2", *f, "conv2")


def dcvc_gen1_from_jax(params) -> dict:
    """DCVCNet flax params -> port (= reference DCVC_net) state_dict."""
    m = FlaxToTorch(params)
    _spynet(m, "opticFlow")
    m.conv("feature_extract.0", "feature_extract_conv")
    m.resblock("feature_extract.1", "feature_extract_res")
    m.resblock("context_refine.0", "context_refine_res")
    m.conv("context_refine.1", "context_refine_conv")
    _seq(m, "mvEncoder", m.conv, "mv_encoder_convs", (0, 2, 4, 6))
    _seq(m, "mvEncoder", m.gdn, "mv_encoder_gdns", (1, 3, 5))
    _seq(m, "mvDecoder_part1", m.deconv, "mv_decoder_deconvs", (0, 2, 4, 6))
    _seq(m, "mvDecoder_part1", m.gdn, "mv_decoder_igdns", (1, 3, 5))
    _seq(m, "mvDecoder_part2", m.conv, "mv_refine_convs", range(0, 13, 2))
    ce = "contextualEncoder"
    _seq(m, ce, m.conv, "contextual_encoder_convs", (0, 3, 6, 8))
    _seq(m, ce, m.gdn, "contextual_encoder_gdns", (1, 4, 7))
    _seq(m, ce, lambda t, f: _res_lrelu(m, t, f), "contextual_encoder_res",
         (2, 5))
    cd = "contextualDecoder_part1"
    _seq(m, cd, m.subpel, "contextual_decoder1_subpels", (0, 2, 5, 8))
    _seq(m, cd, m.gdn, "contextual_decoder1_igdns", (1, 3, 6))
    _seq(m, cd, lambda t, f: _res_lrelu(m, t, f), "contextual_decoder1_res",
         (4, 7))
    m.conv("contextualDecoder_part2.0", "contextual_decoder2_conv1")
    m.resblock("contextualDecoder_part2.1", "contextual_decoder2_res_0")
    m.resblock("contextualDecoder_part2.2", "contextual_decoder2_res_1")
    m.conv("contextualDecoder_part2.3", "contextual_decoder2_conv2")
    _seq(m, "priorEncoder", m.conv, "prior_encoder_convs", (0, 2, 4))
    _seq(m, "mvpriorEncoder", m.conv, "mv_prior_encoder_convs", (0, 2, 4))
    _seq(m, "priorDecoder", m.deconv, "prior_decoder_deconvs", (0, 2, 4))
    _seq(m, "mvpriorDecoder", m.deconv, "mv_prior_decoder_deconvs", (0, 2, 4))
    tpe = "temporalPriorEncoder"
    _seq(m, tpe, m.conv, "temporal_prior_convs", (0, 2, 4, 6))
    _seq(m, tpe, m.gdn, "temporal_prior_gdns", (1, 3, 5))
    m.conv("auto_regressive", "auto_regressive")
    m.conv("auto_regressive_mv", "auto_regressive_mv")
    for t in ("entropy_parameters", "entropy_parameters_mv"):
        for i, idx in enumerate((0, 2, 4)):
            m.conv(f"{t}.{idx}", t, f"c{i + 1}")
    m.bit_estimator("bitEstimator_z", "bit_estimator_z")
    m.bit_estimator("bitEstimator_z_mv", "bit_estimator_z_mv")
    return m.finish()


# registry name -> port_zoo.convert_zoo's kind
ZOO_KINDS = {"bmshj2018-factorized": "factorized",
             "bmshj2018-hyperprior": "scale", "mbt2018-mean": "meanscale",
             "mbt2018": "joint", "cheng2020-anchor": "cheng2020"}


def _ar_head(m: FlaxToTorch):
    m.conv("context_prediction", "context_prediction")
    for i, idx in enumerate((0, 2, 4)):
        m.conv(f"entropy_parameters.{idx}", "entropy_parameters", f"c{i + 1}")


def zoo_from_jax(params, kind: str) -> dict:
    """A zoo model's flax params -> port (= reference CompressAI)
    state_dict; ``kind`` as ``port_zoo.convert_zoo`` takes it (the values
    of ``ZOO_KINDS``)."""
    m = FlaxToTorch(params)
    m.bottleneck("entropy_bottleneck", "entropy_bottleneck")
    if kind in ("factorized", "scale", "meanscale", "joint"):
        for i, idx in enumerate((0, 2, 4, 6)):
            m.conv(f"g_a.{idx}", "g_a", f"conv{i}")
            m.deconv(f"g_s.{idx}", "g_s", f"deconv{i}")
        for i, idx in enumerate((1, 3, 5)):
            m.gdn(f"g_a.{idx}", "g_a", f"gdn{i}")
            m.gdn(f"g_s.{idx}", "g_s", f"igdn{i}")
    if kind in ("scale", "meanscale", "joint"):
        _seq(m, "h_a", m.conv, "h_a_convs", (0, 2, 4))
        m.deconv("h_s.0", "h_s_deconvs_0")
        m.deconv("h_s.2", "h_s_deconvs_1")
        m.conv("h_s.4", "h_s_deconvs_2")
    if kind == "joint":
        _ar_head(m)
    if kind == "cheng2020":
        for i in range(6):
            t, f = f"g_a.{i}", f"g_a_blocks_{i}"
            m.resblock(t, f)
            if i % 2 == 0:
                m.gdn(f"{t}.gdn", f, "gdn")
                m.conv(f"{t}.downsample", f, "downsample")
        m.conv("g_a.6", "g_a_out")
        _seq(m, "h_a", m.conv, "h_a_convs", (0, 2, 4, 6, 8))
        m.conv("h_s.0", "h_s_conv1")
        m.subpel("h_s.2", "h_s_up1")
        m.conv("h_s.4", "h_s_conv2")
        m.subpel("h_s.6", "h_s_up2")
        m.conv("h_s.8", "h_s_conv3")
        for i in range(7):
            t, f = f"g_s.{i}", f"g_s_blocks_{i}"
            if i % 2 == 0:
                m.resblock(t, f)
            else:
                m.rbu(t, f)
                m.gdn(f"{t}.igdn", f, "igdn")
        m.subpel("g_s.7", "g_s_out")
        _ar_head(m)
    return m.finish()
