"""Codec runtimes: device compute + host rANS entropy coding.

Counterpart of ``dcvc_tpu/models/runtime.py`` (``_RuntimeBase``,
``EvcCodecRuntime``, ``ScalableEvcRuntime``, ``IntraZooRuntime``,
``DcvcGen1Runtime``, ``TcmVideoRuntime``, ``HemVideoRuntime``,
``DmcRuntime``, ``IntraDcRuntime``; its ``_build_indexes_i16`` is
``GaussianConditionalCoder.build_indexes`` here); the layer the
reference spreads across CompressionModel.update / compress / decompress
(DCVC-DC/src/models/common_model.py:63-68, image_model.py:198-252,
video_model.py:425-557; EVC/src/models/image_model.py:131-181;
DCVC-HEM/src/models/video_model.py:263-375; DCVC-TCM/src/models/
video_net_dmc.py:321-415; DCVC/src/models/DCVC_net.py:234-420 and
priors.py). Only int16 symbol and scale-index planes cross to the host, in
the JAX package's NHWC order, so streams are interchangeable with
``dcvc_tpu``'s. The decode is the plain serial chain per prior step
(four-part or dual): scales on the device, rANS on the host, update on the
device; the pixel-AR latents of gen-1 and the zoo's joint models are coded
on the host by wavefronts (``ar_coding.py``).

Frames and DPB tensors are NCHW. Runtimes run on ``cuda`` unless built with
``device="cpu"``; without a card they raise.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..entropy.bit_estimator import (
    build_factorized_tables,
    decode_factorized,
    encode_factorized,
)
from ..entropy.bottleneck import (
    bottleneck_decode,
    bottleneck_encode,
    build_bottleneck_tables,
)
from ..entropy.coder import AsyncEntropyCoder, EntropyCoder
from ..entropy.gaussian import GaussianConditionalCoder
from ..entropy.gaussian_conditional import GaussianConditional
from ..ops.warp import get_downsampled_shape, get_padding_size
from . import priors
from .ar_coding import ArNets, ar_decode, ar_encode
from .intra_dc import build_fine_q_tables
from .video_dc import CH_MV, G_CH, Q_SCALE_NAMES, get_dmc_q_tables
from .video_dcvc import extract_ar_nets


def _to_host_nhwc(t: torch.Tensor) -> np.ndarray:
    """NHWC host copy; bf16 comes over as f32 (numpy has no bf16), as the
    JAX runtimes read their bf16 planes back."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def _symbols_nhwc(plane: torch.Tensor) -> np.ndarray:
    """Flat int16 symbols of a y_q plane in the stream's NHWC order."""
    q = torch.round(torch.clamp(plane.float(), -30000, 30000)).to(torch.int16)
    return _to_host_nhwc(q).reshape(-1)


def _dual_chain(q_step, scales, means, scales_step1, sym_source):
    """The serial dual-prior decode: step 0's scales, its symbols, step 1's
    scales from what step 0 decoded (``scales_step1``), its symbols; the two
    channel halves of y_hat before the quant step."""
    scales_r, means_pair = priors.dual_decode_scales(means, scales, q_step,
                                                     None, None, None, 0)
    h0, h1 = priors.dual_decode_update(sym_source(scales_r), means_pair, 0)
    scales_r, means_pair = scales_step1(q_step, scales, means, h0, h1)
    d0, d1 = priors.dual_decode_update(sym_source(scales_r), means_pair, 1)
    return h0 + d0, h1 + d1


class _RuntimeBase:
    """Shared machinery: device, entropy coder and baked tables."""

    y_distribution = "gaussian"

    def __init__(self, module, ec_thread=False, stream_part=1, device=None):
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        self.ec_thread = ec_thread
        self.stream_part = stream_part
        self.entropy_coder: EntropyCoder | None = None
        self.gaussian = GaussianConditionalCoder(distribution=self.y_distribution)
        self._z_tables = {}

    def update(self, force: bool = False):
        if self.entropy_coder is not None and not force:
            return
        self.entropy_coder = (AsyncEntropyCoder(self.stream_part)
                              if self.ec_thread
                              else EntropyCoder(self.stream_part))
        self.gaussian.update(force=True)
        for name in self._z_estimators():
            self._z_tables[name] = build_factorized_tables(
                getattr(self.module, name))

    def _z_estimators(self):
        raise NotImplementedError

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _from_host_nhwc(self, a: np.ndarray) -> torch.Tensor:
        # copy into fresh NCHW strides: a permuted view with size-1 dims
        # passes as contiguous but keeps channels-last strides, and a
        # convolution may then take another algorithm than the encoder's
        # (other f32 bits, other scale indexes)
        t = torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2)
        return torch.empty(t.shape, device=self.device).copy_(t)

    # host-side helpers -----------------------------------------------------

    def _flush(self) -> bytes:
        """Ends the stream being written; its bytes."""
        self.entropy_coder.flush()
        return self.entropy_coder.get_encoded_stream()

    def _encode_z(self, name, z_hat: torch.Tensor):
        encode_factorized(self.entropy_coder, _to_host_nhwc(z_hat),
                          self._z_tables[name])

    def _decode_z(self, name, shape_nchw) -> torch.Tensor:
        n, c, h, w = shape_nchw
        return self._from_host_nhwc(decode_factorized(
            self.entropy_coder, (n, h, w, c), self._z_tables[name]))

    def _host_decode(self, scales_r: torch.Tensor) -> torch.Tensor:
        """rANS-decode one four-part plane whose scales are ``scales_r``."""
        idx = _to_host_nhwc(self.gaussian.build_indexes(scales_r))
        return self._from_host_nhwc(
            self.gaussian.decode_with_indexes(self.entropy_coder, idx))

    def _decode_four_part(self, scales_step, params, channels: int,
                          sym_source=None):
        """Serial four-part decode: scales -> rANS -> update, steps 0..3.
        ``sym_source(scales_r)`` supplies each step's symbol plane: host
        rANS by default; the aligned encode feeds known symbols. The f32
        plane takes the prior's dtype, as in the JAX package."""
        sym_source = sym_source or self._host_decode
        B, _, yh, yw = params.shape
        so_far = torch.zeros(B, channels, yh, yw, dtype=params.dtype,
                             device=params.device)
        for step in range(4):
            scales_r, means_parts = scales_step(params, so_far, step)
            y_q_r = sym_source(scales_r).to(params.dtype)
            so_far = priors.four_part_decode_update(
                params, so_far, y_q_r, means_parts, step)
        return so_far


class EvcCodecRuntime(_RuntimeBase):
    """Runtime for the EVC intra family (dual-part checkerboard prior).

    Parity: EVC/src/models/image_model.py:131-181 compress / decompress.
    Stream order: z, then the two dual-prior symbol planes. As in the JAX
    package, the encoder always codes with decoder-aligned indexes: z and
    the plane-0 symbols re-enter as fresh NCHW tensors, exactly as the
    decoder receives them from host rANS, and the indexes come from the
    decoder's own functions (``_decode_dual``).
    """

    y_distribution = "gaussian"

    def _z_estimators(self):
        return ["bit_estimator_z"]

    @torch.no_grad()
    def forward(self, x, q_scale):
        """Estimated-bits forward: ``{"x_hat", "bit", "bpp", ...}``."""
        return self.module(self._tensor(x), self._tensor(q_scale))

    @torch.no_grad()
    def compress(self, x, q_scale):
        out = self.module.compress_device(self._tensor(x),
                                          self._tensor(q_scale))
        return {"bit_stream": self._encode_aligned(out),
                "x_hat": out["x_hat"]}

    def _decode_dual(self, z_hat, sym_source):
        """The decoder's chain from z to the two halves of y_hat (before the
        quant step) and q_step; ``sym_source(scales_r)`` gives each dual
        step's symbol plane."""
        m = self.module
        q_step, scales, means = m.prior_params(z_hat)
        half0, half1 = _dual_chain(q_step, scales, means, m.dual_scales_step1,
                                   sym_source)
        return half0, half1, q_step

    def _encode_aligned(self, out) -> bytes:
        """Write z and the symbol planes of ``compress_device``'s ``out``
        with the indexes the decoder derives from them."""
        z_np = _to_host_nhwc(out["z_hat"])
        planes = [_to_host_nhwc(torch.round(torch.clamp(q, -30000, 30000)))
                  for q in out["y_q_planes"]]
        indexes = []

        def sym_source(scales_r):
            indexes.append(_to_host_nhwc(self.gaussian.build_indexes(scales_r)))
            return self._from_host_nhwc(planes[len(indexes) - 1])

        self._decode_dual(self._from_host_nhwc(z_np), sym_source)
        self.entropy_coder.reset()
        self._encode_z("bit_estimator_z", out["z_hat"])
        for sym, idx in zip(planes, indexes):
            self.gaussian.encode_with_indexes(self.entropy_coder, sym, idx)
        self.entropy_coder.flush()
        return self.entropy_coder.get_encoded_stream()

    @torch.no_grad()
    def decompress(self, bit_stream, height, width, q_scale):
        self.entropy_coder.set_stream(bit_stream)
        zh, zw = get_downsampled_shape(height, width, 64)
        z_hat = self._decode_z("bit_estimator_z", (1, self.module.N, zh, zw))
        half0, half1, q_step = self._decode_dual(z_hat, self._host_decode)
        y_hat = torch.cat([half0, half1], dim=1) * torch.clamp_min(q_step, 0.5)
        x_hat = self.module.synthesize(y_hat, self._tensor(q_scale))
        return {"x_hat": torch.clamp(x_hat, 0.0, 1.0)}


class ScalableEvcRuntime(EvcCodecRuntime):
    """Scale_EVC: RD-cost encoder selection at encode time
    (EVC/src/models/scalable_encoder_model.py:143-160). The encoder id is
    picked from the forward of the whole bank, then the stream is coded
    with that encoder; the decoder does not depend on it."""

    def __init__(self, module, ec_thread=False, stream_part=1, device=None,
                 rate_idx: int = 0):
        super().__init__(module, ec_thread, stream_part, device)
        self.rate_idx = rate_idx

    def _choose(self, x, q_scale):
        from .evc_scalable import choose_encoder_id

        out = self.module(x, q_scale, None)
        return out, choose_encoder_id(out["mse"], out["bpp"], self.rate_idx)

    @torch.no_grad()
    def forward(self, x, q_scale):
        """Forward of the whole bank + RD argmin (the reference's
        no-stream path)."""
        out, cid = self._choose(self._tensor(x), self._tensor(q_scale))
        return {"x_hat": out["x_hat"][cid:cid + 1], "bit": out["bit"][cid],
                "bpp": out["bpp"][cid:cid + 1], "enc_id": cid}

    @torch.no_grad()
    def compress(self, x, q_scale):
        x, q_scale = self._tensor(x), self._tensor(q_scale)
        _, cid = self._choose(x, q_scale)
        out = self.module.compress_device(x, q_scale, cid)
        return {"bit_stream": self._encode_aligned(out),
                "x_hat": out["x_hat"], "enc_id": cid}


class IntraZooRuntime(_RuntimeBase):
    """Runtime for the CompressAI-style intra zoo (``intra_zoo.py``).

    Parity: DCVC/src/models/priors.py compress / decompress per family:
    one string per latent (``[y]`` or ``[y, z]``), z (the factorized
    model: y) through the EntropyBottleneck, y through the 64-level
    GaussianConditional, one-shot or, for the joint models (``mbt2018``,
    ``cheng2020-anchor``), by host wavefronts. The joint models start
    with one part, as in the JAX package; a caller may set
    ``stream_part`` before ``update``, and the z and one-shot y strings
    take it (the JAX package's bytes). The wavefront y string keeps one
    part: its decoder meets the symbols one wavefront at a time, and the
    JAX package's multi-part AR strings do not decode (ROADMAP R5).
    """

    _KINDS = {"FactorizedPrior": "factorized", "ScaleHyperprior": "scale",
              "MeanScaleHyperprior": "meanscale",
              "JointAutoregressiveHierarchicalPriors": "joint",
              "Cheng2020Anchor": "joint"}

    def __init__(self, module, ec_thread=False, stream_part=1, device=None):
        kind = self._KINDS[type(module).__name__]
        super().__init__(module, False, 1 if kind == "joint" else stream_part,
                         device)
        self.kind = kind
        self.gaussian = GaussianConditional()
        self._table = self._medians = self._ar_nets = None
        self._ar_coder = None

    def update(self, force: bool = False):
        if self.entropy_coder is not None and not force:
            return
        m = self.module
        self.entropy_coder = EntropyCoder(self.stream_part)
        self._ar_coder = EntropyCoder(1) if self.kind == "joint" else None
        self.gaussian.update(force=True)
        self._table = build_bottleneck_tables(m.entropy_bottleneck)
        self._medians = (m.entropy_bottleneck.medians().detach().float()
                         .cpu().numpy())
        if self.kind == "joint":
            self._ar_nets = ArNets.from_modules(
                m.context_prediction, m.entropy_parameters, means_first=False)

    def latent_shape(self, height: int, width: int) -> tuple:
        """(H, W) of the latent ``decompress`` decodes first, for a frame
        of ``height`` x ``width`` padded to 64: y (the factorized model,
        stride 16) or z (stride 64)."""
        pl, pr, pt, pb = get_padding_size(height, width, 64)
        ds = 16 if self.kind == "factorized" else 64
        return (height + pt + pb) // ds, (width + pl + pr) // ds

    @torch.no_grad()
    def forward(self, x):
        """Estimated-bits I-frame: ``{"x_hat", "bit", "bpp", ...}``."""
        return self.module(self._tensor(x))

    def _bottleneck(self, plane: np.ndarray) -> tuple:
        """Codes an NHWC plane with the bottleneck: (string, its
        dequantized values as the decoder gets them)."""
        self.entropy_coder.reset()
        bottleneck_encode(self.entropy_coder, plane, self._medians,
                          self._table)
        medians = self._medians.reshape(1, 1, 1, -1)
        return self._flush(), self._from_host_nhwc(
            np.round(plane - medians) + medians)

    @torch.no_grad()
    def compress(self, x):
        """``{"strings", "shape" (the coded latent's H, W), "x_hat"}``."""
        m, coder = self.module, self.entropy_coder
        x = self._tensor(x)
        if self.kind == "factorized":
            y = _to_host_nhwc(m.analyze(x))
            y_string, y_hat = self._bottleneck(y)
            return {"strings": [y_string], "shape": y.shape[1:3],
                    "x_hat": m.synthesize(y_hat)}

        y, z = m.analyze(x)
        z_string, z_hat = self._bottleneck(_to_host_nhwc(z))
        y_np = _to_host_nhwc(y)
        coder.reset()
        if self.kind == "scale":
            self.gaussian.encode(coder, y_np,
                                 _to_host_nhwc(m.scales_from_z(z_hat)))
            y_hat = torch.round(y)
        elif self.kind == "meanscale":
            scales, means = m.params_from_z(z_hat)
            self.gaussian.encode(coder, y_np, _to_host_nhwc(scales),
                                 _to_host_nhwc(means))
            y_hat = torch.round(y - means) + means
        else:
            hyper = _to_host_nhwc(m.hyper_from_z(z_hat))
            coder = self._ar_coder
            coder.reset()
            y_hat = self._from_host_nhwc(ar_encode(
                y_np[0], hyper[0], self._ar_nets, self.gaussian, coder)[None])
        coder.flush()
        return {"strings": [coder.get_encoded_stream(), z_string],
                "shape": tuple(z.shape[2:]), "x_hat": m.synthesize(y_hat)}

    @torch.no_grad()
    def decompress(self, strings, shape_hw):
        m, coder = self.module, self.entropy_coder
        if self.kind == "factorized":
            coder.set_stream(strings[0])
            y_hat = bottleneck_decode(coder, (1, *shape_hw, m.M),
                                      self._medians, self._table)
            return {"x_hat": m.synthesize(self._from_host_nhwc(y_hat))}

        y_string, z_string = strings
        coder.set_stream(z_string)
        z_hat = self._from_host_nhwc(bottleneck_decode(
            coder, (1, *shape_hw, m.N), self._medians, self._table))
        if self.kind == "joint":
            coder = self._ar_coder
        coder.set_stream(y_string)
        if self.kind == "scale":
            y_hat = self.gaussian.decode(
                coder, _to_host_nhwc(m.scales_from_z(z_hat)))
        elif self.kind == "meanscale":
            scales, means = m.params_from_z(z_hat)
            y_hat = self.gaussian.decode(coder, _to_host_nhwc(scales),
                                         _to_host_nhwc(means))
        else:
            hyper = _to_host_nhwc(m.hyper_from_z(z_hat))
            y_shape = (shape_hw[0] * 4, shape_hw[1] * 4, m.M)
            y_hat = ar_decode(y_shape, hyper[0], self._ar_nets,
                              self.gaussian, coder)[None]
        return {"x_hat": m.synthesize(self._from_host_nhwc(y_hat))}


class DcvcGen1Runtime(_RuntimeBase):
    """Runtime for DCVCNet (gen-1): hyper priors and pixel-AR latents.

    Parity: DCVC/src/models/DCVC_net.py:234-420 compress / decompress with
    four substreams (mv_z, mv_y, z, y). The AR loops run on the host by
    wavefronts. The streams start with one part, as in the JAX package; a
    caller may set ``stream_part`` before ``update``, and the z strings
    take it (the JAX package's bytes). The wavefront mv_y and y strings
    keep one part: their decoder meets the symbols one wavefront at a
    time, and the JAX package's multi-part AR strings do not decode
    (ROADMAP R5).
    """

    y_distribution = "laplace"

    def __init__(self, module, ec_thread=False, stream_part=1, device=None):
        super().__init__(module, ec_thread, 1, device)
        self._ar_nets = self._ar_coder = None

    def _z_estimators(self):
        return ["bitEstimator_z", "bitEstimator_z_mv"]

    def update(self, force: bool = False):
        super().update(force)
        if self._ar_nets is None or force:
            self._ar_coder = EntropyCoder(1)
            self._ar_nets = {w: extract_ar_nets(self.module, w)
                             for w in ("mv", "y")}

    @torch.no_grad()
    def forward(self, referframe, input_image):
        """Estimated-bits P-frame: ``{"recon_image", "bit", "bpp", ...}``."""
        return self.module(self._tensor(referframe), self._tensor(input_image))

    def _ar(self, which: str, y, hyper: np.ndarray) -> tuple:
        """AR-encode latent ``y`` (NCHW) given its NHWC hyper parameters
        into a fresh one-part stream: (its bytes, its y_hat as the decoder
        gets it)."""
        coder = self._ar_coder
        coder.reset()
        y_hat = ar_encode(_to_host_nhwc(y)[0], hyper[0], self._ar_nets[which],
                          self.gaussian, coder)
        coder.flush()
        return coder.get_encoded_stream(), self._from_host_nhwc(y_hat[None])

    @torch.no_grad()
    def compress(self, referframe, input_image):
        m = self.module
        ref, x = self._tensor(referframe), self._tensor(input_image)
        mv_feature, mv_z_hat, params_mv = m.encode_analysis(ref, x)
        self.entropy_coder.reset()
        self._encode_z("bitEstimator_z_mv", mv_z_hat)
        mv_z_string = self._flush()
        mv_y_string, mv_y_hat = self._ar("mv", mv_feature,
                                         _to_host_nhwc(params_mv))

        context, temporal = m.motion_and_context(ref, mv_y_hat)
        y, z_hat, hyper = m.residual_analysis(x, context)
        self.entropy_coder.reset()
        self._encode_z("bitEstimator_z", z_hat)
        z_string = self._flush()
        y_string, y_hat = self._ar("y", y, np.concatenate(
            [_to_host_nhwc(temporal), _to_host_nhwc(hyper)], axis=-1))
        return {"mv_z_string": mv_z_string, "mv_y_string": mv_y_string,
                "z_string": z_string, "y_string": y_string,
                "recon_image": m.synthesis(y_hat, context)}

    @torch.no_grad()
    def decompress(self, referframe, mv_y_string, mv_z_string, y_string,
                   z_string, height, width):
        m, coder = self.module, self.entropy_coder
        ref = self._tensor(referframe)
        zh, zw = get_downsampled_shape(height, width, 64)
        # frames are padded to 64 for this generation, so the y latent is
        # the hyper decoder's 4x upsample of z (not ceil(w / 16), which
        # differs when the width is not a multiple of 64)
        yh, yw = zh * 4, zw * 4
        z_shape = (1, m.channel_N, zh, zw)

        coder.set_stream(mv_z_string)
        params_mv = m.mv_prior_decoder(
            self._decode_z("bitEstimator_z_mv", z_shape))
        ar_coder = self._ar_coder
        ar_coder.set_stream(mv_y_string)
        mv_y_hat = ar_decode((yh, yw, m.channel_mv),
                             _to_host_nhwc(params_mv)[0], self._ar_nets["mv"],
                             self.gaussian, ar_coder)
        context, temporal = m.motion_and_context(
            ref, self._from_host_nhwc(mv_y_hat[None]))

        coder.set_stream(z_string)
        hyper = m.prior_decoder(self._decode_z("bitEstimator_z", z_shape))
        ar_coder.set_stream(y_string)
        y_hyper = np.concatenate([_to_host_nhwc(temporal),
                                  _to_host_nhwc(hyper)], axis=-1)
        y_hat = ar_decode((yh, yw, m.channel_M), y_hyper[0],
                          self._ar_nets["y"], self.gaussian, ar_coder)
        return {"recon_image": m.synthesis(
            self._from_host_nhwc(y_hat[None]), context)}


class TcmVideoRuntime(_RuntimeBase):
    """Runtime for DMCTcm (no spatial prior: one-shot latent coding).

    Parity: DCVC-TCM/src/models/video_net_dmc.py:321-415 compress /
    decompress; one bare payload in the order z_mv, mv_y, z, y (:321-341).
    """

    y_distribution = "laplace"

    def __init__(self, module, ec_thread=False, stream_part=1, device=None):
        super().__init__(module, ec_thread, stream_part, device)
        # decoder-aligned coding indexes (_aligned_indexes): opt in, as in
        # the JAX package
        self.aligned_enc = os.environ.get("DCVC_TPU_ALIGNED_ENC") == "1"

    def _z_estimators(self):
        return ["bit_estimator_z", "bit_estimator_z_mv"]

    @torch.no_grad()
    def forward_one_frame(self, x, ref_frame, ref_feature):
        """Estimated-bits P-frame: ``{"recon_image", "feature", "bit",
        ...}``."""
        return self.module(self._tensor(x), ref_frame, ref_feature)

    def _indexes(self, scales) -> np.ndarray:
        return _to_host_nhwc(self.gaussian.build_indexes(scales)).reshape(-1)

    def _aligned_indexes(self, mv_z_hat, z_hat, mv_sym, ref_frame,
                         ref_feature):
        """Decoder-identical coding indexes of the mv_y and y planes: the
        decoder's stages with the known mv symbols in place of rANS
        (``dcvc_tpu/models/runtime.py:TcmVideoRuntime._aligned_indexes``).
        The z planes and the symbols enter as fresh NCHW f32 tensors, as
        the decoder receives them."""
        m = self.module
        mv_scales, mv_means = m.decode_mv_params(
            self._from_host_nhwc(_to_host_nhwc(mv_z_hat)))
        mv_shape = _to_host_nhwc(mv_scales).shape
        mv_y_q = self._from_host_nhwc(mv_sym.reshape(mv_shape))
        scales, _, _ = m.decode_motion_stage(
            mv_y_q + mv_means, ref_frame, ref_feature,
            self._from_host_nhwc(_to_host_nhwc(z_hat)))
        return [self._indexes(mv_scales), self._indexes(scales)]

    @torch.no_grad()
    def compress(self, x, ref_frame, ref_feature):
        out = self.module.compress_device(self._tensor(x), ref_frame,
                                          ref_feature)
        syms = [_symbols_nhwc(out["mv_y_q"]), _symbols_nhwc(out["y_q"])]
        if self.aligned_enc:
            idx = self._aligned_indexes(out["mv_z_hat"], out["z_hat"],
                                        syms[0], ref_frame, ref_feature)
        else:
            idx = [self._indexes(out["mv_scales"]),
                   self._indexes(out["scales"])]
        self.entropy_coder.reset()
        self._encode_z("bit_estimator_z_mv", out["mv_z_hat"])
        self.gaussian.encode_with_indexes(self.entropy_coder, syms[0], idx[0])
        self._encode_z("bit_estimator_z", out["z_hat"])
        self.gaussian.encode_with_indexes(self.entropy_coder, syms[1], idx[1])
        self.entropy_coder.flush()
        return {"bit_stream": self.entropy_coder.get_encoded_stream(),
                "x_hat": out["x_hat"], "feature": out["feature"]}

    @torch.no_grad()
    def decompress(self, ref_frame, ref_feature, string, height, width):
        m = self.module
        self.entropy_coder.set_stream(string)
        zh, zw = get_downsampled_shape(height, width, 64)
        z_shape = (1, m.channel_N, zh, zw)
        mv_scales, mv_means = m.decode_mv_params(
            self._decode_z("bit_estimator_z_mv", z_shape))
        mv_y_hat = self._host_decode(mv_scales) + mv_means
        z_hat = self._decode_z("bit_estimator_z", z_shape)
        scales, means, contexts = m.decode_motion_stage(
            mv_y_hat, ref_frame, ref_feature, z_hat)
        x_hat, feature = m.decode_recon_stage(
            self._host_decode(scales) + means, contexts)
        return {"x_hat": x_hat, "feature": feature}


class HemVideoRuntime(_RuntimeBase):
    """Runtime for DMCHem and CANFVCDmc (dual checkerboard priors on both
    latents).

    Parity: DCVC-HEM/src/models/video_model.py:263-375 compress /
    decompress. Stream order: z_mv, mv_y w0, mv_y w1, z, y w0, y w1
    (:306-313). The y latents are 4 z_h x 4 z_w (the pad-to-64 contract).
    ``mv_y_q_scale`` / ``y_q_scale`` are scalars.
    """

    y_distribution = "laplace"

    def __init__(self, module, ec_thread=False, stream_part=1, device=None):
        super().__init__(module, ec_thread, stream_part, device)
        # decoder-aligned coding indexes (_aligned_indexes): opt in, as in
        # the JAX package and DmcRuntime
        self.aligned_enc = os.environ.get("DCVC_TPU_ALIGNED_ENC") == "1"

    def _z_estimators(self):
        return ["bit_estimator_z", "bit_estimator_z_mv"]

    @torch.no_grad()
    def forward_one_frame(self, x, dpb, mv_y_q_scale, y_q_scale):
        """Estimated-bits P-frame: ``{"dpb", "bit", "bpp", ...}``."""
        return self.module(self._tensor(x), dpb, self._tensor(mv_y_q_scale),
                           self._tensor(y_q_scale))

    def _decode_latents(self, mv_z_hat, z_hat_fn, dpb, mv_q, yh, yw,
                        sym_source):
        """The decoder's chain from the z planes to y_hat (before its q):
        mv prior, mv dual decode, motion stage, y dual decode. ``z_hat_fn()``
        gives z when the chain reaches it (the stream holds it after the mv
        planes). Returns ``(y_hat, contexts, mv_y_hat times its q)``."""
        m = self.module
        mv_qsm = m.decode_mv_prior(mv_z_hat, dpb["ref_mv_y"], yh, yw)
        h0, h1 = _dual_chain(*mv_qsm, m.mv_dual_scales_step1, sym_source)
        mv_y_hat = torch.cat([h0, h1], dim=1) * torch.clamp_min(mv_qsm[0], 0.5)
        y_qsm, contexts, mv_y_hat = m.decode_motion_stage(
            mv_y_hat, mv_q, dpb, z_hat_fn(), yh, yw)
        h0, h1 = _dual_chain(*y_qsm, m.y_dual_scales_step1, sym_source)
        y_hat = torch.cat([h0, h1], dim=1) * torch.clamp_min(y_qsm[0], 0.5)
        return y_hat, contexts, mv_y_hat

    def _aligned_indexes(self, mv_z_hat, z_hat, sym, dpb, mv_q, yh, yw):
        """Decoder-identical coding indexes of the 4 dual-prior planes (mv
        w0, mv w1, y w0, y w1): replays the decoder's chain with the known
        symbols in place of rANS (``dcvc_tpu/models/runtime.py:
        HemVideoRuntime._aligned_indexes``). The z planes and the symbols
        enter as fresh NCHW f32 tensors, as the decoder receives them."""
        recorded = []
        offset = 0

        def sym_source(scales_r):
            nonlocal offset
            idx = _to_host_nhwc(self.gaussian.build_indexes(scales_r))
            recorded.append(idx.reshape(-1))
            plane = sym[offset:offset + idx.size].reshape(idx.shape)
            offset += idx.size
            return self._from_host_nhwc(plane)

        z_fresh = self._from_host_nhwc(_to_host_nhwc(z_hat))
        self._decode_latents(self._from_host_nhwc(_to_host_nhwc(mv_z_hat)),
                             lambda: z_fresh, dpb, mv_q, yh, yw, sym_source)
        return recorded

    @torch.no_grad()
    def compress(self, x, dpb, mv_y_q_scale, y_q_scale):
        x = self._tensor(x)
        mv_q = self._tensor(mv_y_q_scale)
        out = self.module.compress_device(x, dpb, mv_q,
                                          self._tensor(y_q_scale))
        planes = out["mv_y_q_planes"] + out["y_q_planes"]
        syms = [_symbols_nhwc(q) for q in planes]
        if self.aligned_enc:
            zh, zw = get_downsampled_shape(x.shape[2], x.shape[3], 64)
            idx = self._aligned_indexes(out["mv_z_hat"], out["z_hat"],
                                        np.concatenate(syms), dpb, mv_q,
                                        zh * 4, zw * 4)
        else:
            idx = [_to_host_nhwc(self.gaussian.build_indexes(s)).reshape(-1)
                   for s in out["mv_scales_planes"] + out["scales_planes"]]
        self.entropy_coder.reset()
        self._encode_z("bit_estimator_z_mv", out["mv_z_hat"])
        for i in (0, 1):
            self.gaussian.encode_with_indexes(self.entropy_coder, syms[i],
                                              idx[i])
        self._encode_z("bit_estimator_z", out["z_hat"])
        for i in (2, 3):
            self.gaussian.encode_with_indexes(self.entropy_coder, syms[i],
                                              idx[i])
        self.entropy_coder.flush()
        return {"dpb": out["dpb"],
                "bit_stream": self.entropy_coder.get_encoded_stream()}

    @torch.no_grad()
    def decompress(self, dpb, string, height, width, mv_y_q_scale, y_q_scale):
        m = self.module
        self.entropy_coder.set_stream(string)
        zh, zw = get_downsampled_shape(height, width, 64)
        shape = (1, m.channel_N, zh, zw)
        mv_z_hat = self._decode_z("bit_estimator_z_mv", shape)
        y_hat, contexts, mv_y_hat = self._decode_latents(
            mv_z_hat, lambda: self._decode_z("bit_estimator_z", shape), dpb,
            self._tensor(mv_y_q_scale), zh * 4, zw * 4, self._host_decode)
        x_hat, feature, y_hat = m.decode_recon_stage(
            y_hat, self._tensor(y_q_scale), contexts)
        return {"dpb": {"ref_frame": x_hat, "ref_feature": feature,
                        "ref_y": y_hat, "ref_mv_y": mv_y_hat}}


class DmcRuntime(_RuntimeBase):
    """Runtime for DMC (DCVC-DC P-frame codec, dual four-part priors).

    Parity: DCVC-DC/src/models/video_model.py:425-557 compress / decompress.
    Encode order: z_mv, z, mv_y w0..3, y w0..3 (:455-466).
    """

    y_distribution = "laplace"

    def __init__(self, module, ec_thread=False, stream_part=1, device=None):
        super().__init__(module, ec_thread, stream_part, device)
        self.fine_q = get_dmc_q_tables(self.module)
        self._q_anchor = {n: getattr(self.module, n).detach().cpu().numpy()
                          .reshape(-1) for n in Q_SCALE_NAMES}
        # decoder-aligned coding indexes (_aligned_indexes): opt in, as in
        # the JAX package; f32 with deterministic cuDNN codes the same
        # indexes either way
        self.aligned_enc = os.environ.get("DCVC_TPU_ALIGNED_ENC") == "1"

    def _z_estimators(self):
        return ["bit_estimator_z", "bit_estimator_z_mv"]

    def get_q_for_inference(self, q_in_ckpt: bool, q_index: int) -> dict:
        names = {"mv_enc": "mv_y_q_scale_enc", "mv_dec": "mv_y_q_scale_dec",
                 "y_enc": "y_q_scale_enc", "y_dec": "y_q_scale_dec"}
        table = self._q_anchor if q_in_ckpt else self.fine_q
        return {k: self._tensor(np.float32(table[n][q_index]))
                for k, n in names.items()}

    @torch.no_grad()
    def forward_one_frame(self, x, dpb, q_in_ckpt: bool = False,
                          q_index: int = 0, frame_idx: int = 0):
        """Estimated-bits P-frame: ``{"dpb", "bit", "bpp", ...}``."""
        qs = self.get_q_for_inference(q_in_ckpt, q_index)
        return self.module(self._tensor(x), dpb, qs, frame_idx % 4)

    @torch.no_grad()
    def compress(self, x, dpb, q_in_ckpt: bool, q_index: int, frame_idx: int):
        qs = self.get_q_for_inference(q_in_ckpt, q_index)
        x = self._tensor(x)
        out = self.module.compress_device(x, dpb, qs, frame_idx)
        planes = out["mv_y_q_planes"] + out["y_q_planes"]
        scales = out["mv_scales_planes"] + out["scales_planes"]
        syms = [_symbols_nhwc(q) for q in planes]
        if self.aligned_enc:
            yh, yw = x.shape[2] // 16, x.shape[3] // 16
            idx = self._aligned_indexes(out["mv_z_hat"], out["z_hat"],
                                        np.concatenate(syms), dpb, qs,
                                        frame_idx, yh, yw)
        else:
            idx = [_to_host_nhwc(self.gaussian.build_indexes(s)).reshape(-1)
                   for s in scales]
        self.entropy_coder.reset()
        self._encode_z("bit_estimator_z_mv", out["mv_z_hat"])
        self._encode_z("bit_estimator_z", out["z_hat"])
        for sym, ix in zip(syms, idx):
            self.gaussian.encode_with_indexes(self.entropy_coder, sym, ix)
        self.entropy_coder.flush()
        return {
            "dpb": out["dpb"],
            "bit_stream": self.entropy_coder.get_encoded_stream(),
        }

    def _decode_latents(self, mv_z_hat, z_hat, dpb, qs, frame_idx, yh, yw,
                        sym_source=None):
        """The decoder's chain from the z planes to the y latents: mv prior,
        mv four-part decode, motion stage, y four-part decode."""
        m = self.module
        mv_params = m.decode_mv_prior(mv_z_hat, dpb["ref_mv_y"], yh, yw)
        mv_sofar = self._decode_four_part(
            lambda p, s, k: m.decode_scales_step(p, s, k, "mv"),
            mv_params, CH_MV, sym_source)
        y_params, contexts, mv_y_hat, mv_feature = m.decode_motion_stage(
            mv_params, mv_sofar, qs["mv_dec"], dpb, z_hat, frame_idx, yh, yw)
        y_sofar = self._decode_four_part(
            lambda p, s, k: m.decode_scales_step(p, s, k, "y"),
            y_params, G_CH["16x"], sym_source)
        return y_params, y_sofar, contexts, mv_y_hat, mv_feature

    def _aligned_indexes(self, mv_z_hat, z_hat, sym, dpb, qs, frame_idx,
                         yh, yw):
        """Decoder-identical coding indexes of all 8 four-part planes
        (``dcvc_tpu/models/runtime.py:_aligned_indexes``): replays the
        decoder's chain with the known symbols in place of rANS and records
        the indexes it derives. The z planes and the symbols enter as fresh
        NCHW f32 tensors, as the decoder receives them from the host."""
        recorded = []
        offset = 0

        def sym_source(scales_r):
            nonlocal offset
            idx = _to_host_nhwc(self.gaussian.build_indexes(scales_r))
            recorded.append(idx.reshape(-1))
            n = idx.size
            plane = sym[offset:offset + n].reshape(idx.shape)
            offset += n
            return self._from_host_nhwc(plane)

        self._decode_latents(self._from_host_nhwc(_to_host_nhwc(mv_z_hat)),
                             self._from_host_nhwc(_to_host_nhwc(z_hat)), dpb,
                             qs, frame_idx, yh, yw, sym_source)
        return recorded

    @torch.no_grad()
    def decompress(self, dpb, string, height, width, q_in_ckpt: bool,
                   q_index: int, frame_idx: int):
        m = self.module
        qs = self.get_q_for_inference(q_in_ckpt, q_index)
        self.entropy_coder.set_stream(string)
        zh, zw = get_downsampled_shape(height, width, 64)
        yh, yw = get_downsampled_shape(height, width, 16)
        mv_z_hat = self._decode_z("bit_estimator_z_mv", (1, 64, zh, zw))
        z_hat = self._decode_z("bit_estimator_z", (1, G_CH["16x"], zh, zw))
        y_params, y_sofar, contexts, mv_y_hat, mv_feature = \
            self._decode_latents(mv_z_hat, z_hat, dpb, qs, frame_idx, yh, yw)
        x_hat, feature, y_hat = m.decode_recon_stage(
            y_params, y_sofar, contexts, qs["y_dec"])
        return {
            "dpb": {
                "ref_frame": x_hat,
                "ref_feature": feature,
                "ref_mv_feature": mv_feature,
                "ref_y": y_hat,
                "ref_mv_y": mv_y_hat,
            },
        }


class IntraDcRuntime(_RuntimeBase):
    """Runtime for IntraNoAR (DCVC-DC generation, four-part prior).

    Parity: DCVC-DC/src/models/image_model.py:169-252 encode_decode /
    compress / decompress with q_in_ckpt / q_index (0..63 fine table).
    """

    y_distribution = "gaussian"

    def __init__(self, module, ec_thread=False, stream_part=1, device=None):
        super().__init__(module, ec_thread, stream_part, device)
        self._q_anchor = {n: getattr(self.module, n).detach().cpu().numpy()
                          .reshape(-1) for n in ("q_scale_enc", "q_scale_dec")}
        self.q_scale_enc_fine = build_fine_q_tables(self._q_anchor["q_scale_enc"])
        self.q_scale_dec_fine = build_fine_q_tables(self._q_anchor["q_scale_dec"])

    def _z_estimators(self):
        return ["bit_estimator_z"]

    def get_q_for_inference(self, q_in_ckpt: bool, q_index: int):
        if q_in_ckpt:
            qe = self._q_anchor["q_scale_enc"][q_index]
            qd = self._q_anchor["q_scale_dec"][q_index]
        else:
            qe = self.q_scale_enc_fine[q_index]
            qd = self.q_scale_dec_fine[q_index]
        return self._tensor(np.float32(qe)), self._tensor(np.float32(qd))

    @torch.no_grad()
    def forward(self, x, q_in_ckpt: bool = False, q_index: int = 0):
        """Estimated-bits I-frame: ``{"x_hat", "bit", "bpp", ...}``."""
        qe, qd = self.get_q_for_inference(q_in_ckpt, q_index)
        return self.module(self._tensor(x), qe, qd)

    @torch.no_grad()
    def compress(self, x, q_in_ckpt: bool, q_index: int):
        qe, qd = self.get_q_for_inference(q_in_ckpt, q_index)
        out = self.module.compress_device(self._tensor(x), qe, qd)
        self.entropy_coder.reset()
        self._encode_z("bit_estimator_z", out["z_hat"])
        for q, s in zip(out["y_q_planes"], out["scales_planes"]):
            self.gaussian.encode_with_indexes(
                self.entropy_coder, _symbols_nhwc(q),
                _to_host_nhwc(self.gaussian.build_indexes(s)).reshape(-1))
        self.entropy_coder.flush()
        return {
            "bit_stream": self.entropy_coder.get_encoded_stream(),
            "x_hat": out["x_hat"],
        }

    @torch.no_grad()
    def decompress(self, bit_stream, height, width, q_in_ckpt: bool,
                   q_index: int):
        m = self.module
        _, qd = self.get_q_for_inference(q_in_ckpt, q_index)
        self.entropy_coder.set_stream(bit_stream)
        zh, zw = get_downsampled_shape(height, width, 64)
        yh, yw = get_downsampled_shape(height, width, 16)
        z_hat = self._decode_z("bit_estimator_z", (1, m.N, zh, zw))
        params = m.decode_prior(z_hat, yh, yw)
        so_far = self._decode_four_part(m.decode_scales_step, params, m.N)
        return {"x_hat": m.decode_synthesis(params, so_far, qd)}
