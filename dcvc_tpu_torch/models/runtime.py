"""Codec runtimes: device compute + host rANS entropy coding.

Counterpart of ``dcvc_tpu/models/runtime.py`` (``_RuntimeBase``,
``DmcRuntime``, ``IntraDcRuntime``; its ``_build_indexes_i16`` is
``GaussianConditionalCoder.build_indexes`` here); the layer the
reference spreads across CompressionModel.update / compress / decompress
(DCVC-DC/src/models/common_model.py:63-68, image_model.py:198-252,
video_model.py:425-557). Only int16 symbol and scale-index planes cross to
the host, in the JAX package's NHWC order, so streams are interchangeable
with ``dcvc_tpu``'s. The decode is the plain serial chain per four-part
step: scales on the device, rANS on the host, update on the device.

Frames and DPB tensors are NCHW. Runtimes run on ``cuda`` unless built with
``device="cpu"``; without a card they raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..entropy.bit_estimator import (
    build_factorized_tables,
    decode_factorized,
    encode_factorized,
)
from ..entropy.coder import AsyncEntropyCoder, EntropyCoder
from ..entropy.gaussian import GaussianConditionalCoder
from ..ops.warp import get_downsampled_shape
from . import priors
from .intra_dc import build_fine_q_tables
from .video_dc import CH_MV, G_CH, Q_SCALE_NAMES, get_dmc_q_tables


def _to_host_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def _symbols_nhwc(plane: torch.Tensor) -> np.ndarray:
    """Flat int16 symbols of a y_q plane in the stream's NHWC order."""
    q = torch.round(torch.clamp(plane.float(), -30000, 30000)).to(torch.int16)
    return _to_host_nhwc(q).reshape(-1)


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

    def _decode_four_part(self, scales_step, params, channels: int):
        """Serial four-part decode: scales -> rANS -> update, steps 0..3."""
        B, _, yh, yw = params.shape
        so_far = torch.zeros(B, channels, yh, yw, dtype=params.dtype,
                             device=params.device)
        for step in range(4):
            scales_r, means_parts = scales_step(params, so_far, step)
            y_q_r = self._host_decode(scales_r)
            so_far = priors.four_part_decode_update(
                params, so_far, y_q_r, means_parts, step)
        return so_far


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

    def _z_estimators(self):
        return ["bit_estimator_z", "bit_estimator_z_mv"]

    def get_q_for_inference(self, q_in_ckpt: bool, q_index: int) -> dict:
        names = {"mv_enc": "mv_y_q_scale_enc", "mv_dec": "mv_y_q_scale_dec",
                 "y_enc": "y_q_scale_enc", "y_dec": "y_q_scale_dec"}
        table = self._q_anchor if q_in_ckpt else self.fine_q
        return {k: self._tensor(np.float32(table[n][q_index]))
                for k, n in names.items()}

    @torch.no_grad()
    def compress(self, x, dpb, q_in_ckpt: bool, q_index: int, frame_idx: int):
        qs = self.get_q_for_inference(q_in_ckpt, q_index)
        x = self._tensor(x)
        out = self.module.compress_device(x, dpb, qs, frame_idx)
        planes = out["mv_y_q_planes"] + out["y_q_planes"]
        scales = out["mv_scales_planes"] + out["scales_planes"]
        self.entropy_coder.reset()
        self._encode_z("bit_estimator_z_mv", out["mv_z_hat"])
        self._encode_z("bit_estimator_z", out["z_hat"])
        for q, s in zip(planes, scales):
            self.gaussian.encode_with_indexes(
                self.entropy_coder, _symbols_nhwc(q),
                _to_host_nhwc(self.gaussian.build_indexes(s)).reshape(-1))
        self.entropy_coder.flush()
        return {
            "dpb": out["dpb"],
            "bit_stream": self.entropy_coder.get_encoded_stream(),
        }

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

        mv_params = m.decode_mv_prior(mv_z_hat, dpb["ref_mv_y"], yh, yw)
        mv_sofar = self._decode_four_part(
            lambda p, s, k: m.decode_scales_step(p, s, k, "mv"),
            mv_params, CH_MV)
        y_params, contexts, mv_y_hat, mv_feature = m.decode_motion_stage(
            mv_params, mv_sofar, qs["mv_dec"], dpb, z_hat, frame_idx, yh, yw)
        y_sofar = self._decode_four_part(
            lambda p, s, k: m.decode_scales_step(p, s, k, "y"),
            y_params, G_CH["16x"])
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
