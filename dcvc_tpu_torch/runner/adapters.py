"""Runtime adapters to the DC-shaped protocol the GOP runner drives
(``dcvc_tpu/runner/adapters.py``):

    i.forward(x, q_in_ckpt, q_index)               -> {x_hat, bit}
    i.compress(x, q_in_ckpt, q_index)              -> {bit_stream}
    i.decompress(stream, h, w, q_in_ckpt, q_index) -> {x_hat}
    p.forward_one_frame(x, dpb, q_in_ckpt, q_index, frame_idx) -> {dpb, bit}
    p.compress(x, dpb, q_in_ckpt, q_index, frame_idx)          -> {bit_stream}
    p.decompress(dpb, stream, h, w, q_in_ckpt, q_index, frame_idx) -> {dpb}

The DC runtimes speak it already. The EVC / HEM intra runtime and the
HEM / CANF P runtime take continuous q_scales: a q_index maps to one
through the checkpoint's anchors (q_in_ckpt) or their 64-point
log-interpolated fine table. The zoo, TCM and gen-1 are per-rate models
(q ignored); the zoo's and gen-1's substreams are packed into one payload
(``utils/stream.pack_strings``).
"""

from __future__ import annotations

import torch

from ..models.intra_dc import build_fine_q_tables
from ..models.runtime import (DcvcGen1Runtime, DmcRuntime, EvcCodecRuntime,
                              HemVideoRuntime, IntraDcRuntime,
                              IntraZooRuntime, TcmVideoRuntime)
from ..utils.stream import pack_strings, unpack_strings


def pad_for_model(model: str) -> int:
    """Pad-to-multiple contract per generation: DC pads to 16, older
    generations to 64. Real-coding containers desync if encoder and decoder
    disagree on it."""
    return 16 if model in ("intra_dc", "dmc_dc") else 64


class _QTable:
    """q_index -> q_scale through a module's anchors (``q_in_ckpt``) or
    their 64-point log-interpolated fine table."""

    def __init__(self, anchors):
        self.anchors = anchors.detach().cpu().numpy().reshape(-1)
        self.fine = build_fine_q_tables(self.anchors)

    def __call__(self, q_in_ckpt: bool, q_index: int) -> float:
        return float(self.anchors[q_index] if q_in_ckpt
                     else self.fine[q_index])


class _Adapter:
    def __init__(self, rt):
        self.rt = rt

    @property
    def device(self):
        return self.rt.device

    def update(self, force: bool = False):
        self.rt.update(force)


class QScaleIntraAdapter(_Adapter):
    """EVC / HEM intra: one continuous q_scale argument."""

    def __init__(self, rt):
        super().__init__(rt)
        self._q = _QTable(rt.module.q_scale)

    def forward(self, x, q_in_ckpt, q_index):
        return self.rt.forward(x, self._q(q_in_ckpt, q_index))

    def compress(self, x, q_in_ckpt, q_index):
        return self.rt.compress(x, self._q(q_in_ckpt, q_index))

    def decompress(self, stream, height, width, q_in_ckpt, q_index):
        return self.rt.decompress(stream, height, width,
                                  self._q(q_in_ckpt, q_index))


_HEM_DPB_KEYS = ("ref_frame", "ref_feature", "ref_y", "ref_mv_y")


class HemPFrameAdapter(_Adapter):
    """DMCHem / CANFVCDmc: separate mv / y q_scales, the 4-key DPB."""

    def __init__(self, rt):
        super().__init__(rt)
        self._mv_q = _QTable(rt.module.mv_y_q_scale)
        self._y_q = _QTable(rt.module.y_q_scale)

    def _qs(self, q_in_ckpt, q_index):
        return self._mv_q(q_in_ckpt, q_index), self._y_q(q_in_ckpt, q_index)

    @staticmethod
    def _dpb(dpb):
        return {k: dpb.get(k) for k in _HEM_DPB_KEYS}

    def forward_one_frame(self, x, dpb, q_in_ckpt, q_index, frame_idx):
        return self.rt.forward_one_frame(x, self._dpb(dpb),
                                         *self._qs(q_in_ckpt, q_index))

    def compress(self, x, dpb, q_in_ckpt, q_index, frame_idx):
        return self.rt.compress(x, self._dpb(dpb),
                                *self._qs(q_in_ckpt, q_index))

    def decompress(self, dpb, stream, height, width, q_in_ckpt, q_index,
                   frame_idx):
        return self.rt.decompress(self._dpb(dpb), stream, height, width,
                                  *self._qs(q_in_ckpt, q_index))


class ZooIntraAdapter(_Adapter):
    """The CompressAI zoo (TCM / gen-1 I-frames): per-rate models, no q;
    the latents' strings packed into one payload."""

    def forward(self, x, q_in_ckpt, q_index):
        return self.rt.forward(x)

    def compress(self, x, q_in_ckpt, q_index):
        comp = self.rt.compress(x)
        return {"bit_stream": pack_strings(comp["strings"]),
                "x_hat": comp["x_hat"]}

    def decompress(self, stream, height, width, q_in_ckpt, q_index):
        return self.rt.decompress(unpack_strings(stream),
                                  self.rt.latent_shape(height, width))


class TcmPFrameAdapter(_Adapter):
    """DMCTcm: per-rate checkpoints (q ignored), the (frame, feature) DPB."""

    def forward_one_frame(self, x, dpb, q_in_ckpt, q_index, frame_idx):
        out = self.rt.forward_one_frame(x, dpb["ref_frame"],
                                        dpb["ref_feature"])
        out["dpb"] = {"ref_frame": torch.clamp(out["recon_image"], 0.0, 1.0),
                      "ref_feature": out["feature"]}
        return out

    def compress(self, x, dpb, q_in_ckpt, q_index, frame_idx):
        return self.rt.compress(x, dpb["ref_frame"], dpb["ref_feature"])

    def decompress(self, dpb, stream, height, width, q_in_ckpt, q_index,
                   frame_idx):
        out = self.rt.decompress(dpb["ref_frame"], dpb["ref_feature"],
                                 stream, height, width)
        return {"dpb": {"ref_frame": out["x_hat"],
                        "ref_feature": out["feature"]}}


class Gen1PFrameAdapter(_Adapter):
    """DCVCNet (gen-1): the ref_frame-only DPB; the mv_z / mv_y / z / y
    substreams packed into the payload (DCVC/src/utils/stream_helper.py:
    127-163)."""

    def forward_one_frame(self, x, dpb, q_in_ckpt, q_index, frame_idx):
        out = self.rt.forward(dpb["ref_frame"], x)
        out["dpb"] = {"ref_frame": out["recon_image"]}
        return out

    def compress(self, x, dpb, q_in_ckpt, q_index, frame_idx):
        comp = self.rt.compress(dpb["ref_frame"], x)
        return {"bit_stream": pack_strings([
            comp["mv_z_string"], comp["mv_y_string"], comp["z_string"],
            comp["y_string"]])}

    def decompress(self, dpb, stream, height, width, q_in_ckpt, q_index,
                   frame_idx):
        mv_z, mv_y, z, y = unpack_strings(stream)
        out = self.rt.decompress(dpb["ref_frame"], mv_y, mv_z, y, z, height,
                                 width)
        return {"dpb": {"ref_frame": out["recon_image"]}}


def adapt_i_runtime(rt):
    if isinstance(rt, IntraDcRuntime):
        return rt
    if isinstance(rt, IntraZooRuntime):
        return ZooIntraAdapter(rt)
    if isinstance(rt, EvcCodecRuntime):
        return QScaleIntraAdapter(rt)
    raise TypeError(f"no adapter for {type(rt).__name__}")


def adapt_p_runtime(rt):
    if rt is None or isinstance(rt, DmcRuntime):
        return rt
    if isinstance(rt, HemVideoRuntime):
        return HemPFrameAdapter(rt)
    if isinstance(rt, TcmVideoRuntime):
        return TcmPFrameAdapter(rt)
    if isinstance(rt, DcvcGen1Runtime):
        return Gen1PFrameAdapter(rt)
    raise TypeError(f"no adapter for {type(rt).__name__}")
