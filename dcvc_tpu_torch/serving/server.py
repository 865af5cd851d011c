"""Warm codec server: build once, serve many encode / decode requests.

Port of ``dcvc_tpu/serving/server.py``. A persistent process owning one
card (or the CPU when built with ``device="cpu"``). It builds the requested
codec(s) (any registry model, the same surface as the video CLI), warms
them at a resolution (which builds the block-warp kernel's library at first
use and bakes the CDF tables), then serves length-prefixed requests over a
Unix socket (``serving/protocol.py``). Containers on the wire are
byte-identical to the CLIs' ``.bin`` files (``utils/stream.pack_i`` /
``pack_p``), so server streams and CLI streams interoperate.

Ops (``header["op"]``):
  ping                                    -> server / model info
  encode_image  {q_index,q_in_ckpt,height,width,[want_recon]}
                payload [rgb u8/f32 HWC]  -> {bpp}, payloads [container,
                                              (recon u8)]
  decode_image  payload [container]       -> {height,width}, payload [u8]
  open_video    {}                        -> {session}
  encode_frame  {session,kind:"i"|"p",frame_idx,q_index,q_in_ckpt,
                 height,width,[want_recon]} payload [rgb]
                                          -> {bpp}, payloads [container,
                                              (recon u8)]
  decode_frame  {session} payload [container (i|p as written)]
                kind is taken from the header the client supplies
                                          -> {height,width}, payload [u8]
  close_video   {session}                 -> {}
  shutdown      {}                        -> {} then leaves the serve loop

Video sessions follow ``runner/video.py``'s GOP recurrence: the encoder's
DPB is refreshed from a real decompress of the stream just written (so the
encoder's and the decoder's DPBs stay bit-identical), ref_frame is clamped
as the reference does (DCVC-DC/test_video.py decode path), frames are
edge-padded on the host to the generation's multiple and recons cropped
back. Pixels cross to and from the device as f32 HWC arrays; the u8
conversion is numpy on the host, as in the JAX package (rounding on the
card gives other bytes).
"""

from __future__ import annotations

import os
import socket
import traceback

import numpy as np
import torch

from .protocol import recv_msg, send_msg


def _pad_hwc(x: np.ndarray, mult: int):
    h, w = x.shape[:2]
    ph = -h % mult
    pw = -w % mult
    if ph or pw:
        x = np.pad(x, ((0, ph), (0, pw), (0, 0)), mode="edge")
    return x


def _i_dpb(x_hat: torch.Tensor) -> dict:
    return {"ref_frame": torch.clamp(x_hat, 0.0, 1.0), "ref_feature": None,
            "ref_mv_feature": None, "ref_y": None, "ref_mv_y": None}


def _p_dpb(dec: dict) -> dict:
    dpb = dict(dec["dpb"])
    dpb["ref_frame"] = torch.clamp(dpb["ref_frame"], 0.0, 1.0)
    return dpb


class CodecServer:
    def __init__(self, i_frame_model: str = "evc_SS",
                 p_frame_model: str | None = None,
                 model_path_i: str | None = None,
                 model_path_p: str | None = None,
                 ec_thread: bool = False, stream_part: int = 1,
                 od_warp: str = "auto", device=None):
        """Runs on the card unless ``device="cpu"``; without a card it
        raises."""
        from ..device import resolve_device
        from ..models.registry import build
        from ..ops.warp import default_coding_warp_modes
        from ..runner.adapters import (adapt_i_runtime, adapt_p_runtime,
                                       pad_for_model)
        from ..utils.checkpoint import load_state_dict

        self.device = resolve_device(device)
        self.i_model = i_frame_model
        self.p_model = p_frame_model
        self.pad = pad_for_model(i_frame_model)
        if p_frame_model and pad_for_model(p_frame_model) != self.pad:
            raise ValueError(
                "I/P models must share a padding generation for real "
                "coding (see tools/test_video.py)")

        def weights(path, model):
            return load_state_dict(path, model) if path else None

        _, i_rt = build(i_frame_model, device=self.device,
                        state_dict=weights(model_path_i, i_frame_model))
        i_rt.ec_thread, i_rt.stream_part = ec_thread, stream_part
        i_rt.update(force=True)
        self.i_rt = adapt_i_runtime(i_rt)

        self.p_rt = None
        if p_frame_model:
            # serving drives the write-stream path (compress / decompress),
            # so the coding warp defaults apply (None: exact), passed as the
            # video CLI passes them
            od_d, mc_d, me_d = default_coding_warp_modes(self.device)
            p_kwargs = {}
            if p_frame_model == "dmc_dc":
                p_kwargs.update(
                    od_warp_mode=od_d if od_warp == "auto" else od_warp,
                    me_warp_mode=me_d)
            if p_frame_model in ("dmc_dc", "dmc_hem", "dmc_tcm", "dcvc_gen1"):
                p_kwargs["mc_warp_mode"] = mc_d
            _, p_rt = build(p_frame_model, device=self.device,
                            state_dict=weights(model_path_p, p_frame_model),
                            **p_kwargs)
            p_rt.ec_thread, p_rt.stream_part = ec_thread, stream_part
            p_rt.update(force=True)
            self.p_rt = adapt_p_runtime(p_rt)

        self.sessions: dict[int, dict] = {}
        self._next_session = 1

    # -- image payload conversion ------------------------------------------

    def _host_frame(self, payload: bytes, h: int, w: int,
                    dtype: str) -> np.ndarray:
        """The payload as an f32 HWC frame edge-padded to the generation's
        multiple. A u8 frame is padded before its ``x / 255`` (per value,
        so the order changes no value): the padding copies a quarter of the
        bytes."""
        if dtype == "f32":
            x = _pad_hwc(np.frombuffer(payload, np.float32).reshape(h, w, 3),
                         self.pad)
            return x if x.flags.writeable else x.copy()
        x = _pad_hwc(np.frombuffer(payload, np.uint8).reshape(h, w, 3),
                     self.pad)
        return np.true_divide(x, np.float32(255.0), dtype=np.float32)

    def _device_in(self, x_hwc: np.ndarray) -> torch.Tensor:
        """A padded HWC host frame as a fresh NCHW tensor on the device: one
        plain host-to-device copy, the transpose on the device. Fresh NCHW
        strides, since a permuted view keeps channels-last strides and a
        convolution may then take another algorithm than the decoder's
        (``runtime._from_host_nhwc``)."""
        t = torch.from_numpy(x_hwc).to(self.device)
        return torch.empty((1, 3, *x_hwc.shape[:2]),
                           device=self.device).copy_(t.permute(2, 0, 1)[None])

    @staticmethod
    def _host_u8(x_hat: torch.Tensor, h: int, w: int) -> bytes:
        """The cropped recon as HWC u8 bytes: laid out HWC on the device, one
        plain copy to the host, then the JAX package's
        ``(clip(x, 0, 1) * 255 + 0.5).astype(uint8)`` in numpy, in place on
        that copy (rounding on the card gives other bytes)."""
        x = (x_hat[0, :, :h, :w].permute(1, 2, 0).contiguous()
             .to("cpu", copy=True).numpy())
        np.clip(x, 0.0, 1.0, out=x)
        x *= 255.0
        x += 0.5
        return x.astype(np.uint8).tobytes()

    # -- handlers ------------------------------------------------------------

    def warmup(self, height: int = 64, width: int = 64) -> None:
        """Pays the first-use costs up front (I and, if present, P paths;
        both DPB variants of the P path)."""
        from ..utils.stream import pack_i, pack_p, unpack_i, unpack_p

        h = -(-height // self.pad) * self.pad
        w = -(-width // self.pad) * self.pad
        x = np.zeros((h, w, 3), np.float32)
        comp = self.i_rt.compress(self._device_in(x), True, 0)
        c = pack_i(h, w, True, 0, comp["bit_stream"])
        dec = self.i_rt.decompress(unpack_i(c)[4], h, w, True, 0)
        if self.p_rt is not None:
            dpb = _i_dpb(dec["x_hat"])
            comp = self.p_rt.compress(self._device_in(x), dpb, True, 0, 1)
            c = pack_p(comp["bit_stream"], True, 0, 1)
            dec = self.p_rt.decompress(dpb, unpack_p(c)[3], h, w, True, 0, 1)
            # the second DPB variant: a P-frame's DPB carries features
            self.p_rt.compress(self._device_in(x), dec["dpb"], True, 0, 2)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def handle(self, header: dict, payloads: list):
        from ..utils.stream import pack_i, pack_p, unpack_i, unpack_p

        op = header.get("op")
        if op == "ping":
            return {"i_model": self.i_model, "p_model": self.p_model,
                    "pad": self.pad}, []

        if op == "encode_image":
            h, w = header["height"], header["width"]
            x = self._host_frame(payloads[0], h, w, header.get("dtype", "u8"))
            q_in_ckpt = bool(header.get("q_in_ckpt", True))
            q_index = int(header.get("q_index", 0))
            comp = self.i_rt.compress(self._device_in(x), q_in_ckpt, q_index)
            container = pack_i(h, w, q_in_ckpt, q_index, comp["bit_stream"])
            out_payloads = [container]
            if header.get("want_recon"):
                dec = self.i_rt.decompress(comp["bit_stream"], h, w,
                                           q_in_ckpt, q_index)
                out_payloads.append(self._host_u8(dec["x_hat"], h, w))
            return {"bpp": len(container) * 8 / (h * w)}, out_payloads

        if op == "decode_image":
            h, w, q_in_ckpt, q_index, stream = unpack_i(payloads[0])
            dec = self.i_rt.decompress(stream, h, w, q_in_ckpt, q_index)
            return {"height": h, "width": w}, [self._host_u8(dec["x_hat"],
                                                             h, w)]

        if op == "open_video":
            if self.p_rt is None:
                raise ValueError("server built without a p_frame_model")
            sid = self._next_session
            self._next_session += 1
            self.sessions[sid] = {"dpb": None}
            return {"session": sid}, []

        if op == "encode_frame":
            sess = self.sessions[header["session"]]
            h, w = header["height"], header["width"]
            kind = header.get("kind", "p")
            frame_idx = int(header.get("frame_idx", 0))
            q_in_ckpt = bool(header.get("q_in_ckpt", True))
            q_index = int(header.get("q_index", 0))
            x = self._device_in(self._host_frame(
                payloads[0], h, w, header.get("dtype", "u8")))
            if kind == "i":
                comp = self.i_rt.compress(x, q_in_ckpt, q_index)
                container = pack_i(h, w, q_in_ckpt, q_index,
                                   comp["bit_stream"])
                dec = self.i_rt.decompress(comp["bit_stream"], h, w,
                                           q_in_ckpt, q_index)
                sess["dpb"] = _i_dpb(dec["x_hat"])
            else:
                comp = self.p_rt.compress(x, sess["dpb"], q_in_ckpt,
                                          q_index, frame_idx)
                container = pack_p(comp["bit_stream"], q_in_ckpt, q_index,
                                   frame_idx % 4)
                # free the encoder's own DPB before the refresh allocates
                # the decoder's: one session holds one DPB at a time
                comp.pop("dpb", None)
                dec = self.p_rt.decompress(sess["dpb"], comp["bit_stream"],
                                           h, w, q_in_ckpt, q_index,
                                           frame_idx % 4)
                sess["dpb"] = _p_dpb(dec)
            out_payloads = [container]
            if header.get("want_recon"):
                out_payloads.append(self._host_u8(sess["dpb"]["ref_frame"],
                                                  h, w))
            return {"bpp": len(container) * 8 / (h * w)}, out_payloads

        if op == "decode_frame":
            sess = self.sessions[header["session"]]
            kind = header.get("kind", "p")
            if kind == "i":
                h, w, q_in_ckpt, q_index, stream = unpack_i(payloads[0])
                dec = self.i_rt.decompress(stream, h, w, q_in_ckpt, q_index)
                sess["dpb"] = _i_dpb(dec["x_hat"])
                sess["hw"] = (h, w)
            else:
                q_in_ckpt, q_index, fi, stream = unpack_p(payloads[0])
                h, w = sess["hw"]
                dec = self.p_rt.decompress(sess["dpb"], stream, h, w,
                                           q_in_ckpt, q_index, fi)
                sess["dpb"] = _p_dpb(dec)
            return {"height": h, "width": w}, [self._host_u8(
                sess["dpb"]["ref_frame"], h, w)]

        if op == "close_video":
            self.sessions.pop(header["session"], None)
            return {}, []

        raise ValueError(f"unknown op {op!r}")

    # -- serve loop ------------------------------------------------------------

    def serve(self, socket_path: str) -> None:
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(socket_path)
        srv.listen(4)
        try:
            stop = False
            while not stop:
                conn, _ = srv.accept()
                with conn:
                    while True:
                        # a misbehaving or killed client must never take
                        # down the warm process: a socket error drops this
                        # connection and returns to accept()
                        try:
                            msg = recv_msg(conn)
                        except (ConnectionError, OSError):
                            break
                        if msg is None:
                            break
                        header, payloads = msg
                        if header.get("op") == "shutdown":
                            try:
                                send_msg(conn, {"ok": True})
                            except OSError:
                                pass
                            stop = True
                            break
                        try:
                            resp, out = self.handle(header, payloads)
                            resp["ok"] = True
                            send_msg(conn, resp, out)
                        except (ConnectionError, BrokenPipeError):
                            break
                        except Exception as e:  # noqa: BLE001 - reported to
                            # the client; the server keeps serving
                            traceback.print_exc()
                            try:
                                send_msg(conn, {"ok": False,
                                                "error": repr(e)})
                            except OSError:
                                break
        finally:
            srv.close()
            if os.path.exists(socket_path):
                os.unlink(socket_path)
