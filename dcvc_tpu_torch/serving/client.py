"""Client of the warm codec server (``serving/server.py``), the port's own
copy of ``dcvc_tpu/serving/client.py``:

    with CodecClient("/tmp/dcvc.sock") as c:
        container, recon, bpp = c.encode_image(img_u8, q_index=2)
        rgb = c.decode_image(container)
        sid = c.open_video()
        s0, _, _ = c.encode_frame(sid, frame0, kind="i")
        s1, _, _ = c.encode_frame(sid, frame1, kind="p", frame_idx=1)

Arrays are HWC uint8 (or float32 in [0, 1], sent with dtype="f32").
"""

from __future__ import annotations

import socket
import time

import numpy as np

from .protocol import recv_msg, send_msg


class ServerError(RuntimeError):
    pass


class CodecClient:
    def __init__(self, socket_path: str, connect_timeout: float = 120.0):
        deadline = time.time() + connect_timeout
        while True:
            # a fresh socket per attempt: a socket's state after a failed
            # connect() is unspecified by POSIX
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                self.sock.connect(socket_path)
                break
            except (FileNotFoundError, ConnectionRefusedError):
                self.sock.close()
                if time.time() > deadline:
                    raise
                time.sleep(0.2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self.sock.close()

    def _call(self, header: dict, payloads=()):
        send_msg(self.sock, header, payloads)
        msg = recv_msg(self.sock)
        if msg is None:
            raise ConnectionError("server closed the connection")
        resp, out = msg
        if not resp.get("ok"):
            raise ServerError(resp.get("error", "unknown server error"))
        return resp, out

    @staticmethod
    def _img_header(img: np.ndarray, extra: dict) -> tuple[dict, bytes]:
        if img.dtype == np.uint8:
            dtype = "u8"
        elif img.dtype == np.float32:
            dtype = "f32"
        else:
            raise TypeError(f"expected u8 or f32 HWC image, got {img.dtype}")
        h, w = img.shape[:2]
        hdr = {"height": h, "width": w, "dtype": dtype, **extra}
        return hdr, np.ascontiguousarray(img).tobytes()

    def ping(self) -> dict:
        resp, _ = self._call({"op": "ping"})
        return resp

    def encode_image(self, img: np.ndarray, q_index: int = 0,
                     q_in_ckpt: bool = True, want_recon: bool = False):
        hdr, payload = self._img_header(
            img, {"op": "encode_image", "q_index": q_index,
                  "q_in_ckpt": q_in_ckpt, "want_recon": want_recon})
        resp, out = self._call(hdr, [payload])
        recon = None
        if want_recon:
            recon = np.frombuffer(out[1], np.uint8).reshape(
                img.shape[0], img.shape[1], 3)
        return out[0], recon, resp["bpp"]

    def decode_image(self, container: bytes) -> np.ndarray:
        resp, out = self._call({"op": "decode_image"}, [container])
        return np.frombuffer(out[0], np.uint8).reshape(
            resp["height"], resp["width"], 3)

    def open_video(self) -> int:
        resp, _ = self._call({"op": "open_video"})
        return resp["session"]

    def encode_frame(self, session: int, img: np.ndarray, kind: str = "p",
                     frame_idx: int = 0, q_index: int = 0,
                     q_in_ckpt: bool = True, want_recon: bool = False):
        hdr, payload = self._img_header(
            img, {"op": "encode_frame", "session": session, "kind": kind,
                  "frame_idx": frame_idx, "q_index": q_index,
                  "q_in_ckpt": q_in_ckpt, "want_recon": want_recon})
        resp, out = self._call(hdr, [payload])
        recon = None
        if want_recon:
            recon = np.frombuffer(out[1], np.uint8).reshape(
                img.shape[0], img.shape[1], 3)
        return out[0], recon, resp["bpp"]

    def decode_frame(self, session: int, container: bytes,
                     kind: str = "p") -> np.ndarray:
        resp, out = self._call(
            {"op": "decode_frame", "session": session, "kind": kind},
            [container])
        return np.frombuffer(out[0], np.uint8).reshape(
            resp["height"], resp["width"], 3)

    def close_video(self, session: int) -> None:
        self._call({"op": "close_video", "session": session})

    def shutdown(self) -> None:
        send_msg(self.sock, {"op": "shutdown"})
        recv_msg(self.sock)
