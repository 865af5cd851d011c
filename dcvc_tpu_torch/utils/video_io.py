"""Frame readers and writers: PNG sequences, planar YUV420, raw RGB.

The port's own copy of ``dcvc_tpu/utils/video_io.py`` (parity target:
DCVC-DC/src/utils/video_reader.py:45-161 / video_writer.py:26-111: im1.png /
im00001.png auto-detect, 8/16-bit raw RGB, skip_frame). Frames are HWC float
arrays in [0, 1]. PNG frames are read and written with ``utils/png.py`` (no
Pillow, which the machine with the card does not have): the written files
hold the JAX package's pixels, compressed by stdlib ``zlib``.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .png import read_png, write_png


class PNGReader:
    def __init__(self, src_path: str, width: int | None = None,
                 height: int | None = None, start_num: int = 1):
        self.src_path = src_path
        self.width, self.height = width, height
        self.current = start_num
        if Path(src_path, f"im{start_num}.png").is_file():
            self.pattern = "im{}.png"
        elif Path(src_path, f"im{start_num:05d}.png").is_file():
            self.pattern = "im{:05d}.png"
        elif Path(src_path, f"im{start_num:03d}.png").is_file():
            self.pattern = "im{:03d}.png"
        else:
            raise FileNotFoundError(f"no im*.png found under {src_path}")

    def read_one_frame(self) -> np.ndarray | None:
        path = Path(self.src_path, self.pattern.format(self.current))
        if not path.is_file():
            return None
        self.current += 1
        return read_png(path).astype(np.float32) / 255.0  # HWC in [0, 1]

    def close(self):
        pass


class PNGWriter:
    def __init__(self, dst_path: str, width: int, height: int, start_num: int = 1):
        self.dst_path = dst_path
        self.current = start_num
        os.makedirs(dst_path, exist_ok=True)

    def write_one_frame(self, rgb: np.ndarray):
        """HWC float [0,1]."""
        arr = np.clip(np.rint(rgb * 255.0), 0, 255).astype(np.uint8)
        write_png(Path(self.dst_path, f"im{self.current:05d}.png"), arr)
        self.current += 1

    def close(self):
        pass


def _raw_dtype(bit_depth: int):
    if 8 < bit_depth <= 16:
        return np.uint16, (1 << bit_depth) - 1
    if bit_depth != 8:
        raise ValueError(f"unsupported bit depth {bit_depth}")
    return np.uint8, 255


class RGBReader:
    """Raw planar RGB (3xHxW planes per frame), 8- or 10..16-bit
    little-endian, byte format of the reference RGBReader
    (DCVC-DC/src/utils/video_reader.py:83-120); frames come out HWC [0,1]."""

    def __init__(self, src_path: str, width: int, height: int,
                 bit_depth: int = 8):
        if not src_path.endswith(".rgb"):
            src_path += ".rgb"
        self.width, self.height = width, height
        self.eof = False
        self.dtype, self.max_val = _raw_dtype(bit_depth)
        self._frame_elems = width * height * 3
        self._f = open(src_path, "rb")

    def read_one_frame(self) -> np.ndarray | None:
        raw = self._f.read(self._frame_elems * np.dtype(self.dtype).itemsize)
        buf = np.frombuffer(raw, dtype=self.dtype)
        if buf.size < self._frame_elems:
            self.eof = True
            return None
        chw = buf.reshape(3, self.height, self.width).astype(np.float32)
        return np.transpose(chw / self.max_val, (1, 2, 0))

    def close(self):
        self._f.close()


class RGBWriter:
    """Raw planar RGB writer, byte-compatible with the reference RGBWriter
    (DCVC-DC/src/utils/video_writer.py:51-79)."""

    def __init__(self, dst_path: str, width: int, height: int,
                 bit_depth: int = 8):
        if not dst_path.endswith(".rgb"):
            dst_path += ".rgb"
        os.makedirs(os.path.dirname(dst_path) or ".", exist_ok=True)
        self.width, self.height = width, height
        self.dtype, self.max_val = _raw_dtype(bit_depth)
        self._f = open(dst_path, "wb")

    def write_one_frame(self, rgb: np.ndarray):
        """HWC float [0,1]."""
        chw = np.transpose(rgb, (2, 0, 1))
        arr = np.clip(np.rint(chw * self.max_val), 0,
                      self.max_val).astype(self.dtype)
        self._f.write(arr.tobytes())

    def close(self):
        self._f.close()


class YUVReader:
    """Planar YUV420, 8-bit."""

    def __init__(self, src_path: str, width: int, height: int, skip_frame: int = 0):
        self.width, self.height = width, height
        self.eof = False
        self._f = open(src_path, "rb")
        frame_bytes = width * height * 3 // 2
        if skip_frame:
            self._f.seek(frame_bytes * skip_frame)

    def read_one_frame(self, dst_format: str = "420"):
        w, h = self.width, self.height
        y = np.frombuffer(self._f.read(w * h), dtype=np.uint8)
        uv = np.frombuffer(self._f.read(w * h // 2), dtype=np.uint8)
        if y.size < w * h or uv.size < w * h // 2:
            self.eof = True
            return None, None
        y = y.reshape(h, w).astype(np.float32) / 255.0
        uv = uv.reshape(2, h // 2, w // 2).astype(np.float32) / 255.0
        if dst_format == "420":
            return y, uv
        raise ValueError(dst_format)

    def close(self):
        self._f.close()


class YUVWriter:
    def __init__(self, dst_path: str, width: int, height: int):
        if not dst_path.endswith(".yuv"):
            dst_path += ".yuv"
        os.makedirs(os.path.dirname(dst_path) or ".", exist_ok=True)
        self.width, self.height = width, height
        self._f = open(dst_path, "wb")

    def write_one_frame(self, y: np.ndarray, uv: np.ndarray):
        self._f.write(np.clip(np.rint(y * 255), 0, 255).astype(np.uint8).tobytes())
        self._f.write(np.clip(np.rint(uv * 255), 0, 255).astype(np.uint8).tobytes())

    def close(self):
        self._f.close()
