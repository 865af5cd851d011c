"""PNG reading and writing with the standard library's ``zlib`` only.

The port reads PNG images (the image CLI, PNG sequences of the video
runner) without Pillow, which the machine with the card does not have.

``read_png`` reads PNGs of colour types 0 (grey), 2 (RGB), 3 (palette),
4 (grey + alpha) and 6 (RGBA) at 8 bits per sample, and of types 0, 2, 4
and 6 at 16, with all five row filters, plain or Adam7-interlaced, into
the uint8 ``[H, W, 3]`` array that Pillow's
``Image.open(path).convert("RGB")`` gives: grey is replicated, alpha and
``tRNS`` are dropped, and 16-bit samples reduce as Pillow reduces them
(colour types 2, 4 and 6 keep each sample's high byte; grey, which Pillow
opens as mode ``I;16``, clips at 255). Sub-byte depths raise.
``write_png`` writes 8-bit RGB.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG has no IEND chunk")


def _unfilter(raw: np.ndarray, H: int, W: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw`` ([H, 1 + W * bpp] bytes). Each
    byte depends on its left, upper and upper-left neighbours, so the
    pixels of one anti-diagonal are independent: H + W - 1 vector steps."""
    ftype = raw[:, 0].astype(np.int16)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    if not ftype.any():              # no filter on any row (write_png's files)
        return raw[:, 1:].reshape(H, W, bpp).copy()
    filt = raw[:, 1:].reshape(H, W, bpp).astype(np.int16)
    out = np.zeros((H + 1, W + 1, bpp), np.int16)  # zero row 0 / column 0
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H, d + 1))
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (filt[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def _pixels(raw: np.ndarray, H: int, W: int, bpp: int,
            interlace: int) -> np.ndarray:
    """Unfiltered pixel bytes ``[H, W, bpp]`` of the decompressed image
    data: one image, or the seven Adam7 passes, each filtered on its own
    (an empty pass has no bytes)."""
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [(x0, y0, dx, dy, -(-(W - x0) // dx), -(-(H - y0) // dy))
             for x0, y0, dx, dy in passes]
    sizes = [s for s in sizes if s[4] > 0 and s[5] > 0]
    expected = sum(ph * (1 + pw * bpp) for *_, pw, ph in sizes)
    if raw.size != expected:
        raise ValueError(f"image data is {raw.size} bytes, expected "
                         f"{expected}")
    out = np.empty((H, W, bpp), np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph in sizes:
        n = ph * (1 + pw * bpp)
        out[y0::dy, x0::dx] = _unfilter(raw[pos:pos + n].reshape(ph, -1),
                                        ph, pw, bpp)
        pos += n
    return out


def read_png(path) -> np.ndarray:
    """uint8 ``[H, W, 3]`` RGB of a PNG, as Pillow's ``convert("RGB")``."""
    data = Path(path).read_bytes()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">2I5B", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth not in (8, 16) or (depth == 16 and ctype == 3):
        raise ValueError(f"{path}: {depth}-bit PNG of colour type {ctype}; "
                         f"8-bit, and 16-bit non-palette, are supported")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: unknown interlace method {interlace}")
    channels = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    try:
        px = _pixels(raw, H, W, channels * depth // 8, interlace)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if depth == 16:
        hi_lo = px.reshape(H, W, channels, 2)
        if ctype == 0:
            grey = hi_lo[..., 0].astype(np.uint16) << 8 | hi_lo[..., 1]
            px = np.minimum(grey, 255).astype(np.uint8)
        else:
            px = np.ascontiguousarray(hi_lo[..., 0])
    if ctype == 3:
        if palette is None or px.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        return palette[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, rgb: np.ndarray) -> None:
    """Write uint8 ``[H, W, 3]`` as an 8-bit RGB PNG (filter 0 rows)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {rgb.dtype} "
                         f"{rgb.shape}")
    H, W, _ = rgb.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), rgb.reshape(H, -1)],
                          axis=1)
    Path(path).write_bytes(
        SIGNATURE + _chunk(b"IHDR", struct.pack(">2I5B", W, H, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b""))
