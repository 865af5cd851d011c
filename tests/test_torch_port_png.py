"""The port's Pillow-free PNG reader and writer (``dcvc_tpu_torch/utils/
png.py``) against Pillow, and the video reader's PNG sequences through it.

``read_png`` must equal Pillow's ``Image.open(p).convert("RGB")`` on
colour types 0, 2, 3, 4 and 6: files Pillow writes, and files written here
whose rows cycle through all five filter types. 16-bit and interlaced
files raise. Pillow reads back what ``write_png`` writes.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dcvc_tpu_torch.utils import png
from dcvc_tpu_torch.utils.video_io import PNGReader

MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


def _pixels(h, w, channels, seed):
    rng = np.random.default_rng(seed)
    smooth = np.kron(rng.random((h // 3 + 1, w // 3 + 1, channels)),
                     np.ones((3, 3, 1)))[:h, :w]
    return np.clip((smooth + rng.normal(0, 0.1, smooth.shape)) * 255, 0,
                   255).astype(np.uint8)


def _filter_row(kind, row, prior, bpp):
    """PNG filter ``kind`` of one row (ints; ``prior`` is the row above)."""
    left = np.concatenate([np.zeros(bpp, int), row[:-bpp]])
    up_left = np.concatenate([np.zeros(bpp, int), prior[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prior
    elif kind == 3:
        pred = (left + prior) // 2
    else:
        p = left + prior - up_left
        pa, pb, pc = abs(p - left), abs(p - prior), abs(p - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prior, up_left))
    return (row - pred) % 256


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _write_filtered(path, samples, ctype, palette=None, interlace=0,
                    depth=8):
    """An 8-bit PNG whose row r uses filter r % 5."""
    h, w, bpp = samples.shape
    rows, prior = [], np.zeros(w * bpp, int)
    for r in range(h):
        row = samples[r].reshape(-1).astype(int)
        rows.append(bytes([r % 5]) + _filter_row(r % 5, row, prior, bpp)
                    .astype(np.uint8).tobytes())
        prior = row
    body = _chunk(b"IHDR", struct.pack(">2I5B", w, h, depth, ctype, 0, 0,
                                       interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    body += _chunk(b"IDAT", zlib.compress(b"".join(rows)))
    path.write_bytes(png.SIGNATURE + body + _chunk(b"IEND", b""))


def _pil_rgb(path):
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("ctype", sorted(MODES))
def test_every_filter_matches_pillow(tmp_path, ctype):
    h, w = 11, 13
    channels = png._CHANNELS[ctype]
    samples = _pixels(h, w, channels, seed=ctype)
    palette = None
    if ctype == 3:
        palette = _pixels(1, 40, 3, seed=99)[0]
        samples = samples % 40
    path = tmp_path / "f.png"
    _write_filtered(path, samples, ctype, palette)
    got = png.read_png(path)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, _pil_rgb(path))


@pytest.mark.parametrize("ctype", sorted(MODES))
def test_pillow_written_files_match_pillow(tmp_path, ctype):
    rgba = _pixels(40, 56, 4, seed=10 + ctype)
    mode = MODES[ctype]
    if mode == "P":
        img = Image.fromarray(rgba[..., :3]).quantize(64)
    elif mode == "L":
        img = Image.fromarray(rgba[..., 0], mode)
    else:
        img = Image.fromarray(rgba[..., :len(mode)], mode)
    path = tmp_path / "p.png"
    img.save(path)
    np.testing.assert_array_equal(png.read_png(path), _pil_rgb(path))


def test_16_bit_and_interlaced_raise(tmp_path):
    path16 = tmp_path / "g16.png"
    Image.fromarray((_pixels(8, 8, 1, 3)[..., 0].astype(np.uint16) * 257)
                    ).save(path16)
    with pytest.raises(ValueError, match="16-bit"):
        png.read_png(path16)
    interlaced = tmp_path / "i.png"
    _write_filtered(interlaced, _pixels(8, 8, 3, 4), 2, interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(interlaced)
    bad = bytearray((tmp_path / "i.png").read_bytes())
    bad[20] ^= 0xFF                       # inside IHDR: CRC mismatch
    (tmp_path / "bad.png").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(tmp_path / "bad.png")


def test_write_png_reads_back_in_pillow(tmp_path):
    rgb = _pixels(17, 23, 3, seed=5)
    png.write_png(tmp_path / "w.png", rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png")),
                                  rgb)
    np.testing.assert_array_equal(png.read_png(tmp_path / "w.png"), rgb)


def test_video_png_reader_matches_pillow_frames(tmp_path):
    frames = [_pixels(24, 40, 3, seed=20 + i) for i in range(3)]
    for i, f in enumerate(frames):
        img = Image.fromarray(f)
        (img.quantize(32) if i == 1 else img).save(tmp_path / f"im{i + 1:05d}.png")
    reader = PNGReader(str(tmp_path), 40, 24)
    for i in range(3):
        ref = _pil_rgb(tmp_path / f"im{i + 1:05d}.png").astype(np.float32) / 255.0
        got = reader.read_one_frame()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    assert reader.read_one_frame() is None
