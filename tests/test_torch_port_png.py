"""The port's Pillow-free PNG reader and writer (``dcvc_tpu_torch/utils/
png.py``) against Pillow, and the video reader's PNG sequences through it.

``read_png`` must equal Pillow's ``Image.open(p).convert("RGB")`` on
colour types 0, 2, 3, 4 and 6: files Pillow writes, and files written here
whose rows cycle through all five filter types, at 8 bits and (types 0,
2, 4, 6) 16 bits, plain and Adam7-interlaced (Pillow writes no interlaced
files). Sub-byte depths, 16-bit palettes and unknown interlace methods
raise. Pillow reads back what ``write_png`` writes, and the video
runner's ``PNGWriter`` writes with it when Pillow cannot be imported.
"""

import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from dcvc_tpu_torch.utils import png
from dcvc_tpu_torch.utils.video_io import PNGReader, PNGWriter

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


def _filtered_rows(samples, depth, first_filter=0):
    """Filtered scanlines of ``samples`` [h, w, channels]; row r uses filter
    (first_filter + r) % 5."""
    h, w, _ = samples.shape
    raw = samples.astype(">u2" if depth == 16 else np.uint8)
    raw = raw.view(np.uint8).reshape(h, -1).astype(int)
    bpp = raw.shape[1] // w
    rows, prior = [], np.zeros(raw.shape[1], int)
    for r in range(h):
        kind = (first_filter + r) % 5
        rows.append(bytes([kind]) + _filter_row(kind, raw[r], prior, bpp)
                    .astype(np.uint8).tobytes())
        prior = raw[r]
    return b"".join(rows)


def _write_filtered(path, samples, ctype, palette=None, interlace=0,
                    depth=8):
    """A PNG whose rows cycle through the five filters; ``interlace=1``
    writes the seven Adam7 passes, each filtered on its own."""
    h, w, _ = samples.shape
    if interlace == 1:
        data = b"".join(
            _filtered_rows(samples[y0::dy, x0::dx], depth, k)
            for k, (x0, y0, dx, dy) in enumerate(png._ADAM7)
            if x0 < w and y0 < h)
    else:
        data = _filtered_rows(samples, depth)
    body = _chunk(b"IHDR", struct.pack(">2I5B", w, h, depth, ctype, 0, 0,
                                       interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    body += _chunk(b"IDAT", zlib.compress(data))
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


def _samples(h, w, ctype, depth, seed):
    """Samples of colour type ``ctype`` at ``depth`` bits (16-bit grey
    spans 0..1023, so Pillow's clip at 255 is exercised) and the palette
    of type 3."""
    rng = np.random.default_rng(seed)
    channels = png._CHANNELS[ctype]
    if depth == 8:
        samples = _pixels(h, w, channels, seed)
    else:
        top = 1024 if ctype == 0 else 65536
        samples = rng.integers(0, top, (h, w, channels))
    palette = None
    if ctype == 3:
        palette = _pixels(1, 40, 3, seed=99)[0]
        samples = samples % 40
    return samples, palette


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_16_bit_matches_pillow(tmp_path, ctype):
    samples, _ = _samples(11, 13, ctype, 16, seed=30 + ctype)
    path = tmp_path / "s16.png"
    _write_filtered(path, samples, ctype, depth=16)
    np.testing.assert_array_equal(png.read_png(path), _pil_rgb(path))


@pytest.mark.parametrize("ctype,depth", [(0, 8), (2, 8), (3, 8), (4, 8),
                                         (6, 8), (0, 16), (2, 16), (4, 16),
                                         (6, 16)])
def test_interlaced_matches_pillow(tmp_path, ctype, depth):
    # 11 x 13 fills all seven passes; 3 x 5 leaves passes 2 and 3 empty
    for h, w in [(11, 13), (3, 5)]:
        samples, palette = _samples(h, w, ctype, depth, seed=ctype + depth)
        path = tmp_path / "i.png"
        _write_filtered(path, samples, ctype, palette, interlace=1,
                        depth=depth)
        got = png.read_png(path)
        assert got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, _pil_rgb(path))


def test_16_bit_and_interlaced_raise(tmp_path):
    """16-bit and interlaced files are read (the tests above); what stays
    refused: 16-bit palettes (which the PNG standard forbids), unknown
    interlace methods, sub-byte depths and a corrupt chunk."""
    samples = _pixels(8, 8, 1, 3)
    path = tmp_path / "p16.png"
    _write_filtered(path, samples, 3, _pixels(1, 40, 3, 99)[0], depth=16)
    with pytest.raises(ValueError, match="16-bit PNG of colour type 3"):
        png.read_png(path)
    _write_filtered(path, samples, 0, interlace=2)
    with pytest.raises(ValueError, match="interlace method 2"):
        png.read_png(path)
    _write_filtered(path, samples, 0, depth=4)
    with pytest.raises(ValueError, match="4-bit"):
        png.read_png(path)
    _write_filtered(tmp_path / "i.png", _pixels(8, 8, 3, 4), 2, interlace=1)
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


def test_png_writer_needs_no_pillow(tmp_path, monkeypatch):
    """The runner's decoded-frame writer runs where Pillow cannot be
    imported (the machine with the card) and writes the rounded frames."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    frames = [np.random.default_rng(40 + i).random((24, 40, 3))
              for i in range(2)]
    writer = PNGWriter(str(tmp_path / "dec"), 40, 24)
    for f in frames:
        writer.write_one_frame(f)
    writer.close()
    for i, f in enumerate(frames):
        got = png.read_png(tmp_path / "dec" / f"im{i + 1:05d}.png")
        np.testing.assert_array_equal(
            got, np.clip(np.rint(f * 255.0), 0, 255).astype(np.uint8))
