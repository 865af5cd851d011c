"""The port's numpy-only helpers against the JAX package's, on the CPU:
color transforms, metrics, frame readers / writers, the results summary
and the ``.bin`` file containers.

They are copies (the port imports nothing of ``dcvc_tpu``), so the same
inputs must give the same arrays, floats and bytes exactly; the one
exception is the PNG writer, which is Pillow-free in the port: the same
pixels, other compressed bytes.
"""

import json

import numpy as np
import pytest

from dcvc_tpu.utils import color as jcolor
from dcvc_tpu.utils import metrics as jmetrics
from dcvc_tpu.utils import results as jresults
from dcvc_tpu.utils import stream as jstream
from dcvc_tpu.utils import video_io as jio
from dcvc_tpu_torch.utils import color, metrics, results, stream, video_io
from _flax_init import flax_param_checks  # noqa: F401 (autouse)


def _rgb(h, w, seed):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("order", [0, 1])
def test_color_matches_jax(order):
    rgb = _rgb(16, 24, order)
    for name in ("rgb_to_ycbcr", "ycbcr_to_rgb"):
        np.testing.assert_array_equal(getattr(color, name)(rgb),
                                      getattr(jcolor, name)(rgb), err_msg=name)
    y, uv = color.rgb_to_ycbcr420(rgb)
    jy, juv = jcolor.rgb_to_ycbcr420(rgb)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(uv, juv)
    yuv = color.ycbcr420_to_444(y, uv, order=order)
    np.testing.assert_array_equal(yuv, jcolor.ycbcr420_to_444(y, uv, order=order))
    for a, b in zip(color.ycbcr444_to_420(yuv), jcolor.ycbcr444_to_420(yuv)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(color.ycbcr420_to_rgb(y, uv, order),
                                  jcolor.ycbcr420_to_rgb(y, uv, order))


@pytest.mark.parametrize("hw", [(96, 120), (180, 200)])   # HM levels 4 and 5
def test_metrics_match_jax(hw):
    a = _rgb(*hw, seed=1)
    b = np.clip(a + 0.05 * _rgb(*hw, seed=2), 0, 1)
    assert metrics.calc_msssim(a[..., 0], b[..., 0], 1) == \
        jmetrics.calc_msssim(a[..., 0], b[..., 0], 1)
    assert metrics.calc_msssim_rgb(a, b, 1) == jmetrics.calc_msssim_rgb(a, b, 1)
    assert metrics.calc_psnr(a, b, 1) == jmetrics.calc_psnr(a, b, 1)
    assert metrics.calc_psnr(a, a, 1) == jmetrics.calc_psnr(a, a, 1) == 999.9
    assert metrics.yuv_psnr_6_1_1(30.0, 40.0, 41.0) == \
        jmetrics.yuv_psnr_6_1_1(30.0, 40.0, 41.0)
    with pytest.raises(ValueError, match="too small"):
        metrics.calc_msssim(a[:80, :80, 0], b[:80, :80, 0], 1)


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_raw_rgb_io_matches_jax(tmp_path, bit_depth):
    frames = [_rgb(6, 10, s) for s in range(2)]
    for pkg, mod in (("port", video_io), ("jax", jio)):
        w = mod.RGBWriter(str(tmp_path / pkg), 10, 6, bit_depth=bit_depth)
        for f in frames:
            w.write_one_frame(f)
        w.close()
    raw = (tmp_path / "port.rgb").read_bytes()
    assert raw == (tmp_path / "jax.rgb").read_bytes()
    r = video_io.RGBReader(str(tmp_path / "port"), 10, 6, bit_depth=bit_depth)
    jr = jio.RGBReader(str(tmp_path / "port"), 10, 6, bit_depth=bit_depth)
    for _ in frames:
        np.testing.assert_array_equal(r.read_one_frame(), jr.read_one_frame())
    assert r.read_one_frame() is None and r.eof
    r.close()
    jr.close()


def test_yuv_and_png_io_match_jax(tmp_path):
    rgb = _rgb(8, 12, seed=3)
    y, uv = color.rgb_to_ycbcr420(rgb)
    for pkg, mod in (("port", video_io), ("jax", jio)):
        w = mod.YUVWriter(str(tmp_path / pkg), 12, 8)
        w.write_one_frame(y, uv)
        w.close()
        p = mod.PNGWriter(str(tmp_path / f"{pkg}_png"), 12, 8)
        p.write_one_frame(rgb)
    assert (tmp_path / "port.yuv").read_bytes() == (tmp_path / "jax.yuv").read_bytes()
    # the port's PNG writer is Pillow-free (utils/png.write_png), so its
    # file is compressed otherwise; both packages' readers give the JAX
    # writer's pixels from it
    for read in (video_io.PNGReader, jio.PNGReader):
        np.testing.assert_array_equal(
            read(str(tmp_path / "port_png"), 12, 8).read_one_frame(),
            jio.PNGReader(str(tmp_path / "jax_png"), 12, 8).read_one_frame())
    ty, tuv = video_io.YUVReader(str(tmp_path / "port.yuv"), 12, 8).read_one_frame()
    jy, juv = jio.YUVReader(str(tmp_path / "port.yuv"), 12, 8).read_one_frame()
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tuv, juv)
    tp = video_io.PNGReader(str(tmp_path / "port_png"), 12, 8)
    np.testing.assert_array_equal(
        tp.read_one_frame(),
        jio.PNGReader(str(tmp_path / "port_png"), 12, 8).read_one_frame())
    assert tp.read_one_frame() is None


def test_results_and_containers_match_jax(tmp_path):
    frames = [{"bits": 800.0 * (i + 1), "bpp": 0.1 * (i + 1), "psnr": 30.0 + i,
               "encoding_time": 0.01, "decoding_time": 0.02} for i in range(4)]
    gop = [True, False, False, True]
    for verbose in (False, True):
        out = results.summarize_sequence(frames, gop, verbose, test_time=1.5)
        assert out == jresults.summarize_sequence(frames, gop, verbose, 1.5)
    results.dump_json({"s": {"rate_0": out}}, str(tmp_path / "p" / "r.json"))
    jresults.dump_json({"s": {"rate_0": out}}, str(tmp_path / "j" / "r.json"))
    assert json.loads((tmp_path / "p" / "r.json").read_text()) == \
        json.loads((tmp_path / "j" / "r.json").read_text())

    payload = bytes(range(256)) * 3
    for pkg, mod in (("port", stream), ("jax", jstream)):
        mod.encode_i(1080, 1920, True, 3, payload, str(tmp_path / f"{pkg}_i.bin"))
        mod.encode_p(payload, False, 41, 2, str(tmp_path / f"{pkg}_p.bin"))
    for kind in ("i", "p"):
        data = (tmp_path / f"port_{kind}.bin").read_bytes()
        assert data == (tmp_path / f"jax_{kind}.bin").read_bytes(), kind
        assert stream.filesize(str(tmp_path / f"port_{kind}.bin")) == len(data)
    assert stream.decode_i(str(tmp_path / "jax_i.bin")) == \
        (1080, 1920, True, 3, payload)
    assert stream.decode_p(str(tmp_path / "jax_p.bin")) == (False, 41, 2, payload)
