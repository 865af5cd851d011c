"""The port's remaining tools and numpy-only modules against the JAX
package, on the CPU: ``utils/rd_numbers.py`` and ``tools/rd_compare.py``,
``tools/model_complexity.py``, ``tools/data_to_png.py``,
``utils/vision.py`` and ``ops/rans_compat.py``.

* BD-rate / BD-PSNR equal the JAX functions' on the published anchors and
  seeded curves; ``rd_compare`` prints what the JAX tool prints.
* ``model_complexity``'s parameter count equals the size of the JAX
  parameter tree converted from the same port weights
  (``dcvc_tpu/utils/port_dc.py``); its convolution FLOPs are checked on
  modules whose count is known by hand, and its CLI runs ``evc_SS``.
* ``data_to_png`` writes the JAX tool's pixels (read back with Pillow
  here; the port writes them with ``utils/png.py``).
* The vision functions equal the JAX package's on seeded inputs.
* ``rans_compat`` writes the JAX shims' stream bytes, and each package's
  decoder reads the other's streams.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn
from PIL import Image

from dcvc_tpu.ops import rans as jrans
from dcvc_tpu.ops import rans_compat as jcompat
from dcvc_tpu.utils import port_dc
from dcvc_tpu.utils import rd_numbers as jrd
from dcvc_tpu.utils import vision as jvision
from dcvc_tpu_torch.models.registry import build
from dcvc_tpu_torch.ops import rans_compat as compat
from dcvc_tpu_torch.tools import data_to_png, model_complexity, rd_compare
from dcvc_tpu_torch.utils import color, rd_numbers, vision
from _flax_init import flax_param_checks  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six pytest workers on one host: two torch threads each
    keeps torch's spinning OpenMP pool from starving the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    """A ``tools/<name>.py`` script of the JAX package as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- RD numbers -----------------------------------------------------------------

def _curves():
    rng = np.random.default_rng(0)
    out = {f"anchor_{k}": (v["bpp"], v["psnr"])
           for k, v in jrd.EVC_KODAK.items()}
    for i in range(3):
        bpp = np.sort(rng.uniform(0.2, 1.2, 4))
        psnr = np.sort(rng.uniform(30.0, 39.0, 4))
        out[f"seeded_{i}"] = (bpp.tolist(), psnr.tolist())
    return out


CURVES = _curves()


@pytest.mark.parametrize("name", sorted(CURVES))
def test_bd_metrics_equal_jax(name):
    assert rd_numbers.EVC_KODAK == jrd.EVC_KODAK
    ref = jrd.EVC_KODAK["EncS_DecS"]
    bpp, psnr = CURVES[name]
    for fn in ("bd_rate", "bd_psnr"):
        args = (ref["bpp"], ref["psnr"], bpp, psnr)
        try:
            want = getattr(jrd, fn)(*args)
        except ValueError:
            with pytest.raises(ValueError):
                getattr(rd_numbers, fn)(*args)
            continue
        assert getattr(rd_numbers, fn)(*args) == want


@pytest.mark.parametrize("rates", [2, 4])
def test_rd_compare_prints_what_the_jax_tool_prints(rates, tmp_path,
                                                    monkeypatch):
    bpp, psnr = CURVES["seeded_1"]
    res = {"average": {f"rate_{i}": {"bpp": bpp[i], "psnr": psnr[i]}
                       for i in range(rates)}}
    path = tmp_path / "r.json"
    path.write_text(json.dumps(res))
    argv = ["--results", str(path), "--anchor", "EncL_DecL"]
    jtool = _jax_tool("rd_compare")
    outs = []
    for main in (lambda: rd_compare.main(argv), jtool.main):
        monkeypatch.setattr("sys.argv", ["rd_compare", *argv])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "anchor EncL_DecL" in outs[0]


# -- model complexity ---------------------------------------------------------

CONVERT = {"intra_dc": port_dc.convert_intra_dc, "dmc_dc": port_dc.convert_dmc,
           "evc_SS": port_dc.convert_evc}


@pytest.mark.parametrize("name", sorted(CONVERT))
def test_model_complexity_params_equal_jax_tree(name):
    module, _ = build(name, seed=3, device="cpu")
    tree = CONVERT[name]({k: v.numpy() for k, v in module.state_dict().items()})

    def size(node):
        if isinstance(node, dict):
            return sum(size(v) for v in node.values())
        return int(np.size(node))

    assert model_complexity.count_params(module) == size(tree) > 0


def test_conv_flops_counts_by_hand():
    m = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1),          # 2*8*16*16*3*9
                      nn.Conv2d(8, 8, 3, padding=1, groups=4),  # 2*8*256*2*9
                      nn.ConvTranspose2d(8, 4, 2, stride=2),  # 2*8*256*4*4
                      nn.ReLU())
    x = torch.rand(1, 3, 16, 16)
    want = (2 * 8 * 256 * 3 * 9) + (2 * 8 * 256 * 2 * 9) + (2 * 8 * 256 * 4 * 4)
    with torch.no_grad():
        assert model_complexity.conv_flops(m, lambda: m(x)) == want
        # the hooks are gone afterwards
        assert model_complexity.conv_flops(nn.Sequential(), lambda: m(x)) == 0


def test_model_complexity_cli_and_device_rule(capsys, monkeypatch):
    row = model_complexity.main(["--model", "evc_SS", "--height", "64",
                                 "--width", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "M params" in out and "conv MACs/pixel" in out
    assert row["params"] == model_complexity.count_params(
        build("evc_SS", device="cpu")[0])
    assert row["conv_flops"] > 0 and row["forward_ms"] > 0
    assert row["conv_macs_per_pixel"] == row["conv_flops"] / 2 / (64 * 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="device='cpu'"):
        model_complexity.main(["--model", "evc_SS"])


# -- data_to_png ----------------------------------------------------------------

def test_data_to_png_pixels_equal_jax_tool(tmp_path):
    h, w, n = 48, 80, 3
    rng = np.random.default_rng(5)
    with open(tmp_path / "seq.yuv", "wb") as f:
        for _ in range(n):
            y, uv = color.rgb_to_ycbcr420(rng.random((h, w, 3)))
            for plane in (y, uv):
                f.write(np.clip(np.rint(plane * 255), 0, 255)
                        .astype(np.uint8).tobytes())
    _jax_tool("data_to_png").convert_one_seq_to_png(
        str(tmp_path / "seq.yuv"), w, h, str(tmp_path / "jax"))
    cfg = {"root_path": str(tmp_path), "test_classes": {"c": {
        "test": 1, "src_type": "yuv420",
        "sequences": {"seq.yuv": {"width": w, "height": h}}}}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    data_to_png.main(["--test_config", str(tmp_path / "cfg.json"),
                      "--dst_root", str(tmp_path / "port")])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == n
    assert sorted(p.name for p in (tmp_path / "port" / "seq").iterdir()) == names
    for name in names:
        a = np.asarray(Image.open(tmp_path / "jax" / name))
        b = np.asarray(Image.open(tmp_path / "port" / "seq" / name))
        np.testing.assert_array_equal(a, b)


# -- vision ---------------------------------------------------------------------

def _vision_cases():
    rng = np.random.default_rng(9)
    flow = rng.normal(0, 3, (12, 20, 2)).astype(np.float32)
    img = rng.random((30, 50, 3))
    fmap = rng.normal(size=(7, 5, 6)).astype(np.float32)
    sets = [rng.random((3, 4, 5, 3)) for _ in range(2)]

    def alignment(mod):
        a = mod.Alignment(16)
        padded = a.align(img)
        return padded, a.resume(padded)

    return {
        "flow_to_color": lambda m: m.flow_to_color(flow),
        "flow_to_color_max": lambda m: m.flow_to_color(flow, max_flow=4.0),
        "heatmap": lambda m: m.heatmap(img[..., 0]),
        "ctu_crop": lambda m: m.ctu_crop(img, 16),
        "ctu_crop_pad_edge": lambda m: m.ctu_crop(img, 16, True, "edge"),
        "ctu_crop_pad_reflect": lambda m: m.ctu_crop(img, 16, True, "reflect"),
        "gen_color_rainbow": lambda m: m.gen_color("RAINBOW", 10),
        "gen_color_rainbow2": lambda m: m.gen_color("RAINBOW2", 7),
        "gen_color_rb": lambda m: m.gen_color("RB", 8),
        "gen_color_anchors": lambda m: m.gen_color([[0, 0, 0], [1, 0.5, 0],
                                                    [0, 0, 1]], 9),
        "plot_heatmap": lambda m: m.plot_heatmap(img[..., 1] * 2 - 0.5, "U"),
        "plot_yuv_444": lambda m: m.plot_yuv(*img.transpose(2, 0, 1)),
        "plot_yuv_420": lambda m: m.plot_yuv(img[..., 0], img[::2, ::2, 1],
                                             img[::2, ::2, 2]),
        "feature_map_grid": lambda m: m.feature_map_grid(fmap, nrow=3),
        "compare_img": lambda m: m.compare_img(sets, nrow=2),
        "alignment": alignment,
    }


VISION = _vision_cases()


@pytest.mark.parametrize("name", sorted(VISION))
def test_vision_equals_jax(name):
    got, want = VISION[name](vision), VISION[name](jvision)
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -- rans_compat ----------------------------------------------------------------

def _tables():
    rng = np.random.default_rng(0)
    raw, lengths, offsets = [], [], []
    for _ in range(4):
        n = int(rng.integers(4, 12))
        pmf = rng.random(n) + 0.05
        cdf = jrans.pmf_to_quantized_cdf(pmf / pmf.sum(), 16)
        raw.append(cdf)
        lengths.append(len(cdf))
        offsets.append(-(n // 2))
    maxlen = max(lengths)
    cdfs = [list(c) + [0] * (maxlen - len(c)) for c in raw]
    return cdfs, lengths, offsets


def _symbols(seed, n, lengths, offsets):
    rng = np.random.default_rng(seed)
    idx = [int(i) for i in rng.integers(0, 4, n)]
    sym = [int(rng.integers(0, lengths[i] - 2)) + offsets[i] for i in idx]
    return idx, sym


def _buffered(mod, tables, idx, sym):
    enc = mod.BufferedRansEncoder()
    enc.encode_with_indexes(sym[:100], idx[:100], *tables)
    enc.encode_with_indexes(sym[100:], idx[100:], *tables)
    return enc.flush()


def _set_cdf(mod, tables, idx, sym):
    enc = mod.BufferedRansEncoder()
    enc.set_cdf(*tables)
    enc.encode_with_indexes(sym, idx)
    return enc.flush()


def _one_shot(mod, tables, idx, sym):
    return mod.RansEncoder().encode_with_indexes(sym, idx, *tables)


@pytest.mark.parametrize("encode", [_buffered, _set_cdf, _one_shot],
                         ids=["buffered", "set_cdf", "one_shot"])
def test_rans_compat_streams_equal_jax(encode):
    tables = _tables()
    idx, sym = _symbols(1, 257, tables[1], tables[2])
    stream = encode(compat, tables, idx, sym)
    assert isinstance(stream, bytes) and stream == encode(jcompat, tables,
                                                          idx, sym)
    # each package's decoder reads the other's stream, by either path
    assert compat.RansDecoder().decode_with_indexes(stream, idx,
                                                    *tables) == sym
    dec = jcompat.RansDecoder()
    dec.set_cdf(*tables)
    dec.set_stream(stream)
    assert dec.decode_stream_only_indexes(idx) == sym
    dec = compat.RansDecoder()
    dec.set_cdf(*tables)
    dec.set_stream(stream)
    assert dec.decode_stream_only_indexes(idx) == sym
