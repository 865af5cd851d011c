"""The port's image CLI (``python -m dcvc_tpu_torch.tools.test_image``)
against the JAX package, on the CPU.

``evc_SS`` at full width with seeded port weights (q_scale anchors set
apart so the rate points differ), saved as a port ``.pth`` and as the JAX
package's ``.npz`` (``convert_evc`` + ``save_params``). Two PNGs written
with Pillow: 64x64 and 60x52 (edge-padded to 64x64). The CLI, loading
either file, must write the ``.bin`` files that the JAX
``EvcCodecRuntime`` writes with ``encode_i_ushort_q`` at the CLI's q
values, byte for byte, and a results JSON with the JAX CLI's nesting and
keys. The ``intra_dc`` branch must write what the port's
``IntraDcRuntime`` and ``encode_i`` write; the zoo branch
(``bmshj2018-factorized``, ``mbt2018``, full width, one rate) what the JAX
``IntraZooRuntime`` and ``encode_i_strings`` write. (The ``intra_hem`` branch is
tests/test_torch_port_cli.py's, with these helpers, on the JAX runtime
that its video case builds.)
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dcvc_tpu.models import intra_zoo as jzoo
from dcvc_tpu.models.evc import make_evc as j_make_evc
from dcvc_tpu.models.runtime import EvcCodecRuntime as JEvcCodecRuntime
from dcvc_tpu.models.runtime import IntraZooRuntime as JIntraZooRuntime
from dcvc_tpu.ops.warp import get_padding_size
from dcvc_tpu.utils import port_dc
from dcvc_tpu.utils import stream as jstream
from dcvc_tpu.utils.checkpoint import load_params, save_params
from dcvc_tpu_torch.models.evc import build_evc
from dcvc_tpu_torch.models.intra_zoo import build_zoo
from dcvc_tpu_torch.models.registry import build
from dcvc_tpu_torch.tools import test_image as cli
from dcvc_tpu_torch.utils import stream

SIZES = {"a.png": (64, 64), "b.png": (60, 52)}
FRAME_KEYS = {"bpp", "psnr", "enc_time", "dec_time", "latency"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six pytest workers on one host: two torch threads each
    keeps torch's spinning OpenMP pool from starving the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_images(folder):
    """The two seeded test PNGs (SIZES), written with Pillow."""
    folder.mkdir()
    rng = np.random.default_rng(12)
    for name, (h, w) in SIZES.items():
        base = rng.random((h // 4 + 1, w // 4 + 1, 3))
        img = np.kron(base, np.ones((4, 4, 1)))[:h, :w]
        img = img + rng.normal(0, 0.05, img.shape)
        Image.fromarray(np.clip(img * 255, 0, 255).astype(np.uint8)).save(
            folder / name)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("image_cli")
    _write_images(d / "imgs")
    tm = build_evc("SS", seed=13, device="cpu")
    with torch.no_grad():
        tm.q_scale.copy_(torch.tensor([1.6, 1.2, 0.9, 0.7]).view(4, 1, 1, 1))
    torch.save(tm.state_dict(), d / "evc_ss.pth")
    params = port_dc.convert_evc({k: v.numpy() for k, v in
                                  tm.state_dict().items()})
    save_params(str(d / "evc_ss.npz"), params)
    return d, params


def _run(d, tag, *extra):
    out = d / f"{tag}.json"
    res = cli.main(["--img_folder", str(d / "imgs"), "--device", "cpu",
                    "--stream_path", str(d / tag), "--output_path", str(out),
                    "--verbose", "0", *extra])
    assert json.loads(out.read_text()).keys() == res.keys()
    return res


def _bins(d, tag, rates, sizes=SIZES):
    return {f"{n}_{r}": (d / tag / f"{n}_{r}.bin").read_bytes()
            for n in sizes for r in range(rates)}


def _check_schema(res, rates, extra=frozenset()):
    assert set(res) == {"per_image", "average"}
    assert set(res["per_image"]) == set(SIZES)
    for per_rate in (*res["per_image"].values(), res["average"]):
        assert set(per_rate) == {f"rate_{r}" for r in range(rates)}
        for fr in per_rate.values():
            assert set(fr) == FRAME_KEYS | extra
            assert all(np.isfinite(v) for v in fr.values())


def _jax_bins(d, rt, rates, sizes=SIZES):
    """What the JAX CLI's EVC / HEM write-stream branch writes
    (tools/test_image.py) for the PNGs ``sizes`` names in ``d / "imgs"``,
    through its runtime ``rt`` (tables built) and container."""
    anchors = np.asarray(rt.params["params"]["q_scale"]).reshape(-1)
    q_scales = np.exp(np.linspace(np.log(anchors[0]), np.log(anchors[-1]),
                                  rates))
    out = {}
    for name, (h, w) in sizes.items():
        img = np.asarray(Image.open(d / "imgs" / name).convert("RGB"),
                         dtype=np.float32) / 255.0
        l, r, t, b = get_padding_size(h, w, 64)
        x = jnp.asarray(np.pad(img, ((t, b), (l, r), (0, 0)), mode="edge"))[None]
        for rate_idx, q in enumerate(q_scales):
            q_rounded, q_index = jstream.get_rounded_q(float(q))
            comp = rt.compress(x, jnp.asarray(q_rounded))
            path = d / f"jax_{name}_{rate_idx}.bin"
            jstream.encode_i_ushort_q(h, w, q_index, comp["bit_stream"], path)
            out[f"{name}_{rate_idx}"] = path.read_bytes()
    return out


def test_evc_cli_writes_the_jax_runtimes_bins(case):
    d, params = case
    res = _run(d, "pth", "--model", "evc_SS", "--model_path",
               str(d / "evc_ss.pth"), "--rate_num", "2", "--write_stream", "1")
    _check_schema(res, 2)
    res_npz = _run(d, "npz", "--model", "evc_SS", "--model_path",
                   str(d / "evc_ss.npz"), "--rate_num", "2", "--write_stream",
                   "1")
    _check_schema(res_npz, 2)
    bins = _bins(d, "pth", 2)
    assert bins == _bins(d, "npz", 2)
    assert bins["a.png_0"] != bins["a.png_1"]
    rt = JEvcCodecRuntime(j_make_evc("SS"), params)
    rt.update(force=True)
    assert bins == _jax_bins(d, rt, 2)


def test_evc_cli_estimated_bits_and_single_rate(case):
    d, _ = case
    res = _run(d, "est", "--model", "evc_SS", "--model_path",
               str(d / "evc_ss.pth"), "--rate_num", "1")
    _check_schema(res, 1)


def test_intra_dc_cli_writes_the_port_runtimes_bins(case):
    d, _ = case
    res = _run(d, "dc", "--model", "intra_dc", "--rate_num", "1",
               "--write_stream", "1")
    _check_schema(res, 1)
    _, rt = build("intra_dc", device="cpu")
    rt.update()
    for name, (h, w) in SIZES.items():
        img = np.asarray(Image.open(d / "imgs" / name).convert("RGB"),
                         dtype=np.float32) / 255.0
        l, r, t, b = get_padding_size(h, w, 64)
        x = np.pad(img, ((t, b), (l, r), (0, 0)), mode="edge")
        comp = rt.compress(torch.from_numpy(x.transpose(2, 0, 1)[None].copy()),
                           False, 0)
        stream.encode_i(h, w, False, 0, comp["bit_stream"], d / "dc_ref.bin")
        assert (d / "dc" / f"{name}_0.bin").read_bytes() == \
            (d / "dc_ref.bin").read_bytes()


@pytest.mark.parametrize("model", ["bmshj2018-factorized", "mbt2018"])
def test_unported_models_point_at_the_roadmap(case, model):
    """These two zoo models once raised here, pointing at the ROADMAP; the
    zoo is ported, so they code. A per-rate model runs one rate point
    (``--rate_num 2`` is cut to 1) and writes the ``.bin`` files
    (``encode_i_strings``) that the JAX image CLI's zoo branch writes
    through the JAX ``IntraZooRuntime``, byte for byte, from a full-width
    port ``.pth`` that the JAX package loads with its own converter
    (``load_params``, ``port_zoo``)."""
    d, _ = case
    path = d / f"{model}.pth"
    tm = build_zoo(model, seed=21, device="cpu")
    with torch.no_grad():
        q = tm.entropy_bottleneck.quantiles
        q.add_(torch.from_numpy(np.random.default_rng(21).normal(
            0, 1.5, q.shape).astype(np.float32)))
    torch.save(tm.state_dict(), path)
    res = _run(d, model, "--model", model, "--model_path", str(path),
               "--rate_num", "2", "--write_stream", "1")
    _check_schema(res, 1)
    rt = JIntraZooRuntime(jzoo.model_architectures[model](),
                          load_params(str(path), model=model))
    rt.update(force=True)
    for name, (h, w) in SIZES.items():
        img = np.asarray(Image.open(d / "imgs" / name).convert("RGB"),
                         dtype=np.float32) / 255.0
        l, r, t, b = get_padding_size(h, w, 64)
        x = jnp.asarray(np.pad(img, ((t, b), (l, r), (0, 0)), mode="edge"))[None]
        jpath = d / f"jax_{model}_{name}.bin"
        jstream.encode_i_strings(h, w, rt.compress(x)["strings"], jpath)
        assert (d / model / f"{name}_0.bin").read_bytes() == jpath.read_bytes()
