"""Port GOP runner (dcvc_tpu_torch/runner/video.py) against the JAX
package's ``run_sequence``, on the CPU, with the same weights.

One module fixture makes seeded port weights for IntraNoAR (at the golden
widths, N=32) and DMC (its fixed full widths; the same seed as
tests/test_torch_port_cli.py) and carries them to the JAX package with its
own converter (``dcvc_tpu/utils/port_dc.py``), which skips the JAX models'
init; tests/test_torch_port_intra.py and tests/test_torch_port_dmc.py cover
the other direction (utils/convert.py). Both packages code a 96x64 sequence
of 3 frames (I, P, P) from PNG and from YUV420 sources, with the
OffsetDiversity block warp (``block:4,4,64,128,median4``) on both sides.

Tolerances: write-stream ``.bin`` files byte-identical and per-frame bits
equal; PSNR within 1e-3 dB (reconstructions agree to ~1e-6, f32 convolutions
in another summation order); estimated bits rtol 1e-4 (the bit estimate
sums ~10^4 f32 log-probabilities per frame).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from dcvc_tpu.models.intra_dc import IntraNoAR as JIntraNoAR
from dcvc_tpu.models.runtime import DmcRuntime as JDmcRuntime
from dcvc_tpu.models.runtime import IntraDcRuntime as JIntraDcRuntime
from dcvc_tpu.models.video_dc import DMC as JDMC
from dcvc_tpu.runner import video as jvideo
from dcvc_tpu.utils import port_dc
from dcvc_tpu_torch.models.registry import build
from dcvc_tpu_torch.runner import adapters
from dcvc_tpu_torch.runner import video as tvideo
from dcvc_tpu_torch.utils import color
from _flax_init import flax_param_checks  # noqa: F401 (autouse)

BLOCK = "block:4,4,64,128,median4"
H, W, FRAMES = 64, 96, 3
INTRA_WIDTHS = {"N": 32, "ch_a": 16, "ch_b": 24}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six pytest workers on one host: two torch threads each
    keeps torch's spinning OpenMP pool from starving the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random((H // 8 + 2, W // 8 + 2, 3))
    return [np.kron(np.roll(base, i, axis=1), np.ones((8, 8, 1)))[:H, :W]
            for i in range(FRAMES)]


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("src")
    (d / "png").mkdir()
    frames = _frames()
    with open(d / "seq.yuv", "wb") as f:
        for i, img in enumerate(frames):
            Image.fromarray((img * 255).round().astype(np.uint8)).save(
                d / "png" / f"im{i + 1}.png")
            y, uv = color.rgb_to_ycbcr420(img)
            f.write(np.clip(np.rint(y * 255), 0, 255).astype(np.uint8).tobytes())
            f.write(np.clip(np.rint(uv * 255), 0, 255).astype(np.uint8).tobytes())
    return {"png": str(d / "png"), "yuv420": str(d / "seq.yuv")}


@pytest.fixture(scope="module")
def pair():
    ti_mod, ti = build("intra_dc", seed=5, device="cpu", **INTRA_WIDTHS)
    tp_mod, tp = build("dmc_dc", seed=6, device="cpu", od_warp_mode=BLOCK)
    jip = port_dc.convert_intra_dc(
        {k: v.numpy() for k, v in ti_mod.state_dict().items()})
    jpp = port_dc.convert_dmc(
        {k: v.numpy() for k, v in tp_mod.state_dict().items()})
    jrt = {"i": JIntraDcRuntime(JIntraNoAR(**INTRA_WIDTHS), jip),
           "p": JDmcRuntime(JDMC(od_warp_mode=BLOCK), jpp)}
    trt = {"i": adapters.adapt_i_runtime(ti), "p": adapters.adapt_p_runtime(tp)}
    for rt in (*jrt.values(), *trt.values()):
        rt.update(force=True)
    return {"jax": jrt, "port": trt}


def _run(pkg, pair, sources, tmp, src_type, write_stream, aligned=False):
    mod = jvideo if pkg == "jax" else tvideo
    rts = pair[pkg]
    rts["p"].aligned_enc = aligned
    path = sources[src_type]
    spec = mod.SequenceSpec("seq", path, W, H, FRAMES, gop=32,
                            src_type=src_type)
    streams = os.path.join(tmp, f"{pkg}_{src_type}_{write_stream}_{aligned}")
    cfg = mod.EvalConfig(intra_period=32, frame_num=FRAMES,
                         write_stream=write_stream, stream_path=streams,
                         verbose=2)
    summary = mod.run_sequence(rts["i"], rts["p"], spec, cfg, q_index_i=32,
                               q_index_p=32)
    bins = [open(os.path.join(streams, f"seq_{i}.bin"), "rb").read()
            for i in range(FRAMES)] if write_stream else None
    return summary, bins


@pytest.mark.parametrize("src_type", ["png", "yuv420"])
def test_write_stream_bins_identical_across_packages(pair, sources, tmp_path,
                                                     src_type):
    js, jbins = _run("jax", pair, sources, tmp_path, src_type, True)
    ts, tbins = _run("port", pair, sources, tmp_path, src_type, True)
    assert [len(b) for b in tbins] == [len(b) for b in jbins]
    for i, (tb, jb) in enumerate(zip(tbins, jbins)):
        assert tb == jb, f"frame {i}"
    assert set(ts) == set(js)
    assert ts["frame_type"] == js["frame_type"] == [0, 1, 1]
    assert ts["frame_bits"] == js["frame_bits"]
    np.testing.assert_allclose(ts["frame_psnr"], js["frame_psnr"], atol=1e-3)
    if src_type == "yuv420":
        for k in ("frame_psnr_y", "frame_psnr_u", "frame_psnr_v"):
            np.testing.assert_allclose(ts[k], js[k], atol=1e-3, err_msg=k)


def test_estimated_bits_match_jax(pair, sources, tmp_path):
    js, _ = _run("jax", pair, sources, tmp_path, "yuv420", False)
    ts, _ = _run("port", pair, sources, tmp_path, "yuv420", False)
    assert set(ts) == set(js)
    np.testing.assert_allclose(ts["frame_bits"], js["frame_bits"], rtol=1e-4)
    np.testing.assert_allclose(ts["frame_psnr"], js["frame_psnr"], atol=1e-3)


def test_aligned_enc_gives_the_same_bytes(pair, sources, tmp_path):
    """Both packages: the decoder-aligned encode codes the same streams as
    the direct one (f32 on the CPU is deterministic)."""
    for pkg in ("jax", "port"):
        _, plain = _run(pkg, pair, sources, tmp_path, "yuv420", True)
        _, aligned = _run(pkg, pair, sources, tmp_path, "yuv420", True, True)
        assert aligned == plain, pkg
    pair["port"]["p"].aligned_enc = pair["jax"]["p"].aligned_enc = False


def test_dataset_config_and_recon_writer(pair, sources, tmp_path):
    cfg = {"root_path": os.path.dirname(sources["yuv420"]),
           "test_classes": {
               "A": {"test": 1, "base_path": "", "src_type": "yuv420",
                     "sequences": {"seq": {"width": W, "height": H,
                                           "frames": FRAMES, "gop": 32}}},
               "B": {"test": 0, "sequences": {"x": {"width": 1, "height": 1,
                                                   "frames": 1}}}}}
    (spec,) = tvideo.load_dataset_config(cfg)
    (jspec,) = jvideo.load_dataset_config(cfg)
    assert spec.__dict__ == jspec.__dict__
    dec = tmp_path / "dec"
    tcfg = tvideo.EvalConfig(intra_period=2, frame_num=FRAMES,
                             write_stream=True, stream_path=str(tmp_path / "s"),
                             decoded_path=str(dec))
    s = tvideo.run_sequence(pair["port"]["i"], pair["port"]["p"], spec, tcfg,
                            q_index_i=20, q_index_p=20)
    assert (s["i_frame_num"], s["p_frame_num"]) == (2, 1)
    assert (dec / "seq.yuv").stat().st_size == FRAMES * H * W * 3 // 2
    assert adapters.pad_for_model("dmc_dc") == 16
    assert adapters.pad_for_model("dmc_hem") == 64
    with pytest.raises(TypeError, match="no adapter for object"):
        adapters.adapt_p_runtime(object())
