"""The port's video CLI (``python -m dcvc_tpu_torch.tools.test_video``)
against the JAX package, on the CPU.

The DC pair's weights are made once, seeded, by the port and carried to
the JAX package's native ``.npz`` (``save_params``) with
``dcvc_tpu/utils/port_dc.py`` (the converter its own CLI uses for
published checkpoints), and saved as port ``.pth`` files. The port's own
``run_sequence`` codes a 96x64 YUV420 sequence of 2 frames (I, P) with
them in process; the CLI, loading either file, must write the same
``.bin`` files byte for byte and a results JSON with the same keys. That
runner's streams and summary keys are held against the JAX package's
``run_sequence`` in ``tests/test_torch_port_runner.py``, and the
full-width IntraNoAR / DMC streams against the JAX package's golden pins
in ``test_torch_port_intra.py`` / ``test_torch_port_dmc.py``, so the DC
case compiles no JAX program of its own. (Chained P-frames through the
same runner are tests/test_torch_port_runner.py's subject.)

The other generations' cases build the JAX side as the JAX CLI does
(``dcvc_tpu/runner/adapters.py``, ``run_sequence`` with the CLI's padding
and intra period), from weights written once by the port:
  * ``evc_SS --force_intra`` (seeded port EVC, ``convert_evc``): two
    I-frames through ``QScaleIntraAdapter``;
  * ``intra_hem`` + ``dmc_hem`` at full width from port ``.pth`` files,
    which the JAX package reads with its own loader (``load_params``,
    ``port_hem``), on a 2-frame PNG sequence padded to 64. Each runner
    decodes the streams it wrote, so with identical bytes each package
    decodes the other's; the port CLI writes its decoded frames
    (``--decoded_frame_path``) with Pillow blocked, and they match the
    JAX runner's within one code value. The image CLI's ``intra_hem``
    branch codes the sequence's first frame at the two rates its q_scale
    anchors give, on the same JAX ``EvcCodecRuntime`` (one JAX program at
    that shape for both cases);
  * a zoo I model (``mbt2018-mean``) + ``dmc_tcm`` at full width from port
    ``.pth`` files (``port_zoo``, ``port_tcm``) on the same PNG sequence.
"""

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dcvc_tpu.models.evc import make_evc as j_make_evc
from dcvc_tpu.models.intra_hem import IntraNoARHem as JIntraNoARHem
from dcvc_tpu.models.runtime import EvcCodecRuntime as JEvcCodecRuntime
from dcvc_tpu.models.runtime import HemVideoRuntime as JHemVideoRuntime
from dcvc_tpu.models.video_hem import DMCHem as JDMCHem
from dcvc_tpu.runner import adapters as jadapters
from dcvc_tpu.runner import video as jvideo
from dcvc_tpu.utils import port_dc
from dcvc_tpu.utils.checkpoint import load_params, save_params
from dcvc_tpu_torch.models.evc import build_evc
from dcvc_tpu_torch.models.intra_dc import build_intra_dc
from dcvc_tpu_torch.models.intra_hem import build_intra_hem
from dcvc_tpu_torch.models.registry import build
from dcvc_tpu_torch.models.video_dc import build_dmc
from dcvc_tpu_torch.models.video_hem import build_dmc_hem
from dcvc_tpu_torch.runner import adapters as tadapters
from dcvc_tpu_torch.runner import video as tvideo
from dcvc_tpu_torch.tools import test_image as image_cli
from dcvc_tpu_torch.tools import test_video as cli
from dcvc_tpu_torch.utils import color, png
import _waits

ROOT = Path(__file__).resolve().parent.parent
H, W, FRAMES, Q = 64, 96, 2, 32


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six pytest workers on one host: two torch threads each
    keeps torch's spinning OpenMP pool from starving the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(3)
    base = rng.random((H // 8 + 2, W // 8 + 2, 3))
    with open(d / "s1.yuv", "wb") as f:
        for i in range(FRAMES):
            img = np.kron(np.roll(base, i, axis=0), np.ones((8, 8, 1)))[:H, :W]
            y, uv = color.rgb_to_ycbcr420(img)
            f.write(np.clip(np.rint(y * 255), 0, 255).astype(np.uint8).tobytes())
            f.write(np.clip(np.rint(uv * 255), 0, 255).astype(np.uint8).tobytes())
    cfg = {"root_path": str(d), "test_classes": {"c": {
        "test": 1, "base_path": "", "src_type": "yuv420",
        "sequences": {"s1": {"width": W, "height": H, "frames": FRAMES,
                             "gop": 32}}}}}
    (d / "cfg.json").write_text(json.dumps(cfg))

    sd = {"i": build_intra_dc(seed=5, device="cpu").state_dict(),
          "p": build_dmc(seed=6, device="cpu").state_dict()}
    jp = {"i": port_dc.convert_intra_dc({k: v.numpy() for k, v in sd["i"].items()}),
          "p": port_dc.convert_dmc({k: v.numpy() for k, v in sd["p"].items()})}
    save_params(str(d / "i.npz"), jp["i"])
    save_params(str(d / "p.npz"), jp["p"])
    torch.save(sd["i"], d / "i.pth")
    # a DataParallel-style wrapped checkpoint: unwrapped on load
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd["p"].items()}},
               d / "p.pth.tar")

    irt = tadapters.adapt_i_runtime(build("intra_dc", seed=5, device="cpu")[1])
    prt = tadapters.adapt_p_runtime(build("dmc_dc", seed=6, device="cpu")[1])
    irt.update(force=True)
    prt.update(force=True)
    (spec,) = tvideo.load_dataset_config(cfg)
    ecfg = tvideo.EvalConfig(intra_period=32, frame_num=FRAMES,
                             write_stream=True, stream_path=str(d / "ref"),
                             verbose=1)
    summary = tvideo.run_sequence(irt, prt, spec, ecfg, q_index_i=Q,
                                  q_index_p=Q)
    return {"dir": d, "ref_summary": summary, "ref_bins": _bins(d / "ref")}


def _bins(path):
    return [Path(path, f"s1_{i}.bin").read_bytes() for i in range(FRAMES)]


def _args(d, tag, model_i, model_p):
    return ["--device", "cpu", "--test_config", str(d / "cfg.json"),
            "--model_path_i", str(d / model_i), "--model_path_p",
            str(d / model_p), "--write_stream", "1", "--rate_num", "1",
            "--q_indexes", str(Q), "--force_frame_num", str(FRAMES),
            "--stream_path", str(d / tag), "--output_path",
            str(d / f"{tag}.json")]


def test_cli_npz_subprocess_writes_the_jax_streams(case):
    """The CLI in a process of its own, on the JAX package's ``.npz``
    weights, writes the port runner's streams of the same weights and
    sequence, byte for byte, and its results keys. No JAX program runs
    here: the port's ``run_sequence`` is held to the JAX package's on the
    96x64 DC pair (DMC seed 6, OD block warp, IntraNoAR at N = 32, I + 2 P)
    by ``test_torch_port_runner.py::
    test_write_stream_bins_identical_across_packages``, and this case's
    full-width IntraNoAR and exact-warp DMC by the ``dc_intra`` / ``dc_p``
    pins (``test_torch_port_intra.py``, ``test_torch_port_dmc.py``)."""
    d = case["dir"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = _waits.run([sys.executable, "-m", "dcvc_tpu_torch.tools.test_video",
                    *_args(d, "npz", "i.npz", "p.npz")], 600, cwd=ROOT,
                   env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert _bins(d / "npz") == case["ref_bins"]
    res = json.loads((d / "npz.json").read_text())
    assert list(res) == ["s1"] and list(res["s1"]) == ["rate_0"]
    summary = res["s1"]["rate_0"]
    assert set(summary) == set(case["ref_summary"])
    assert summary["ave_all_frame_bits"] == pytest.approx(
        case["ref_summary"]["ave_all_frame_bits"])


def test_cli_pth_in_process_codes_the_same_bytes(case):
    d = case["dir"]
    res = cli.main(_args(d, "pth", "i.pth", "p.pth.tar"))
    assert _bins(d / "pth") == case["ref_bins"]
    assert res["s1"]["rate_0"]["frame_num"] == FRAMES


def test_cli_refuses_what_is_not_ported(case, capsys):
    """What the CLI still refuses: a write-stream pair of two padding
    generations (in the worker pool too, before it spawns), an unknown
    model. (The zoo and TCM refusals it once checked are gone: those models
    code, in ``test_cli_zoo_tcm_pair_writes_the_jax_streams``; so is the
    worker pool's, ``tests/test_torch_port_parallel.py``.)"""
    d = case["dir"]
    base = ["--device", "cpu", "--test_config", str(d / "cfg.json"),
            "--rate_num", "1", "--q_indexes", "0", "--force_frame_num", "1",
            "--output_path", str(d / "x.json")]
    with pytest.raises(SystemExit, match="padding generation"):
        cli.main(base + ["--worker_num", "2", "--p_frame_model", "dmc_hem",
                         "--write_stream", "1"])
    with pytest.raises(SystemExit, match="padding generation"):
        cli.main(base + ["--p_frame_model", "dmc_hem", "--write_stream", "1"])
    with pytest.raises(SystemExit, match="padding generation"):
        cli.main(base + ["--p_frame_model", "dmc_tcm", "--write_stream", "1"])
    with pytest.raises(KeyError):
        from dcvc_tpu_torch.utils.checkpoint import load_state_dict

        load_state_dict(str(d / "i.pth"), "no_such_model")
    with pytest.raises(KeyError):
        from dcvc_tpu_torch.models.registry import build

        build("no_such_model", device="cpu")


def _jax_run(d, cfg, tag, i_rt, p_rt, pad, intra_period, decoded=None):
    """The JAX CLI's evaluation of one (sequence, rate) on runtimes whose
    tables are built: its adapters and run_sequence with its padding and
    intra period."""
    i_rt = jadapters.adapt_i_runtime(i_rt)
    if p_rt is not None:
        p_rt = jadapters.adapt_p_runtime(p_rt)
    (spec,) = jvideo.load_dataset_config(cfg)
    ecfg = jvideo.EvalConfig(intra_period=intra_period, frame_num=FRAMES,
                             write_stream=True, stream_path=str(d / tag),
                             decoded_path=decoded, pad_multiple=pad)
    jvideo.run_sequence(i_rt, p_rt, spec, ecfg, q_index_i=Q, q_index_p=Q)
    return [Path(d, tag, f"{spec.name}_{i}.bin").read_bytes()
            for i in range(FRAMES)]


def test_cli_evc_force_intra_writes_the_jax_streams(case):
    """Queue 3 F1: EVC I-frames code through the port's video CLI."""
    d = case["dir"]
    tm = build_evc("SS", seed=7, device="cpu")
    with torch.no_grad():
        tm.q_scale.copy_(torch.tensor([1.3, 1.0, 0.8, 0.6]).view(4, 1, 1, 1))
    torch.save(tm.state_dict(), d / "evc_ss.pth")
    params = port_dc.convert_evc(
        {k: v.numpy() for k, v in tm.state_dict().items()})
    cfg = json.loads((d / "cfg.json").read_text())
    rt = JEvcCodecRuntime(j_make_evc("SS"), params)
    rt.update(force=True)
    jbins = _jax_run(d, cfg, "jax_evc", rt, None, 64, 1)
    cli.main(["--device", "cpu", "--test_config", str(d / "cfg.json"),
              "--i_frame_model", "evc_SS", "--force_intra",
              "--model_path_i", str(d / "evc_ss.pth"), "--write_stream", "1",
              "--rate_num", "1", "--q_indexes", str(Q), "--force_frame_num",
              str(FRAMES), "--stream_path", str(d / "evc"), "--output_path",
              str(d / "evc.json")])
    assert _bins(d / "evc") == jbins


@pytest.fixture(scope="module")
def hem(tmp_path_factory):
    """A 2-frame PNG sequence, full-width intra_hem + dmc_hem port weights
    saved as ``.pth``, and the JAX runtimes the JAX CLI builds from those
    files, tables built."""
    d = tmp_path_factory.mktemp("hem")
    (d / "src" / "s2").mkdir(parents=True)
    rng = np.random.default_rng(8)
    base = rng.random((H // 8 + 2, W // 8 + 2, 3))
    for i in range(FRAMES):
        img = np.kron(np.roll(base, i, axis=1), np.ones((8, 8, 1)))[:H, :W]
        img = img + rng.normal(0, 0.05, img.shape)
        png.write_png(d / "src" / "s2" / f"im{i + 1}.png",
                      np.clip(np.rint(img * 255), 0, 255).astype(np.uint8))
    cfg = {"root_path": str(d / "src"), "test_classes": {"c": {
        "test": 1, "base_path": "", "src_type": "png",
        "sequences": {"s2": {"width": W, "height": H, "frames": FRAMES,
                             "gop": 32}}}}}
    (d / "cfg.json").write_text(json.dumps(cfg))
    ti = build_intra_hem(seed=9, device="cpu")
    tp = build_dmc_hem(seed=10, device="cpu")
    with torch.no_grad():
        tp.mv_y_q_scale.copy_(torch.tensor([1.2, 1.0, 0.8, 0.6]).view(4, 1, 1, 1))
        tp.y_q_scale.copy_(torch.tensor([1.4, 1.1, 0.8, 0.5]).view(4, 1, 1, 1))
    torch.save(ti.state_dict(), d / "i.pth")
    torch.save(tp.state_dict(), d / "p.pth")
    irt = JEvcCodecRuntime(JIntraNoARHem(),
                           load_params(str(d / "i.pth"), model="intra_hem"))
    prt = JHemVideoRuntime(JDMCHem(),
                           load_params(str(d / "p.pth"), model="dmc_hem"))
    irt.update(force=True)
    prt.update(force=True)
    return d, cfg, irt, prt


def test_cli_hem_pair_writes_the_jax_streams_without_pillow(hem, monkeypatch):
    """intra_hem + dmc_hem from port .pth files that both packages load;
    the decoded PNGs are written with Pillow blocked (Queue 3 F2)."""
    d, cfg, irt, prt = hem
    jbins = _jax_run(d, cfg, "jax", irt, prt, 64, 32,
                     decoded=str(d / "jax_dec"))

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    res = cli.main(["--device", "cpu", "--test_config", str(d / "cfg.json"),
                    "--i_frame_model", "intra_hem", "--p_frame_model",
                    "dmc_hem", "--model_path_i", str(d / "i.pth"),
                    "--model_path_p", str(d / "p.pth"), "--write_stream", "1",
                    "--rate_num", "1", "--q_indexes", str(Q),
                    "--force_frame_num", str(FRAMES), "--stream_path",
                    str(d / "port"), "--decoded_frame_path",
                    str(d / "port_dec"), "--output_path",
                    str(d / "port.json")])
    assert [Path(d, "port", f"s2_{i}.bin").read_bytes()
            for i in range(FRAMES)] == jbins
    assert all(len(b) > 100 for b in jbins)
    assert res["s2"]["rate_0"]["frame_num"] == FRAMES
    for i in range(FRAMES):
        name = f"im{i + 1:05d}.png"
        mine = png.read_png(d / "port_dec" / "s2" / name).astype(int)
        theirs = png.read_png(d / "jax_dec" / "s2" / name).astype(int)
        assert mine.shape == (H, W, 3)
        assert np.abs(mine - theirs).max() <= 1


def test_image_cli_intra_hem_writes_the_jax_runtimes_bins(hem):
    """The image CLI's ``intra_hem`` branch (a full-width port ``.pth``)
    writes what the JAX ``EvcCodecRuntime`` writes at the q_scale anchors'
    rates (the JAX image CLI's branch)."""
    from test_torch_port_image_cli import _bins, _jax_bins

    d, _, irt, _ = hem
    (d / "imgs").mkdir()
    shutil.copy(d / "src" / "s2" / "im1.png", d / "imgs" / "f.png")
    sizes = {"f.png": (H, W)}
    image_cli.main(["--img_folder", str(d / "imgs"), "--device", "cpu",
                    "--model", "intra_hem", "--model_path", str(d / "i.pth"),
                    "--rate_num", "2", "--write_stream", "1", "--stream_path",
                    str(d / "image"), "--output_path",
                    str(d / "image.json"), "--verbose", "0"])
    bins = _bins(d, "image", 2, sizes)
    # the anchors [1.541 .. 0.5] give two rates
    assert bins["f.png_0"] != bins["f.png_1"]
    assert bins == _jax_bins(d, irt, 2, sizes)


def test_cli_zoo_tcm_pair_writes_the_jax_streams(hem):
    """A zoo I-frame model (``mbt2018-mean``) + ``dmc_tcm`` at full width,
    from port ``.pth`` files that the JAX package loads with its own
    converters (``load_params``: ``port_zoo``, ``port_tcm``), on the HEM
    case's 2-frame PNG sequence: the CLI writes the JAX CLI's ``.bin``
    files (the zoo's packed substreams, TCM's bare payload) byte for byte.
    Each runner decodes the streams it wrote, so each package decodes the
    other's bytes."""
    from dcvc_tpu.models.intra_zoo import MeanScaleHyperprior
    from dcvc_tpu.models.runtime import IntraZooRuntime as JIntraZooRuntime
    from dcvc_tpu.models.runtime import TcmVideoRuntime as JTcmVideoRuntime
    from dcvc_tpu.models.video_tcm import DMCTcm as JDMCTcm
    from dcvc_tpu_torch.models.intra_zoo import build_zoo
    from dcvc_tpu_torch.models.video_tcm import build_dmc_tcm

    d, cfg, _, _ = hem
    torch.save(build_zoo("mbt2018-mean", seed=11, device="cpu").state_dict(),
               d / "zoo_i.pth")
    torch.save(build_dmc_tcm(seed=12, device="cpu").state_dict(),
               d / "tcm_p.pth")
    irt = JIntraZooRuntime(MeanScaleHyperprior(), load_params(
        str(d / "zoo_i.pth"), model="mbt2018-mean"))
    prt = JTcmVideoRuntime(JDMCTcm(), load_params(str(d / "tcm_p.pth"),
                                                  model="dmc_tcm"))
    irt.update(force=True)
    prt.update(force=True)
    jbins = _jax_run(d, cfg, "jax_tcm", irt, prt, 64, 32)
    res = cli.main(["--device", "cpu", "--test_config", str(d / "cfg.json"),
                    "--i_frame_model", "mbt2018-mean", "--p_frame_model",
                    "dmc_tcm", "--model_path_i", str(d / "zoo_i.pth"),
                    "--model_path_p", str(d / "tcm_p.pth"), "--write_stream",
                    "1", "--rate_num", "1", "--q_indexes", str(Q),
                    "--force_frame_num", str(FRAMES), "--stream_path",
                    str(d / "port_tcm"), "--output_path",
                    str(d / "port_tcm.json")])
    assert [Path(d, "port_tcm", f"s2_{i}.bin").read_bytes()
            for i in range(FRAMES)] == jbins
    assert all(len(b) > 100 for b in jbins)
    assert res["s2"]["rate_0"]["frame_num"] == FRAMES
