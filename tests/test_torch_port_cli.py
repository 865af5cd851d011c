"""The port's video CLI (``python -m dcvc_tpu_torch.tools.test_video``)
against the JAX package, on the CPU.

The weights are made once, seeded, by the port and carried to the JAX
package with ``dcvc_tpu/utils/port_dc.py`` (the converter its own CLI uses
for published checkpoints); this skips the JAX models' ~60 s init, and
``tests/test_torch_port_runner.py`` covers the other direction. They are
saved as the JAX package's native ``.npz`` (``save_params``) and as a port
``.pth``. The JAX ``run_sequence`` codes a 96x64 YUV420 sequence of 2
frames (I, P) with them; the CLI, loading either file, must write the
same ``.bin`` files byte for byte and a results JSON with the same keys.
(Chained P-frames through the same runner are
tests/test_torch_port_runner.py's subject; a third frame here cost a
second P-frame program in both packages and tested nothing new.)
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dcvc_tpu.models.intra_dc import IntraNoAR as JIntraNoAR
from dcvc_tpu.models.runtime import DmcRuntime as JDmcRuntime
from dcvc_tpu.models.runtime import IntraDcRuntime as JIntraDcRuntime
from dcvc_tpu.models.video_dc import DMC as JDMC
from dcvc_tpu.runner import video as jvideo
from dcvc_tpu.utils import port_dc
from dcvc_tpu.utils.checkpoint import save_params
from dcvc_tpu_torch.models.intra_dc import build_intra_dc
from dcvc_tpu_torch.models.video_dc import build_dmc
from dcvc_tpu_torch.tools import test_video as cli
from dcvc_tpu_torch.utils import color

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

    irt = JIntraDcRuntime(JIntraNoAR(), jp["i"])
    prt = JDmcRuntime(JDMC(od_warp_mode="exact"), jp["p"])
    irt.update(force=True)
    prt.update(force=True)
    (spec,) = jvideo.load_dataset_config(cfg)
    ecfg = jvideo.EvalConfig(intra_period=32, frame_num=FRAMES,
                             write_stream=True, stream_path=str(d / "jax"),
                             verbose=1)
    summary = jvideo.run_sequence(irt, prt, spec, ecfg, q_index_i=Q,
                                  q_index_p=Q)
    return {"dir": d, "jax_summary": summary, "jax_bins": _bins(d / "jax")}


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
    d = case["dir"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "dcvc_tpu_torch.tools.test_video",
                        *_args(d, "npz", "i.npz", "p.npz")], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert _bins(d / "npz") == case["jax_bins"]
    res = json.loads((d / "npz.json").read_text())
    assert list(res) == ["s1"] and list(res["s1"]) == ["rate_0"]
    summary = res["s1"]["rate_0"]
    assert set(summary) == set(case["jax_summary"])
    assert summary["ave_all_frame_bits"] == pytest.approx(
        case["jax_summary"]["ave_all_frame_bits"])


def test_cli_pth_in_process_codes_the_same_bytes(case):
    d = case["dir"]
    res = cli.main(_args(d, "pth", "i.pth", "p.pth.tar"))
    assert _bins(d / "pth") == case["jax_bins"]
    assert res["s1"]["rate_0"]["frame_num"] == FRAMES


def test_cli_refuses_what_is_not_ported(case, capsys):
    d = case["dir"]
    base = ["--device", "cpu", "--test_config", str(d / "cfg.json"),
            "--rate_num", "1", "--q_indexes", "0", "--force_frame_num", "1",
            "--output_path", str(d / "x.json")]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 13"):
        cli.main(base + ["--i_frame_model", "evc_SS", "--force_intra"])
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 13"):
        cli.main(base + ["--p_frame_model", "dmc_hem"])
    with pytest.raises(SystemExit, match="worker_num"):
        cli.main(base + ["--worker_num", "2"])
    with pytest.raises(SystemExit, match="padding generation"):
        cli.main(base + ["--p_frame_model", "dmc_hem", "--write_stream", "1"])
    with pytest.raises(NotImplementedError, match="item 13"):
        from dcvc_tpu_torch.utils.checkpoint import load_state_dict

        load_state_dict(str(d / "i.pth"), "intra_hem")
    with pytest.raises(KeyError):
        from dcvc_tpu_torch.models.registry import build

        build("no_such_model", device="cpu")
