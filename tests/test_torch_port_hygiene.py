"""The port stands alone and keeps its device rule.

* No module of dcvc_tpu_torch, and not chip_smoke.py, imports jax, flax,
  optax or dcvc_tpu: checked on the source (AST) and by importing every
  module in a fresh interpreter.
* Entry points run on the card unless asked for the CPU: without CUDA and
  without device="cpu" they raise.
* Every module of dcvc_tpu_torch and chip_smoke.py imports without Pillow
  (the machine with the card has none; PNGs are read by utils/png.py).
"""

import ast
import json
import sys
from pathlib import Path

import pytest
import torch
import _waits

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dcvc_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "dcvc_tpu")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name} imports {bad}"


@pytest.fixture(scope="module")
def fresh_imports():
    """One fresh interpreter for both import checks (it costs seconds to
    start with torch): it imports every module of the package and
    chip_smoke.py, and lists the PIL and the JAX modules then loaded."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in PKG.rglob("*.py")]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = (
        "import importlib, json, sys\n"
        "def loaded(names):\n"
        "    return [m for m in sys.modules if any(\n"
        "        m == f or m.startswith(f + '.') for f in names)]\n"
        f"for m in {sorted(mods) + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        f"print(json.dumps({{'pil': loaded(['PIL']), "
        f"'jax': loaded({FORBIDDEN!r}), "
        "'modules': len(sys.modules)}))\n")
    res = _waits.run([sys.executable, "-c", code], 300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.splitlines()[-1])


def test_import_all_modules_loads_no_jax(fresh_imports):
    assert not fresh_imports["jax"], fresh_imports["jax"]
    assert fresh_imports["modules"] > 0


def test_entry_points_raise_without_cuda(monkeypatch):
    from dcvc_tpu_torch.device import resolve_device
    from dcvc_tpu_torch.models.intra_dc import IntraNoAR, build_intra_dc
    from dcvc_tpu_torch.models.intra_hem import build_intra_hem
    from dcvc_tpu_torch.models.runtime import (DmcRuntime, HemVideoRuntime,
                                               IntraDcRuntime)
    from dcvc_tpu_torch.models.intra_zoo import build_zoo
    from dcvc_tpu_torch.models.runtime import (DcvcGen1Runtime,
                                               IntraZooRuntime,
                                               TcmVideoRuntime)
    from dcvc_tpu_torch.models.video_canf import build_canf
    from dcvc_tpu_torch.models.video_dc import build_dmc
    from dcvc_tpu_torch.models.video_dcvc import build_dcvc_gen1
    from dcvc_tpu_torch.models.video_hem import build_dmc_hem
    from dcvc_tpu_torch.models.video_tcm import build_dmc_tcm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        IntraDcRuntime(IntraNoAR(N=8, ch_a=8, ch_b=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_intra_dc(N=8, ch_a=8, ch_b=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_dmc()
    module = build_dmc(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DmcRuntime(module)
    for builder in (build_intra_hem, build_dmc_hem, build_canf,
                    build_dmc_tcm, build_dcvc_gen1,
                    lambda: build_zoo("bmshj2018-factorized")):
        with pytest.raises(RuntimeError, match="CUDA"):
            builder()
    small = {"channel_mv": 8, "channel_N": 8, "channel_M": 8}
    for runtime, module in (
            (HemVideoRuntime, build_dmc_hem(device="cpu", **small)),
            (TcmVideoRuntime, build_dmc_tcm(device="cpu", **small)),
            (DcvcGen1Runtime, build_dcvc_gen1(device="cpu", **small)),
            (IntraZooRuntime, build_zoo("mbt2018", device="cpu", N=8, M=8))):
        with pytest.raises(RuntimeError, match="CUDA"):
            runtime(module)
    assert resolve_device("cpu").type == "cpu"


def test_runner_cli_and_chip_smoke_load_no_pil(fresh_imports):
    assert not fresh_imports["pil"], fresh_imports["pil"]


def test_registry_and_cli_raise_without_cuda(monkeypatch, tmp_path):
    from dcvc_tpu_torch.models import registry
    from dcvc_tpu_torch.tools import test_image, test_video

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.build("intra_dc", N=8, ch_a=8, ch_b=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.build("dmc_dc")
    for name in ("evc_LL", "evc_scalable", "intra_hem", "dmc_hem",
                 "canfvc_dmc", "bmshj2018-factorized", "cheng2020-anchor",
                 "dmc_tcm", "dcvc_gen1"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            registry.build(name)
    with pytest.raises(SystemExit, match="device='cpu'"):
        test_image.main(["--img_folder", str(tmp_path)])
    with pytest.raises(SystemExit, match="no .png images"):
        test_image.main(["--img_folder", str(tmp_path), "--device", "cpu"])
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"test_classes": {}}')
    with pytest.raises(SystemExit, match="device='cpu'"):
        test_video.main(["--test_config", str(cfg)])
    # with --device cpu the same (empty) config runs and writes its JSON
    out = tmp_path / "res.json"
    assert test_video.main(["--test_config", str(cfg), "--device", "cpu",
                            "--force_intra", "--output_path", str(out)]) == {}
    assert out.read_text().strip() == "{}"


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The trainer, build_train_module and the training CLI run
    on the card unless given the CPU."""
    from dcvc_tpu_torch.training.trainer import (PFrameTrainer,
                                                 build_train_module)
    from dcvc_tpu_torch.tools import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = {"channel_mv": 8, "channel_N": 8, "channel_M": 8}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_train_module("dmc_hem", **small)
    module = build_train_module("dmc_hem", device="cpu", **small)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PFrameTrainer(module, workdir=str(tmp_path))
    assert PFrameTrainer(module, workdir=str(tmp_path),
                         device="cpu").device.type == "cpu"
    with pytest.raises(SystemExit, match="device='cpu'"):
        train.main(["--workdir", str(tmp_path / "w")])
