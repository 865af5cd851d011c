"""The port stands alone and keeps its device rule.

* No module of dcvc_tpu_torch, and not chip_smoke.py, imports jax, flax or
  dcvc_tpu: checked on the source (AST) and by importing every module in a
  fresh interpreter.
* Entry points run on the card unless asked for the CPU: without CUDA and
  without device="cpu" they raise.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dcvc_tpu_torch"
FORBIDDEN = ("jax", "flax", "dcvc_tpu")


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


def test_import_all_modules_loads_no_jax():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in PKG.rglob("*.py")]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(mods) + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.') "
        f"for f in {FORBIDDEN!r})]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_entry_points_raise_without_cuda(monkeypatch):
    from dcvc_tpu_torch.device import resolve_device
    from dcvc_tpu_torch.models.intra_dc import IntraNoAR, build_intra_dc
    from dcvc_tpu_torch.models.runtime import DmcRuntime, IntraDcRuntime
    from dcvc_tpu_torch.models.video_dc import build_dmc

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
    assert resolve_device("cpu").type == "cpu"
