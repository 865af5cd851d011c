"""The frozen reference: plain, independent of the program, and equal to
the port at a tiny size on the CPU."""

import ast

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.reference import warp

from . import _tiny


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted((harness.BENCH / "reference").glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top in ("torch", "numpy", "math", "importlib",
                           "__future__"), (f, name)


@pytest.mark.parametrize("cell", ["dc_1080p_stream", "evc_ll_1080p_stream"])
def test_reference_equals_port_tiny(cell, monkeypatch):
    _tiny.shrink(monkeypatch)
    mix = harness.traffic(harness.cell(harness.spec(), cell)["traffic"])
    row = calibrate.read_seed(cell, 5, torch.device("cpu"), traffic=mix)
    assert row["checked"][:2] == [0, 1] and len(row["checked"]) == 4
    assert row["recon_gap"] == 0.0
    assert row["symbol_faults"] == 0 and row["tie_symbols"] == 0
    assert row["old_recon_gap"] == 0.0
    if cell.startswith("dc"):
        assert row["feature_gap"] == 0.0


def test_block_warp_equals_the_ports_plain_version():
    from dcvc_tpu_torch.ops.block_warp import block_warp_plain_nchw

    g = torch.Generator().manual_seed(3)
    im = torch.rand(6, 3, 72, 200, generator=g)
    flow = (torch.rand(6, 2, 72, 200, generator=g) - 0.5) * 30
    for args in ((4, 4, 64, 128, "median4"), (8, 2, 8, 512, "median"),
                 (4, 4, 16, 64, "mean")):
        a = warp.block_warp(im, flow, *args)
        b = block_warp_plain_nchw(im, flow, *args)
        assert torch.equal(a, b)
    # where every residual fits, it is the exact warp up to rounding
    small = torch.full_like(flow, 0.3)
    assert torch.allclose(warp.block_warp(im, small, 4, 4, 64, 128, "median4"),
                          warp.flow_warp(im, small), atol=1e-5)
