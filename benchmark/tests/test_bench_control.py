"""The control, on the card: the reference computed in TF32 (the
precision below the configurations' float32) in the program's place fails
at least one of each cell's numbers, at a size a test run holds, and in a
coding cell the reference with float64-accumulated convolutions (another
exact order) passes. The cell-size readings come from
``benchmark/calibrate.py`` (PERF.md)."""

import pytest

from benchmark import calibrate, harness
from benchmark.run import checks, correct

SIZES = {"dc_1080p_stream": {"height": 256, "width": 448},
         "evc_ll_1080p_stream": {"height": 256, "width": 448},
         "dc_train_256": {"batch": 2, "crop": 128}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SIZES))
def test_control_fails_and_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (TF32 exists only there)")
    from dcvc_tpu_torch.device import exact_numerics

    exact_numerics()
    c = harness.cell(harness.spec(), cell)
    mix = dict(harness.traffic(c["traffic"]), **SIZES[cell])
    if "check_below" in mix:
        mix.update(check=2, check_below=6)
    lim = harness.limits(cell)
    dev = torch.device("cuda")
    for seed in (2100009001, 2100009002, 2100009003):
        prog = calibrate.read_seed(cell, seed, dev, "program", traffic=mix)
        ctrl = calibrate.read_seed(cell, seed, dev, "control", traffic=mix)
        assert correct(checks(prog, lim)), prog
        assert not correct(checks(ctrl, lim)), ctrl
        if mix["kind"] == "coding_stream":
            twin = calibrate.read_seed(cell, seed, dev, "twin", traffic=mix)
            assert correct(checks(twin, lim)), twin
