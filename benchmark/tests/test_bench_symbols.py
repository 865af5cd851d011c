"""The reference judges a decoder's symbols one by one: a rounding tie of
float32 arithmetic passes, any other difference is a fault; and a program
that sums its convolutions in another exact order still reads correct."""

import pytest
import torch

from benchmark.reference.symbols import Symbols, flat_nhwc, tally
from benchmark.run import checks, correct

from . import _tiny

DELTA = 1e-5
LIMITS = {"symbol_faults": 0, "tie_delta": DELTA}


def _plane(r: float, n: int = 6):
    """[1, 2, 1, n] residuals, all ``r``."""
    return torch.full((1, 2, 1, n), r, dtype=torch.float64)


def _judged(r, q) -> Symbols:
    sym = Symbols(("z",), [flat_nhwc(q)], DELTA)
    got = sym.round("z", r)
    assert torch.equal(got, q.to(r.dtype))      # the decoder's symbols
    return sym


@pytest.mark.parametrize("r", [2.5 - DELTA / 2, 2.5 + DELTA / 2,
                               -2.5 - DELTA / 2, -2.5 + DELTA / 2])
def test_a_flip_at_a_boundary_is_a_tie_and_passes(r):
    res = _plane(r)
    q = torch.round(res)
    q[0, 1, 0, 3] += 1 if q[0, 1, 0, 3] < res[0, 1, 0, 3] else -1
    sym = _judged(res, q)
    assert (sym.ties, sym.faults) == (1, 0)
    assert sym.distances == pytest.approx([DELTA / 2])
    assert correct(checks({"symbol_faults": sym.faults}, LIMITS))


@pytest.mark.parametrize("r", [2.5 - 10 * DELTA, 2.5 + 10 * DELTA,
                               -2.5 - 10 * DELTA, 0.3])
def test_a_flip_off_a_boundary_is_a_fault_and_fails(r):
    res = _plane(r)
    q = torch.round(res)
    q[0, 0, 0, 2] += 1
    sym = _judged(res, q)
    assert (sym.ties, sym.faults) == (0, 1)
    assert not correct(checks({"symbol_faults": sym.faults}, LIMITS))


@pytest.mark.parametrize("move", [2, -1])
def test_more_than_the_neighbour_across_the_boundary_is_a_fault(move):
    """At 2.5 - delta/2 the tie is 3; 4 (2 away) and 1 (the wrong side)
    are faults."""
    res = _plane(2.5 - DELTA / 2)
    q = torch.round(res)
    q[0, 0, 0, 0] += move
    assert tally(res, q, DELTA)[:2] == (0, 1)


def test_a_missing_or_misshapen_plane_is_all_faults():
    r = _plane(1.2)
    sym = Symbols(("z", "y0"), [flat_nhwc(torch.round(r))[:-1]], DELTA)
    sym.round("z", r)
    sym.round("y0", r)
    assert sym.faults == 2 * r.numel() and sym.ties == 0
    extra = Symbols(("z",), [flat_nhwc(torch.round(r))] * 2, DELTA)
    extra.round("z", r)
    assert extra.faults == r.numel()


def test_own_rounding_keeps_the_streams_layout():
    """Without the decoder's planes the reference rounds its own
    residuals and keeps them flat in NHWC order, as a decoder's tap
    would give them."""
    g = torch.Generator().manual_seed(1)
    r = torch.randn(1, 3, 2, 4, generator=g) * 5
    sym = Symbols(("z",))
    assert torch.equal(sym.round("z", r), torch.round(r))
    assert torch.equal(sym.stream()[0],
                       torch.round(r).permute(0, 2, 3, 1).reshape(-1))
    follow = Symbols(("z",), sym.stream(), DELTA, sym.residuals())
    assert torch.equal(follow.round("z", r), torch.round(r))
    assert (follow.ties, follow.faults) == (0, 0)
    assert float(torch.cat(follow.gaps).max()) == 0.0


def _program_convs_f64(monkeypatch) -> list:
    """The program's dense 3x3 convolutions accumulated in float64 and
    rounded to float32 (another exact order); the count of calls."""
    import torch.nn.functional as F

    from dcvc_tpu_torch.layers import blocks

    calls = []
    orig = blocks.Conv2d._conv

    def conv(self, x, padding):
        if self.kernel_size != (3, 3) or self.groups != 1 \
                or self.compute_dtype is not None:
            return orig(self, x, padding)
        calls.append(1)
        b = None if self.bias is None else self.bias.double()
        return F.conv2d(x.double(), self.weight.double(), b, self.stride,
                        padding, self.dilation, self.groups).to(x.dtype)

    monkeypatch.setattr(blocks.Conv2d, "_conv", conv)
    return calls


@pytest.mark.parametrize("cell", ["dc_1080p_stream", "evc_ll_1080p_stream"])
def test_program_with_f64_accumulated_convs_reads_correct(cell, monkeypatch):
    _tiny.shrink(monkeypatch)
    calls = _program_convs_f64(monkeypatch)
    out = _tiny.run(cell, seconds=0.3)
    assert calls and out["correct"] is True, out["checks"]
    assert out["checks"]["symbol_faults"]["value"] == 0


@pytest.mark.parametrize("cell", ["dc_1080p_stream", "evc_ll_1080p_stream"])
def test_twin_control_reads_correct(cell, monkeypatch):
    """``calibrate``'s twin: the reference, its dense convolutions in
    float64 accumulation, in the program's place."""
    from benchmark import calibrate, harness

    _tiny.shrink(monkeypatch)
    mix = harness.traffic(harness.cell(harness.spec(), cell)["traffic"])
    row = calibrate.read_seed(cell, 9, torch.device("cpu"), "twin",
                              traffic=mix)
    lim = harness.limits(cell)
    assert correct(checks(row, lim)), row
    # the tie window holds four times the twin's largest residual gap
    assert row["residual_gap_max"] * 4 <= lim["tie_delta"]
