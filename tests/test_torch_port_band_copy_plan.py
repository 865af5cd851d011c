"""K2's launch plan (dcvc_tpu_torch/ops/band_copy.py:plan_band_copy), on the
CPU.

The kernel (csrc/band_copy.cu) runs only on the card, but every index it
uses comes from the plan: the chunks of a band, the ring's stages and slot
stride, the grid and each CTA's range of (row, chunk) stages, and the slot
and barrier parities of its walk. These tests check them at the probe
tool's shape, at the shapes chip_smoke.py runs and over a hypothesis sweep:
every stage is issued exactly once, the chunks tile each band, the ring
fits a CTA's shared memory, the grid fills the SMs, the mbarrier parities
the walk waits on are the phases that hold its chunk, and a numpy replay of
the walk gives the plain version's output.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dcvc_tpu_torch.ops import band_copy as bc
from dcvc_tpu_torch.tools import diag_dma

SMS = 132   # an H100's SMs
SHAPES = {   # (H, Wp, C, A): the tool's and chip_smoke.py's
    "tool": (720, 1408, 16, 4),
    "edge_4_byte": (16, 130, 3, 4),
    "uneven": (64, 1004, 5, 7),
    "thin": (720, 1408, 1, 1),
}


def _check_plan(plan: bc.BandCopyPlan, sms: int):
    # the chunks tile the band: no gap, no overlap, as equal as the split
    # granularity allows (the last chunk also takes the tail)
    ends, sizes = 0, []
    for k in range(plan.n_chunks):
        off, size = plan.chunk(k)
        assert off == ends and size > 0
        assert size <= plan.slot_bytes
        assert off % plan.split == 0
        if plan.bulk:
            assert off % 16 == 0 and size % 16 == 0
        ends += size
        sizes.append(size - (plan.tail if k == plan.n_chunks - 1 else 0))
    assert ends == plan.band_bytes
    assert max(sizes) - min(sizes) <= plan.split
    assert 0 <= plan.tail < plan.split and plan.tail % plan.unit == 0
    assert plan.slot_bytes % bc.SLOT_ALIGN == 0
    # the ring fits one CTA; bulk copies need 16-byte aligned slots
    assert 1 <= plan.NST <= bc.MAX_STAGES
    assert plan.smem <= bc.SMEM_MAX == 232_448
    assert 2 * 8 * bc.MAX_STAGES <= bc.BARRIER_BYTES
    # every SM gets a CTA, every CTA a stage
    assert plan.grid == min(plan.stages, sms)
    # every (row, chunk) stage is issued exactly once; at local step j the
    # CTAs hold stages j grid .. j grid + grid - 1, neighbours in src
    issued = np.zeros(plan.stages, np.int64)
    for b in range(plan.grid):
        for j, (s, row, k, *_) in enumerate(plan.ring(b)):
            assert s == j * plan.grid + b
            assert (row, k) == divmod(s, plan.n_chunks)
            issued[s] += 1
    assert (issued == 1).all()
    # a CTA's share differs from another's by one stage at most
    spans = [len(plan.cta_stages(b)) for b in range(plan.grid)]
    assert min(spans) >= 1 and max(spans) - min(spans) <= 1
    # the output row (the first Wp * 4 bytes of a band) is written whole,
    # by 16-byte stores only at 16-byte boundaries
    row0 = plan.Wp * 4
    covered = 0
    for k in range(plan.n_chunks):
        off, size = plan.chunk(k)
        if off < row0:
            assert off == covered
            covered = min(off + size, row0)
            if plan.vec_out:
                assert off % 16 == 0 and covered % 16 == 0
    assert covered == row0


def _replay_ring(plan: bc.BandCopyPlan, b: int, order):
    """Run CTA ``b``'s walk against a model of its mbarriers.

    ``order`` picks, at each step, whether the issuing thread or the
    consumers try to move (a stand-in for any interleaving on the card).
    try_wait.parity(P) passes once the barrier's phase of parity P has
    completed, i.e. when its completed-phase count is odd for P = 0 and
    even (and nonzero) for P = 1. Asserts that every wait that passes finds
    exactly the phase holding its own stage's chunk."""
    walk = list(plan.ring(b))
    full = [0] * plan.NST     # completed phases per slot
    empty = [0] * plan.NST
    held = [None] * plan.NST  # stage whose chunk a slot holds
    issued = consumed = 0
    for pick in order:
        if pick and issued < len(walk):
            s, _, _, slot, _, empty_parity = walk[issued]
            j = issued
            if empty_parity is None:
                assert j < plan.NST and empty[slot] == 0
            elif empty[slot] % 2 == empty_parity:   # phase not completed yet
                continue
            else:
                assert empty[slot] == j // plan.NST    # slot released once
            held[slot] = s
            full[slot] += 1                            # its chunk lands
            issued += 1
        elif consumed < issued:
            s, _, _, slot, full_parity, _ = walk[consumed]
            if full[slot] % 2 == full_parity:
                continue
            assert full[slot] == consumed // plan.NST + 1
            assert held[slot] == s
            empty[slot] += 1
            consumed += 1
    return issued, consumed, len(walk)


def _replay_copies(plan: bc.BandCopyPlan, src: np.ndarray, by: np.ndarray):
    """A numpy replay of every CTA's copies through its ring slots."""
    raw = src.reshape(-1).view(np.uint8)
    out = np.full((plan.H, plan.Wp), np.nan, np.float32)
    out_raw = out.reshape(-1).view(np.uint8)
    row0 = plan.Wp * 4
    for b in range(plan.grid):
        ring = np.zeros((plan.NST, plan.slot_bytes), np.uint8)
        for _, row, k, slot, _, _ in plan.ring(b):
            off, size = plan.chunk(k)
            start = int(by[row]) * plan.row_bytes + off
            ring[slot, :size] = raw[start:start + size]
            if off < row0:
                end = min(off + size, row0)
                out_raw[row * row0 + off:row * row0 + end] = \
                    ring[slot, :end - off]
    return out


def _inputs(H, Wp, C, A, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((H + A, C, Wp)).astype(np.float32)
    by = np.clip(rng.integers(-8, 8, H) + np.arange(H), 0, H).astype(np.int32)
    by[0], by[-1] = H, 0              # the last band and the first
    return src, by


def test_tool_shape_plan():
    """The probe's shape: 7 chunks of 51,584 / 51,456 B (128-byte
    boundaries) in a 4-stage ring, one CTA per SM, 38 or 39 stages each."""
    plan = bc.plan_band_copy(*SHAPES["tool"], 8, SMS)
    assert plan.bulk and plan.vec_out and plan.split == 128
    assert plan.band_bytes == 360_448 and plan.n_chunks == 7
    assert [plan.chunk(k)[1] for k in range(7)] == [51_584] * 2 + [51_456] * 5
    assert (plan.NST, plan.slot_bytes, plan.smem) == (4, 51_584, 206_464)
    assert (plan.stages, plan.grid) == (5040, 132)
    assert {len(plan.cta_stages(b)) for b in range(132)} == {38, 39}


@pytest.mark.parametrize("rows_per_step", [1, 8, 16])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_chip_smoke_shapes_plan(name, rows_per_step):
    H, Wp, C, A = SHAPES[name]
    plan = bc.plan_band_copy(H, Wp, C, A, rows_per_step, SMS)
    _check_plan(plan, SMS)
    assert plan.bulk == (name != "edge_4_byte")
    if name == "uneven":   # 8 row groups; a band of 1098 lines and 16 B
        assert H // rows_per_step < SMS and plan.tail == 16
        assert [plan.chunk(k)[1] for k in range(3)] == [46_848, 46_848,
                                                        46_864]
    for b in (0, plan.grid // 2, plan.grid - 1):
        issued, consumed, n = _replay_ring(plan, b, [True] * 8 + [False] * 8
                                           + [True, False] * 400)
        assert issued == consumed == n


@pytest.mark.parametrize("name", ["edge_4_byte", "uneven"])
def test_replayed_copies_match_plain(name):
    H, Wp, C, A = SHAPES[name]
    src, by = _inputs(H, Wp, C, A)
    plain = bc.band_copy_plain(torch.from_numpy(src), torch.from_numpy(by))
    for aligned in (True, False):
        plan = bc.plan_band_copy(H, Wp, C, A, 8, SMS, aligned)
        np.testing.assert_array_equal(_replay_copies(plan, src, by),
                                      plain.numpy())


def test_misaligned_src_or_out_takes_the_4_byte_instance():
    H, Wp, C, A = SHAPES["tool"]
    plan = bc.plan_band_copy(H, Wp, C, A, 8, SMS, aligned=False)
    assert plan.unit == 4 and not plan.bulk and not plan.vec_out
    _check_plan(plan, SMS)
    plan = bc.plan_band_copy(H, Wp, C, A, 8, SMS, out_aligned=False)
    assert plan.bulk and not plan.vec_out


@pytest.mark.parametrize("variant", diag_dma.SWEEP)
def test_sweep_plans_fit_and_tile_the_band(variant):
    """Every plan the probe tool's sweep launches is one the kernel takes:
    the overrides only move chunk count, ring depth and boundaries."""
    n_chunks, stages, split = variant
    plan = bc.plan_band_copy(*SHAPES["tool"], 8, SMS, n_chunks=n_chunks,
                             stages=stages, split=split)
    _check_plan(plan, SMS)
    assert plan.n_chunks == (n_chunks or 7) and plan.NST == (stages or 4)
    assert plan.split == (split or 128)


def test_plan_preconditions_raise():
    with pytest.raises(ValueError, match="multiple of rows_per_step"):
        bc.plan_band_copy(12, 32, 2, 4, 8, SMS)
    with pytest.raises(ValueError, match="positive"):
        bc.plan_band_copy(16, 32, 2, 0, 8, SMS)
    with pytest.raises(ValueError, match="copy unit"):
        bc.plan_band_copy(16, 32, 2, 4, 8, SMS, split=24)
    with pytest.raises(ValueError, match="ring stages"):
        bc.plan_band_copy(16, 32, 2, 4, 8, SMS, stages=5)


@settings(max_examples=150, deadline=None)
@given(rows_per_step=st.sampled_from([1, 2, 4, 8, 16]),
       steps=st.integers(1, 120), Wp=st.integers(1, 4096),
       C=st.integers(1, 32), A=st.integers(1, 9),
       sms=st.sampled_from([1, 7, 66, 132]), aligned=st.booleans(),
       data=st.data())
def test_plan_sweep(rows_per_step, steps, Wp, C, A, sms, aligned, data):
    H = rows_per_step * steps
    plan = bc.plan_band_copy(H, Wp, C, A, rows_per_step, sms, aligned)
    _check_plan(plan, sms)
    assert plan.bulk == (aligned and C * Wp % 4 == 0)
    b = data.draw(st.integers(0, plan.grid - 1))
    order = data.draw(st.lists(st.booleans(), min_size=0, max_size=60))
    n = len(plan.cta_stages(b))
    # any interleaving first, then one that finishes the walk
    issued, consumed, _ = _replay_ring(plan, b, order + [True, False] * (2 * n + 8))
    assert issued == consumed == n
    if H * A * C * Wp <= 200_000:
        src, by = _inputs(H, Wp, C, A, seed=H + Wp)
        np.testing.assert_array_equal(
            _replay_copies(plan, src, by),
            bc.band_copy_plain(torch.from_numpy(src),
                               torch.from_numpy(by)).numpy())
