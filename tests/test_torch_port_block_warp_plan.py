"""The block warp's launch plan (dcvc_tpu_torch/ops/block_warp.py), checked
on the CPU by integer reasoning. The CUDA kernels that follow it run only on
the card, where tests/test_torch_port_cuda.py holds them against the plain
version. Here, at the 1080p OffsetDiversity shape, the JAX default block
and the edge shapes:

* the kernel's chunk order keeps every tap row of every strip in the ring
  while that strip resolves, and the kernel's ring-row arithmetic finds it;
* every tap column, clamped or not, lies in the block's staged columns;
* the ring fits the 227 KB a CTA may have;
* the blocks classed as reaching outside the frame are exactly those whose
  taps, as the plain version computes them, leave it;
* the 4-pixel instance runs exactly where rows are 16-byte aligned.
"""

import pytest
import torch

from dcvc_tpu_torch.ops import block_warp as bw

PAD = 16
# name: (C, H, W, (Dh, Rv, BH, BW), bytes per element)
CASES = {
    "od_1080p_f32": (3, 1088, 1920, (4, 4, 64, 128), 4),
    "od_1080p_bf16": (3, 1088, 1920, (4, 4, 64, 128), 2),
    "jax_default_f32": (3, 20, 600, (8, 2, 8, 512), 4),
    "jax_default_bf16": (5, 20, 600, (8, 2, 8, 512), 2),
    "edge_270x481_f32": (3, 270, 481, (4, 4, 64, 128), 4),
    "edge_67x130_bf16": (2, 67, 130, (4, 4, 64, 128), 2),
    "c5_70x136_f32": (5, 70, 136, (4, 4, 64, 128), 4),
    "small_blocks_f32": (1, 17, 33, (4, 2, 8, 16), 4),
}


def _setup(name):
    C, H, W, (Dh, Rv, BH, BW), itemsize = CASES[name]
    BH, BW = bw._block_dims(H, W, BH, BW)
    px = 4 if bw.vector_rows(W, BW, itemsize) else 1
    return C, H, W, Dh, Rv, BH, BW, bw.plan_warp(C, BH, BW, Dh, Rv,
                                                 itemsize, px)


@pytest.mark.parametrize("name,px", [
    ("od_1080p_f32", 4), ("od_1080p_bf16", 4), ("jax_default_f32", 4),
    ("jax_default_bf16", 4), ("edge_270x481_f32", 1),
    ("edge_67x130_bf16", 1), ("c5_70x136_f32", 4), ("small_blocks_f32", 1)])
def test_instance_choice(name, px):
    C, H, W, Dh, Rv, BH, BW, plan = _setup(name)
    assert plan.px == px
    assert plan.align * plan.itemsize == (16 if px == 4 else plan.itemsize)
    # a tensor whose data does not start 16-byte aligned takes one pixel
    # per thread whatever its width
    base = torch.zeros(4 * W + 1)
    assert not bw.vector_rows(W, BW, 4, base[1:])


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_holds_every_tap_row(name):
    C, H, W, Dh, Rv, BH, BW, p = _setup(name)
    assert p.S & (p.S - 1) == 0 and p.NST == p.D + 1 + bw.AHEAD
    nch = p.NS + p.D
    ncg = -(-C // p.Cg)
    ring = [None] * p.NST   # chunk held by each stage
    issued = 0
    for u in range(ncg * p.NS):
        grp, s = divmod(u, p.NS)
        first = grp * nch + s
        # the kernel's issue loop: a chunk goes into stage t % NST once the
        # strips that read the chunk there before are done
        while issued < ncg * nch and issued < first + p.NST:
            ring[issued % p.NST] = issued
            issued += 1
        assert issued > first + p.D              # all it reads is issued
        rs = (first % p.NST) * p.S
        for il in range(s * p.S, min(s * p.S + p.S, BH)):
            for f in range(-Rv, Rv):             # floor of the residual
                for a in (il + f + Rv + 1, il + f + Rv + 2):  # window rows
                    assert 1 <= a <= BH + 2 * Rv
                    k = (a - 1) // p.S
                    assert k < nch
                    stage = (grp * nch + k) % p.NST
                    assert ring[stage] == grp * nch + k
                    rr = rs + a - s * p.S - 1   # the kernel's rt / rb
                    if rr >= p.ring_rows:
                        rr -= p.ring_rows
                    assert rr == stage * p.S + (a - 1) % p.S


@pytest.mark.parametrize("name", sorted(CASES))
def test_staged_columns_cover_every_tap(name):
    C, H, W, Dh, Rv, BH, BW, p = _setup(name)
    Py, Px, _, KD_u = bw._pad_extents(BH, BW, Dh, Rv, PAD)
    Wp = -(-W // BW) * BW + 2 * Px
    sx = torch.arange(0, Wp - KD_u + 1)          # every clamped origin
    xs, width = bw.staged_columns(sx, W, BW, Dh, Px, p.align)
    assert (xs % p.align == 0).all() and (xs >= 0).all()
    assert (xs + width <= W).all() and (width <= p.span).all()
    _, cols = bw.edge_classes(torch.zeros_like(sx) + Py, sx, H, W, BH, BW,
                              Dh, Rv, Py, Px)
    # tap columns: window columns jl + floor(rx) + Dh + 1 and the next one
    taps = (sx - Px)[:, None] + torch.arange(1, BW + 2 * Dh + 1)[None]
    inside = (taps >= 0) & (taps <= W - 1)
    assert inside[~cols].all()                   # unclamped, in the frame
    taps = torch.where(cols[:, None], taps.clamp(0, W - 1), taps)
    assert ((taps >= xs[:, None]) & (taps < (xs + width)[:, None])).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_fits_shared_memory(name):
    C, H, W, Dh, Rv, BH, BW, p = _setup(name)
    assert p.smem <= bw.SMEM_MAX
    assert p.smem <= bw.SMEM_BUDGET or p.Cg == 1
    if name.startswith("od_1080p"):   # every channel in one group
        assert p.Cg == C and p.smem == 24 * 3 * (140 if p.itemsize == 4
                                                 else 144) * p.itemsize


def _taps_leave(start, P, R, B, n):
    """Per block: whether any tap the plain version computes, before its
    clamp, leaves [0, n): p0 = start + local + f0 + R + 1 - P and p0 + 1."""
    local = torch.arange(B).view(B, 1)
    f0 = torch.arange(-R, R).view(1, 2 * R)
    p0 = start[..., None, None] + local + f0 + R + 1 - P
    return ((p0 < 0) | (p0 + 1 > n - 1)).flatten(-2).any(-1)


@pytest.mark.parametrize("name,shift,expect", [
    ("od_1080p_f32", (0.0, 0.0), 60),        # the frame's border blocks
    ("edge_270x481_f32", (60.0, -35.0), None),
    ("edge_67x130_bf16", (-90.0, 70.0), None),
    ("small_blocks_f32", (25.0, -40.0), None),
])
def test_edge_classes_are_the_blocks_whose_taps_leave(name, shift, expect):
    C, H, W, Dh, Rv, BH, BW, _ = _setup(name)
    g = torch.Generator().manual_seed(0)
    flow = torch.randn(1, 2, H, W, generator=g) * (2.0 if expect is None
                                                    else 0.0)
    flow += torch.tensor(shift).view(1, 2, 1, 1)
    sy, sx, _, _, Py, Px = bw._block_prep(flow, BH, BW, Dh, Rv, "median4",
                                          PAD)
    rows, cols = bw.edge_classes(sy, sx, H, W, BH, BW, Dh, Rv, Py, Px)
    assert torch.equal(rows, _taps_leave(sy, Py, Rv, BH, H))
    assert torch.equal(cols, _taps_leave(sx, Px, Dh, BW, W))
    if expect is not None:
        assert int((rows | cols).sum()) == expect
    else:   # the shifts push some windows out and keep some inside
        assert 0 < int((rows | cols).sum()) <= rows.numel()


def test_geometry_matches_the_kernel_fields():
    C, H, W, Dh, Rv, BH, BW, p = _setup("od_1080p_f32")
    geo = list(bw._geometry(32, C, H, W, 17, 15, BH, BW, Dh, Rv, 21, 21, p))
    assert len(geo) == 19                        # Geo's ints, kGeoInts
    assert geo[12:] == [8, 1, 3, 8, 3, 140, 5]   # S D NST NS Cg span shift
    p1 = bw.plan_warp(3, 64, 120, 4, 4, 4, 1)    # 120 units a row: divide
    assert bw._geometry(1, 3, 64, 120, 1, 1, 64, 120, 4, 4, 5, 5, p1)[18] == -1


def test_plan_rejects_zero_reach():
    with pytest.raises(ValueError, match="Dh, Rv >= 1"):
        bw.plan_warp(3, 64, 128, 0, 4, 4, 4)
    with pytest.raises(ValueError, match="exceeds shared memory"):
        bw.plan_warp(1, 64, 60000, 4, 4, 4, 4)
