"""Port warp ops (dcvc_tpu_torch/ops/warp.py, ops/block_warp.py) against the
JAX package on the CPU.

Inputs come from numpy seeds and go through both packages; the port is
NCHW inside, so tensors are transposed at the boundary. Tolerances:
  * exact warp / resize / shuffle: atol 1e-5 (grid_sample's [-1, 1]
    normalisation costs ~W * 2**-24 px; the rest is summation order);
  * block warp, plain version vs ``block_warp_ref`` and vs the Pallas
    kernel in interpret mode: atol 1e-6 (same f32 arithmetic);
  * bf16 input: 1e-2, one bf16 ulp near 1 after f32 accumulation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.ops import block_warp as jbw
from dcvc_tpu.ops import warp as jwarp
from dcvc_tpu_torch.ops import block_warp as tbw
from dcvc_tpu_torch.ops import warp as twarp


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six pytest workers on one host: two torch threads each
    keeps torch's spinning OpenMP pool from starving the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape,scale,shift", [
    ((2, 24, 48, 3), 0.7, (0.0, 0.0)),
    ((1, 17, 33, 2), 4.0, (3.3, -2.7)),
    ((2, 16, 40, 1), 2.0, (-30.0, 25.0)),   # flows that leave the frame
])
def test_flow_warp_matches_jax(shape, scale, shift):
    rng = np.random.default_rng(0)
    im = rng.random(shape).astype(np.float32)
    flow = (rng.normal(0, scale, shape[:3] + (2,)) + np.array(shift)).astype(np.float32)
    ref = np.asarray(jwarp._flow_warp_naive(jnp.asarray(im), jnp.asarray(flow)))
    out = _nhwc(twarp.flow_warp(_nchw(im), _nchw(flow)))
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("hw", [(16, 24), (17, 33)])
def test_resize_and_shuffle_helpers_match_jax(hw):
    rng = np.random.default_rng(1)
    x = rng.random((2, *hw, 8)).astype(np.float32)
    jx, tx = jnp.asarray(x), _nchw(x)
    np.testing.assert_allclose(_nhwc(twarp.bilinear_up2(tx)),
                               np.asarray(jwarp.bilinear_up2(jx)), atol=1e-5)
    np.testing.assert_allclose(_nhwc(twarp.bilinear_down2(tx)),
                               np.asarray(jwarp.bilinear_down2(jx)), atol=1e-5)
    np.testing.assert_allclose(_nhwc(twarp.pixel_shuffle(tx, 2)),
                               np.asarray(jwarp.pixel_shuffle(jx, 2)), atol=0)
    e = x[:, :hw[0] // 2 * 2, :hw[1] // 2 * 2]
    np.testing.assert_array_equal(_nhwc(twarp.pixel_unshuffle(_nchw(e), 2)),
                                  np.asarray(jwarp.pixel_unshuffle(jnp.asarray(e), 2)))
    pad = jwarp.get_padding_size(*hw, 8)
    assert twarp.get_padding_size(*hw, 8) == pad
    assert twarp.get_downsampled_shape(*hw, 8) == jwarp.get_downsampled_shape(*hw, 8)
    padded = twarp.replicate_pad(tx, pad)
    np.testing.assert_array_equal(_nhwc(padded),
                                  np.asarray(jwarp.replicate_pad(jx, pad)))
    np.testing.assert_array_equal(_nhwc(twarp.crop_lrtb(padded, pad)), x)


def test_resolve_warp_fn_modes():
    assert twarp.resolve_warp_fn("exact") is twarp.flow_warp
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        twarp.resolve_warp_fn("tile:32,2")
    assert twarp.default_od_warp_mode(torch.device("cpu")) == "exact"
    assert twarp.default_od_warp_mode(torch.device("cuda")) == \
        "block:4,4,64,128,median4"


def _median4_distinct_middle_flow(shape, rng):
    """Flow whose median4 sample (even count) has distinct middle values:
    jnp.median averages them, torch.median would take the lower."""
    M, H, W = shape[:3]
    flow = rng.normal(0, 0.3, (M, H, W, 2)).astype(np.float32)
    flow[:, ::4, ::4, :] = rng.choice([1.2, 2.9], size=flow[:, ::4, ::4, :].shape)
    return flow


_jax_block_ref = jax.jit(jbw.block_warp_ref, static_argnames=(
    "Dh", "Rv", "BH", "BW", "base_mode"))


BLOCK_CASES = [
    ((2, 24, 48, 3), dict(Dh=4, Rv=2, BH=8, BW=16)),
    ((1, 16, 40, 2), dict(Dh=3, Rv=1, BH=8, BW=8)),
    ((3, 17, 33, 1), dict(Dh=4, Rv=2, BH=8, BW=16)),  # pad-to-block path
]


@pytest.mark.parametrize("base_mode", ["median", "mean", "median4"])
@pytest.mark.parametrize("shape,blk", BLOCK_CASES)
def test_block_warp_plain_matches_jax_ref_and_kernel(shape, blk, base_mode):
    rng = np.random.default_rng(0)
    im = rng.random(shape).astype(np.float32)
    flows = [(rng.normal(0, s, shape[:3] + (2,)) + np.array(sh)).astype(np.float32)
             for s, sh in [(0.5, (3.0, -2.0)), (8.0, (0.0, 0.0)),
                           (0.3, (25.0, -40.0))]]
    flows.append(_median4_distinct_middle_flow(shape, rng))
    for flow in flows:
        ref = np.asarray(_jax_block_ref(jnp.asarray(im), jnp.asarray(flow),
                                        base_mode=base_mode, **blk))
        plain = tbw.block_warp_plain(torch.from_numpy(im),
                                     torch.from_numpy(flow),
                                     base_mode=base_mode, **blk).numpy()
        wrap = tbw.block_warp(torch.from_numpy(im), torch.from_numpy(flow),
                              base_mode=base_mode, **blk).numpy()
        np.testing.assert_allclose(plain, ref, atol=1e-6)
        np.testing.assert_array_equal(wrap, plain)
        if base_mode == "median4":  # the shipped mode: also the Pallas kernel
            ker = np.asarray(jbw.block_warp(
                jnp.asarray(im), jnp.asarray(flow), base_mode=base_mode,
                interpret=True, **blk))
            np.testing.assert_allclose(plain, ker, atol=1e-6)


def test_median_midpoint_averages_even_middle():
    x = torch.tensor([[3.0, 1.0, 2.0, 4.0], [5.0, 5.0, 1.0, 9.0]])
    np.testing.assert_array_equal(tbw._median_midpoint(x).numpy(),
                                  np.median(x.numpy(), axis=1))


def test_block_warp_exact_within_window():
    rng = np.random.default_rng(1)
    im = rng.random((2, 24, 48, 3)).astype(np.float32)
    for shift in [(0.0, 0.0), (3.3, -2.7), (-30.0, 15.0), (200.0, 200.0)]:
        flow = (rng.normal(0, 0.5, (2, 24, 48, 2)) + np.array(shift)).astype(np.float32)
        out = tbw.block_warp_plain(torch.from_numpy(im), torch.from_numpy(flow),
                                   Dh=4, Rv=2, BH=8, BW=16).numpy()
        exact = np.asarray(jwarp._flow_warp_naive(jnp.asarray(im), jnp.asarray(flow)))
        np.testing.assert_allclose(out, exact, atol=1e-5)


def test_block_warp_ramp_flows_exact():
    rng = np.random.default_rng(2)
    H, W = 32, 64
    im = rng.random((1, H, W, 2)).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    for fx, fy in [(0.04 * (xs - W / 2), 0.04 * (ys - H / 2)),   # zoom
                   (0.06 * ys, np.zeros_like(ys))]:              # shear
        flow = np.stack([fx, fy], -1)[None].astype(np.float32)
        out = tbw.block_warp_plain(torch.from_numpy(im), torch.from_numpy(flow),
                                   Dh=8, Rv=2, BH=8, BW=32).numpy()
        exact = twarp.flow_warp(_nchw(im), _nchw(flow))
        np.testing.assert_allclose(out, _nhwc(exact), atol=1e-5)


def test_block_warp_clamp_is_bounded():
    rng = np.random.default_rng(3)
    im = rng.random((1, 16, 32, 1)).astype(np.float32)
    flow = rng.normal(0, 20.0, (1, 16, 32, 2)).astype(np.float32)
    out = tbw.block_warp_plain(torch.from_numpy(im), torch.from_numpy(flow),
                               Dh=4, Rv=1, BH=8, BW=16).numpy()
    assert np.isfinite(out).all()
    assert out.min() >= im.min() - 1e-6 and out.max() <= im.max() + 1e-6


def test_block_warp_bf16_path():
    rng = np.random.default_rng(4)
    im = torch.from_numpy(rng.random((1, 16, 32, 2)).astype(np.float32))
    flow = torch.from_numpy(rng.normal(0, 0.5, (1, 16, 32, 2)).astype(np.float32))
    out = tbw.block_warp(im.to(torch.bfloat16), flow, Dh=4, Rv=1, BH=8, BW=16)
    assert out.dtype == torch.bfloat16
    ker = jbw.block_warp(jnp.asarray(im.to(torch.bfloat16).float().numpy(),
                                     jnp.bfloat16), jnp.asarray(flow.numpy()),
                         Dh=4, Rv=1, BH=8, BW=16, interpret=True)
    ref = tbw.block_warp_plain(im.to(torch.bfloat16).float(), flow,
                               Dh=4, Rv=1, BH=8, BW=16)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=1e-2)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ker, np.float32), atol=1e-2)


def test_block_warp_counts_only_kernel_launches():
    rng = np.random.default_rng(5)
    im = torch.from_numpy(rng.random((1, 3, 16, 32)).astype(np.float32))
    flow = torch.zeros(1, 2, 16, 32)
    before = tbw.block_warp_nchw.launches
    tbw.block_warp_nchw(im, flow, 4, 1, 8, 16)
    assert tbw.block_warp_nchw.launches == before  # CPU: plain version


def test_offset_diversity_warp_chunks_and_cpu_default():
    """warp_chunks splits the one batched warp call into a Python loop with
    identical results; on the CPU the default OD warp is the exact warp."""
    from dcvc_tpu_torch.models.video_net import OffsetDiversity

    torch.manual_seed(0)
    weights = OffsetDiversity().state_dict()
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((1, 48, 16, 24)).astype(np.float32))
    aux = torch.from_numpy(rng.random((1, 53, 16, 24)).astype(np.float32))
    flow = torch.from_numpy(rng.normal(0, 2, (1, 2, 16, 24)).astype(np.float32))

    def run(**kw):
        od = OffsetDiversity(**kw)
        od.load_state_dict(weights, strict=True)
        with torch.no_grad():
            return od(x, aux, flow)

    block = "block:4,4,64,128,median4"
    torch.testing.assert_close(run(warp_mode=block, warp_chunks=4),
                               run(warp_mode=block), atol=0, rtol=0)
    torch.testing.assert_close(run(), run(warp_mode="exact"), atol=0, rtol=0)
