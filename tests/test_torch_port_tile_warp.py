"""Port tile warp (dcvc_tpu_torch/ops/warp.py:tile_warp) against the JAX
package's ``tile_warp``, on the CPU.

Inputs come from numpy seeds and go through both packages (NHWC there,
NCHW here). Tolerances: f32 atol 1e-5 (the same f32 taps and weights;
only the order of the zero-weight terms and FMA contraction may differ);
bf16 atol 1e-2 (both compute in f32 and round once to bf16, one bf16 ulp
near 1). A DMC with ``od_warp_mode="tile:32,2"`` in both packages codes one
P-frame to byte-identical streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.runtime import DmcRuntime as JDmcRuntime
from dcvc_tpu.models.video_dc import DMC as JDMC
from dcvc_tpu.ops import warp as jwarp
from dcvc_tpu.utils import port_dc
from dcvc_tpu_torch.models.registry import build
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
    return t.permute(0, 2, 3, 1).float().numpy()


# one compiled program per case: op-by-op dispatch of the JAX tile warp
# took most of each case's time
_jax_tile_warp = jax.jit(jwarp.tile_warp, static_argnums=(2, 3, 4))


def _jax(im, flow, T, R, base, dtype=jnp.float32):
    out = _jax_tile_warp(jnp.asarray(im, dtype), jnp.asarray(flow), T, R, base)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("T,R,base", [(16, 2, "median"), (32, 2, "median"),
                                      (16, 2, "mean")])
@pytest.mark.parametrize("shape,scale,shift", [
    ((2, 20, 64, 3), 1.5, (2.3, -1.2)),
    ((3, 17, 50, 2), 3.0, (0.0, 0.0)),        # W not a multiple of T
    ((1, 12, 40, 1), 6.0, (60.0, -45.0)),     # windows clamped at borders
])
def test_tile_warp_matches_jax(T, R, base, shape, scale, shift):
    rng = np.random.default_rng(sum(shape) + T)
    im = rng.random(shape).astype(np.float32)
    flow = (rng.normal(0, scale, shape[:3] + (2,)) + np.array(shift)).astype(np.float32)
    ref = _jax(im, flow, T, R, base)
    out = twarp.tile_warp(_nchw(im), _nchw(flow), T, R, base)
    assert out.shape == _nchw(im).shape and out.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-5)


@pytest.mark.parametrize("base", ["median", "mean"])
def test_tile_warp_bf16_matches_jax(base):
    rng = np.random.default_rng(7)
    im = rng.random((2, 16, 48, 3)).astype(np.float32)
    flow = rng.normal(0, 2.0, (2, 16, 48, 2)).astype(np.float32)
    ref = _jax(im, flow, 16, 2, base, jnp.bfloat16)
    out = twarp.tile_warp(_nchw(im).to(torch.bfloat16), _nchw(flow), 16, 2, base)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-2)


def test_median_and_mean_bases_differ_at_a_motion_boundary():
    """A 16-pixel run with 11 pixels moving by +6 px and 5 by -6 px: the
    median base sits on the majority motion and resolves those 11 pixels
    exactly; the mean base (+2) pushes every pixel past R = 2 and clamps.
    Both packages agree on both."""
    rng = np.random.default_rng(8)
    im = rng.random((1, 8, 64, 2)).astype(np.float32)
    flow = np.zeros((1, 8, 64, 2), np.float32)
    flow[..., 0] = 6.0
    flow[:, :, 11:16, 0] = -6.0
    flow[:, :, 16:, 0] = rng.normal(0, 0.4, (1, 8, 48))
    exact = np.asarray(jwarp._flow_warp_naive(jnp.asarray(im), jnp.asarray(flow)))
    outs = {}
    for base in ("median", "mean"):
        outs[base] = _nhwc(twarp.tile_warp(_nchw(im), _nchw(flow), 16, 2, base))
        np.testing.assert_allclose(outs[base], _jax(im, flow, 16, 2, base),
                                   atol=1e-5)
    np.testing.assert_allclose(outs["median"][:, :, :11], exact[:, :, :11],
                               atol=1e-5)
    assert np.abs(outs["mean"][:, :, :11] - exact[:, :, :11]).max() > 0.05
    assert np.abs(outs["median"] - outs["mean"]).max() > 0.05


def test_tile_warp_chunked_equals_unchunked_and_is_exact_within_residual():
    rng = np.random.default_rng(9)
    im = torch.from_numpy(rng.random((8, 3, 16, 48)).astype(np.float32))
    flow = torch.from_numpy(
        (rng.normal(0, 0.4, (8, 2, 16, 48)) + 3.0).astype(np.float32))
    chunked = twarp.tile_warp(im, flow, 16, 2, chunk=4)
    torch.testing.assert_close(twarp.tile_warp(im, flow, 16, 2, chunk=0),
                               chunked, atol=0, rtol=0)
    torch.testing.assert_close(twarp.tile_warp(im, flow, 16, 2), chunked,
                               atol=0, rtol=0)
    torch.testing.assert_close(chunked, twarp.flow_warp(im, flow), atol=1e-5,
                               rtol=0)


def test_resolve_tile_modes_and_coding_defaults():
    rng = np.random.default_rng(10)
    im = torch.from_numpy(rng.random((2, 2, 8, 40)).astype(np.float32))
    flow = torch.from_numpy(rng.normal(0, 3, (2, 2, 8, 40)).astype(np.float32))
    for mode, args in [("tile", (16, 2, "median")),
                       ("tile:32", (32, 2, "median")),
                       ("tile:16,1,mean", (16, 1, "mean"))]:
        torch.testing.assert_close(twarp.resolve_warp_fn(mode)(im, flow),
                                   twarp.tile_warp(im, flow, *args),
                                   atol=0, rtol=0)
    assert twarp.default_coding_warp_modes(torch.device("cpu")) == \
        ("exact", None, None)
    assert twarp.default_coding_warp_modes(torch.device("cuda")) == \
        ("block:4,4,64,128,median4", None, None)


def test_dmc_with_tile_od_warp_codes_jax_identical_stream():
    tile = "tile:32,2"
    module, trt = build("dmc_dc", seed=2, device="cpu", od_warp_mode=tile)
    params = port_dc.convert_dmc(
        {k: v.numpy() for k, v in module.state_dict().items()})
    jrt = JDmcRuntime(JDMC(od_warp_mode=tile), params)
    trt.update()
    jrt.update(force=True)
    rng = np.random.default_rng(11)
    ref, x = (rng.random((1, 64, 64, 3)).astype(np.float32) for _ in range(2))

    def dpb(r):
        return {"ref_frame": r, "ref_feature": None, "ref_mv_feature": None,
                "ref_y": None, "ref_mv_y": None}

    jc = jrt.compress(jnp.asarray(x), dpb(jnp.asarray(ref)), False, 30, 1)
    tc = trt.compress(_nchw(x), dpb(_nchw(ref)), False, 30, 1)
    assert tc["bit_stream"] == jc["bit_stream"]
    np.testing.assert_allclose(_nhwc(tc["dpb"]["ref_frame"]),
                               np.asarray(jc["dpb"]["ref_frame"]), atol=1e-4)
