"""Port layer zoo (dcvc_tpu_torch/layers/blocks.py) against the flax blocks.

Each block is initialised in flax from a fixed key, its params go through
``dcvc_tpu_torch.utils.convert.FlaxToTorch`` (the mapper the model
converters use) into the port block with ``load_state_dict(strict=True)``,
and both run the same numpy-seeded input. Tolerance: atol 2e-5 (f32
convolutions summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.layers import blocks as J
from dcvc_tpu_torch.layers import blocks as T
from dcvc_tpu_torch.utils.convert import FlaxToTorch


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six pytest workers on one host: two torch threads each
    keeps torch's spinning OpenMP pool from starving the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _depth_conv(m):
    m.conv("conv1.0", "conv1")
    m.conv("depth_conv", "depth_conv")
    m.conv("conv2", "conv2")
    if m.has("adaptor", "kernel"):
        m.conv("adaptor", "adaptor")


CASES = {
    "conv": (lambda: J.conv(24, 3, 2), lambda c: T.conv(c, 24, 3, 2),
             lambda m: m.conv("")),
    "deconv": (lambda: J.deconv(12, 3, 2), lambda c: T.deconv(c, 12, 3, 2),
               lambda m: m.deconv("")),
    "subpel_conv": (lambda: J.SubpelConv(8, 2, 3),
                    lambda c: T.subpel_conv(c, 8, 2, 3),
                    lambda m: m.subpel("")),
    "residual_block_with_stride": (
        lambda: J.ResidualBlockWithStride(24, 2),
        lambda c: T.ResidualBlockWithStride(c, 24, 2), lambda m: m.rbws("")),
    "residual_block_upsample": (
        lambda: J.ResidualBlockUpsample(12, 2),
        lambda c: T.ResidualBlockUpsample(c, 12, 2), lambda m: m.rbu("")),
    "residual_block_adaptor": (
        lambda: J.ResidualBlock(24), lambda c: T.ResidualBlock(c, 24),
        lambda m: m.resblock("")),
    "res_block_bottleneck": (
        lambda: J.ResBlock(16, slope=0.1, end_with_relu=True, bottleneck=True),
        lambda c: T.ResBlock(c, slope=0.1, end_with_relu=True, bottleneck=True),
        lambda m: m.resblock("")),
    "depth_conv_stride2": (lambda: J.DepthConv(24, stride=2),
                           lambda c: T.DepthConv(c, 24, stride=2), _depth_conv),
    "conv_ffn": (lambda: J.ConvFFN(), lambda c: T.ConvFFN(c),
                 lambda m: (m.conv("conv.0", "conv1"), m.conv("conv.2", "conv2"))),
    "conv_ffn2": (lambda: J.ConvFFN2(), lambda c: T.ConvFFN2(c),
                  lambda m: (m.conv("conv", "conv"),
                             m.conv("conv_out", "conv_out"))),
    "depth_conv_block": (lambda: J.DepthConvBlock(24),
                         lambda c: T.DepthConvBlock(c, 24),
                         lambda m: m.dcb("", two=False)),
    "depth_conv_block2": (lambda: J.DepthConvBlock2(16),
                          lambda c: T.DepthConvBlock2(c, 16),
                          lambda m: m.dcb("", two=True)),
    "unet": (lambda: J.UNet(16), lambda c: T.UNet(c, 16),
             lambda m: m.unet("", two=False)),
    "unet2": (lambda: J.UNet(16, block2=True), lambda c: T.UNet(c, 16, True),
              lambda m: m.unet("", two=True)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_flax(name):
    make_j, make_t, mapping = CASES[name]
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (1, 16, 20, 16)).astype(np.float32)   # NHWC
    jm = make_j()
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    m = FlaxToTorch(jax.tree_util.tree_map(np.asarray, params))
    mapping(m)
    tm = make_t(x.shape[-1])
    tm.load_state_dict(m.finish(), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=2e-5)


def test_pools_match_flax():
    x = np.random.default_rng(1).normal(0, 1, (2, 8, 12, 5)).astype(np.float32)
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    for jf, tf in [(J.max_pool2, T.max_pool2), (J.avg_pool2, T.avg_pool2)]:
        np.testing.assert_allclose(tf(tx).permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jf(jnp.asarray(x))), atol=1e-6)
