"""Port EVC intra family (blocks, dual prior, EVCIntra, EvcCodecRuntime)
against the JAX package, on the CPU.

Weights are seeded *port* weights carried to JAX with
``dcvc_tpu/utils/port_dc.py`` (no JAX model init), except for the golden
case: the committed ``evc`` pin was coded with the JAX init at
``PRNGKey(0)`` at widths (16, 16, 24, 32), N = 32
(tests/test_golden_bins.py:_case_evc); that init runs once, under
``jax.jit``, and reaches the port through ``evc_from_jax``.
Tolerances: blocks and the model's x_hat / bpp atol 2e-5 (f32
convolutions in another summation order), dual-prior floats atol 1e-6,
cross-package recons atol 1e-5; symbol planes and streams must be
identical.
"""

import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from dcvc_tpu.layers import evc_blocks as jblocks
from dcvc_tpu.models import priors as jpriors
from dcvc_tpu.models.evc import EVCIntra as JEVCIntra
from dcvc_tpu.models.runtime import EvcCodecRuntime as JEvcCodecRuntime
from dcvc_tpu.ops.math import lower_bound as j_lower_bound
from dcvc_tpu.utils import port_dc
from dcvc_tpu.utils import stream as jstream
from dcvc_tpu_torch.layers import evc_blocks
from dcvc_tpu_torch.models import priors
from dcvc_tpu_torch.models.evc import EVCIntra, build_evc
from dcvc_tpu_torch.models.runtime import EvcCodecRuntime
from dcvc_tpu_torch.ops.math import lower_bound
from dcvc_tpu_torch.utils import stream
from dcvc_tpu_torch.utils.convert import evc_from_jax

GOLDEN = Path(__file__).parent / "golden"
GOLDEN_CH = (16, 16, 24, 32)


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
    return t.detach().permute(0, 2, 3, 1).numpy()


def _sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def test_lower_bound_value_and_gradient_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 0.5, 64).astype(np.float32)
    w = rng.normal(0.0, 1.0, 64).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda a: jnp.sum(j_lower_bound(a, 0.5) * w))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    tv = (lower_bound(t, 0.5) * torch.from_numpy(w)).sum()
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-6)
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    # both pass-through cases and the blocked one occur
    below = x < 0.5
    assert (below & (w < 0)).any() and (below & (w > 0)).any()


class _Holder(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.m = m


def _map_depth_conv(m: port_dc._Mapper):
    m.conv("m.conv1.0", "conv1")
    m.dwconv("m.depth_conv.0", "depth_conv")
    m.conv("m.conv2.0", "conv2")
    if "m.adaptor.weight" in m.sd:
        m.conv("m.adaptor", "adaptor")


def _map_ffn(m):
    m.conv("m.conv.0", "conv1")
    m.conv("m.conv.2", "conv2")


def _map_upsample(m):
    m.dcb("m", "block", two=False, seq=True)
    m.conv("m.block.2", "subpel", "conv")


# (port block, flax block, mapper, input channels)
BLOCKS = {
    "depth_conv_same": (lambda: evc_blocks.EvcDepthConv(8, 8),
                        lambda: jblocks.EvcDepthConv(8), _map_depth_conv, 8),
    "depth_conv_adaptor": (lambda: evc_blocks.EvcDepthConv(8, 12),
                           lambda: jblocks.EvcDepthConv(12), _map_depth_conv, 8),
    "depth_conv_stride2": (lambda: evc_blocks.EvcDepthConv(8, 12, stride=2),
                           lambda: jblocks.EvcDepthConv(12, stride=2),
                           _map_depth_conv, 8),
    "conv_ffn": (lambda: evc_blocks.EvcConvFFN(8), lambda: jblocks.EvcConvFFN(),
                 _map_ffn, 8),
    "depth_conv_block": (lambda: evc_blocks.EvcDepthConvBlock(8, 12),
                         lambda: jblocks.EvcDepthConvBlock(12),
                         lambda m: m.dcb("m", two=False, seq=True), 8),
    "evc_block_upsample": (lambda: evc_blocks.EvcDepthConvBlockUpsample(8, 12),
                           lambda: jblocks.EvcDepthConvBlockUpsample(12),
                           _map_upsample, 8),
    "dc_block_upsample": (lambda: evc_blocks.DepthConvBlockUpsample(8, 12),
                          lambda: jblocks.DepthConvBlockUpsample(12),
                          lambda m: m.dcb_upsample("m"), 8),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_evc_blocks_match_jax(name):
    port_fn, jax_fn, mapper, cin = BLOCKS[name]
    torch.manual_seed(11)
    block = port_fn().eval()
    m = port_dc._Mapper(_sd(_Holder(block)))
    mapper(m)
    params = m.finish()
    x = np.random.default_rng(1).normal(size=(1, 12, 10, cin)).astype(np.float32)
    jout = jax.jit(jax_fn().apply)(params, jnp.asarray(x))
    with torch.no_grad():
        tout = block(_nchw(x))
    assert _nhwc(tout).shape == jout.shape
    np.testing.assert_allclose(_nhwc(tout), np.asarray(jout), atol=2e-5)


def _channel_prior(w):
    """A spatial prior both packages evaluate bit for bit (one rounded
    multiply, no reduction): the first 2C of the 4C params channels (the
    two y_hat halves and the means) scaled per channel by ``w``, as 4
    chunks (scales_0, means_0, scales_1, means_1); scales taken |.|."""
    def chunks(out, split):
        s0, m0, s1, m1 = split(out)
        return abs(s0), m0, abs(s1), m1

    def jfn(params):
        out = params[..., :w.size] * w
        return chunks(out, lambda o: jnp.split(o, 4, axis=-1))

    def tfn(params):
        out = params[:, :w.size] * torch.from_numpy(w).view(1, -1, 1, 1)
        return chunks(out, lambda o: o.chunk(4, dim=1))
    return jfn, tfn


def test_dual_prior_functions_match_jax():
    rng = np.random.default_rng(2)
    B, H, W, C = 1, 6, 7, 8
    y = rng.normal(0, 3, (B, H, W, C)).astype(np.float32)
    means = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    scales = rng.uniform(0.05, 2, (B, H, W, C)).astype(np.float32)
    q_step = rng.uniform(0.2, 1.5, (B, H, W, C)).astype(np.float32)
    w = rng.normal(0, 1, 2 * C).astype(np.float32)
    jfn, tfn = _channel_prior(w)
    ja = [jnp.asarray(a) for a in (y, means, scales, q_step)]
    ta = [_nchw(a) for a in (y, means, scales, q_step)]

    for parity in (0, 1):
        np.testing.assert_array_equal(
            _nhwc(priors.checkerboard_mask(H, W, parity)),
            np.asarray(jpriors.checkerboard_mask(H, W, parity)))

    jres = jpriors.forward_dual_prior(*ja, jfn)
    tres = priors.forward_dual_prior(*ta, tfn)
    for name, jv, tv in zip(("y_res", "y_q", "y_hat", "scales_hat"), jres, tres):
        if name == "y_q":
            np.testing.assert_array_equal(_nhwc(tv), np.asarray(jv))
        else:
            np.testing.assert_allclose(_nhwc(tv), np.asarray(jv), atol=1e-6,
                                       err_msg=name)
    jw = jpriors.forward_dual_prior(*ja, jfn, write=True)
    tw = priors.forward_dual_prior(*ta, tfn, write=True)
    for i in (0, 1):
        np.testing.assert_array_equal(_nhwc(tw[i]), np.asarray(jw[i]))
    for i in (2, 3, 4):
        np.testing.assert_allclose(_nhwc(tw[i]), np.asarray(jw[i]), atol=1e-6)

    # the decode steps, fed the encoder's own symbol planes
    js0, jm0 = jpriors.dual_decode_scales(ja[1], ja[2], ja[3], None, None,
                                          None, 0)
    ts0, tm0 = priors.dual_decode_scales(ta[1], ta[2], ta[3], None, None,
                                         None, 0)
    np.testing.assert_allclose(_nhwc(ts0), np.asarray(js0), atol=1e-6)
    jh = jpriors.dual_decode_update(jw[0], jm0, H, W, 0, jnp.float32)
    th = priors.dual_decode_update(tw[0], tm0, 0)
    js1, jm1 = jpriors.dual_decode_scales(ja[1], ja[2], ja[3], *jh, jfn, 1)
    ts1, tm1 = priors.dual_decode_scales(ta[1], ta[2], ta[3], *th, tfn, 1)
    np.testing.assert_allclose(_nhwc(ts1), np.asarray(js1), atol=1e-6)
    jd = jpriors.dual_decode_update(jw[1], jm1, H, W, 1, jnp.float32)
    td = priors.dual_decode_update(tw[1], tm1, 1)
    for jv, tv in zip((*jh, *jd), (*th, *td)):
        np.testing.assert_allclose(_nhwc(tv), np.asarray(jv), atol=1e-6)


@pytest.fixture(scope="module")
def narrow():
    """Seeded port EVCIntra at the golden widths, carried to JAX."""
    torch.manual_seed(3)
    tm = EVCIntra(GOLDEN_CH, GOLDEN_CH, 32).eval()
    with torch.no_grad():
        tm.q_scale.copy_(torch.tensor([1.4, 1.1, 0.9, 0.6]).view(4, 1, 1, 1))
        tm.q_basic.mul_(torch.linspace(0.4, 1.6, 32).view(1, 32, 1, 1))
    return tm, JEVCIntra(GOLDEN_CH, GOLDEN_CH, 32), port_dc.convert_evc(_sd(tm))


def test_evc_intra_forward_and_compress_planes_match_jax(narrow):
    tm, jm, params = narrow
    rng = np.random.default_rng(4)
    x = (rng.random((1, 64, 128, 3)) * 6 - 2.5).astype(np.float32)
    q = np.float32(0.85)
    jout = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(q))
    with torch.no_grad():
        tout = tm(_nchw(x), torch.tensor(q))
    np.testing.assert_allclose(_nhwc(tout["x_hat"]), np.asarray(jout["x_hat"]),
                               atol=2e-5)
    for k in ("bpp", "bpp_y", "bpp_z"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=2e-5, err_msg=k)

    jc = jax.jit(lambda p, a, s: jm.apply(p, a, s,
                                          method=JEVCIntra.compress_device))(
        params, jnp.asarray(x), jnp.asarray(q))
    with torch.no_grad():
        tc = tm.compress_device(_nchw(x), torch.tensor(q))
    np.testing.assert_array_equal(_nhwc(tc["z_hat"]), np.asarray(jc["z_hat"]))
    for tq, jq in zip(tc["y_q_planes"], jc["y_q_planes"]):
        assert tq.abs().sum() > 0
        np.testing.assert_array_equal(_nhwc(tq), np.asarray(jq))
    for ts, js in zip(tc["scales_planes"], jc["scales_planes"]):
        np.testing.assert_allclose(_nhwc(ts), np.asarray(js), atol=2e-5)
    np.testing.assert_allclose(_nhwc(tc["x_hat"]), np.asarray(jc["x_hat"]),
                               atol=2e-5)


def test_runtime_roundtrip_and_ushort_container(narrow, tmp_path):
    tm, _, _ = narrow
    rt = EvcCodecRuntime(tm, device="cpu")
    rt.update()
    x = _nchw(np.random.default_rng(5).random((1, 64, 64, 3)).astype(np.float32) * 4 - 1.5)
    q, q_index = stream.get_rounded_q(0.63)
    comp = rt.compress(x, q)
    path = tmp_path / "p.bin"
    stream.encode_i_ushort_q(64, 64, q_index, comp["bit_stream"], path)
    jstream.encode_i_ushort_q(64, 64, q_index, comp["bit_stream"],
                              tmp_path / "j.bin")
    assert path.read_bytes() == (tmp_path / "j.bin").read_bytes()
    assert jstream.decode_i_ushort_q(path) == stream.decode_i_ushort_q(path)
    h, w, qi, s = stream.decode_i_ushort_q(path)
    assert (h, w, qi) == (64, 64, 63)
    dec = rt.decompress(s, h, w, qi / 100)
    np.testing.assert_array_equal(dec["x_hat"].numpy(), comp["x_hat"].numpy())
    est = rt.forward(x, q)
    assert est["x_hat"].shape == x.shape and float(est["bit"]) > 0


def test_golden_evc_pin_and_cross_package_streams():
    """The port writes the committed ``evc`` pin byte for byte; it decodes
    the pin (a JAX stream), and the JAX runtime decodes the port's stream:
    the two recons agree within 1e-5."""
    from test_golden_bins import _img

    jm = JEVCIntra(GOLDEN_CH, GOLDEN_CH, 32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                              jnp.ones(()))
    tm = EVCIntra(GOLDEN_CH, GOLDEN_CH, 32)
    tm.load_state_dict(evc_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                       strict=True)
    rt = EvcCodecRuntime(tm, device="cpu")
    rt.update()
    q, q_index = stream.get_rounded_q(0.85)
    comp = rt.compress(_nchw(_img(seed=17)), q)
    data = stream.pack_i_ushort_q(128, 128, q_index, comp["bit_stream"])
    golden = (GOLDEN / "evc.bin").read_bytes()
    manifest = json.loads((GOLDEN / "manifest.json").read_text())["evc"]
    assert hashlib.sha256(data).hexdigest() == manifest["sha256"]
    assert data == golden

    h, w, qi, s = stream.unpack_i_ushort_q(golden)
    dec = rt.decompress(s, h, w, qi / 100)
    np.testing.assert_array_equal(dec["x_hat"].numpy(), comp["x_hat"].numpy())
    jrt = JEvcCodecRuntime(jm, params)
    jrt.update(force=True)
    jdec = jrt.decompress(comp["bit_stream"], 128, 128, jnp.asarray(qi / 100))
    np.testing.assert_allclose(np.asarray(jdec["x_hat"]), _nhwc(dec["x_hat"]),
                               atol=1e-5)


def test_weights_convert_is_exact_inverse():
    tm = build_evc("MS", N=192, seed=6, device="cpu")
    sd = _sd(tm)
    back = evc_from_jax(port_dc.convert_evc(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    build_evc("MS", device="cpu").load_state_dict(back, strict=True)
