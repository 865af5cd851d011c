"""The port's gen-1 DCVC (MaskedConv2d, the wavefront AR coder,
``build_indexes_np``, DCVCNet, DcvcGen1Runtime) against the JAX package,
on the CPU.

The AR coder is held on the same numpy inputs: the same context and
entropy-parameter weights, a latent and its hyper parameters, coded with
each package's own Gaussian tables and rANS coder; the bytes, the y_hat
and the decodes must be identical, with the gen-1 laplace tables and with
the zoo's 64-level GaussianConditional.

DCVCNet runs at the ``gen1_p`` golden pin's widths (mv / N / M = 16 / 16 /
24) with the JAX ``PRNGKey(0)`` init the pin was coded with
(tests/test_golden_bins.py:_case_gen1_p), once, under ``jax.jit``, carried
over by ``dcvc_gen1_from_jax``. The port writes the pin byte for byte and
decodes it (a JAX stream); the JAX package decodes the same bytes in
tests/test_golden_bins.py.

Tolerances (f32, convolutions in another summation order): layers atol
1e-5; the forward's bpp, recon and context atol 2e-5 + rtol 1e-5 (the
context reaches ~30 under the test's drive); a decoded recon against the
encoder's exact; streams identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.entropy.coder import EntropyCoder as JEntropyCoder
from dcvc_tpu.entropy.gaussian import GaussianConditionalCoder as JGaussian
from dcvc_tpu.entropy.gaussian_conditional import (
    GaussianConditional as JGaussianConditional,
)
from dcvc_tpu.models import ar_coding as jar
from dcvc_tpu.models.video_dcvc import DCVCNet as JDCVCNet
from dcvc_tpu.models.video_dcvc import MaskedConv2d as JMaskedConv2d
from dcvc_tpu.utils import port_gen1
from dcvc_tpu_torch.entropy.coder import EntropyCoder
from dcvc_tpu_torch.entropy.gaussian import GaussianConditionalCoder
from dcvc_tpu_torch.entropy.gaussian_conditional import GaussianConditional
from dcvc_tpu_torch.models import ar_coding
from dcvc_tpu_torch.models.runtime import DcvcGen1Runtime
from dcvc_tpu_torch.models.video_dcvc import DCVCNet, MaskedConv2d
from dcvc_tpu_torch.ops.warp import RD_GATED_BLOCK_MODE
from dcvc_tpu_torch.utils import stream
from dcvc_tpu_torch.utils.convert import dcvc_gen1_from_jax

WIDTHS = {"channel_mv": 16, "channel_N": 16, "channel_M": 24}
ATOL = 2e-5


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


def test_masked_conv_matches_jax():
    rng = np.random.default_rng(6)
    tm = MaskedConv2d(6, 12, 5)
    x = rng.normal(0, 1, (1, 9, 11, 6)).astype(np.float32)
    params = {"params": {
        "kernel": tm.weight.detach().numpy().transpose(2, 3, 1, 0),
        "bias": tm.bias.detach().numpy()}}
    jout = JMaskedConv2d(12, 5).apply(params, jnp.asarray(x))
    with torch.no_grad():
        tout = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(tout), np.asarray(jout), atol=1e-5)
    # causal: a change at a pixel moves no output at or before it
    x2 = x.copy()
    x2[0, 4, 5] += 10.0
    with torch.no_grad():
        d = (tm(_nchw(x2)) - tout).abs()[0].sum(0)
    assert d[:4].max() == 0 and d[4, :6].max() == 0 and d[4, 6] > 0


@pytest.mark.parametrize("distribution", ["laplace", "gaussian"])
def test_build_indexes_np_identical(distribution):
    scales = np.exp(np.random.default_rng(7).uniform(-6, 5, 5000))
    np.testing.assert_array_equal(
        GaussianConditionalCoder(distribution).build_indexes_np(scales),
        JGaussian(distribution).build_indexes_np(scales))


def _nets(pkg, C, C_hyper, seed, means_first):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.3, (5, 5, C, 2 * C)).astype(np.float32)
    b = rng.normal(0, 0.3, 2 * C).astype(np.float32)
    dims = [C_hyper + 2 * C, 10, 8, 2 * C]
    ep_ws = [rng.normal(0, 0.3, (dims[i], dims[i + 1])).astype(np.float32)
             for i in range(3)]
    ep_bs = [rng.normal(0, 0.3, dims[i + 1]).astype(np.float32)
             for i in range(3)]
    return pkg.ArNets(w, b, ep_ws, ep_bs, means_first=means_first)


@pytest.mark.parametrize("tables", ["laplace", "zoo"])
def test_ar_coding_identical_to_jax(tables):
    """ar_encode / ar_decode on the same numpy inputs: the same bytes, the
    same y_hat, and each package decodes the other's stream."""
    assert ([p.tolist() for p in ar_coding.wavefronts(6, 9)]
            == [p.tolist() for p in jar.wavefronts(6, 9)])
    rng = np.random.default_rng(8)
    H, W, C, CH = 6, 9, 4, 8
    y = rng.normal(0, 4, (H, W, C)).astype(np.float32)
    hyper = rng.normal(0, 1, (H, W, CH)).astype(np.float32)
    means_first = tables == "laplace"
    if means_first:
        tg, jg = GaussianConditionalCoder("laplace"), JGaussian("laplace")
    else:
        tg, jg = GaussianConditional(), JGaussianConditional()
    tg.update()
    jg.update()
    tnets = _nets(ar_coding, C, CH, 9, means_first)
    jnets = _nets(jar, C, CH, 9, means_first)
    tcoder, jcoder = EntropyCoder(), JEntropyCoder()
    tcoder.reset()
    jcoder.reset()
    ty = ar_coding.ar_encode(y, hyper, tnets, tg, tcoder)
    jy = jar.ar_encode(y, hyper, jnets, jg, jcoder)
    tcoder.flush()
    jcoder.flush()
    data = tcoder.get_encoded_stream()
    assert data == bytes(jcoder.get_encoded_stream())
    assert len(data) > 50
    np.testing.assert_array_equal(ty, jy)
    tcoder.set_stream(data)
    jcoder.set_stream(data)
    np.testing.assert_array_equal(
        ar_coding.ar_decode((H, W, C), hyper, tnets, tg, tcoder), ty)
    np.testing.assert_array_equal(
        jar.ar_decode((H, W, C), hyper, jnets, jg, jcoder), ty)


# ---- DCVCNet, the gen1_p pin's init ----


@pytest.fixture(scope="module")
def gen1():
    jm = JDCVCNet(**WIDTHS)
    x0 = jnp.zeros((1, 64, 64, 3))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x0, x0)
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = DCVCNet(**WIDTHS)
    tm.load_state_dict(dcvc_gen1_from_jax(params), strict=True)
    return tm.eval(), params


def test_golden_gen1_p_pin_and_cross_package_streams(gen1):
    """The port writes the committed ``gen1_p`` pin (four substreams) byte
    for byte and decodes the pin (a JAX stream) to its own encoder recon."""
    import hashlib
    import json
    from pathlib import Path

    from test_golden_bins import _img

    golden = Path(__file__).parent / "golden"
    tm, _ = gen1
    rt = DcvcGen1Runtime(tm, device="cpu")
    rt.update()
    ref = _nchw(_img(192, 192, seed=15, gain=12.0))
    comp = rt.compress(ref, _nchw(_img(192, 192, seed=115, gain=12.0)))
    data = stream.pack_strings([comp["mv_z_string"], comp["mv_y_string"],
                                comp["z_string"], comp["y_string"]])
    pin = json.loads((golden / "manifest.json").read_text())["gen1_p"]
    assert hashlib.sha256(data).hexdigest() == pin["sha256"]
    assert data == (golden / "gen1_p.bin").read_bytes()
    mv_z, mv_y, z, y = stream.unpack_strings(data)
    dec = rt.decompress(ref, mv_y, mv_z, y, z, 192, 192)
    np.testing.assert_array_equal(dec["recon_image"].numpy(),
                                  comp["recon_image"].numpy())


def test_gen1_block_mc_forward_matches_jax(gen1):
    """Estimated-bits forward (the masked convs on the device) with
    ``mc_warp_mode=RD_GATED_BLOCK_MODE``: K1's plain version on the CPU,
    ``block_warp_ref`` in JAX on the CPU backend. The init's motion rounds
    to zero, so the mv encoder's and decoder's last layers are scaled
    (x100, x20) in both packages: flows of about a pixel on average, up
    to ~20."""
    import copy

    from test_golden_bins import _img

    tm, params = gen1
    tm = copy.deepcopy(tm)
    params = jax.tree_util.tree_map(np.array, params)
    for t, name, s in ((tm.mvEncoder[6], "mv_encoder_convs_3", 100.0),
                       (tm.mvDecoder_part1[6], "mv_decoder_deconvs_3", 20.0)):
        with torch.no_grad():
            t.weight.mul_(s)
        params["params"][name]["kernel"] *= s
    seen = {}
    tm.mvDecoder_part1.register_forward_hook(
        lambda mod, i, out: seen.setdefault("mv", out))
    H, W = 128, 128
    ref = np.asarray(_img(H, W, seed=31, gain=12.0))
    x = np.asarray(_img(H, W, seed=32, gain=12.0))
    jm = JDCVCNet(**WIDTHS, mc_warp_mode=RD_GATED_BLOCK_MODE)
    jout = jax.jit(jm.apply)(params, jnp.asarray(ref), jnp.asarray(x))
    tm.mc_warp_mode = RD_GATED_BLOCK_MODE
    with torch.no_grad():
        tout = tm(_nchw(ref), _nchw(x))
    assert float(seen["mv"].abs().max()) > 4.0
    assert float(tout["bpp_mv_y"]) > 0 and float(tout["bpp_y"]) > 0
    for k in ("bpp", "bpp_mv_y", "bpp_mv_z", "bpp_y", "bpp_z"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=ATOL, rtol=1e-5, err_msg=k)
    for k in ("recon_image", "context"):
        np.testing.assert_allclose(_nhwc(tout[k]), np.asarray(jout[k]),
                                   atol=ATOL, rtol=1e-5, err_msg=k)


def test_dcvc_gen1_converter_round_trip(gen1):
    """``port_gen1.convert_dcvc_gen1`` undoes ``dcvc_gen1_from_jax``."""
    tm, params = gen1
    back = port_gen1.convert_dcvc_gen1(
        {k: v.numpy() for k, v in tm.state_dict().items()})
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    assert set(got) == set(ref)
    for path, v in ref.items():
        np.testing.assert_array_equal(got[path], v)


def test_dcvc_gen1_checkpoints_load(gen1, tmp_path):
    """``load_state_dict`` takes the JAX package's ``.npz`` and a
    reference-style ``.pth`` whose AR masks and GDN buffers it drops; both
    load strictly."""
    from dcvc_tpu.utils.checkpoint import save_params
    from dcvc_tpu_torch.utils.checkpoint import load_state_dict

    tm, params = gen1
    save_params(str(tmp_path / "p.npz"), params)
    sd = tm.state_dict()
    torch.save(dict(sd, **{"auto_regressive.mask": torch.ones(1, 1, 5, 5),
                           "auto_regressive_mv.mask": torch.ones(1, 1, 5, 5),
                           "mvEncoder.1.beta_reparam.pedestal": torch.zeros(1)}),
               tmp_path / "p.pth")
    for path in ("p.npz", "p.pth"):
        got = load_state_dict(str(tmp_path / path), "dcvc_gen1")
        DCVCNet(**WIDTHS).load_state_dict(got, strict=True)
        for k, v in sd.items():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(),
                                          err_msg=f"{path} {k}")
