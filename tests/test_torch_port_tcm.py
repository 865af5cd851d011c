"""The port's TCM generation (GDN stacks, DMCTcm, TcmVideoRuntime) against
the JAX package, on the CPU.

DMCTcm runs at the ``tcm_p`` golden pin's widths (mv / N / M = 16 / 16 /
24) with the JAX ``PRNGKey(0)`` init the pin was coded with
(tests/test_golden_bins.py:_case_tcm_p), once, under ``jax.jit``, carried
over by ``dmc_tcm_from_jax``. The port writes the pin (the bare payload)
byte for byte, directly and with the decoder-aligned encode, and decodes
it (a JAX stream); the JAX package decodes the same bytes in
tests/test_golden_bins.py. The zoo I + TCM P pair at full width through
both CLIs is tests/test_torch_port_cli.py's.

Tolerances (f32, convolutions in another summation order): the forward's
bpp, recon and feature atol 2e-5 + rtol 1e-5; a decoded recon / feature
against the encoder's exact; streams identical.
"""

import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.video_tcm import DMCTcm as JDMCTcm
from dcvc_tpu.utils import port_tcm
from dcvc_tpu_torch.models.runtime import TcmVideoRuntime
from dcvc_tpu_torch.models.video_tcm import DMCTcm
from dcvc_tpu_torch.ops.warp import RD_GATED_BLOCK_MODE
from dcvc_tpu_torch.utils.convert import dmc_tcm_from_jax

GOLDEN = Path(__file__).parent / "golden"
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


@pytest.fixture(scope="module")
def tcm():
    jm = JDMCTcm(**WIDTHS)
    x0 = jnp.zeros((1, 64, 64, 3))
    params = jax.jit(jm.init, static_argnums=(3,))(
        jax.random.PRNGKey(0), x0, x0, None)
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = DMCTcm(**WIDTHS)
    tm.load_state_dict(dmc_tcm_from_jax(params), strict=True)
    return tm.eval(), params


def test_golden_tcm_p_pin_and_cross_package_streams(tcm):
    """The port writes the committed ``tcm_p`` pin byte for byte (directly
    and with ``aligned_enc``) and decodes the pin (a JAX stream) to its own
    encoder recon and feature."""
    from test_golden_bins import _img

    tm, _ = tcm
    rt = TcmVideoRuntime(tm, device="cpu")
    rt.update()
    ref = _nchw(_img(192, 192, seed=14, gain=12.0))
    x = _nchw(_img(192, 192, seed=114, gain=12.0))
    comp = rt.compress(x, ref, None)
    data = comp["bit_stream"]
    pin = json.loads((GOLDEN / "manifest.json").read_text())["tcm_p"]
    assert hashlib.sha256(data).hexdigest() == pin["sha256"]
    assert data == (GOLDEN / "tcm_p.bin").read_bytes()
    rt.aligned_enc = True
    assert rt.compress(x, ref, None)["bit_stream"] == data
    dec = rt.decompress(ref, None, data, 192, 192)
    for k in ("x_hat", "feature"):
        np.testing.assert_array_equal(dec[k].numpy(), comp[k].numpy(),
                                      err_msg=k)


def test_dmc_tcm_block_mc_forward_matches_jax(tcm):
    """Estimated-bits forward with ``mc_warp_mode=RD_GATED_BLOCK_MODE``
    (K1's plain version on the CPU; ``block_warp_ref`` in JAX on the CPU
    backend) and a reference feature (``feature_adaptor_P``). The init's
    motion rounds to zero, so the mv encoder's and decoder's last layers
    are scaled (x100, x300) in both packages: flows of several pixels. The
    exact-mc compress planes are the ``tcm_p`` pin's (byte for byte,
    above)."""
    import copy

    from test_golden_bins import _img

    tm, params = tcm
    tm = copy.deepcopy(tm)
    params = jax.tree_util.tree_map(np.array, params)
    for t, path, s in ((tm.mv_encoder[12], ("mv_encoder", "down3"), 100.0),
                       (tm.mv_decoder[8], ("mv_decoder", "up3"), 300.0)):
        with torch.no_grad():
            t.weight.mul_(s)
        params["params"][path[0]][path[1]]["kernel"] *= s
    seen = {}
    tm.mv_decoder.register_forward_hook(
        lambda mod, i, out: seen.setdefault("mv", out))
    H, W = 128, 128
    ref = np.asarray(_img(H, W, seed=33, gain=12.0))
    x = np.asarray(_img(H, W, seed=34, gain=12.0))
    feat = np.random.default_rng(35).normal(0, 1, (1, H, W, 16)).astype(np.float32)
    jm = JDMCTcm(**WIDTHS, mc_warp_mode=RD_GATED_BLOCK_MODE)
    jout = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(ref),
                             jnp.asarray(feat))
    tm.mc_warp_mode = RD_GATED_BLOCK_MODE
    with torch.no_grad():
        tout = tm(_nchw(x), _nchw(ref), _nchw(feat))
    assert float(seen["mv"].abs().max()) > 4.0
    assert float(tout["bpp_mv_y"]) > 0 and float(tout["bpp_y"]) > 0
    for k in ("bpp", "bpp_mv_y", "bpp_mv_z", "bpp_y", "bpp_z", "me_mse",
              "mse_loss"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=ATOL, rtol=1e-5, err_msg=k)
    for k in ("recon_image", "feature"):
        np.testing.assert_allclose(_nhwc(tout[k]), np.asarray(jout[k]),
                                   atol=ATOL, rtol=1e-5, err_msg=k)


def test_dmc_tcm_converter_round_trip(tcm):
    """``port_tcm.convert_dmc_tcm`` undoes ``dmc_tcm_from_jax``."""
    tm, params = tcm
    back = port_tcm.convert_dmc_tcm(
        {k: v.numpy() for k, v in tm.state_dict().items()})
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    assert set(got) == set(ref)
    for path, v in ref.items():
        np.testing.assert_array_equal(got[path], v)


def test_dmc_tcm_checkpoints_load(tcm, tmp_path):
    """``load_state_dict`` takes the JAX package's ``.npz`` and a
    reference-style ``.pth`` whose GDN reparametrisation buffers it
    drops; both load strictly."""
    from dcvc_tpu.utils.checkpoint import save_params
    from dcvc_tpu_torch.utils.checkpoint import load_state_dict

    tm, params = tcm
    save_params(str(tmp_path / "p.npz"), params)
    sd = tm.state_dict()
    torch.save(dict(sd, **{"mv_encoder.1.beta_reparam.pedestal": torch.zeros(1),
                           "contextual_decoder.gdn1.gamma_reparam.lower_bound"
                           ".bound": torch.zeros(1)}), tmp_path / "p.pth")
    for path in ("p.npz", "p.pth"):
        got = load_state_dict(str(tmp_path / path), "dmc_tcm")
        DMCTcm(**WIDTHS).load_state_dict(got, strict=True)
        for k, v in sd.items():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(),
                                          err_msg=f"{path} {k}")
