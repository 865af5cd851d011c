"""Port HEM generation (IntraNoARHem, DMCHem, HemVideoRuntime) against
the JAX package, on the CPU.

The two models run at the golden pins' widths (IntraNoARHem N = 32;
DMCHem mv / N / M = 16 / 16 / 24) with the JAX ``PRNGKey(0)`` init those
pins were coded with (tests/test_golden_bins.py:_case_hem_intra /
_case_hem_p): each init runs once, under ``jax.jit``, in a module fixture,
and reaches the port through ``intra_hem_from_jax`` / ``dmc_hem_from_jax``.
The port writes each pin byte for byte and decodes it (a JAX stream); the
JAX package decodes those same bytes in tests/test_golden_bins.py, so the
pins need no JAX runtime here. Recons across packages are held by the
forward cases below and, at full width through both CLIs (each decodes
the other's identical streams), by tests/test_torch_port_cli.py, which
also holds the image CLI's ``intra_hem`` branch. Blocks and converters
are tests/test_torch_port_hem_blocks.py's.

Tolerances (f32; convolutions in another summation order): the models'
recons / bpp / DPBs atol 2e-5, a decoded DPB against the encoder's atol
1e-5; the pins' streams (and so every symbol and scale index) must be
identical.
"""

import hashlib
import json
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.intra_hem import IntraNoARHem as JIntraNoARHem
from dcvc_tpu.models.video_hem import DMCHem as JDMCHem
from dcvc_tpu_torch.models.intra_hem import IntraNoARHem
from dcvc_tpu_torch.models.runtime import EvcCodecRuntime, HemVideoRuntime
from dcvc_tpu_torch.models.video_hem import DMCHem
from dcvc_tpu_torch.ops.warp import RD_GATED_BLOCK_MODE
from dcvc_tpu_torch.utils import stream
from dcvc_tpu_torch.utils.convert import dmc_hem_from_jax, intra_hem_from_jax

GOLDEN = Path(__file__).parent / "golden"
P_WIDTHS = {"channel_mv": 16, "channel_N": 16, "channel_M": 24}
DPB_KEYS = ("ref_frame", "ref_feature", "ref_y", "ref_mv_y")


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


def _manifest(name):
    return json.loads((GOLDEN / "manifest.json").read_text())[name]


# ---- IntraNoARHem, the hem_intra pin's init ----


@pytest.fixture(scope="module")
def intra():
    jm = JIntraNoARHem(N=32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 64, 3)), jnp.ones(()))
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = IntraNoARHem(32)
    tm.load_state_dict(intra_hem_from_jax(params), strict=True)
    return tm.eval(), jm, params


def test_intra_hem_forward_matches_jax(intra):
    """Estimated-bits forward; the compress planes are the ``hem_intra``
    pin's (byte for byte, below)."""
    tm, jm, params = intra
    torch.testing.assert_close(tm.q_scale.view(-1),
                               torch.tensor([1.541, 1.083, 0.729, 0.500]))
    x = (np.random.default_rng(25).random((1, 64, 128, 3)) * 6 - 2.5
         ).astype(np.float32)
    q = np.float32(0.73)
    jout = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(q))
    with torch.no_grad():
        tout = tm(_nchw(x), torch.tensor(q))
    np.testing.assert_allclose(_nhwc(tout["x_hat"]), np.asarray(jout["x_hat"]),
                               atol=2e-5)
    for k in ("bpp", "bpp_y", "bpp_z"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=2e-5, err_msg=k)


def test_golden_hem_intra_pin_and_cross_package_streams(intra):
    """The port writes the committed ``hem_intra`` pin byte for byte and
    decodes the pin (a JAX stream) to its own encoder recon."""
    from test_golden_bins import _img

    tm, _, _ = intra
    rt = EvcCodecRuntime(tm, device="cpu")
    rt.update()
    q, q_index = stream.get_rounded_q(0.73)
    comp = rt.compress(_nchw(_img(seed=16)), q)
    data = stream.pack_i_ushort_q(128, 128, q_index, comp["bit_stream"])
    golden = (GOLDEN / "hem_intra.bin").read_bytes()
    assert hashlib.sha256(data).hexdigest() == _manifest("hem_intra")["sha256"]
    assert data == golden

    h, w, qi, s = stream.unpack_i_ushort_q(golden)
    dec = rt.decompress(s, h, w, qi / 100)
    np.testing.assert_array_equal(dec["x_hat"].numpy(), comp["x_hat"].numpy())


# ---- DMCHem, the hem_p pin's init ----


@pytest.fixture(scope="module")
def dmc():
    jm = JDMCHem(**P_WIDTHS)
    x0 = jnp.zeros((1, 64, 64, 3))
    dpb0 = {"ref_frame": x0, "ref_feature": None, "ref_y": None,
            "ref_mv_y": None}
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x0, dpb0, jnp.ones(()),
                              jnp.ones(()))
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = DMCHem(**P_WIDTHS)
    tm.load_state_dict(dmc_hem_from_jax(params), strict=True)
    return tm.eval(), jm, params


def _dpb_nchw(dpb):
    return {k: None if dpb[k] is None else _nchw(dpb[k]) for k in DPB_KEYS}


def test_golden_hem_p_pin_and_cross_package_streams(dmc):
    """The port writes the committed ``hem_p`` pin byte for byte (directly
    and with the decoder-aligned encode) and decodes the pin (a JAX
    stream) to its own encoder DPB."""
    from test_golden_bins import _img

    tm, _, _ = dmc
    rt = HemVideoRuntime(tm, device="cpu")
    rt.update()
    ref = _img(192, 192, seed=13, gain=3.0)
    x = _nchw(_img(192, 192, seed=113, gain=3.0))
    dpb = _dpb_nchw({"ref_frame": ref, "ref_feature": None, "ref_y": None,
                     "ref_mv_y": None})
    mv_q, mv_i = stream.get_rounded_q(0.9)
    y_q, y_i = stream.get_rounded_q(0.8)
    comp = rt.compress(x, dpb, mv_q, y_q)
    data = (struct.pack(">2H", y_i, mv_i)
            + struct.pack(">I", len(comp["bit_stream"]))
            + bytes(comp["bit_stream"]))
    golden = (GOLDEN / "hem_p.bin").read_bytes()
    assert hashlib.sha256(data).hexdigest() == _manifest("hem_p")["sha256"]
    assert data == golden
    rt.aligned_enc = True
    assert rt.compress(x, dpb, mv_q, y_q)["bit_stream"] == comp["bit_stream"]

    dec = rt.decompress(dpb, golden[8:], 192, 192, mv_i / 100, y_i / 100)
    for k in DPB_KEYS:
        np.testing.assert_allclose(dec["dpb"][k].numpy(),
                                   comp["dpb"][k].numpy(), atol=1e-5,
                                   err_msg=k)


def test_dmc_hem_block_mc_forward_matches_jax(dmc):
    """Estimated-bits forward with ``mc_warp_mode=RD_GATED_BLOCK_MODE``
    (K1's plain version on the CPU; ``block_warp_ref`` in JAX on the CPU
    backend) and a full DPB (ref_feature through feature_adaptor_P, ref_y /
    ref_mv_y in the priors). The exact-mc compress planes after an
    I-frame are the ``hem_p`` pin's (byte for byte, above)."""
    from test_golden_bins import _img

    tm, _, params = dmc
    jm = JDMCHem(**P_WIDTHS, mc_warp_mode=RD_GATED_BLOCK_MODE)
    rng = np.random.default_rng(27)
    H, W = 64, 128
    # the golden inputs' out-of-gamut drive and a small mv q: at this size
    # the init's latents round to zero on [0, 1] frames at q 0.9
    x = np.asarray(_img(H, W, seed=27, gain=3.0))
    jdpb = {"ref_frame": np.asarray(_img(H, W, seed=28, gain=3.0)),
            "ref_feature": rng.normal(0, 1, (1, H, W, 16)).astype(np.float32),
            "ref_y": rng.normal(0, 2, (1, H // 16, W // 16, 24)).astype(np.float32),
            "ref_mv_y": rng.normal(0, 2, (1, H // 16, W // 16, 16)).astype(np.float32)}
    jout = jax.jit(lambda p, a, d: jm.apply(p, a, d, jnp.float32(0.05),
                                            jnp.float32(0.8)))(
        params, jnp.asarray(x), jdpb)
    tm.mc_warp_mode = RD_GATED_BLOCK_MODE
    try:
        with torch.no_grad():
            tout = tm(_nchw(x), _dpb_nchw(jdpb), torch.tensor(0.05),
                      torch.tensor(0.8))
    finally:
        tm.mc_warp_mode = None
    assert float(tout["bpp_mv_y"][0]) > 0 and float(tout["bpp_y"][0]) > 0
    for k in ("bpp", "bpp_mv_y", "bpp_mv_z", "bpp_y", "bpp_z", "me_mse"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=2e-5, rtol=1e-5, err_msg=k)
    for k in DPB_KEYS:
        np.testing.assert_allclose(_nhwc(tout["dpb"][k]),
                                   np.asarray(jout["dpb"][k]), atol=2e-5,
                                   err_msg=k)
