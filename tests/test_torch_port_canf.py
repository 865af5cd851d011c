"""Port CANF-VC hybrid (CanfMainCoder, CANFVCDmc on HemVideoRuntime,
converter, checkpoints) against the JAX package, on the CPU.

CANF has no golden pin. Seeded *port* weights at narrow widths (mv / N /
M = 16 / 16 / 24; the DQ post-filter and the ANF ladder at their fixed
sizes) are carried to JAX with ``dcvc_tpu/utils/port_hem.py``
(``convert_canf_dmc``), with no JAX model init. The port's stream must be
byte-identical to the JAX ``HemVideoRuntime``'s on those weights. The port
decodes the JAX stream to within 1e-5 of the JAX encoder's DPB; the JAX
runtime decoding those same bytes is the JAX package's own round trip
(tests/test_canf.py), so it is not compiled again here.

Tolerances (f32; convolutions in another summation order): forward bpp /
mse terms atol 2e-5 (rtol 1e-5), DPBs atol 2e-5, a decoded DPB against an
encoder's atol 1e-5; streams identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.runtime import HemVideoRuntime as JHemVideoRuntime
from dcvc_tpu.models.video_canf import CANFVCDmc as JCANFVCDmc
from dcvc_tpu.utils import port_hem
from dcvc_tpu_torch.models.registry import build
from dcvc_tpu_torch.models.runtime import HemVideoRuntime
from dcvc_tpu_torch.models.video_canf import CANFVCDmc, CanfMainCoder
from dcvc_tpu_torch.utils.checkpoint import load_state_dict
from dcvc_tpu_torch.utils.convert import canf_dmc_from_jax

WIDTHS = {"channel_mv": 16, "channel_N": 16, "channel_M": 24}
DPB_KEYS = ("ref_frame", "ref_y", "ref_mv_y")
H, W = 64, 128
MV_Q, Y_Q = 0.7, 0.6


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


@pytest.fixture(scope="module")
def canf():
    """Seeded port CANF at narrow widths, the same weights in JAX, and the
    JAX runtime."""
    torch.manual_seed(31)
    tm = CANFVCDmc(**WIDTHS).eval()
    params = port_hem.convert_canf_dmc(_sd(tm))
    jm = JCANFVCDmc(**WIDTHS)
    jrt = JHemVideoRuntime(jm, params)
    jrt.update(force=True)
    return tm, jm, params, jrt


def _frames():
    from test_golden_bins import _img

    return (np.asarray(_img(H, W, seed=32, gain=3.0)),
            np.asarray(_img(H, W, seed=33, gain=3.0)))


def test_canf_forward_matches_jax(canf):
    """Estimated-bits forward, x2_mse (the ANF regularizer) included."""
    tm, jm, params, _ = canf
    x, ref = _frames()
    jdpb = {"ref_frame": ref, "ref_feature": None, "ref_y": None,
            "ref_mv_y": None}
    jout = jax.jit(lambda p, a, d: jm.apply(p, a, d, jnp.float32(MV_Q),
                                            jnp.float32(Y_Q)))(
        params, jnp.asarray(x), jdpb)
    with torch.no_grad():
        tout = tm(_nchw(x), {"ref_frame": _nchw(ref), "ref_feature": None,
                             "ref_y": None, "ref_mv_y": None},
                  torch.tensor(MV_Q), torch.tensor(Y_Q))
    for k in ("bpp", "bpp_mv_y", "bpp_mv_z", "bpp_y", "bpp_z", "me_mse",
              "x2_mse"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=2e-5, rtol=1e-5, err_msg=k)
    assert tout["dpb"]["ref_feature"] is None
    for k in DPB_KEYS:
        np.testing.assert_allclose(_nhwc(tout["dpb"][k]),
                                   np.asarray(jout["dpb"][k]), atol=2e-5,
                                   err_msg=k)


def test_canf_stream_equals_jax_runtime_and_decodes_across(canf):
    tm, _, _, jrt = canf
    x, ref = _frames()
    jdpb = {"ref_frame": ref, "ref_feature": None, "ref_y": None,
            "ref_mv_y": None}
    dpb = {"ref_frame": _nchw(ref), "ref_feature": None, "ref_y": None,
           "ref_mv_y": None}
    rt = HemVideoRuntime(tm, device="cpu")
    rt.update()
    comp = rt.compress(_nchw(x), dpb, MV_Q, Y_Q)
    jcomp = jrt.compress(jnp.asarray(x), jdpb, MV_Q, Y_Q)
    assert len(comp["bit_stream"]) > 100
    assert comp["bit_stream"] == jcomp["bit_stream"]
    rt.aligned_enc = True
    assert rt.compress(_nchw(x), dpb, MV_Q, Y_Q)["bit_stream"] == \
        comp["bit_stream"]

    dec = rt.decompress(dpb, jcomp["bit_stream"], H, W, MV_Q, Y_Q)
    assert dec["dpb"]["ref_feature"] is None
    for k in DPB_KEYS:
        np.testing.assert_allclose(dec["dpb"][k].numpy(),
                                   comp["dpb"][k].numpy(), atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(np.asarray(jcomp["dpb"][k]),
                                   _nhwc(dec["dpb"][k]), atol=1e-5, err_msg=k)


def test_canf_main_coder_decode_inverts_encode():
    """decode(last_residual(encode(x))) gives x back: the additive ANF
    ladder is invertible for any latent."""
    torch.manual_seed(34)
    coder = CanfMainCoder(2, 8, 12).eval()
    x = torch.rand(1, 3, 32, 48)
    contexts = (torch.randn(1, 8, 32, 48), torch.randn(1, 8, 16, 24),
                torch.randn(1, 8, 8, 12))
    with torch.no_grad():
        x_res, code = coder.encode(x, contexts)
        x0 = coder.last_residual(x_res, contexts, code)
        back = coder.decode(x0, contexts, code)
    torch.testing.assert_close(back, x, atol=1e-5, rtol=0)


def test_canf_weights_convert_is_exact_inverse_and_published_pth_loads(
        tmp_path):
    """canf_dmc_from_jax inverts port_hem.convert_canf_dmc at full width; a
    published-style checkpoint, which still carries the DMC base class's
    unused feature_adaptor_P, loads with strict=True once it is dropped."""
    module, _ = build("canfvc_dmc", seed=35, device="cpu")
    sd = _sd(module)
    published = dict(sd, **{"feature_adaptor_P.weight":
                            np.zeros((64, 64, 1, 1), np.float32),
                            "feature_adaptor_P.bias":
                            np.zeros(64, np.float32)})
    back = canf_dmc_from_jax(port_hem.convert_canf_dmc(published))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    path = tmp_path / "canf.pth"
    torch.save({k: torch.from_numpy(v) for k, v in published.items()}, path)
    loaded, rt = build("canfvc_dmc", seed=36, device="cpu",
                       state_dict=load_state_dict(str(path), "canfvc_dmc"))
    assert isinstance(rt, HemVideoRuntime)
    for k, v in loaded.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
