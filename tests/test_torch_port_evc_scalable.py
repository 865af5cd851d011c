"""Port ScalableEVC + ScalableEvcRuntime against the JAX package, on the
CPU, at enc_num = 4 and narrow widths.

Weights are seeded port weights carried to JAX with
``port_dc.convert_evc_scalable`` (no JAX init). Tolerances: scalable_add
values atol 1e-6 and gradients exact; mse / bpp of the whole bank atol
2e-5; the chosen encoder, the stream bytes and the symbols identical;
cross-package recons atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.evc_scalable import ScalableEVC as JScalableEVC
from dcvc_tpu.models.evc_scalable import choose_encoder_id as j_choose
from dcvc_tpu.models.evc_scalable import scalable_add as j_scalable_add
from dcvc_tpu.models.runtime import ScalableEvcRuntime as JScalableEvcRuntime
from dcvc_tpu.utils import port_dc
from dcvc_tpu_torch.models.evc import build_evc
from dcvc_tpu_torch.models.evc_scalable import (ScalableEVC,
                                                build_evc_scalable,
                                                choose_encoder_id,
                                                scalable_add)
from dcvc_tpu_torch.models.runtime import ScalableEvcRuntime
from dcvc_tpu_torch.utils import stream
from dcvc_tpu_torch.utils.checkpoint import load_state_dict
from dcvc_tpu_torch.utils.convert import evc_scalable_from_jax

ENC_CH, DEC_CH, N = (8, 8, 12, 16), (16, 16, 16, 16), 16


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


def test_scalable_add_values_and_gradients_match_jax():
    rng = np.random.default_rng(0)
    ys = rng.normal(size=(4, 2, 5, 6, 3)).astype(np.float32)   # NHWC bank
    w = rng.normal(size=ys.shape).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda a: jnp.sum(j_scalable_add(a) * w))(jnp.asarray(ys))
    t = torch.from_numpy(ys.transpose(0, 1, 4, 2, 3).copy()).requires_grad_()
    out = scalable_add(t)
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 1, 3, 4, 2),
                               np.asarray(j_scalable_add(jnp.asarray(ys))),
                               atol=1e-6)
    (out * torch.from_numpy(w.transpose(0, 1, 4, 2, 3).copy())).sum().backward()
    # only the last term of each running mean carries a gradient
    np.testing.assert_array_equal(t.grad.numpy().transpose(0, 1, 3, 4, 2),
                                  np.asarray(jg))
    np.testing.assert_allclose(float(jv), float((out.detach() * torch.from_numpy(
        w.transpose(0, 1, 4, 2, 3).copy())).sum()), rtol=1e-5)


@pytest.fixture(scope="module")
def bank():
    tm = build_evc_scalable(enc_channels=ENC_CH, dec_channels=DEC_CH, N=N,
                            seed=7, device="cpu")
    with torch.no_grad():
        tm.q_scale.copy_(torch.tensor([1.3, 1.0, 0.8, 0.5]).view(4, 1, 1, 1))
    jm = JScalableEVC(enc_channels=ENC_CH, dec_channels=DEC_CH, N=N)
    params = port_dc.convert_evc_scalable(_sd(tm))
    rng = np.random.default_rng(8)
    x = (rng.random((1, 64, 64, 3)) * 5 - 2).astype(np.float32)
    return tm, jm, params, x


def test_bank_forward_and_encoder_choice_match_jax(bank):
    tm, jm, params, x = bank
    q = np.float32(0.85)
    jout = jax.jit(lambda p, a, s: jm.apply(p, a, s, None))(
        params, jnp.asarray(x), jnp.asarray(q))
    with torch.no_grad():
        tout = tm(_nchw(x), torch.tensor(q), None)
    assert tout["mse"].shape == (4,)
    for k in ("mse", "bpp"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=2e-5, err_msg=k)
    np.testing.assert_allclose(_nhwc(tout["x_hat"]), np.asarray(jout["x_hat"]),
                               atol=2e-5)
    for rate_idx in (0, 3):
        assert choose_encoder_id(tout["mse"], tout["bpp"], rate_idx) == \
            j_choose(jout["mse"], jout["bpp"], rate_idx)


@pytest.fixture(scope="module")
def runtimes(bank):
    """One runtime per package (the JAX one compiles its programs once)."""
    tm, jm, params, _ = bank
    trt = ScalableEvcRuntime(tm, device="cpu")
    trt.update()
    jrt = JScalableEvcRuntime(jm, params)
    jrt.update(force=True)
    return trt, jrt


@pytest.mark.parametrize("rate_idx", [0, 3])
def test_streams_identical_and_decode_across_packages(bank, runtimes,
                                                      rate_idx):
    x = bank[3]
    trt, jrt = runtimes
    trt.rate_idx = jrt.rate_idx = rate_idx
    q, q_index = stream.get_rounded_q(0.7)
    comp = trt.compress(_nchw(x), q)
    jcomp = jrt.compress(jnp.asarray(x), jnp.asarray(q))
    print(f"rate_idx {rate_idx}: encoder {comp['enc_id']}, "
          f"{len(comp['bit_stream'])} B")
    assert comp["enc_id"] == jcomp["enc_id"]
    assert comp["bit_stream"] == jcomp["bit_stream"]

    dec = trt.decompress(jcomp["bit_stream"], 64, 64, q_index / 100)
    np.testing.assert_array_equal(dec["x_hat"].numpy(), comp["x_hat"].numpy())
    jdec = jrt.decompress(comp["bit_stream"], 64, 64,
                          jnp.asarray(q_index / 100))
    np.testing.assert_allclose(np.asarray(jdec["x_hat"]), _nhwc(dec["x_hat"]),
                               atol=1e-5)
    est = trt.forward(_nchw(x), q)
    assert est["enc_id"] == comp["enc_id"] and est["x_hat"].shape[0] == 1


def test_weights_convert_is_exact_inverse_and_replicates_plain(tmp_path):
    tm = build_evc_scalable(seed=9, device="cpu")
    sd = _sd(tm)
    back = evc_scalable_from_jax(port_dc.convert_evc_scalable(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)

    # a plain EVC checkpoint: its one encoder goes onto every bank slot, by
    # the JAX converter and by the port's .pth loader alike
    plain = build_evc("SL", seed=10, device="cpu").state_dict()
    psd = {k: v.numpy() for k, v in plain.items()}
    rep = evc_scalable_from_jax(port_dc.convert_evc_scalable(psd))
    torch.save({"state_dict": plain}, tmp_path / "evc_sl.pth")
    loaded = load_state_dict(str(tmp_path / "evc_sl.pth"), "evc_scalable")
    assert set(rep) == set(loaded) == set(sd)
    for k, v in rep.items():
        src = "enc." + k.split(".", 2)[2] if k.startswith("encs.") else k
        np.testing.assert_array_equal(v.numpy(), psd[src], err_msg=k)
        np.testing.assert_array_equal(loaded[k].numpy(), psd[src], err_msg=k)
    ScalableEVC().load_state_dict(loaded, strict=True)
