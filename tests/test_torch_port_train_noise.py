"""The training rate surrogate (``quant_mode="noise"``) of the model
forwards that have one, port against ``dcvc_tpu`` on the CPU, in float32:
IntraNoAR, IntraNoARHem, the five CompressAI zoo models, DMCTcm and
DCVCNet. (DMC, DMCHem, CANFVCDmc and EVCIntra are held in
``test_torch_port_train_grads.py``, in the program that also takes their
gradients.)

Seeded *port* weights at narrow widths are carried to JAX with the
``dcvc_tpu/utils/port_*.py`` converters; no JAX model init runs. Both
packages' ``priors.quant_noise`` are replaced, in this file only, by one
that adds the same numpy draws in call order (the JAX draw is the port's
NCHW draw in NHWC), so the two forwards see the same noise and must give
the same bpp parts and recon.

Tolerances (f32, convolutions in another summation order): bpp parts and
recon rtol 1e-5, atol 1e-5. Noise leaves the recon of the DMC generations
(STE recon, noisy rate) equal to STE's exactly; the CompressAI zoo perturbs
both paths, as its training convention does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models import priors as jpriors
from dcvc_tpu.models import intra_zoo as jzoo
from dcvc_tpu.models.intra_dc import IntraNoAR as JIntraNoAR
from dcvc_tpu.models.intra_hem import IntraNoARHem as JIntraNoARHem
from dcvc_tpu.models.video_dcvc import DCVCNet as JDCVCNet
from dcvc_tpu.models.video_tcm import DMCTcm as JDMCTcm
from dcvc_tpu.utils import port_dc, port_gen1, port_hem, port_tcm, port_zoo
from dcvc_tpu_torch.models import priors as tpriors
from dcvc_tpu_torch.models.evc import EVCIntra
from dcvc_tpu_torch.models.evc_scalable import ScalableEVC
from dcvc_tpu_torch.models.intra_dc import IntraNoAR
from dcvc_tpu_torch.models.intra_hem import IntraNoARHem
from dcvc_tpu_torch.models.intra_zoo import build_zoo
from dcvc_tpu_torch.models.video_dcvc import DCVCNet
from dcvc_tpu_torch.models.video_tcm import DMCTcm
from dcvc_tpu_torch.utils.convert import ZOO_KINDS
from _flax_init import flax_param_checks  # noqa: F401 (autouse)

P_WIDTHS = {"channel_mv": 16, "channel_N": 16, "channel_M": 24}
EVC_CH = (16, 16, 24, 32)
TOL = {"rtol": 1e-5, "atol": 1e-5}
H = W = 64


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six pytest workers on one host: two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


class _Draws:
    """The k-th call draws U(-0.5, 0.5) of the caller's NCHW shape from one
    seeded stream; both packages replay the same stream."""

    def __init__(self, seed):
        self.seed = seed
        self.calls = {"port": [], "jax": []}

    def _draw(self, who, shape_nchw):
        k = len(self.calls[who])
        self.calls[who].append(shape_nchw)
        rng = np.random.default_rng([self.seed, k])
        return rng.uniform(-0.5, 0.5, shape_nchw).astype(np.float32)

    def port(self, x, generator, rows=True):
        assert isinstance(generator, torch.Generator)
        return x + torch.from_numpy(self._draw("port", tuple(x.shape)))

    def jax(self, x, key):
        B, Hh, Ww, C = x.shape
        d = self._draw("jax", (B, C, Hh, Ww)).transpose(0, 2, 3, 1)
        return x + jnp.asarray(d)


@pytest.fixture
def draws(monkeypatch):
    d = _Draws(seed=5)
    monkeypatch.setattr(tpriors, "quant_noise", d.port)
    monkeypatch.setattr(jpriors, "quant_noise", d.jax)
    return d


def _frames(n, seed=11):
    rng = np.random.default_rng(seed)
    base = rng.random((1, H // 8 + n, W // 8 + n, 3))
    big = np.kron(base, np.ones((1, 8, 8, 1)))
    return [np.clip(big[:, 8 * i // 4:8 * i // 4 + H, 3 * i:3 * i + W]
                    + 0.05 * rng.random((1, H, W, 3)), 0, 1).astype(np.float32)
            for i in range(n)]


def _jit_apply(jm, params, *args):
    """One jitted JAX forward (the replaced ``quant_noise`` runs while it
    traces: its draws are constants of the program)."""
    *arrays, mode = args
    return jax.jit(lambda p, *a: jm.apply(
        p, *a, mode, rngs={"noise": jax.random.PRNGKey(0)}))(params, *arrays)


def _check(tout, jout, keys, recon_t, recon_j):
    for k in keys:
        np.testing.assert_allclose(np.asarray(tout[k].detach()),
                                   np.asarray(jout[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(_nhwc(recon_t), np.asarray(recon_j), **TOL)


def _noise_vs_ste(forward, recon):
    """Port forward under noise and under STE: the recon must be equal."""
    gen = torch.Generator().manual_seed(0)
    out_n = forward("noise", gen)
    out_s = forward("ste", None)
    torch.testing.assert_close(recon(out_n), recon(out_s), rtol=0, atol=0)
    for k in ("bpp_y", "bpp_z"):
        assert not torch.equal(out_n[k], out_s[k]), k


INTRA = ["intra_dc", "intra_hem"]


def _intra(name):
    torch.manual_seed(21)
    if name == "intra_dc":
        tm = IntraNoAR(N=32, ch_a=16, ch_b=24)
        return (tm, JIntraNoAR(N=32, ch_a=16, ch_b=24),
                port_dc.convert_intra_dc(_sd(tm)))
    tm = IntraNoARHem(N=32)
    return tm, JIntraNoARHem(N=32), port_hem.convert_intra_hem(_sd(tm))


@pytest.mark.parametrize("name", INTRA)
def test_intra_noise_forward_matches_jax(name, draws):
    tm, jm, params = _intra(name)
    x = _frames(1)[0]
    q = np.full((1, 1, 1, 1), 0.8, np.float32)
    args = (q, q) if name == "intra_dc" else (q,)
    jout = _jit_apply(jm, params, jnp.asarray(x), *map(jnp.asarray, args),
                      "noise")
    tq = [torch.from_numpy(a) for a in args]
    tout = tm(_nchw(x), *tq, quant_mode="noise",
              generator=torch.Generator().manual_seed(0))
    assert draws.calls["port"] == draws.calls["jax"]
    assert len(draws.calls["port"]) == 2          # y, then z
    _check(tout, jout, ("bpp", "bpp_y", "bpp_z"), tout["x_hat"],
           jout["x_hat"])
    _noise_vs_ste(lambda qm, g: tm(_nchw(x), *tq, quant_mode=qm,
                                   generator=g), lambda o: o["x_hat"])


@pytest.mark.parametrize("name", list(ZOO_KINDS))
def test_zoo_noise_forward_matches_jax(name, draws):
    """The CompressAI convention: noise on the recon and the rate paths."""
    kw = {"N": 16} if name == "cheng2020-anchor" else {"N": 16, "M": 24}
    tm = build_zoo(name, seed=22, device="cpu", **kw)
    params = port_zoo.convert_zoo(_sd(tm), ZOO_KINDS[name])
    jkw = {"N": 16, "M": 16} if name == "cheng2020-anchor" else kw
    jm = jzoo.model_architectures[name](**jkw)
    x = _frames(1)[0]
    jout = _jit_apply(jm, params, jnp.asarray(x), "noise")
    tout = tm(_nchw(x), "noise", generator=torch.Generator().manual_seed(0))
    assert draws.calls["port"] == draws.calls["jax"]
    keys = ("bpp",) if name == "bmshj2018-factorized" else (
        "bpp", "bpp_y", "bpp_z")
    _check(tout, jout, keys, tout["x_hat"], jout["x_hat"])


@pytest.mark.parametrize("name", ["dmc_tcm", "dcvc_gen1"])
def test_tcm_and_gen1_noise_forward_matches_jax(name, draws):
    torch.manual_seed(25)
    if name == "dmc_tcm":
        tm, jm = DMCTcm(**P_WIDTHS), JDMCTcm(**P_WIDTHS)
        params = port_tcm.convert_dmc_tcm(_sd(tm))
    else:
        tm, jm = DCVCNet(**P_WIDTHS), JDCVCNet(**P_WIDTHS)
        params = port_gen1.convert_dcvc_gen1(_sd(tm))
    ref, x = _frames(2)
    if name == "dmc_tcm":
        jargs = (jnp.asarray(x), jnp.asarray(ref), None)
        targs = (_nchw(x), _nchw(ref), None)
    else:
        jargs = (jnp.asarray(ref), jnp.asarray(x))
        targs = (_nchw(ref), _nchw(x))
    jout = _jit_apply(jm, params, *jargs, "noise")
    tout = tm(*targs, "noise", generator=torch.Generator().manual_seed(0))
    assert draws.calls["port"] == draws.calls["jax"]
    assert len(draws.calls["port"]) == 4
    _check(tout, jout, ("bpp", "bpp_y", "bpp_z", "bpp_mv_y", "bpp_mv_z"),
           tout["recon_image"], jout["recon_image"])
    _noise_vs_ste(lambda qm, g: tm(*targs, qm, generator=g),
                  lambda o: o["recon_image"])


def test_quant_noise_draws_from_its_generator():
    """``quant_noise`` adds U(-0.5, 0.5) from the generator it is given
    (same seed, same draw), refuses to run without one, and ``noise``
    needs a generator in every forward; the scalable EVC has no noise
    mode (nor has the JAX package's)."""
    x = torch.zeros(2, 3, 8, 8)
    a = tpriors.quant_noise(x, torch.Generator().manual_seed(3))
    b = tpriors.quant_noise(x, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(a.min()) >= -0.5 and float(a.max()) < 0.5
    assert abs(float(a.mean())) < 0.1
    with pytest.raises(ValueError, match="Generator"):
        tpriors.quant_noise(x, None)
    tm = EVCIntra(EVC_CH, EVC_CH, 32)
    with pytest.raises(ValueError, match="Generator"):
        tm(torch.rand(1, 3, 64, 64), torch.ones(1, 1, 1, 1), "noise")
    sm = ScalableEVC(enc_num=2, N=32)
    with pytest.raises(ValueError, match="noise"):
        sm(torch.rand(1, 3, 64, 64), torch.ones(1, 1, 1, 1),
           quant_mode="noise")
