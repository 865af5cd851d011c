"""Training losses and gradients, port against ``dcvc_tpu`` on the CPU.

For DMC (its one width, 64 x 64), DMCHem and CANFVCDmc (16 / 16 /
24, as ``tests/test_train_fidelity.py`` builds DMCHem) and EVCIntra (16 /
16 / 24 / 32, N = 32), seeded *port* weights go to JAX with the
``dcvc_tpu/utils/port_*.py`` converters (no JAX model init). One jitted
JAX program per model computes the STE RD loss and the noise-mode forward
(the rate surrogate, with both packages' ``quant_noise`` replaced in this
file by the same numpy draws), and the gradients:

* of the whole model's loss, ``jax.value_and_grad``, for DMC, DMCHem and
  EVCIntra; the port computes the same with ``backward``;
* for CANFVCDmc, whose networks but one are DMCHem's
  classes at DMCHem's widths (its CANF ladder is two of DMCHem's
  contextual encoders, decoders and recon nets, joined by additions): the
  DQ post-filter's VJP (``jax.vjp``, ``torch.autograd.grad``) of a seeded
  random cotangent, at the input it got in the port's STE forward, as to
  its parameters and its input. CANFVCDmc's whole-model backward was one
  of the largest programs the port's tests compile, for no op that
  DMCHem's whole-model gradient does not check; its STE loss and noise
  forward stay whole-model.

JAX gradients come back in the port's names through
``dcvc_tpu_torch/utils/convert.py``.

Both packages compute in float64 here (``jax.enable_x64``, the port module
``.double()``). In float32 the gradient of this loss is ill-conditioned at
seeded weights: the bit estimators' ``clamp_min(bits, 0)`` and the
probability floors switch an element's gradient on or off within a few
ulps, so two correct float32 implementations differ by up to ~1.4e-2
relative L2 on some tensors (DMC's ``mv_y_prior_fusion`` biases here; the
port's own float32 gradient is ~3.5e-3 from its float64 one at 128 px).
In float64 the two packages agree to ~1e-13. The Gaussian bit estimate
(EVC) evaluates ``ndtr`` in float32 in both packages, whose two ``ndtr``
implementations differ by an ulp; in this file both packages'
``bits.gaussian_cdf`` take their float64 ``ndtr`` instead. The float32
forwards are held in ``test_torch_port_train_noise.py`` and the trainer
file.

Tolerances: loss rtol 1e-5; every parameter's (and the DQ input's)
gradient relative L2 gap <= 1e-3; noise-mode bpp parts and recon rtol
1e-5, atol 1e-5. The exact warp's gradient (float32) with flows
that leave the frame: rtol 1e-4, atol 1e-5 against the JAX package's naive
VJP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.entropy import bits as jbits
from dcvc_tpu.models import priors as jpriors
from dcvc_tpu.models.evc import EVCIntra as JEVCIntra
from dcvc_tpu.models.video_canf import CANFVCDmc as JCANFVCDmc
from dcvc_tpu.models.video_dc import DMC as JDMC
from dcvc_tpu.models.video_hem import DMCHem as JDMCHem
from dcvc_tpu.ops import warp as jwarp
from dcvc_tpu.training import step as jstep
from dcvc_tpu.utils import port_dc, port_hem
from dcvc_tpu_torch.entropy import bits as tbits
from dcvc_tpu_torch.models import priors as tpriors
from dcvc_tpu_torch.models.evc import EVCIntra
from dcvc_tpu_torch.models.video_canf import CANFVCDmc
from dcvc_tpu_torch.models.video_dc import DMC
from dcvc_tpu_torch.models.video_hem import DMCHem
from dcvc_tpu_torch.ops.warp import flow_warp
from dcvc_tpu_torch.training import step as tstep
from dcvc_tpu_torch.utils import convert
from _flax_init import flax_param_checks  # noqa: F401 (autouse)

P_WIDTHS = {"channel_mv": 16, "channel_N": 16, "channel_M": 24}
EVC_CH = (16, 16, 24, 32)
LOSS_RTOL, GRAD_REL_L2 = 1e-5, 1e-3
NOISE_TOL = {"rtol": 1e-5, "atol": 1e-5}
LAMBDAS = np.asarray([380.0], np.float32)
B, H, W = 1, 64, 64


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


def _draw(k, shape_nchw):
    rng = np.random.default_rng([7, k])
    return rng.uniform(-0.5, 0.5, shape_nchw)


def _patch_noise(monkeypatch):
    """Both packages' quant_noise add the k-th numpy draw of the caller's
    NCHW shape (the JAX side in NHWC); returns the per-package call lists."""
    calls = {"port": [], "jax": []}

    def port(x, generator, rows=True):
        calls["port"].append(tuple(x.shape))
        return x + torch.from_numpy(_draw(len(calls["port"]) - 1,
                                          tuple(x.shape)))

    def jx(x, key):
        b, h, w, c = x.shape
        calls["jax"].append((b, c, h, w))
        d = _draw(len(calls["jax"]) - 1, (b, c, h, w))
        return x + jnp.asarray(d.transpose(0, 2, 3, 1))

    monkeypatch.setattr(tpriors, "quant_noise", port)
    monkeypatch.setattr(jpriors, "quant_noise", jx)
    monkeypatch.setattr(tbits, "gaussian_cdf",
                        lambda x, scale: torch.special.ndtr(x / scale))
    monkeypatch.setattr(jbits, "gaussian_cdf",
                        lambda x, scale: jax.scipy.special.ndtr(x / scale))
    return calls


def _clip(T=2, seed=31):
    """A float64 clip [B, T, H, W, 3]."""
    rng = np.random.default_rng(seed)
    base = rng.random((B, H // 8 + T, W // 8 + T, 3))
    big = np.kron(base, np.ones((1, 8, 8, 1)))
    return np.stack([np.clip(big[:, 2 * t:2 * t + H, 3 * t:3 * t + W]
                             + 0.05 * rng.random((B, H, W, 3)), 0, 1)
                     for t in range(T)], axis=1)


def _port_grads(module) -> dict:
    return {n: (np.zeros(p.shape) if p.grad is None
                else p.grad.numpy().copy())
            for n, p in module.named_parameters()}


def _jax_grads(grads, from_jax) -> dict:
    """JAX gradients in the port's names (the converters are linear)."""
    sd = from_jax(jax.tree_util.tree_map(np.asarray, grads))
    return {k: v.numpy() for k, v in sd.items()}


def _port_module_vjp(tm, path, x, cot):
    """Parameter and input gradients of ``sum(tm.<path>(x) * cot)``."""
    x = x.detach().clone().requires_grad_(True)
    names, params = zip(*tm.named_parameters())
    g = torch.autograd.grad((tm.get_submodule(path)(x) * cot).sum(),
                            list(params) + [x], allow_unused=True)
    return ({n: (np.zeros(p.shape) if t is None else t.numpy())
             for n, p, t in zip(names, params, g)}, g[-1].numpy())


def _ste_loss_and_noise(monkeypatch, tm, jm, params, jfwd, tfwd,
                        module=None):
    """``jfwd(params, mode)`` / ``tfwd(mode, generator)`` -> (x, out,
    recon). One jitted JAX program gives the STE loss, the noise forward
    and the gradients: of the whole loss when ``module`` is None, else
    the VJP of the submodule ``module = (port path, JAX path)`` at the
    input it got in the port's STE forward."""
    calls = _patch_noise(monkeypatch)
    lam = jnp.asarray(LAMBDAS, jnp.float64)
    tlam = torch.from_numpy(LAMBDAS).double()

    def jloss(p):
        x, out, recon = jfwd(p, "ste")
        return jstep.rd_loss(x, recon, out["bpp"], lam)

    if module is None:
        x, out, recon = tfwd("ste", None)
        tl = tstep.rd_loss(x, recon, out["bpp"], tlam)
        tm.zero_grad(set_to_none=True)
        tl.backward()
        tg = _port_grads(tm)

        @jax.jit
        def program(p):
            loss, grads = jax.value_and_grad(jloss)(p)
            _, out, recon = jfwd(p, "noise")
            return loss, grads, out, recon

        jl, jg, jout, jrecon = program(params)
    else:
        path, jpath = module
        seen = []
        hook = tm.get_submodule(path).register_forward_pre_hook(
            lambda _, args: seen.append(args[0]))
        try:
            with torch.no_grad():
                x, out, recon = tfwd("ste", None)
                tl = tstep.rd_loss(x, recon, out["bpp"], tlam)
        finally:
            hook.remove()
        mx = seen[0]
        cot = torch.from_numpy(np.random.default_rng(45).standard_normal(
            tuple(mx.shape)))
        tg = _port_module_vjp(tm, path, mx, cot)

        @jax.jit
        def program(p, mx, cot):
            _, vjp = jax.vjp(lambda p, a: jm.apply(
                p, a, method=lambda m, a: getattr(m, jpath)(a)), p, mx)
            _, out, recon = jfwd(p, "noise")
            return jloss(p), vjp(cot), out, recon

        jl, jg, jout, jrecon = program(params, jnp.asarray(_nhwc(mx)),
                                       jnp.asarray(_nhwc(cot)))
    assert jl.dtype == jnp.float64
    with torch.no_grad():
        _, tout, trecon = tfwd("noise", torch.Generator().manual_seed(0))
    assert calls["port"] == calls["jax"] and len(calls["port"]) >= 2
    return {"loss": (float(tl.detach()), float(jl)), "grads": (tg, jg),
            "noise": (tout, jout, trecon, jrecon),
            "ste": (out["bpp_y"].detach(), recon.detach())}


def _dmc(monkeypatch):
    torch.manual_seed(41)
    tm = DMC(od_warp_mode="exact").double()
    params = port_dc.convert_dmc(_sd(tm))
    jm = JDMC(od_warp_mode="exact")
    clip = _clip()
    q = np.ones((B, 1, 1, 1))
    jqs = {k: jnp.asarray(q) for k in ("mv_enc", "mv_dec", "y_enc", "y_dec")}
    tqs = {k: torch.from_numpy(q) for k in jqs}
    jdpb = {"ref_frame": jnp.asarray(clip[:, 0]), "ref_feature": None,
            "ref_mv_feature": None, "ref_y": None, "ref_mv_y": None}
    tdpb = dict(jdpb, ref_frame=_nchw(clip[:, 0]))
    jx, tx = jnp.asarray(clip[:, 1]), _nchw(clip[:, 1])

    def jfwd(p, mode):
        out = jm.apply(p, jx, jdpb, jqs, 1, mode,
                       rngs={"noise": jax.random.PRNGKey(0)})
        return jx, out, out["dpb"]["ref_frame"]

    def tfwd(mode, gen):
        out = tm(tx, tdpb, tqs, 1, mode, generator=gen)
        return tx, out, out["dpb"]["ref_frame"]

    return tm, jm, params, jfwd, tfwd, convert.dmc_from_jax


def _hem_like(monkeypatch, canf: bool):
    torch.manual_seed(42)
    if canf:
        tm, jm = CANFVCDmc(**P_WIDTHS).double(), JCANFVCDmc(**P_WIDTHS)
        params, from_jax = (port_hem.convert_canf_dmc(_sd(tm)),
                            convert.canf_dmc_from_jax)
    else:
        tm, jm = DMCHem(**P_WIDTHS).double(), JDMCHem(**P_WIDTHS)
        params, from_jax = (port_hem.convert_dmc_hem(_sd(tm)),
                            convert.dmc_hem_from_jax)
    clip = _clip()
    q = np.ones((B, 1, 1, 1))
    jdpb = {"ref_frame": jnp.asarray(clip[:, 0]), "ref_feature": None,
            "ref_y": None, "ref_mv_y": None}
    tdpb = dict(jdpb, ref_frame=_nchw(clip[:, 0]))
    jx, tx = jnp.asarray(clip[:, 1]), _nchw(clip[:, 1])

    def jfwd(p, mode):
        out = jm.apply(p, jx, jdpb, jnp.asarray(q), jnp.asarray(q), mode,
                       rngs={"noise": jax.random.PRNGKey(0)})
        return jx, out, out["dpb"]["ref_frame"]

    def tfwd(mode, gen):
        qq = torch.from_numpy(q)
        out = tm(tx, tdpb, qq, qq, mode, generator=gen)
        return tx, out, out["dpb"]["ref_frame"]

    return tm, jm, params, jfwd, tfwd, from_jax


def _evc(monkeypatch):
    torch.manual_seed(43)
    tm = EVCIntra(EVC_CH, EVC_CH, 32).double()
    params = port_dc.convert_evc(_sd(tm))
    jm = JEVCIntra(EVC_CH, EVC_CH, 32)
    x = _clip()[:, 1]
    q = np.full((B, 1, 1, 1), 0.8)
    jx, tx = jnp.asarray(x), _nchw(x)

    def jfwd(p, mode):
        out = jm.apply(p, jx, jnp.asarray(q), mode,
                       rngs={"noise": jax.random.PRNGKey(0)})
        return jx, out, out["x_hat"]

    def tfwd(mode, gen):
        out = tm(tx, torch.from_numpy(q), mode, generator=gen)
        return tx, out, out["x_hat"]

    return tm, jm, params, jfwd, tfwd, convert.evc_from_jax


BUILD = {"dmc": _dmc, "dmc_hem": lambda mp: _hem_like(mp, False),
         "canfvc_dmc": lambda mp: _hem_like(mp, True), "evc": _evc}
NOISE_KEYS = {"dmc": ("bpp", "bpp_y", "bpp_z", "bpp_mv_y", "bpp_mv_z"),
              "dmc_hem": ("bpp", "bpp_y", "bpp_z", "bpp_mv_y", "bpp_mv_z",
                          "me_mse"),
              "canfvc_dmc": ("bpp", "bpp_y", "bpp_z", "bpp_mv_y",
                             "bpp_mv_z", "me_mse", "x2_mse"),
              "evc": ("bpp", "bpp_y", "bpp_z")}


# CANFVCDmc's one network that is not a DMCHem class: its DQ post-filter
MODULE_VJP = {"canfvc_dmc": ("DQ", "dq")}


@pytest.fixture(scope="module", params=list(BUILD))
def model_run(request):
    """(name, results of one STE loss / gradient / noise-forward run)."""
    mp = pytest.MonkeyPatch()
    module = MODULE_VJP.get(request.param)
    try:
        with jax.enable_x64(True):
            tm, jm, params, jfwd, tfwd, from_jax = BUILD[request.param](mp)
            res = _ste_loss_and_noise(mp, tm, jm, params, jfwd, tfwd, module)
    finally:
        mp.undo()
    tg, jg = res["grads"]
    if module is None:
        res["grads"] = (tg, _jax_grads(jg, from_jax), None, None)
    else:
        res["grads"] = (tg[0], _jax_grads(jg[0], from_jax),
                        tg[1].transpose(0, 2, 3, 1), np.asarray(jg[1]))
    return request.param, res


def test_ste_loss_matches_jax(model_run):
    _, res = model_run
    tl, jl = res["loss"]
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)


def _rel(t, j):
    den = np.linalg.norm(j)
    num = np.linalg.norm(t - j)
    return num / den if den > 0 else (0.0 if num == 0 else np.inf)


def test_ste_gradients_match_jax(model_run):
    """Every parameter tensor's gradient within 1e-3 relative L2 of JAX's
    (zero where neither package's loss reaches it): of the whole loss, or
    of the one module's VJP, whose input's gradient is held the same way."""
    name, res = model_run
    tg, jg, tin, jin = res["grads"]
    assert set(tg) == set(jg), set(tg) ^ set(jg)
    worst = max((_rel(tg[k], g), k) for k, g in jg.items())
    assert worst[0] <= GRAD_REL_L2, worst
    reached = sum(np.any(g != 0) for g in jg.values())
    if tin is None:
        assert reached > len(jg) // 2
    else:
        assert reached and _rel(tin, jin) <= GRAD_REL_L2, _rel(tin, jin)


def test_noise_forward_matches_jax(model_run):
    """The noise-mode forward against JAX's; noise leaves the port's recon
    equal to STE's (only the rate takes the noise)."""
    name, res = model_run
    tout, jout, trecon, jrecon = res["noise"]
    for k in NOISE_KEYS[name]:
        np.testing.assert_allclose(np.asarray(tout[k]), np.asarray(jout[k]),
                                   err_msg=k, **NOISE_TOL)
    np.testing.assert_allclose(_nhwc(trecon), np.asarray(jrecon),
                               **NOISE_TOL)
    ste_bpp_y, ste_recon = res["ste"]
    torch.testing.assert_close(trecon, ste_recon, rtol=0, atol=0)
    assert not torch.equal(tout["bpp_y"], ste_bpp_y)


def test_exact_warp_gradient_at_the_border_matches_jax():
    """Flows that push samples out of the frame on every side: the exact
    warp's gradients (F.grid_sample, border) against the JAX package's
    naive formulation's VJP, for the image and the flow."""
    rng = np.random.default_rng(44)
    Bw, C, Hh, Ww = 2, 3, 12, 16
    im = rng.random((Bw, Hh, Ww, C)).astype(np.float32)
    flow = rng.uniform(-6, 6, (Bw, Hh, Ww, 2)).astype(np.float32)
    flow[:, :2, :, 1] -= 9.3        # above the top
    flow[:, -2:, :, 1] += 9.7       # below the bottom
    flow[:, :, :3, 0] -= 11.1       # left of the left edge
    flow[:, :, -3:, 0] += 12.4      # right of the right edge
    g = rng.standard_normal((Bw, Hh, Ww, C)).astype(np.float32)
    _, vjp = jax.vjp(jwarp._flow_warp_naive, jnp.asarray(im),
                     jnp.asarray(flow))
    jg_im, jg_flow = vjp(jnp.asarray(g))
    tim = _nchw(im).requires_grad_(True)
    tflow = _nchw(flow).requires_grad_(True)
    (flow_warp(tim, tflow) * _nchw(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(tim.grad), np.asarray(jg_im),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_nhwc(tflow.grad), np.asarray(jg_flow),
                               rtol=1e-4, atol=1e-5)
    out_of_frame = np.abs(np.asarray(jg_flow)) == 0
    assert out_of_frame.mean() > 0.2    # the clamped taps give no gradient
