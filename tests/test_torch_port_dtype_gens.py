"""The port's ``dtype`` option (bf16 compute on f32 parameters) for HEM,
CANF-VC, TCM, gen-1 and the CompressAI zoo, against the JAX package's, on
the CPU.

Weights are seeded *port* weights at small widths carried to JAX with
``dcvc_tpu/utils/port_{hem,tcm,gen1,zoo}.py`` (no JAX model init); inputs
are seeded numpy. Both sides run ``dtype=bfloat16``. Each model's module
cases run in one jitted JAX program per model.

The helpers and tolerances are ``tests/test_torch_port_dtype.py``'s: each
output within ``ULPS_BLOCK`` (one block) or ``ULPS_NET`` (a stack of
blocks) bf16 ulps of its largest magnitude, dtypes equal. Output dtype
trees come from ``jax.eval_shape`` (no compile); the zoo's JAX forward
also returns its training ``aux_loss``, which the port's does not.

The dtype reaches what the JAX constructors give it to: every layer of
HEM, CANF and TCM but their bit estimators and GDNs; gen-1's flow net,
residual blocks and entropy parameters only; the zoo's analysis and
synthesis transforms (Cheng2020: their blocks) and entropy parameters. So
``canfvc_dmc``'s compress DPB, gen-1's and ``cheng2020-anchor``'s outputs
come back f32. ``mbt2018`` takes no dtype (ROADMAP R4): the JAX package's
``MaskedConv2d`` refuses its bf16 latent.

The JAX exact warp computes source positions in the flow's dtype (ROADMAP
R3); the JAX programs here run with the repair of
``tests/test_torch_port_dtype.py`` (``jax_r3_repair``), applied also to
the CANF module's own ``flow_warp`` binding.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcvc_tpu.models.video_canf as jcanf_mod
import dcvc_tpu.ops.warp as jwarp
from dcvc_tpu.layers import blocks as jb
from dcvc_tpu.layers.gdn import GDN as JGDN
from dcvc_tpu.layers.gdn import GDN1 as JGDN1
from dcvc_tpu.models import intra_zoo as jzoo
from dcvc_tpu.models.intra_hem import IntraNoARHem as JIntraNoARHem
from dcvc_tpu.models.video_canf import CANFVCDmc as JCANFVCDmc
from dcvc_tpu.models.video_dcvc import DCVCNet as JDCVCNet
from dcvc_tpu.models.video_hem import DMCHem as JDMCHem
from dcvc_tpu.models.video_tcm import DMCTcm as JDMCTcm
from dcvc_tpu.utils import port_gen1, port_hem, port_tcm, port_zoo
from dcvc_tpu_torch.layers import blocks as tb
from dcvc_tpu_torch.layers.gdn import GDN, GDN1
from dcvc_tpu_torch.models import registry
from dcvc_tpu_torch.models.intra_hem import IntraNoARHem
from dcvc_tpu_torch.models.intra_zoo import build_zoo
from dcvc_tpu_torch.models.runtime import HemVideoRuntime, TcmVideoRuntime
from dcvc_tpu_torch.models.video_canf import CANFVCDmc
from dcvc_tpu_torch.models.video_dcvc import DCVCNet
from dcvc_tpu_torch.models.video_hem import DMCHem
from dcvc_tpu_torch.models.video_tcm import DMCTcm
from dcvc_tpu_torch.utils.convert import ZOO_KINDS
from test_torch_port_dtype import (ULPS_BLOCK, ULPS_NET, _check, _frames,
                                   _jtree, _nchw, _sd, _Tap, _ttree)
from _flax_init import flax_param_checks  # noqa: F401 (autouse)

BF = torch.bfloat16
JBF = jnp.bfloat16
P_WIDTHS = {"channel_mv": 16, "channel_N": 16, "channel_M": 24}
ZOO_W = {"N": 16, "M": 24}
TOL, DESYNC = 4e-3, 0.05    # tools/check_tpu_roundtrip.py:37-38


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six pytest workers on one host: two torch threads each
    keeps torch's spinning OpenMP pool from starving the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _r3_repaired():
    """``jax_r3_repair`` for a module-scoped fixture: the JAX exact warp
    with an f32 flow, its output in the image's dtype; CANF binds
    ``flow_warp`` at import, so its binding is patched too."""
    orig = jwarp.flow_warp

    def repaired(im, flow):
        return orig(im, flow.astype(jnp.float32)).astype(im.dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwarp, "flow_warp", repaired)
        mp.setattr(jcanf_mod, "flow_warp", repaired)
        yield


def _seeded(make, seed):
    torch.manual_seed(seed)
    return make().eval()


def _input(rng, shape, kind):
    """(JAX array, port tensor) of one seeded input: ``f32`` / ``bf16``
    values ~N(0, 1), ``flow`` a bf16 field of a few pixels, ``f32flow`` the
    same in f32, ``img`` f32 in [0, 1)."""
    if kind == "img":
        a = rng.random(shape)
    else:
        a = rng.normal(size=shape) * (3.0 if "flow" in kind else 1.0)
    a = a.astype(np.float32)
    bf = kind in ("bf16", "flow")
    return (jnp.asarray(a).astype(JBF if bf else jnp.float32),
            _nchw(a, BF if bf else torch.float32))


def _ctx(n, hw=64):
    """The three context scales of an n-channel pyramid at ``hw``."""
    return [((1, hw, hw, n), "bf16"), ((1, hw // 2, hw // 2, n), "bf16"),
            ((1, hw // 4, hw // 4, n), "bf16")]


def _tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else out


# (port fn, JAX fn, inputs) per case; the port fns take NCHW tensors, the
# JAX fns the flax module and NHWC arrays
HEM_CASES = {
    "mv_encoder": (lambda t, f: t.mv_encoder(f),
                   lambda m, f: m.mv_encoder(f), [((1, 64, 64, 2), "flow")]),
    "mv_decoder": (lambda t, y: t.mv_decoder(y),
                   lambda m, y: m.mv_decoder(y), [((1, 4, 4, 16), "f32")]),
    "mv_hyper_dec": (lambda t, z: t.mv_hyper_prior_decoder(z),
                     lambda m, z: m.mv_hyper_prior_decoder(z),
                     [((1, 1, 1, 16), "f32")]),
    "mv_prior_fusion": (lambda t, p: t.mv_y_prior_fusion(p),
                        lambda m, p: m.mv_y_prior_fusion(p),
                        [((1, 4, 4, 48), "bf16")]),
    "feature_extractor": (lambda t, f: t.feature_extractor(f),
                          lambda m, f: m.feature_extractor(f),
                          [((1, 64, 64, 16), "bf16")]),
    "context_fusion": (lambda t, *c: t.context_fusion_net(*c),
                       lambda m, *c: m.context_fusion_net(*c), _ctx(16)),
    "motion_compensation": (
        lambda t, r, mv: (*(o := t.motion_compensation(
            {"ref_frame": r, "ref_feature": None}, mv))[0], o[1]),
        lambda m, r, mv: m.motion_compensation(
            {"ref_frame": r, "ref_feature": None}, mv),
        [((1, 64, 64, 3), "bf16"), ((1, 64, 64, 2), "flow")]),
    "contextual_encoder": (lambda t, x, *c: t.contextual_encoder(x, *c),
                           lambda m, x, *c: m.contextual_encoder(x, *c),
                           [((1, 64, 64, 3), "img"), *_ctx(16)]),
    "contextual_hyper_enc": (lambda t, y: t.contextual_hyper_prior_encoder(y),
                             lambda m, y: m.contextual_hyper_prior_encoder(y),
                             [((1, 4, 4, 24), "f32")]),
    "temporal_prior": (lambda t, c: t.temporal_prior_encoder(c),
                       lambda m, c: m.temporal_prior_encoder_2(jb.leaky_relu(
                           m.temporal_prior_encoder_1(c), 0.1)),
                       [((1, 16, 16, 16), "bf16")]),
    "contextual_decoder": (lambda t, y, *c: t.contextual_decoder(y, *c),
                           lambda m, y, *c: m.contextual_decoder(y, *c),
                           [((1, 4, 4, 24), "f32"), *_ctx(16)[1:]]),
    "recon_generation": (lambda t, c, r: t.recon_generation_net(c, r),
                         lambda m, c, r: m.recon_generation_net(c, r),
                         [((1, 64, 64, 32), "bf16"),
                          ((1, 64, 64, 16), "bf16")]),
}
CANF_CASES = {
    "canf_encode": (lambda t, x, *c: t.contextual_coder.encode(x, c),
                    lambda m, x, *c: m.contextual_coder.encode(x, c),
                    [((1, 64, 64, 3), "img"), *_ctx(16)]),
    "canf_decode": (lambda t, y, *c: t.contextual_coder.decode(
                        torch.zeros(1, 3, 64, 64), c, y),
                    lambda m, y, *c: m.contextual_coder.decode(
                        jnp.zeros((1, 64, 64, 3)), c, y),
                    [((1, 4, 4, 24), "f32"), *_ctx(16)]),
    "dequantization": (lambda t, x: t.DQ(x), lambda m, x: m.dq(x),
                       [((1, 64, 64, 3), "img")]),
}
INTRA_HEM_CASES = {
    "intra_hem_enc": (lambda t, x: t.enc(x), lambda m, x: m.enc(x),
                      [((1, 64, 64, 3), "img")]),
    "intra_hem_dec_refine": (lambda t, y: t.reconstruct(y),
                             lambda m, y: m.refine_conv(m.refine_unet(
                                 m.dec(y))), [((1, 4, 4, 32), "f32")]),
    "intra_hem_hyper": (lambda t, y: t.hyper_enc(y),
                        lambda m, y: m.hyper_enc(y), [((1, 4, 4, 32), "f32")]),
    "intra_hem_prior": (lambda t, z: t.prior_params(z),
                        lambda m, z: m.prior_params(z),
                        [((1, 1, 1, 32), "f32")]),
    "intra_hem_spatial_prior": (lambda t, p: t.spatial_prior_chunks(p),
                                lambda m, p: m.spatial_prior_chunks(p),
                                [((1, 4, 4, 128), "bf16")]),
}
TCM_CASES = {
    "tcm_mv_encoder": (lambda t, f: t.mv_encoder(f),
                       lambda m, f: m.mv_encoder(f),
                       [((1, 64, 64, 2), "flow")]),
    "tcm_mv_prior": (lambda t, z: t.decode_mv_params(z),
                     lambda m, z: m.decode_mv_params(z),
                     [((1, 1, 1, 16), "f32")]),
    "tcm_mv_decoder": (lambda t, y: t.mv_decoder(y),
                       lambda m, y: m.mv_decoder(y),
                       [((1, 4, 4, 16), "bf16")]),
    "tcm_contextual_encoder": (lambda t, x, *c: t.contextual_encoder(x, *c),
                               lambda m, x, *c: m.contextual_encoder(x, *c),
                               [((1, 64, 64, 3), "img"), *_ctx(16)]),
    "tcm_gaussian_params": (lambda t, z, *c: t.y_gaussian_params(z, *c),
                            lambda m, z, *c: m.y_gaussian_params(z, *c),
                            [((1, 1, 1, 16), "f32"), *_ctx(16)]),
    "tcm_contextual_decoder": (
        lambda t, y, c2, c3: t.contextual_decoder(y, c2, c3),
        lambda m, y, c2, c3: m.contextual_decoder(y, c2, c3),
        [((1, 4, 4, 24), "bf16"), *_ctx(16)[1:]]),
    "tcm_recon_generation": (lambda t, c, r: t.recon_generation_net(c, r),
                             lambda m, c, r: m.recon_generation_net(c, r),
                             [((1, 64, 64, 32), "bf16"),
                              ((1, 64, 64, 16), "bf16")]),
}
GEN1_CASES = {
    "gen1_mv_encoder": (lambda t, f: t.mvEncoder(f),
                        lambda m, f: m.mv_encoder(f),
                        [((1, 64, 64, 2), "flow")]),
    "gen1_motion_compensation": (lambda t, r, mv: t.motion_compensation(r, mv),
                                 lambda m, r, mv: m.motion_compensation(r, mv),
                                 [((1, 64, 64, 3), "img"),
                                  ((1, 64, 64, 2), "f32flow")]),
    "gen1_contextual_encoder": (
        lambda t, x, c: t.contextualEncoder(torch.cat([x, c], 1)),
        lambda m, x, c: m.contextual_encoder(x, c),
        [((1, 64, 64, 3), "img"), ((1, 64, 64, 16), "f32")]),
    "gen1_contextual_decoder": (
        lambda t, y, c: t.contextual_decoder(y, c),
        lambda m, y, c: m.contextual_decoder_part2(
            m.contextual_decoder_part1(y), c),
        [((1, 4, 4, 24), "f32"), ((1, 64, 64, 16), "f32")]),
    "gen1_entropy_parameters": (lambda t, p: t.entropy_parameters(p),
                                lambda m, p: m.entropy_parameters(p),
                                [((1, 4, 4, 96), "f32")]),
}
HYPER_CASES = {
    "zoo_g_a": (lambda t, x: t.g_a(x), lambda m, x: m.g_a(x),
                [((1, 64, 64, 3), "img")]),
    "zoo_g_s": (lambda t, y: t.g_s(y), lambda m, y: m.g_s(y),
                [((1, 4, 4, 24), "f32")]),
    "zoo_h_a": (lambda t, y: t.h_a(torch.abs(y)), lambda m, y: m.h_a(y),
                [((1, 4, 4, 24), "bf16")]),
}
FACTORIZED_CASES = {k: HYPER_CASES[k] for k in ("zoo_g_a", "zoo_g_s")}
MEAN_CASES = {
    **FACTORIZED_CASES,
    "zoo_mean_h_a": (lambda t, y: t.h_a(y), lambda m, y: m.h_a(y),
                     [((1, 4, 4, 24), "bf16")]),
    "zoo_params_from_z": (lambda t, z: t.params_from_z(z),
                          lambda m, z: m.params_from_z(z),
                          [((1, 1, 1, 16), "f32")]),
}
CHENG_CASES = {
    "cheng_g_a": (lambda t, x: t.g_a(x), lambda m, x: m.g_a(x),
                  [((1, 64, 64, 3), "img")]),
    "cheng_g_s": (lambda t, y: t.g_s(y), lambda m, y: m.g_s(y),
                  [((1, 4, 4, 16), "f32")]),
    "cheng_entropy_parameters": (lambda t, p: t.entropy_parameters(p),
                                 lambda m, p: m.entropy_parameters(p),
                                 [((1, 4, 4, 64), "f32")]),
}


def _hem():
    tm = _seeded(lambda: DMCHem(**P_WIDTHS, dtype=BF), 61)
    return (tm, JDMCHem(**P_WIDTHS, dtype=JBF),
            port_hem.convert_dmc_hem(_sd(tm)))


def _canf():
    tm = _seeded(lambda: CANFVCDmc(**P_WIDTHS, dtype=BF), 62)
    return (tm, JCANFVCDmc(**P_WIDTHS, dtype=JBF),
            port_hem.convert_canf_dmc(_sd(tm)))


def _intra_hem():
    tm = _seeded(lambda: IntraNoARHem(32, dtype=BF), 63)
    return tm, JIntraNoARHem(N=32, dtype=JBF), port_hem.convert_intra_hem(
        _sd(tm))


def _tcm():
    tm = _seeded(lambda: DMCTcm(**P_WIDTHS, dtype=BF), 64)
    return tm, JDMCTcm(**P_WIDTHS, dtype=JBF), port_tcm.convert_dmc_tcm(
        _sd(tm))


def _gen1():
    tm = _seeded(lambda: DCVCNet(**P_WIDTHS, dtype=BF), 65)
    return tm, JDCVCNet(**P_WIDTHS, dtype=JBF), port_gen1.convert_dcvc_gen1(
        _sd(tm))


def _zoo(name, seed):
    w = {"N": 16} if name == "cheng2020-anchor" else ZOO_W
    tm = build_zoo(name, seed=seed, device="cpu", dtype=BF, **w)
    jw = {"N": 16, "M": 16} if name == "cheng2020-anchor" else ZOO_W
    return (tm, jzoo.model_architectures[name](**jw, dtype=JBF),
            port_zoo.convert_zoo(_sd(tm), ZOO_KINDS[name]))


MODELS = {"dmc_hem": (_hem, HEM_CASES), "canfvc_dmc": (_canf, CANF_CASES),
          "intra_hem": (_intra_hem, INTRA_HEM_CASES),
          "dmc_tcm": (_tcm, TCM_CASES), "dcvc_gen1": (_gen1, GEN1_CASES),
          "bmshj2018-factorized": (lambda: _zoo("bmshj2018-factorized", 68),
                                   FACTORIZED_CASES),
          "bmshj2018-hyperprior": (lambda: _zoo("bmshj2018-hyperprior", 66),
                                   HYPER_CASES),
          "mbt2018-mean": (lambda: _zoo("mbt2018-mean", 69), MEAN_CASES),
          "cheng2020-anchor": (lambda: _zoo("cheng2020-anchor", 67),
                               CHENG_CASES)}
CASES = [(model, case) for model, (_, cases) in MODELS.items()
         for case in cases]
_RUNS = {}


def _run(model):
    """(port outputs, JAX outputs) of every case of ``model``: one jitted
    JAX program for all of them, under the R3 repair."""
    if model not in _RUNS:
        make, cases = MODELS[model]
        tm, jm, params = make()
        rng = np.random.default_rng(17)
        jin, tin = {}, {}
        for name, (_, _, inputs) in cases.items():
            pairs = [_input(rng, shape, kind) for shape, kind in inputs]
            jin[name] = [j for j, _ in pairs]
            tin[name] = [t for _, t in pairs]

        def program(p, ins):
            return {n: jm.apply(p, *ins[n], method=cases[n][1])
                    for n in cases}

        with _r3_repaired():
            jout = jax.jit(program)(params, jin)
        with torch.no_grad():
            tout = {n: cases[n][0](tm, *tin[n]) for n in cases}
        _RUNS[model] = tout, jout
    return _RUNS[model]


@pytest.mark.parametrize("model,case", CASES)
def test_module_bf16_matches_jax(model, case):
    tout, jout = _run(model)
    deep = case not in ("mv_hyper_dec", "mv_prior_fusion",
                        "contextual_hyper_enc", "temporal_prior",
                        "tcm_mv_prior", "intra_hem_hyper", "zoo_h_a",
                        "zoo_mean_h_a", "zoo_params_from_z",
                        "gen1_entropy_parameters", "cheng_entropy_parameters")
    _check(_tuple(tout[case]), _tuple(jout[case]),
           ULPS_NET if deep else ULPS_BLOCK, f"{model} {case}")


# ---- GDN and the f32-promoting convolution on bf16 inputs ----

@pytest.mark.parametrize("kind", ["gdn", "igdn", "gdn1"])
def test_gdn_bf16_input_gives_f32_as_jax(kind):
    """GDN has no compute dtype: x * x (|x|) rounds in bf16, then the f32
    gamma widens it; the output is f32."""
    rng = np.random.default_rng(3)
    C = 12
    tm = (GDN1 if kind == "gdn1" else GDN)(C, inverse=kind == "igdn")
    with torch.no_grad():
        tm.gamma.copy_(torch.from_numpy(
            rng.uniform(0.0, 0.4, (C, C)).astype(np.float32)))
    jm = (JGDN1 if kind == "gdn1" else JGDN)(C, inverse=kind == "igdn")
    jx, tx = _input(rng, (1, 9, 7, C), "bf16")
    jout = jm.apply({"params": _sd(tm)}, jx)
    with torch.no_grad():
        tout = tm(tx)
    assert tout.dtype == torch.float32
    _check(tout, jout, ULPS_BLOCK, kind)


@pytest.mark.parametrize("kind", ["conv", "deconv", "linear"])
def test_f32_layer_promotes_a_bf16_input_as_flax(kind):
    """A layer without a compute dtype widens a bf16 input to its f32
    parameters, as flax's ``promote_dtype`` does (gen-1's and the zoo's
    f32 layers after bf16 blocks); torch's own layer would refuse it."""
    rng = np.random.default_rng(4)
    torch.manual_seed(4)
    if kind == "conv":
        tm, jm = tb.Conv2d(8, 6, 3, padding=1), jb.conv(6, 3, 1)
        params = {"kernel": tm.weight.detach().numpy().transpose(2, 3, 1, 0),
                  "bias": tm.bias.detach().numpy()}
        shape = (1, 10, 12, 8)
    elif kind == "deconv":
        from dcvc_tpu.utils import torch_port as tp

        tm, jm = tb.deconv(8, 6, 3, 2), jb.deconv(6, 3, 2)
        params = {"kernel": tp.conv_transpose_kernel(tm.weight.detach()
                                                     .numpy()),
                  "bias": tm.bias.detach().numpy()}
        shape = (1, 10, 12, 8)
    else:
        import flax.linen as fnn

        tm, jm = tb.Linear(8, 6, bias=False), fnn.Dense(6, use_bias=False)
        params = {"kernel": tm.weight.detach().numpy().T}
        shape = (3, 8)
    x = rng.normal(size=shape).astype(np.float32)
    jout = jm.apply({"params": params}, jnp.asarray(x).astype(JBF))
    tx = (_nchw(x, BF) if len(shape) == 4 else torch.from_numpy(x).to(BF))
    with torch.no_grad():
        tout = tm(tx)
        want = tm(tx.float())
    assert tout.dtype == torch.float32 and str(jout.dtype) == "float32"
    assert torch.equal(tout, want)      # the widened bf16 input, no more
    if len(shape) == 4:
        _check(tout, jout, ULPS_BLOCK, kind)
    else:
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-6)


# ---- output dtype trees of the nine names, against jax.eval_shape ----

def _dpb_hem(ref):
    return {"ref_frame": ref, "ref_feature": None, "ref_y": None,
            "ref_mv_y": None}


def _trees(name):
    """(port tree, JAX tree) of the forward and the coding-side device
    calls of ``name`` at small widths on seeded inputs; the P-frame
    models' reference is a bf16 frame, as the bf16 I-frame models give."""
    x, ref = _frames(2)
    tx, tref = _nchw(x), _nchw(ref, BF)
    jref = jax.ShapeDtypeStruct(ref.shape, JBF)
    q = np.float32(0.8)
    if name in ("dmc_hem", "canfvc_dmc"):
        tm, jm, params = (_hem if name == "dmc_hem" else _canf)()
        jcls = type(jm)
        with torch.no_grad():
            t = (tm(tx, _dpb_hem(tref), torch.tensor(q), torch.tensor(q)),
                 tm.compress_device(tx, _dpb_hem(tref), torch.tensor(q),
                                    torch.tensor(q)))
        j = (jax.eval_shape(jm.apply, params, x, _dpb_hem(jref), q, q),
             jax.eval_shape(lambda p, a, d: jm.apply(
                 p, a, d, q, q, method=jcls.compress_device),
                 params, x, _dpb_hem(jref)))
    elif name == "dmc_tcm":
        tm, jm, params = _tcm()
        with torch.no_grad():
            t = (tm(tx, tref, None), tm.compress_device(tx, tref, None))
        j = (jax.eval_shape(lambda p, a, r: jm.apply(p, a, r, None),
                            params, x, jref),
             jax.eval_shape(lambda p, a, r: jm.apply(
                 p, a, r, None, method=JDMCTcm.compress_device),
                 params, x, jref))
    elif name == "dcvc_gen1":
        tm, jm, params = _gen1()
        tref, jref = _nchw(ref), ref       # cheng2020-anchor's recon is f32
        with torch.no_grad():
            t = (tm(tref, tx), tm.encode_analysis(tref, tx))
        j = (jax.eval_shape(jm.apply, params, jref, x),
             jax.eval_shape(lambda p, r, a: jm.apply(
                 p, r, a, method=JDCVCNet.encode_analysis), params, jref, x))
    elif name == "intra_hem":
        tm, jm, params = _intra_hem()
        with torch.no_grad():
            t = (tm(tx, torch.tensor(q)),
                 tm.compress_device(tx, torch.tensor(q)))
        j = (jax.eval_shape(jm.apply, params, x, q),
             jax.eval_shape(lambda p, a: jm.apply(
                 p, a, q, method=JIntraNoARHem.compress_device), params, x))
    else:
        tm, jm, params = _zoo(name, 68)
        with torch.no_grad():
            t = (tm(tx), tm.analyze(tx))
        j = (jax.eval_shape(jm.apply, params, x),
             jax.eval_shape(lambda p, a: jm.apply(
                 p, a, method=type(jm).analyze), params, x))
        j = ({k: v for k, v in j[0].items() if k != "aux_loss"}, j[1])
    return _ttree(t), _jtree(j)


F32_OUT = {"canfvc_dmc", "dcvc_gen1", "cheng2020-anchor"}


@pytest.mark.parametrize("name", [n for n in registry.DTYPE_MODELS
                                  if n not in ("intra_dc", "dmc_dc",
                                               "evc_scalable")
                                  and not n.startswith("evc_")])
def test_output_dtype_trees_equal_jax(name):
    tree, jtree = _trees(name)
    assert tree == jtree
    recon = {"dmc_hem": lambda t: t[1]["dpb"]["ref_frame"],
             "canfvc_dmc": lambda t: t[1]["dpb"]["ref_frame"],
             "dmc_tcm": lambda t: t[1]["x_hat"],
             "dcvc_gen1": lambda t: t[0]["recon_image"]}.get(
        name, lambda t: t[0]["x_hat"])(tree)
    assert recon.endswith("float32" if name in F32_OUT else "bfloat16")


# ---- the DPB dtype fixed point, and the port's own round trips ----

def _hem_p(tm, x, dpb):
    q = torch.tensor(0.8)
    return tm(x, dpb, q, q)["dpb"]


def _tcm_p(tm, x, dpb):
    out = tm(x, dpb["ref_frame"], dpb["ref_feature"])
    return {"ref_frame": out["recon_image"], "ref_feature": out["feature"]}


@pytest.mark.parametrize("name", ["dmc_hem", "dmc_tcm"])
def test_dpb_dtypes_are_a_fixed_point(name):
    """I -> P gives the DPB dtypes that P -> P gives (the JAX package's
    tests/test_dtype_consistency.py), from a bf16 I-frame recon."""
    tm, step = (_hem()[0], _hem_p) if name == "dmc_hem" else (_tcm()[0],
                                                             _tcm_p)
    x0, x1, x2 = (_nchw(f) for f in _frames(3))
    dpb0 = {"ref_frame": x0.to(BF), "ref_feature": None, "ref_y": None,
            "ref_mv_y": None}
    with torch.no_grad():
        d1 = step(tm, x1, dpb0)
        d2 = step(tm, x2, d1)
    dt = {k: str(v.dtype) for k, v in d1.items() if v is not None}
    assert dt == {k: str(v.dtype) for k, v in d2.items() if v is not None}
    assert dt["ref_frame"] == dt["ref_feature"] == "torch.bfloat16"


def _gaps(enc: dict, dec: dict):
    worst, n = 0.0, 0
    for k, v in enc.items():
        if v is not None:
            d = (v.float() - dec[k].float()).abs()
            worst, n = max(worst, float(d.max())), n + int((d > DESYNC).sum())
    return worst, n


@pytest.mark.parametrize("name", ["dmc_hem", "canfvc_dmc", "dmc_tcm"])
def test_bf16_p_frames_round_trip(name):
    """Two chained bf16 P-frames through the runtime from a bf16 I-frame
    recon: symbols decoded = symbols encoded, every DPB gap within
    check_tpu_roundtrip's TOL and none above DESYNC (CANF: R6 below)."""
    x0, x1, x2 = (_nchw(f) for f in _frames(3))
    if name == "dmc_tcm":
        rt = TcmVideoRuntime(_tcm()[0], device="cpu")
    else:
        rt = HemVideoRuntime((_hem if name == "dmc_hem" else _canf)()[0],
                             device="cpu")
    rt.update()
    tap = _Tap(rt)
    de = dd = {"ref_frame": x0.to(BF), "ref_feature": None, "ref_y": None,
               "ref_mv_y": None}
    for x in (x1, x2):
        if name != "dmc_tcm":
            comp = rt.compress(x, de, 0.9, 0.8)
            dec = rt.decompress(dd, comp["bit_stream"], 64, 64, 0.9, 0.8)
            de, dd = comp["dpb"], dec["dpb"]
        else:
            comp = rt.compress(x, de["ref_frame"], de["ref_feature"])
            dec = rt.decompress(dd["ref_frame"], dd["ref_feature"],
                                comp["bit_stream"], 64, 64)
            de = {"ref_frame": comp["x_hat"], "ref_feature": comp["feature"]}
            dd = {"ref_frame": dec["x_hat"], "ref_feature": dec["feature"]}
        tap.check()
        gap, desync = _gaps(de, dd)
        assert gap <= TOL and desync == 0, (gap, desync)
        assert de["ref_frame"].dtype == dd["ref_frame"].dtype == (
            torch.float32 if name == "canfvc_dmc" else BF)


def test_r6_canf_decoder_dpb_dtype_on_both_sides():
    """The JAX package's CANF decoder starts its ladder from zeros of
    context1's dtype: under bf16 its decoded recon is bf16 where its
    encoder's DPB is f32 (ROADMAP R6; the next P-frame then
    desynchronises). The port's decoder starts from the frame's f32 zeros,
    as its encoder does."""
    tm, jm, params = _canf()
    y = jax.ShapeDtypeStruct((1, 4, 4, 24), jnp.float32)
    ctx = tuple(jax.ShapeDtypeStruct(shape, JBF) for shape, _ in _ctx(16))
    jx = jax.eval_shape(lambda p, a, c: jm.apply(
        p, a, np.float32(0.8), c, method=JCANFVCDmc.decode_recon_stage),
        params, y, ctx)[0]
    assert str(jx.dtype) == "bfloat16"
    rng = np.random.default_rng(5)
    tctx = tuple(_input(rng, shape, kind)[1] for shape, kind in _ctx(16))
    with torch.no_grad():
        tx = tm.decode_recon_stage(torch.zeros(1, 24, 4, 4),
                                   torch.tensor(0.8), tctx)[0]
    assert tx.dtype == torch.float32


# ---- R4: mbt2018 takes no dtype, on both sides ----

def test_r4_mbt2018_bf16_refused_on_both_sides():
    """The JAX package's MaskedConv2d ignores its dtype: mbt2018's bf16 g_a
    gives a bf16 latent and the masked convolution's f32 kernel refuses
    it; the port's registry refuses the dtype, naming R4."""
    jm = jzoo.model_architectures["mbt2018"](**ZOO_W, dtype=JBF)
    tm = build_zoo("mbt2018", seed=1, device="cpu", **ZOO_W)
    params = port_zoo.convert_zoo(_sd(tm), ZOO_KINDS["mbt2018"])
    x = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    with pytest.raises(TypeError, match="same dtypes"):
        jax.eval_shape(jm.apply, params, x)
    with pytest.raises(NotImplementedError, match="R4"):
        registry.build("mbt2018", dtype=BF, device="cpu")


# ---- the converters' f32 state_dict in a bf16 module ----

def _small(name, dtype):
    if name == "intra_hem":
        return IntraNoARHem(32, dtype=dtype)
    if name in ZOO_KINDS:
        w = {"N": 16} if name == "cheng2020-anchor" else ZOO_W
        return build_zoo(name, seed=5, device="cpu", dtype=dtype, **w)
    return {"dmc_hem": DMCHem, "canfvc_dmc": CANFVCDmc, "dmc_tcm": DMCTcm,
            "dcvc_gen1": DCVCNet}[name](**P_WIDTHS, dtype=dtype)


@pytest.mark.parametrize("name", ["intra_hem", "dmc_hem", "canfvc_dmc",
                                  "dmc_tcm", "dcvc_gen1",
                                  "bmshj2018-factorized",
                                  "bmshj2018-hyperprior", "mbt2018-mean",
                                  "cheng2020-anchor"])
def test_bf16_module_loads_the_f32_state_dict_of_the_converters(name):
    """Parameters stay f32 in both packages, so the JAX converters' f32
    params, carried back by ``utils/convert.py``, load into a bf16-compute
    module with ``strict=True``."""
    from dcvc_tpu_torch.utils import convert

    to_jax, from_jax = {
        "intra_hem": (port_hem.convert_intra_hem, convert.intra_hem_from_jax),
        "dmc_hem": (port_hem.convert_dmc_hem, convert.dmc_hem_from_jax),
        "canfvc_dmc": (port_hem.convert_canf_dmc, convert.canf_dmc_from_jax),
        "dmc_tcm": (port_tcm.convert_dmc_tcm, convert.dmc_tcm_from_jax),
        "dcvc_gen1": (port_gen1.convert_dcvc_gen1,
                      convert.dcvc_gen1_from_jax)}.get(name, (
        lambda sd: port_zoo.convert_zoo(sd, ZOO_KINDS[name]),
        lambda p: convert.zoo_from_jax(p, ZOO_KINDS[name])))
    torch.manual_seed(9)
    sd = from_jax(to_jax(_sd(_small(name, None))))
    module = _small(name, BF)
    module.load_state_dict(sd, strict=True)
    for k, v in module.state_dict().items():
        assert v.dtype == torch.float32, k
        assert torch.equal(v, torch.as_tensor(np.asarray(sd[k]))), k
