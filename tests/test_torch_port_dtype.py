"""The port's ``dtype`` option (bf16 compute on f32 parameters) against the
JAX package's, on the CPU.

Weights are seeded *port* weights carried to JAX with
``dcvc_tpu/utils/port_dc.py`` (no JAX model init); inputs are seeded
numpy. Both sides run ``dtype=bfloat16``.

Tolerances, in bf16 ulps of the output's largest magnitude (an ulp there
is ``2 ** (floor(log2 max|out|) - 7)``): ``ULPS_BLOCK`` for one block,
``ULPS_NET`` for a stack of blocks. XLA:CPU may keep f32 between the bf16
ops of a fusion where PyTorch rounds after each op, so a result may sit an
ulp or two away and a few such steps add up. Whole models: the share of
quantized symbols that differ (a value on a rounding boundary goes the
other way) at most ``SYMBOL_SHARE``, and the recon within ``RECON_ULPS``
ulps (for DMC ``RECON_ATOL_DMC`` absolute: its recon follows a flipped
motion symbol through the warps). The port rounds as the JAX package
does where that is cheap: bf16 bias added after the convolution, the
leaky-ReLU slope rounded to bf16, the resize one axis at a time. Dtypes are compared exactly: every output's,
from ``jax.eval_shape`` on the JAX side (no compile).

The JAX exact warp computes source positions in the flow's dtype (ROADMAP
R3: at bf16 it samples whole pixels away); ``test_r3_*`` show both sides.
For the model comparisons the JAX side gets the repair through
``jax_r3_repair``, a ``monkeypatch`` of ``dcvc_tpu.ops.warp.flow_warp``
that casts the flow to f32 and the output back to the image's dtype;
nothing under ``dcvc_tpu/`` changes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

import dcvc_tpu.ops.warp as jwarp
from dcvc_tpu.layers import blocks as jb
from dcvc_tpu.layers import evc_blocks as jeb
from dcvc_tpu.entropy import bits as jbits
from dcvc_tpu.models import evc as jevc
from dcvc_tpu.models import priors as jpriors
from dcvc_tpu.models import video_dc as jvd
from dcvc_tpu.models import video_net as jvn
from dcvc_tpu.models.intra_dc import IntraNoAR as JIntraNoAR
from dcvc_tpu.utils import port_dc
from dcvc_tpu.utils import torch_port as tp
from dcvc_tpu_torch.entropy import bits as tbits
from dcvc_tpu_torch.entropy.bit_estimator import build_factorized_tables
from dcvc_tpu_torch.layers import blocks as tb
from dcvc_tpu_torch.layers import evc_blocks as teb
from dcvc_tpu_torch.models import priors as tpriors
from dcvc_tpu_torch.models import registry
from dcvc_tpu_torch.models.evc import EVCIntra, build_evc
from dcvc_tpu_torch.models.intra_dc import IntraNoAR, build_intra_dc
from dcvc_tpu_torch.models.runtime import DmcRuntime, IntraDcRuntime
from dcvc_tpu_torch.models.video_dc import build_dmc
from dcvc_tpu_torch.ops.warp import flow_warp
from dcvc_tpu_torch.utils import stream
from dcvc_tpu_torch.utils.convert import (dmc_from_jax, evc_from_jax,
                                          intra_dc_from_jax)
from _flax_init import flax_param_checks  # noqa: F401 (autouse)

BF = torch.bfloat16
JBF = jnp.bfloat16
ULPS_BLOCK, ULPS_NET = 4, 8
SYMBOL_SHARE = 0.02
RECON_ULPS = 8
RECON_ATOL_DMC = 0.01
EVC_CH = (16, 16, 24, 32)           # EVCIntra widths (c2, c4, c8, c16), N 32
INTRA_W = dict(N=64, ch_a=32, ch_b=48)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six pytest workers on one host: two torch threads each
    keeps torch's spinning OpenMP pool from starving the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_r3_repair(monkeypatch):
    orig = jwarp.flow_warp

    def repaired(im, flow):
        return orig(im, flow.astype(jnp.float32)).astype(im.dtype)

    monkeypatch.setattr(jwarp, "flow_warp", repaired)


def _nchw(a, dtype=torch.float32):
    a = np.asarray(a).astype(np.float32)        # numpy or JAX, any dtype
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))
                            ).to(dtype)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _jnp(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _ulp(ref: np.ndarray) -> float:
    m = float(np.abs(ref).max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 2.0 ** -133


def _tdt(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _check(tout, jout, ulps, what=""):
    """Equal dtypes, gap within ``ulps`` of every output leaf."""
    touts = tout if isinstance(tout, (tuple, list)) else (tout,)
    jouts = jout if isinstance(jout, (tuple, list)) else (jout,)
    assert len(touts) == len(jouts)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        assert _tdt(t) == str(j.dtype), f"{what}[{i}]: {t.dtype} vs {j.dtype}"
        a, b = _nhwc(t), np.asarray(j.astype(jnp.float32))
        assert a.shape == b.shape
        gap, ulp = float(np.abs(a - b).max()), _ulp(b)
        print(f"{what}[{i}] {_tdt(t)}: gap {gap:.3e} = {gap / ulp:.2f} ulps")
        assert gap <= ulps * ulp, f"{what}[{i}]: {gap / ulp:.1f} ulps > {ulps}"


class _Holder(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.m = m


def _seeded(make, seed=11):
    torch.manual_seed(seed)
    return make().eval()


def _deconv_params(m):
    w = m.m.weight.detach().numpy()
    return {"params": {"kernel": tp.conv_transpose_kernel(w),
                       "bias": m.m.bias.detach().numpy()}}


def _mapped(fn):
    def params(holder):
        mp = port_dc._Mapper(_sd(holder))
        fn(mp)
        return mp.finish()
    return params


def _depth_conv(mp):
    mp.conv("m.conv1.0", "conv1")
    mp.dwconv("m.depth_conv", "depth_conv")
    mp.conv("m.conv2", "conv2")
    if "m.adaptor.weight" in mp.sd:
        mp.conv("m.adaptor", "adaptor")


def _evc_depth_conv(mp):
    mp.conv("m.conv1.0", "conv1")
    mp.dwconv("m.depth_conv.0", "depth_conv")
    mp.conv("m.conv2.0", "conv2")
    if "m.adaptor.weight" in mp.sd:
        mp.conv("m.adaptor", "adaptor")


def _evc_upsample(mp):
    mp.dcb("m", "block", two=False, seq=True)
    mp.conv("m.block.2", "subpel", "conv")


# items 1 and 9: (port block, flax block, port -> flax params, in channels)
BLOCKS = {
    "conv": (lambda: tb.conv(16, 24, 3, 2, dtype=BF),
             lambda: jb.conv(24, 3, 2, dtype=JBF),
             _mapped(lambda mp: mp.conv("m")), 16),
    "deconv": (lambda: tb.deconv(16, 12, 3, 2, dtype=BF),
               lambda: jb.deconv(12, 3, 2, dtype=JBF), _deconv_params, 16),
    "subpel_conv": (lambda: tb.subpel_conv(16, 8, 2, 3, dtype=BF),
                    lambda: jb.SubpelConv(8, 2, 3, dtype=JBF),
                    _mapped(lambda mp: mp.subpel("m")), 16),
    "residual_block_with_stride": (
        lambda: tb.ResidualBlockWithStride(16, 24, 2, dtype=BF),
        lambda: jb.ResidualBlockWithStride(24, 2, dtype=JBF),
        _mapped(lambda mp: mp.rbws("m")), 16),
    "residual_block_upsample": (
        lambda: tb.ResidualBlockUpsample(16, 12, 2, dtype=BF),
        lambda: jb.ResidualBlockUpsample(12, 2, dtype=JBF),
        _mapped(lambda mp: mp.rbu("m")), 16),
    "residual_block": (lambda: tb.ResidualBlock(16, 24, dtype=BF),
                       lambda: jb.ResidualBlock(24, dtype=JBF),
                       _mapped(lambda mp: mp.resblock("m")), 16),
    "res_block": (lambda: tb.ResBlock(16, slope=0.1, end_with_relu=True,
                                      bottleneck=True, dtype=BF),
                  lambda: jb.ResBlock(16, slope=0.1, end_with_relu=True,
                                      bottleneck=True, dtype=JBF),
                  _mapped(lambda mp: mp.resblock("m")), 16),
    "depth_conv_stride2": (lambda: tb.DepthConv(16, 24, stride=2, dtype=BF),
                           lambda: jb.DepthConv(24, stride=2, dtype=JBF),
                           _mapped(_depth_conv), 16),
    "conv_ffn": (lambda: tb.ConvFFN(16, dtype=BF),
                 lambda: jb.ConvFFN(dtype=JBF),
                 _mapped(lambda mp: (mp.conv("m.conv.0", "conv1"),
                                     mp.conv("m.conv.2", "conv2"))), 16),
    "conv_ffn2": (lambda: tb.ConvFFN2(16, dtype=BF),
                  lambda: jb.ConvFFN2(dtype=JBF),
                  _mapped(lambda mp: (mp.conv("m.conv", "conv"),
                                      mp.conv("m.conv_out", "conv_out"))), 16),
    "depth_conv_block": (lambda: tb.DepthConvBlock(16, 24, dtype=BF),
                         lambda: jb.DepthConvBlock(24, dtype=JBF),
                         _mapped(lambda mp: mp.dcb("m", two=False)), 16),
    "depth_conv_block2": (lambda: tb.DepthConvBlock2(16, 16, dtype=BF),
                          lambda: jb.DepthConvBlock2(16, dtype=JBF),
                          _mapped(lambda mp: mp.dcb("m", two=True)), 16),
    "unet": (lambda: tb.UNet(16, 16, dtype=BF),
             lambda: jb.UNet(16, dtype=JBF),
             _mapped(lambda mp: mp.unet("m", two=False)), 16),
    "unet2": (lambda: tb.UNet(16, 16, True, dtype=BF),
              lambda: jb.UNet(16, block2=True, dtype=JBF),
              _mapped(lambda mp: mp.unet("m", two=True)), 16),
    "evc_depth_conv_stride2": (
        lambda: teb.EvcDepthConv(8, 12, stride=2, dtype=BF),
        lambda: jeb.EvcDepthConv(12, stride=2, dtype=JBF),
        _mapped(_evc_depth_conv), 8),
    "evc_conv_ffn": (lambda: teb.EvcConvFFN(8, dtype=BF),
                     lambda: jeb.EvcConvFFN(dtype=JBF),
                     _mapped(lambda mp: (mp.conv("m.conv.0", "conv1"),
                                         mp.conv("m.conv.2", "conv2"))), 8),
    "evc_depth_conv_block": (
        lambda: teb.EvcDepthConvBlock(8, 12, dtype=BF),
        lambda: jeb.EvcDepthConvBlock(12, dtype=JBF),
        _mapped(lambda mp: mp.dcb("m", two=False, seq=True)), 8),
    "evc_block_upsample": (
        lambda: teb.EvcDepthConvBlockUpsample(8, 12, dtype=BF),
        lambda: jeb.EvcDepthConvBlockUpsample(12, dtype=JBF),
        _mapped(_evc_upsample), 8),
    "dc_block_upsample": (
        lambda: teb.DepthConvBlockUpsample(8, 12, dtype=BF),
        lambda: jeb.DepthConvBlockUpsample(12, dtype=JBF),
        _mapped(lambda mp: mp.dcb_upsample("m")), 8),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_bf16_matches_jax(name):
    make_t, make_j, to_jax, cin = BLOCKS[name]
    holder = _Holder(_seeded(make_t))
    params = to_jax(holder)
    x = np.random.default_rng(1).normal(size=(1, 16, 20, cin))
    x = x.astype(np.float32)
    jout = jax.jit(make_j().apply)(params, jnp.asarray(x))
    with torch.no_grad():
        tout = holder.m(_nchw(x))
    assert all(p.dtype == torch.float32 for p in holder.parameters())
    _check(tout, jout, ULPS_NET if name.startswith("unet") else ULPS_BLOCK,
           name)


# ---- item 4 (video_net) and DMC's own parts, from one seeded DMC ----

@pytest.fixture(scope="module")
def dmc():
    tm = build_dmc(seed=3, device="cpu", dtype=BF)
    return tm, port_dc.convert_dmc(_sd(tm))["params"]


def _bf16_input(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _dmc_cases():
    """(port attribute, flax module, input shapes NHWC, input dtypes)."""
    ones = (1, 64, 64)
    return {
        "me_basic": (lambda m: m.optic_flow.moduleBasic[0],
                     lambda: jvn.MEBasic(dtype=JBF), "optic_flow.basic0",
                     [((*ones, 8), "f32")]),
        "me_spynet": (lambda m: m.optic_flow,
                      lambda: jvn.MESpynet(dtype=JBF), "optic_flow",
                      [((*ones, 3), "f32"), ((*ones, 3), "bf16")]),
        "offset_diversity": (lambda m: m.align,
                             lambda: jvn.OffsetDiversity(
                                 in_channel=48, warp_mode="exact", dtype=JBF),
                             "align",
                             [((*ones, 48), "bf16"), ((*ones, 53), "bf16"),
                              ((*ones, 2), "flow")]),
        "feature_extractor": (lambda m: m.feature_extractor,
                              lambda: jvn.FeatureExtractor(dtype=JBF),
                              "feature_extractor", [((*ones, 48), "bf16")]),
        "context_fusion": (lambda m: m.context_fusion_net,
                           lambda: jvn.MultiScaleContextFusion(dtype=JBF),
                           "context_fusion_net",
                           [((*ones, 48), "bf16"), ((1, 32, 32, 64), "bf16"),
                            ((1, 16, 16, 96), "bf16")]),
        "hyper_enc": (lambda m: m.mv_hyper_prior_encoder,
                      lambda: jvn.HyperEnc(64, dtype=JBF),
                      "mv_hyper_prior_encoder", [((1, 16, 16, 64), "bf16")]),
        "hyper_enc_reduced": (lambda m: m.contextual_hyper_prior_encoder,
                              lambda: jvn.HyperEncReduced(128, dtype=JBF),
                              "contextual_hyper_prior_encoder",
                              [((1, 16, 16, 128), "f32")]),
        "hyper_dec": (lambda m: m.mv_hyper_prior_decoder,
                      lambda: jvn.HyperDec(64, dtype=JBF),
                      "mv_hyper_prior_decoder", [((1, 4, 4, 64), "f32")]),
        "mv_enc": (lambda m: m.mv_encoder, lambda: jvd.MvEnc(64, dtype=JBF),
                   "mv_encoder", [((*ones, 2), "f32"),
                                  ((1, 16, 16, 64), "bf16"),
                                  ((1, 1, 1, 64), "q")]),
        "mv_dec": (lambda m: m.mv_decoder,
                   lambda: jvd.MvDec(2, 64, dtype=JBF), "mv_decoder",
                   [((1, 4, 4, 64), "bf16"), ((1, 1, 1, 64), "q")]),
        "contextual_encoder": (lambda m: m.contextual_encoder,
                               lambda: jvd.ContextualEncoder(dtype=JBF),
                               "contextual_encoder",
                               [((*ones, 3), "f32"), ((*ones, 48), "bf16"),
                                ((1, 32, 32, 64), "bf16"),
                                ((1, 16, 16, 96), "bf16"),
                                ((1, 1, 1, 128), "q")]),
        "contextual_decoder": (lambda m: m.contextual_decoder,
                               lambda: jvd.ContextualDecoder(dtype=JBF),
                               "contextual_decoder",
                               [((1, 4, 4, 128), "bf16"),
                                ((1, 32, 32, 64), "bf16"),
                                ((1, 16, 16, 96), "bf16"),
                                ((1, 1, 1, 64), "q")]),
        "recon_generation": (lambda m: m.recon_generation_net,
                             lambda: jvd.ReconGeneration(dtype=JBF),
                             "recon_generation_net",
                             [((*ones, 32), "bf16"), ((*ones, 48), "bf16")]),
    }


DMC_CASES = _dmc_cases()


@pytest.mark.parametrize("name", list(DMC_CASES))
def test_video_net_module_bf16_matches_jax(name, dmc, jax_r3_repair):
    port_of, make_j, path, inputs = DMC_CASES[name]
    tm, params = dmc
    for key in path.split("."):
        params = params[key]
    rng = np.random.default_rng(7)
    jin, tin = [], []
    for shape, kind in inputs:
        if kind == "q":
            a = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif kind == "flow":     # a bf16 motion field of a few px
            a = _bf16_input(rng, shape, 3.0)
        else:
            a = _bf16_input(rng, shape)
        dt = (JBF, BF) if kind in ("bf16", "flow") else (jnp.float32,
                                                         torch.float32)
        jin.append(_jnp(a, dt[0]))
        tin.append(_nchw(a, dt[1]))
    jout = jax.jit(make_j().apply)({"params": params}, *jin)
    with torch.no_grad():
        tout = port_of(tm)(*tin)
    # the OD offsets reach 40 px, where a bf16 ulp is a quarter pixel
    deep = name in ("me_spynet", "offset_diversity", "recon_generation",
                    "mv_enc", "mv_dec", "contextual_encoder",
                    "contextual_decoder", "context_fusion")
    _check(tout, jout, ULPS_NET if deep else ULPS_BLOCK, name)


# ---- item 10: the EVC nets, from one seeded narrow EVCIntra ----

@pytest.fixture(scope="module")
def evc():
    torch.manual_seed(3)
    tm = EVCIntra(EVC_CH, EVC_CH, 32, dtype=BF).eval()
    with torch.no_grad():
        tm.q_basic.mul_(torch.linspace(0.4, 1.6, 32).view(1, 32, 1, 1))
    jm = jevc.EVCIntra(EVC_CH, EVC_CH, 32, dtype=JBF)
    return tm, jm, port_dc.convert_evc(_sd(tm))


EVC_PARTS = {
    "encoder": ("enc", lambda: jevc.EvcEncoder(EVC_CH, dtype=JBF),
                (1, 64, 64, 3)),
    "decoder": ("dec", lambda: jevc.EvcDecoder(EVC_CH, dtype=JBF),
                (1, 4, 4, 32)),
    "hyper_enc": ("hyper_enc", lambda: jevc.EvcHyperEnc(32, dtype=JBF),
                  (1, 4, 4, 32)),
    "hyper_dec": ("hyper_dec", lambda: jevc.EvcHyperDec(32, dtype=JBF),
                  (1, 1, 1, 32)),
    "prior_fusion": ("y_prior_fusion",
                     lambda: jevc.EvcPriorFusion(32, dtype=JBF),
                     (1, 4, 4, 32)),
    "spatial_prior": ("y_spatial_prior",
                      lambda: jevc.EvcSpatialPrior(32, dtype=JBF),
                      (1, 4, 4, 128)),
}


@pytest.mark.parametrize("name", list(EVC_PARTS))
def test_evc_part_bf16_matches_jax(name, evc):
    attr, make_j, shape = EVC_PARTS[name]
    tm, _, params = evc
    x = _bf16_input(np.random.default_rng(8), shape)
    jout = jax.jit(make_j().apply)({"params": params["params"][attr]},
                                   jnp.asarray(x))
    with torch.no_grad():
        tout = getattr(tm, attr)(_nchw(x))
    _check(tout, jout, ULPS_NET, name)


# ---- items 5 and 6: priors, bit estimates and the CDF bake ----

def test_prior_masks_and_bits_follow_the_latent_dtype():
    """The four-part and dual priors' masks take the latent's dtype and
    the bit estimates return in the input's, as in JAX; values equal (the
    masks are 0 / 1)."""
    rng = np.random.default_rng(4)
    y = _bf16_input(rng, (1, 4, 6, 8), 3.0)
    params = np.abs(_bf16_input(rng, (1, 4, 6, 24))) + 0.2
    jy, jp = _jnp(y, JBF), _jnp(params, JBF)
    ty, tp_ = _nchw(y, BF), _nchw(params, BF)
    jw = jpriors.forward_four_part_prior(
        jy, jp, [lambda q: jnp.split(q[..., :16], 8, axis=-1)] * 3,
        write=True)
    tw = tpriors.forward_four_part_prior(
        ty, tp_, [lambda q: q[:, :16].chunk(8, 1)] * 3, write=True)
    for j, t in zip(jax.tree.leaves(jw), [*tw[0], *tw[1], tw[2]]):
        assert _tdt(t) == str(j.dtype)
        np.testing.assert_array_equal(_nhwc(t),
                                      np.asarray(j.astype(jnp.float32)))
    means, scales, q = jp[..., :8], jp[..., 8:16], jp[..., 16:24]
    jd = jpriors.forward_dual_prior(
        jy, means, scales, q, lambda p: jnp.split(p[..., :16], 4, axis=-1),
        write=True)
    td = tpriors.forward_dual_prior(
        ty, *(_nchw(np.asarray(a.astype(jnp.float32)), BF)
              for a in (means, scales, q)),
        lambda p: p[:, :16].chunk(4, 1), write=True)
    for j, t in zip(jd, td):
        assert _tdt(t) == str(j.dtype)
        np.testing.assert_array_equal(_nhwc(t),
                                      np.asarray(j.astype(jnp.float32)))
    sigma = np.abs(_bf16_input(rng, y.shape)) + 0.1
    for jf, tf in ((jbits.y_gaussian_bits, tbits.y_gaussian_bits),
                   (jbits.y_laplace_bits, tbits.y_laplace_bits)):
        j = jf(jy, _jnp(sigma, JBF))
        t = tf(ty, _nchw(sigma, BF))
        _check(t, j, ULPS_BLOCK, jf.__name__)


def test_bit_estimator_keeps_f32_and_its_tables():
    """The estimator's parameters stay f32 in a bf16 model: its bf16 z
    likelihood comes back in f32 as JAX's does, and the baked CDF tables
    equal the f32 twin's byte for byte."""
    f32 = build_evc("SS", seed=6, device="cpu")
    bf = build_evc("SS", seed=6, device="cpu", dtype=BF)
    est = bf.bit_estimator_z
    assert all(p.dtype == torch.float32 for p in est.parameters())
    a, b = build_factorized_tables(f32.bit_estimator_z), \
        build_factorized_tables(est)
    for k in ("quantized_cdf", "cdf_length", "offset"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    z = torch.round(torch.randn(1, 192, 2, 3) * 3).to(BF)
    with torch.no_grad():
        assert tbits.z_bits(z, est).dtype == torch.float32


# ---- dtype trees, exact ----

def _tree(tree, leaf):
    """A nested dict / sequence of outputs as plain dicts and lists of
    ``leaf(x)`` (None entries dropped)."""
    if isinstance(tree, dict):
        return {k: _tree(v, leaf) for k, v in tree.items() if v is not None}
    if isinstance(tree, (tuple, list)):
        return [_tree(v, leaf) for v in tree]
    return leaf(tree)


def _jtree(tree):
    return _tree(tree, lambda a: f"{tuple(a.shape)} {a.dtype}")


def _ttree(tree):
    """Port outputs as JAX avals (NCHW -> NHWC shapes)."""
    def leaf(t):
        shape = tuple(t.shape)
        if t.dim() == 4:
            shape = (shape[0], shape[2], shape[3], shape[1])
        return f"{shape} {_tdt(t)}"
    return _tree(tree, leaf)


@pytest.fixture(scope="module")
def intra():
    torch.manual_seed(5)
    tm = IntraNoAR(INTRA_W["N"], 4, INTRA_W["ch_a"], INTRA_W["ch_b"],
                   dtype=BF).eval()
    with torch.no_grad():
        tm.q_basic_enc.mul_(torch.linspace(0.6, 1.4, 32).view(1, 32, 1, 1))
    return tm, JIntraNoAR(dtype=JBF, **INTRA_W), port_dc.convert_intra_dc(
        _sd(tm))


def _frames(n, seed=9):
    rng = np.random.default_rng(seed)
    base = rng.random((1, 64 + 8, 64 + 8, 3)).astype(np.float32)
    return [base[:, 2 * i:2 * i + 64, 3 * i:3 * i + 64].copy()
            for i in range(n)]


def test_intra_output_dtype_trees_equal_jax(intra):
    tm, jm, params = intra
    x = _frames(1)[0]
    qe, qd = np.float32(1.1), np.float32(0.9)
    jf = jax.eval_shape(jm.apply, params, x, qe, qd)
    jc = jax.eval_shape(lambda p, a, b, c: jm.apply(
        p, a, b, c, method=JIntraNoAR.compress_device), params, x, qe, qd)
    with torch.no_grad():
        tf = tm(_nchw(x), torch.tensor(qe), torch.tensor(qd))
        tc = tm.compress_device(_nchw(x), torch.tensor(qe), torch.tensor(qd))
    assert _ttree(tf) == _jtree(jf)
    assert _ttree(tc) == _jtree(jc)
    assert _tdt(tc["x_hat"]) == "bfloat16"


def test_evc_output_dtype_trees_equal_jax(evc):
    tm, jm, params = evc
    x = _frames(1)[0]
    q = np.float32(0.85)
    jf = jax.eval_shape(jm.apply, params, x, q)
    jc = jax.eval_shape(lambda p, a, b: jm.apply(
        p, a, b, method=jevc.EVCIntra.compress_device), params, x, q)
    with torch.no_grad():
        tf = tm(_nchw(x), torch.tensor(q))
        tc = tm.compress_device(_nchw(x), torch.tensor(q))
    assert _ttree(tf) == _jtree(jf)
    assert _ttree(tc) == _jtree(jc)


def _qs():
    return {"mv_enc": 1.1, "mv_dec": 0.9, "y_enc": 1.2, "y_dec": 0.8}


def _dpb0(ref):
    return {"ref_frame": ref, "ref_feature": None, "ref_mv_feature": None,
            "ref_y": None, "ref_mv_y": None}


def test_dmc_output_dtype_trees_equal_jax_and_dpb_fixed_point(dmc):
    tm, params = dmc
    jm = jvd.DMC(dtype=JBF)
    jparams = {"params": params}
    x, ref = _frames(2)
    jqs = {k: np.float32(v) for k, v in _qs().items()}
    tqs = {k: torch.tensor(np.float32(v)) for k, v in _qs().items()}
    # the I-frame's recon is bf16 in both packages (IntraNoAR(dtype=bf16))
    jdpb = _dpb0(jax.ShapeDtypeStruct(ref.shape, JBF))
    tdpb = _dpb0(_nchw(ref, BF))
    jf = jax.eval_shape(lambda p, a, d, q: jm.apply(p, a, d, q, 1),
                        jparams, x, jdpb, jqs)
    jc = jax.eval_shape(lambda p, a, d, q: jm.apply(
        p, a, d, q, 1, method=jvd.DMC.compress_device), jparams, x, jdpb, jqs)
    with torch.no_grad():
        tf = tm(_nchw(x), tdpb, tqs, 1)
        tc = tm.compress_device(_nchw(x), tdpb, tqs, 1)
        tpp = tm(_nchw(x), tf["dpb"], tqs, 2)["dpb"]
    assert _ttree(tf) == _jtree(jf)
    assert _ttree(tc) == _jtree(jc)
    # the port's DPB dtypes are a fixed point: I -> P equals P -> P
    assert _ttree(tpp) == _ttree(tf["dpb"])
    assert {k: _tdt(v) for k, v in tf["dpb"].items()} == dict.fromkeys(
        tf["dpb"], "bfloat16")


# ---- whole models against JAX ----

def _symbols_share(tplanes, jplanes):
    diff = total = 0
    for t, j in zip(tplanes, jplanes):
        a, b = _nhwc(t), np.asarray(j.astype(jnp.float32))
        diff += int((a != b).sum())
        total += a.size
    return diff / total


def test_intra_bf16_forward_matches_jax(intra):
    tm, jm, params = intra
    x = _frames(1)[0]
    qe, qd = np.float32(1.1), np.float32(0.9)
    jc = jax.jit(lambda p, a, b, c: jm.apply(
        p, a, b, c, method=JIntraNoAR.compress_device))(
        params, jnp.asarray(x), qe, qd)
    with torch.no_grad():
        tc = tm.compress_device(_nchw(x), torch.tensor(qe), torch.tensor(qd))
    share = _symbols_share(tc["y_q_planes"], jc["y_q_planes"])
    print(f"intra: {share:.4%} of symbols differ")
    assert share <= SYMBOL_SHARE
    assert sum(float(q.abs().sum()) for q in tc["y_q_planes"]) > 0
    _check(tc["x_hat"], jc["x_hat"], RECON_ULPS, "intra x_hat")
    np.testing.assert_array_equal(_nhwc(tc["z_hat"]),
                                  np.asarray(jc["z_hat"].astype(jnp.float32)))


def test_dmc_bf16_forward_matches_jax(dmc, jax_r3_repair):
    tm, params = dmc
    jm = jvd.DMC(dtype=JBF)
    x, ref = _frames(2)
    jqs = {k: np.float32(v) for k, v in _qs().items()}
    tqs = {k: torch.tensor(np.float32(v)) for k, v in _qs().items()}
    jc = jax.jit(lambda p, a, d, q: jm.apply(
        p, a, d, q, 1, method=jvd.DMC.compress_device))(
        {"params": params}, jnp.asarray(x), _dpb0(_jnp(ref, JBF)), jqs)
    with torch.no_grad():
        tc = tm.compress_device(_nchw(x), _dpb0(_nchw(ref, BF)), tqs, 1)
    share = _symbols_share(tc["mv_y_q_planes"] + tc["y_q_planes"],
                           jc["mv_y_q_planes"] + jc["y_q_planes"])
    print(f"dmc: {share:.4%} of symbols differ")
    assert share <= SYMBOL_SHARE
    recon = tc["dpb"]["ref_frame"]
    jrecon = jc["dpb"]["ref_frame"]
    assert _tdt(recon) == str(jrecon.dtype) == "bfloat16"
    gap = float(np.abs(_nhwc(recon) - np.asarray(
        jrecon.astype(jnp.float32))).max())
    print(f"dmc recon gap {gap:.3e}")
    assert gap <= RECON_ATOL_DMC


def test_evc_bf16_forward_matches_jax(evc):
    tm, jm, params = evc
    x = _frames(1)[0] * 4 - 1.5
    q = np.float32(0.85)
    jc = jax.jit(lambda p, a, b: jm.apply(
        p, a, b, method=jevc.EVCIntra.compress_device))(
        params, jnp.asarray(x), q)
    with torch.no_grad():
        tc = tm.compress_device(_nchw(x), torch.tensor(q))
    share = _symbols_share(tc["y_q_planes"], jc["y_q_planes"])
    print(f"evc: {share:.4%} of symbols differ")
    assert share <= SYMBOL_SHARE
    _check(tc["x_hat"], jc["x_hat"], RECON_ULPS, "evc x_hat")


# ---- round trips in the port alone ----

class _Tap:
    """The symbols a coder encodes and the ones it decodes."""

    def __init__(self, rt):
        coder = rt.entropy_coder
        self.enc, self.dec = [], []
        encode, decode = coder.encode_with_indexes, coder.decode_stream

        def tap_encode(symbols, indexes, table):
            self.enc.append(np.asarray(symbols).reshape(-1).astype(np.int32))
            return encode(symbols, indexes, table)

        def tap_decode(indexes, table):
            out = decode(indexes, table)
            self.dec.append(np.asarray(out).reshape(-1).astype(np.int32))
            return out

        coder.encode_with_indexes = tap_encode
        coder.decode_stream = tap_decode

    def check(self):
        assert self.enc and np.array_equal(np.concatenate(self.enc),
                                           np.concatenate(self.dec))
        self.enc, self.dec = [], []


def _equal(a, b, what):
    assert a.dtype == b.dtype == BF, what
    assert torch.equal(a, b), f"{what}: max gap {(a - b).abs().max()}"


def test_dc_runtimes_bf16_roundtrip():
    irt = IntraDcRuntime(build_intra_dc(seed=0, device="cpu", dtype=BF),
                         device="cpu")
    prt = DmcRuntime(build_dmc(seed=1, device="cpu", dtype=BF), device="cpu")
    irt.update()
    prt.update()
    itap, ptap = _Tap(irt), _Tap(prt)
    x0, x1 = (_nchw(f) for f in _frames(2))
    comp = irt.compress(x0, False, 32)
    h, w, qc, qi, s = stream.unpack_i(stream.pack_i(64, 64, False, 32,
                                                    comp["bit_stream"]))
    dec = irt.decompress(s, h, w, qc, qi)
    itap.check()
    _equal(dec["x_hat"], comp["x_hat"], "I recon")
    comp = prt.compress(x1, _dpb0(comp["x_hat"]), False, 32, 1)
    qc, qi, fi, s = stream.unpack_p(stream.pack_p(comp["bit_stream"], False,
                                                  32, 1))
    dec = prt.decompress(_dpb0(dec["x_hat"]), s, 64, 64, qc, qi, fi)
    ptap.check()
    for k, v in comp["dpb"].items():
        _equal(dec["dpb"][k], v, k)


@pytest.mark.parametrize("name", ["evc_SS", "evc_scalable"])
def test_evc_bf16_roundtrip(name):
    _, rt = registry.build(name, seed=2, dtype=BF, device="cpu")
    rt.update()
    tap = _Tap(rt)
    x = _nchw(_frames(1)[0])
    comp = rt.compress(x, 0.85)
    dec = rt.decompress(comp["bit_stream"], 64, 64, 0.85)
    tap.check()
    _equal(dec["x_hat"], comp["x_hat"], "recon")


# ---- registry and weights ----

# where the JAX constructors give the dtype to some layers only: the port
# modules (by state_dict path) that compute in bf16; every other layer of
# those models stays f32 (dcvc_tpu/models/video_dcvc.py:121-160,
# intra_zoo.py:133, :189, :240, :345-352)
PARTIAL_REACH = {
    "dcvc_gen1": r"(opticFlow|feature_extract\.1|context_refine\.0|"
                 r"contextualEncoder\.[25]|contextualDecoder_part1\.[47]|"
                 r"contextualDecoder_part2\.[12]|entropy_parameters(_mv)?)\.",
    "cheng2020-anchor": r"(g_a\.[0-5]|g_s\.[0-6]|entropy_parameters)\.",
    "bmshj2018-hyperprior": r"(g_a|g_s)\.",
    "mbt2018-mean": r"(g_a|g_s)\.",
}


@pytest.mark.parametrize("name", registry.MODEL_NAMES)
def test_registry_dtype_option(name):
    """Every name but mbt2018 (ROADMAP R4) builds with bf16 compute on f32
    parameters; each layer's compute dtype is the one the JAX constructor
    gives it: bf16 for every layer, or for those of PARTIAL_REACH only."""
    import re

    if name not in registry.DTYPE_MODELS:
        with pytest.raises(NotImplementedError, match="R4"):
            registry.build(name, dtype=BF, device="cpu")
        return
    module, rt = registry.build(name, dtype=BF, device="cpu")
    layers = [(n, m) for n, m in module.named_modules()
              if isinstance(m, (tb.Conv2d, tb.ConvTranspose2d, tb.Linear))]
    reach = PARTIAL_REACH.get(name, "")
    want = {n: BF if re.match(reach, n + ".") else None for n, _ in layers}
    assert layers and {n: m.compute_dtype for n, m in layers} == want
    assert any(v is BF for v in want.values())
    assert all(p.dtype == torch.float32 for p in module.parameters())
    assert rt.module is module


@pytest.mark.parametrize("name", ["intra_dc", "dmc_dc", "evc_SS"])
def test_bf16_module_loads_the_f32_state_dict_of_the_converters(name):
    """Parameters stay f32 in both packages, so the converters' f32
    ``state_dict`` loads into a bf16-compute module as it is."""
    make, to_jax, from_jax = {
        "intra_dc": (lambda d: build_intra_dc(seed=4, device="cpu", dtype=d,
                                              **INTRA_W),
                     port_dc.convert_intra_dc, intra_dc_from_jax),
        "dmc_dc": (lambda d: build_dmc(seed=4, device="cpu", dtype=d),
                   port_dc.convert_dmc, dmc_from_jax),
        "evc_SS": (lambda d: build_evc("SS", seed=4, device="cpu", dtype=d),
                   port_dc.convert_evc, evc_from_jax)}[name]
    sd = from_jax(to_jax(_sd(make(None))))
    module = make(BF)
    module.load_state_dict(sd, strict=True)
    for k, v in module.state_dict().items():
        assert v.dtype == torch.float32, k
        assert torch.equal(v, torch.as_tensor(np.asarray(sd[k]))), k


# ---- R3: the exact warp's source positions with a bf16 flow ----

R3_W = 1920


def _ramp():
    """8 x 1920 image whose value is its column: a warp's output is the
    column it sampled."""
    return np.broadcast_to(np.arange(R3_W, dtype=np.float32),
                           (1, 8, R3_W)).copy()


def test_r3_jax_exact_warp_bf16_flow_samples_whole_pixels_away():
    ramp = _ramp()
    out = jwarp.flow_warp(jnp.asarray(ramp[..., None]),
                          jnp.zeros((1, 8, R3_W, 2), JBF))
    err = float(np.abs(np.asarray(out)[..., 0] - ramp).max())
    print(f"JAX exact warp, zero bf16 flow at W={R3_W}: {err} px")
    assert err >= 1.0


@pytest.mark.parametrize("flow_px", [0.0, -3.0, 5.0, 0.3])
def test_r3_port_exact_warp_bf16_flow_positions_exact(flow_px):
    ramp = _ramp()
    flow = torch.full((1, 2, 8, R3_W), flow_px).to(BF)
    out = flow_warp(torch.from_numpy(ramp)[:, None], flow)[:, 0].numpy()
    fx = float(flow[0, 0, 0, 0])
    want = np.clip(ramp + fx, 0, R3_W - 1)
    if fx == round(fx):
        np.testing.assert_array_equal(out, want)
    else:   # the f32 lerp of two neighbours: its rounding, no more
        np.testing.assert_allclose(out, want, rtol=0, atol=2.5e-4)


def test_r3_port_exact_warp_bf16_image_keeps_the_source():
    rng = np.random.default_rng(3)
    im = torch.from_numpy(rng.random((1, 3, 8, R3_W), np.float32)).to(BF)
    out = flow_warp(im, torch.zeros(1, 2, 8, R3_W, dtype=BF))
    assert out.dtype == BF
    ulp = 2.0 ** -8      # a bf16 ulp of values in [0.5, 1)
    assert float((out.float() - im.float()).abs().max()) <= ulp
    # a subpixel flow lerps in bf16 between the right neighbours
    out = flow_warp(im, torch.full((1, 2, 8, R3_W), 0.5, dtype=BF))
    ref = flow_warp(im.float(), torch.full((1, 2, 8, R3_W), 0.5))
    assert float((out.float() - ref).abs().max()) <= 2 * ulp
