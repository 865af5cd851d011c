"""The port's CompressAI intra zoo (GDN, EntropyBottleneck,
GaussianConditional, the five models, IntraZooRuntime) against the JAX
package, on the CPU.

Weights are made once per model by the port, seeded, with the bottleneck's
quantiles moved off their init (so the channels' medians and pmf lengths
differ), and carried to the JAX package with its own converter
(``dcvc_tpu/utils/port_zoo.convert_zoo``): no JAX model init runs. Widths
are cut (N = 16, M = 24; Cheng2020 N = M = 16) and the image is 128x192,
driven out of gamut as the golden pins' inputs are, so every latent
carries symbols.

Tolerances: the baked CDF tables, the GaussianConditional tables and scale
indexes, and every stream must be identical; each package decodes the
other's stream, the port to its own encoder recon exactly and to the JAX
recon within atol 1e-5 (f32 convolutions in another summation order, as
are the layers and the estimated-bits forward: atol 1e-5 / rtol 1e-5;
its bpp within atol 1e-4, since torch's and XLA's f32 ``ndtr`` differ by
ulps over thousands of elements).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.entropy.bottleneck import EntropyBottleneck as JEntropyBottleneck
from dcvc_tpu.entropy.bottleneck import build_bottleneck_tables as j_tables
from dcvc_tpu.entropy.gaussian_conditional import (
    GaussianConditional as JGaussianConditional,
)
from dcvc_tpu.layers.gdn import GDN as JGDN
from dcvc_tpu.layers.gdn import GDN1 as JGDN1
from dcvc_tpu.models import intra_zoo as jzoo
from dcvc_tpu.models.runtime import IntraZooRuntime as JIntraZooRuntime
from dcvc_tpu.utils import port_zoo
from dcvc_tpu_torch.entropy.bottleneck import (
    EntropyBottleneck,
    build_bottleneck_tables,
)
from dcvc_tpu_torch.entropy.gaussian_conditional import GaussianConditional
from dcvc_tpu_torch.layers.gdn import GDN, GDN1
from dcvc_tpu_torch.models.intra_zoo import build_zoo
from dcvc_tpu_torch.models.runtime import IntraZooRuntime
from dcvc_tpu_torch.utils.convert import ZOO_KINDS, zoo_from_jax
from _flax_init import flax_param_checks  # noqa: F401 (autouse)

ATOL = 1e-5


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
    return {k: v.numpy() for k, v in module.state_dict().items()}


# ---- GDN ----


@pytest.mark.parametrize("kind", ["gdn", "igdn", "gdn1"])
def test_gdn_matches_jax(kind):
    rng = np.random.default_rng(3)
    C = 12
    tm = (GDN1 if kind == "gdn1" else GDN)(C, inverse=kind == "igdn")
    with torch.no_grad():
        tm.beta.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)))
        # a few entries under the bounds, to take the lower_bound's branch
        tm.gamma.copy_(torch.from_numpy(
            rng.uniform(-0.05, 0.4, (C, C)).astype(np.float32)))
    jm = (JGDN1 if kind == "gdn1" else JGDN)(C, inverse=kind == "igdn")
    x = rng.normal(0, 2, (2, 9, 7, C)).astype(np.float32)
    params = {"params": _sd(tm)}
    jout = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        tout = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(tout), np.asarray(jout), atol=ATOL,
                               rtol=1e-5)


# ---- EntropyBottleneck ----


def _bottleneck(C, spread, seed):
    """A port bottleneck with every parameter moved off its init and
    quantile tails up to ``spread`` wide; its JAX params."""
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    eb = EntropyBottleneck(C)
    with torch.no_grad():
        for p in [*eb._matrices, *eb._biases, *eb._factors]:
            p.add_(torch.from_numpy(rng.normal(0, 0.5, p.shape).astype(np.float32)))
        q = rng.normal(0, 1, (C, 1, 3)).astype(np.float32)
        q[:, 0, 0] -= spread * rng.random(C)
        q[:, 0, 2] += spread * rng.random(C)
        eb.quantiles.copy_(torch.from_numpy(q))
    params = {"quantiles": eb.quantiles.detach().numpy()}
    for i in range(5):
        params[f"matrix{i}"] = eb._matrices[i].detach().numpy()
        params[f"bias{i}"] = eb._biases[i].detach().numpy()
        if i < 4:
            params[f"factor{i}"] = eb._factors[i].detach().numpy()
    return eb, {"params": params}


# spreads giving pmf lengths of 1 mod 8 and others: XLA:CPU's
# vector-matrix loop rounds its scalar remainder apart (_xla_f32)
@pytest.mark.parametrize("C,spread,seed", [(16, 10.0, 0), (32, 3.3, 1),
                                           (40, 15.2, 2), (8, 0.6, 3)])
def test_bottleneck_tables_byte_identical(C, spread, seed):
    eb, params = _bottleneck(C, spread, seed)
    jt = j_tables(params, JEntropyBottleneck(C))
    tt = build_bottleneck_tables(eb)
    np.testing.assert_array_equal(tt.quantized_cdf, jt.quantized_cdf)
    np.testing.assert_array_equal(tt.cdf_length, jt.cdf_length)
    np.testing.assert_array_equal(tt.offset, jt.offset)


def test_bottleneck_likelihood_matches_jax():
    eb, params = _bottleneck(12, 8.0, 4)
    jm = JEntropyBottleneck(12)
    rng = np.random.default_rng(4)
    x = np.round(rng.normal(0, 4, (2, 5, 6, 12))).astype(np.float32)
    jlik = jm.apply(params, jnp.asarray(x), method=JEntropyBottleneck.likelihood)
    with torch.no_grad():
        tlik = eb.likelihood(_nchw(x))
    np.testing.assert_allclose(_nhwc(tlik), np.asarray(jlik), atol=ATOL,
                               rtol=1e-5)


def test_gaussian_conditional_tables_and_indexes_identical():
    jg, tg = JGaussianConditional(), GaussianConditional()
    jg.update()
    tg.update()
    for name in ("quantized_cdf", "cdf_length", "offset"):
        np.testing.assert_array_equal(getattr(tg.table, name),
                                      getattr(jg.table, name), err_msg=name)
    scales = np.exp(np.random.default_rng(5).uniform(-4, 6.5, 4000))
    for s in (scales, scales.astype(np.float32)):
        np.testing.assert_array_equal(tg.build_indexes_np(s),
                                      jg.build_indexes_np(s))


# ---- the five models through their runtimes ----


def _widths(name):
    return ({"N": 16} if name == "cheng2020-anchor"
            else {"N": 16, "M": 24})


@pytest.fixture(scope="module", params=list(ZOO_KINDS))
def zoo(request):
    """(name, port module, its JAX params, the JAX module)."""
    name = request.param
    tm = build_zoo(name, seed=3, device="cpu", **_widths(name))
    rng = np.random.default_rng(5)
    with torch.no_grad():
        q = tm.entropy_bottleneck.quantiles
        q.add_(torch.from_numpy(rng.normal(0, 1.5, q.shape).astype(np.float32)))
    params = port_zoo.convert_zoo(_sd(tm), ZOO_KINDS[name])
    jkw = {"N": 16, "M": 16} if name == "cheng2020-anchor" else _widths(name)
    return name, tm, params, jzoo.model_architectures[name](**jkw)


def _image():
    from test_golden_bins import _img

    return np.asarray(_img(128, 192, seed=30, gain=8.0))


_JAX_RUNTIMES = {}


def _jax_runtime(name, jm, params):
    """One JAX IntraZooRuntime per model, its programs compiled once."""
    if name not in _JAX_RUNTIMES:
        _JAX_RUNTIMES[name] = JIntraZooRuntime(jm, params)
    jrt = _JAX_RUNTIMES[name]
    jrt.update(force=True)
    return jrt


def test_zoo_streams_identical_and_decode_across(zoo):
    """Each model's strings equal the JAX IntraZooRuntime's on the same
    weights; each package decodes the other's."""
    name, tm, params, jm = zoo
    x = _image()
    jrt = _jax_runtime(name, jm, params)
    rt = IntraZooRuntime(tm, device="cpu")
    rt.update()
    jc = jrt.compress(jnp.asarray(x))
    tc = rt.compress(_nchw(x))
    assert tuple(tc["shape"]) == tuple(jc["shape"])
    assert tc["strings"] == jc["strings"]
    assert all(len(s) > 20 for s in tc["strings"]), [len(s) for s in tc["strings"]]
    shape = rt.latent_shape(128, 192)
    assert shape == tuple(jc["shape"])
    tdec = rt.decompress(jc["strings"], shape)
    jdec = jrt.decompress(tc["strings"], shape)
    np.testing.assert_array_equal(tdec["x_hat"].numpy(), tc["x_hat"].numpy())
    np.testing.assert_allclose(_nhwc(tdec["x_hat"]), np.asarray(jdec["x_hat"]),
                               atol=ATOL)


def test_zoo_two_part_streams_equal_jax(zoo):
    """``stream_part = 2`` set after the runtime is built, as the CLIs and
    the server set it (ROADMAP F5): the z strings and the one-shot y
    strings equal the JAX runtime's. The joint models' wavefront y string
    keeps one part (the port's own one-part string): the JAX package's
    two-part AR string does not decode to its encoder's recon (ROADMAP
    R5), the port's does."""
    name, tm, params, jm = zoo
    x = _image()
    jrt = _jax_runtime(name, jm, params)
    rt = IntraZooRuntime(tm, device="cpu")
    one = IntraZooRuntime(tm, device="cpu")
    one.update()
    for r in (jrt, rt):
        r.stream_part = 2
        r.update(force=True)
    try:
        jc = jrt.compress(jnp.asarray(x))
        jdec = jrt.decompress(jc["strings"], jc["shape"])
    finally:
        jrt.stream_part = 1
    tc = rt.compress(_nchw(x))
    oc = one.compress(_nchw(x))
    joint = rt.kind == "joint"
    if len(tc["strings"]) > 1:      # z; the factorized model has y only
        assert tc["strings"][1] == jc["strings"][1] != oc["strings"][1]
    if joint:
        assert tc["strings"][0] == oc["strings"][0] != jc["strings"][0]
        gap = float(np.abs(np.asarray(jdec["x_hat"])
                           - np.asarray(jc["x_hat"])).max())
        assert gap > 1e-3, f"R5: JAX's two-part AR string decoded ({gap})"
    else:
        assert tc["strings"][0] == jc["strings"][0] != oc["strings"][0]
    dec = rt.decompress(tc["strings"], rt.latent_shape(128, 192))
    np.testing.assert_array_equal(dec["x_hat"].numpy(), tc["x_hat"].numpy())


def test_zoo_forward_matches_jax(zoo):
    """The estimated-bits forward (the CLIs' no-stream mode)."""
    _, tm, params, jm = zoo
    x = _image()
    jout = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        tout = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(tout["x_hat"]), np.asarray(jout["x_hat"]),
                               atol=ATOL)
    for k in ("bpp", "bpp_y", "bpp_z"):
        if k in jout:
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                       atol=1e-4, err_msg=k)


def test_zoo_converter_round_trip(zoo):
    """``port_zoo.convert_zoo`` and ``zoo_from_jax`` are inverses."""
    name, tm, params, _ = zoo
    sd = zoo_from_jax(params, ZOO_KINDS[name])
    assert set(sd) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    back = port_zoo.convert_zoo({k: v.numpy() for k, v in sd.items()},
                                ZOO_KINDS[name])
    flat = jax.tree_util.tree_leaves_with_path(back)
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat) == len(ref)
    for path, v in flat:
        np.testing.assert_array_equal(v, ref[path])


def test_zoo_checkpoints_load(zoo, tmp_path):
    """``load_state_dict`` takes the JAX package's ``.npz`` (``save_params``)
    and a reference-style ``.pth`` whose baked buffers (CDF tables, the
    scale table, bounds, pedestals, the AR mask) it drops; both load
    strictly into the port model."""
    from dcvc_tpu.utils.checkpoint import save_params
    from dcvc_tpu_torch.utils.checkpoint import load_state_dict

    name, tm, params, _ = zoo
    save_params(str(tmp_path / "m.npz"), params)
    sd = tm.state_dict()
    gdn = "g_a.0.gdn" if name == "cheng2020-anchor" else "g_a.1"
    ref = dict(sd, **{
        "entropy_bottleneck._quantized_cdf": torch.zeros(4, 8, dtype=torch.int32),
        "entropy_bottleneck._offset": torch.zeros(4, dtype=torch.int32),
        "entropy_bottleneck._cdf_length": torch.zeros(4, dtype=torch.int32),
        "gaussian_conditional.scale_table": torch.ones(64),
        f"{gdn}.beta_reparam.pedestal": torch.zeros(1),
        f"{gdn}.gamma_reparam.lower_bound.bound": torch.zeros(1)})
    if name in ("mbt2018", "cheng2020-anchor"):
        ref["context_prediction.mask"] = torch.ones(1, 1, 5, 5)
    torch.save({"state_dict": {f"module.{k}": v for k, v in ref.items()}},
               tmp_path / "m.pth.tar")
    for path in ("m.npz", "m.pth.tar"):
        got = load_state_dict(str(tmp_path / path), name)
        build_zoo(name, device="cpu", **_widths(name)).load_state_dict(
            got, strict=True)
        for k, v in sd.items():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(),
                                          err_msg=f"{path} {k}")
