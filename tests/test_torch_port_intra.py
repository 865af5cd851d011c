"""Port IntraNoAR + IntraDcRuntime against the JAX package, on the CPU.

Golden widths (N=32, ch_a=16, ch_b=24, tests/test_golden_bins.py:66) and
the golden case's own init (PRNGKey(0), not jitted); the flax params reach
the port through utils/convert.py with load_state_dict(strict=True).
Tolerances: x_hat / bits / latents atol 1e-4 (f32 convolutions in another
summation order through a deep network); symbol planes and int16 scale
indexes must be identical (mismatch counts are printed).
"""

import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.intra_dc import IntraNoAR as JIntraNoAR
from dcvc_tpu.entropy.gaussian import GaussianConditionalCoder as JGaussian
from dcvc_tpu.models.runtime import IntraDcRuntime as JIntraDcRuntime
from dcvc_tpu.models.runtime import _build_indexes_i16 as j_idx16
from dcvc_tpu.utils import port_dc
from dcvc_tpu_torch.models.intra_dc import IntraNoAR, build_intra_dc
from dcvc_tpu_torch.models.runtime import IntraDcRuntime
from dcvc_tpu_torch.utils import stream
from dcvc_tpu_torch.utils.convert import intra_dc_from_jax


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six pytest workers on one host: two torch threads each
    keeps torch's spinning OpenMP pool from starving the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def intra():
    jm = JIntraNoAR(N=32, ch_a=16, ch_b=24)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                     jnp.ones(()), jnp.ones(()))
    tm = IntraNoAR(N=32, ch_a=16, ch_b=24)
    tm.load_state_dict(intra_dc_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    trt = IntraDcRuntime(tm, device="cpu")
    trt.update()
    return jm, params, tm, trt


def _x(seed, h=64, w=64, gain=6.0):
    rng = np.random.default_rng(seed)
    return (rng.random((1, h, w, 3)) * gain - gain / 2.5).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_forward_and_compress_planes_match_jax(intra):
    jm, params, tm, trt = intra
    x = _x(0)
    one = jnp.ones(())
    jout = jax.jit(jm.apply)(params, jnp.asarray(x), one, one)
    with torch.no_grad():
        tout = tm(_nchw(x), torch.tensor(1.0), torch.tensor(1.0))
    np.testing.assert_allclose(_nhwc(tout["x_hat"]), np.asarray(jout["x_hat"]),
                               atol=1e-4)
    np.testing.assert_allclose(float(tout["bit"]), float(jout["bit"]), rtol=1e-4)

    jc = jax.jit(lambda p, a: jm.apply(p, a, one, one,
                                       method=JIntraNoAR.compress_device))(
        params, jnp.asarray(x))
    with torch.no_grad():
        tc = tm.compress_device(_nchw(x), torch.tensor(1.0), torch.tensor(1.0))
    np.testing.assert_array_equal(_nhwc(tc["z_hat"]), np.asarray(jc["z_hat"]))
    g = trt.gaussian
    jg = j_idx16(JGaussian(distribution="gaussian"))
    sym_bad = idx_bad = 0
    for tq, jq, ts, js in zip(tc["y_q_planes"], jc["y_q_planes"],
                              tc["scales_planes"], jc["scales_planes"]):
        sym_bad += int((_nhwc(tq) != np.asarray(jq)).sum())
        tidx = _nhwc(g.build_indexes(ts))
        jidx = np.asarray(jg(js))
        idx_bad += int((tidx != jidx).sum())
    print(f"intra symbol mismatches {sym_bad}, scale-index mismatches {idx_bad}")
    assert sym_bad == 0 and idx_bad == 0
    np.testing.assert_allclose(_nhwc(tc["x_hat"]), np.asarray(jc["x_hat"]),
                               atol=1e-4)


def test_runtime_roundtrip_exact(intra):
    _, _, _, trt = intra
    x = _nchw(_x(1))
    comp = trt.compress(x, False, 20)
    data = stream.pack_i(64, 64, False, 20, comp["bit_stream"])
    h, w, q_in_ckpt, q_index, s = stream.unpack_i(data)
    assert (h, w, q_in_ckpt, q_index) == (64, 64, False, 20)
    dec = trt.decompress(s, h, w, q_in_ckpt, q_index)
    np.testing.assert_allclose(dec["x_hat"].numpy(), comp["x_hat"].numpy(),
                               atol=1e-5)


def test_golden_dc_intra_and_cross_package_streams(intra):
    """The committed dcvc_tpu stream (tests/golden/dc_intra.bin) decodes in
    the port; the port re-encodes the golden input (byte match recorded);
    a port stream decodes in dcvc_tpu."""
    from test_golden_bins import _img

    jm, params, _, trt = intra
    golden = (GOLDEN / "dc_intra.bin").read_bytes()
    manifest = json.loads((GOLDEN / "manifest.json").read_text())["dc_intra"]
    assert hashlib.sha256(golden).hexdigest() == manifest["sha256"]
    x = np.asarray(_img(seed=11, gain=1.5))

    comp = trt.compress(_nchw(x), True, 0)
    data = stream.pack_i(128, 128, True, 0, comp["bit_stream"])
    n = min(len(data), len(golden))
    diff = sum(a != b for a, b in zip(data[:n], golden[:n])) + abs(len(data) - len(golden))
    print(f"dc_intra: port stream {len(data)} B vs golden {len(golden)} B, "
          f"{diff} bytes differ")

    h, w, q_in_ckpt, q_index, s = stream.unpack_i(golden)
    dec = trt.decompress(s, h, w, q_in_ckpt, q_index)
    np.testing.assert_allclose(dec["x_hat"].numpy(), comp["x_hat"].numpy(),
                               atol=1e-4)

    jrt = JIntraDcRuntime(jm, params)
    jrt.update(force=True)
    jdec = jrt.decompress(comp["bit_stream"], 128, 128, True, 0)
    np.testing.assert_allclose(np.asarray(jdec["x_hat"]),
                               _nhwc(comp["x_hat"]), atol=1e-4)
    assert data == golden


def test_weights_convert_is_exact_inverse():
    tm = build_intra_dc(N=32, ch_a=16, ch_b=24, seed=3, device="cpu")
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    back = intra_dc_from_jax(port_dc.convert_intra_dc(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    IntraNoAR(N=32, ch_a=16, ch_b=24).load_state_dict(back, strict=True)
