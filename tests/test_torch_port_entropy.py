"""Port entropy layer (dcvc_tpu_torch/entropy, ops/rans.py + its rans.cpp)
against the JAX package.

  * factorized and Gaussian/Laplace CDF tables: byte-identical;
  * the port's rANS core: round trips, and writes the same bytes as
    dcvc_tpu/ops/rans.py for the same symbols;
  * scale indexes: identical on the same scales;
  * estimated bits match real stream bits (5% + 128 bits, as in
    tests/test_entropy.py), and match the JAX estimates (rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.entropy import bits as jbits
from dcvc_tpu.entropy.bit_estimator import BitEstimator as JBitEstimator
from dcvc_tpu.entropy.bit_estimator import build_factorized_tables as j_tables
from dcvc_tpu.entropy.coder import EntropyCoder as JEntropyCoder
from dcvc_tpu.entropy.gaussian import build_gaussian_tables as j_gaussian
from dcvc_tpu_torch.entropy import bits as tbits
from dcvc_tpu_torch.entropy.bit_estimator import BitEstimator
from dcvc_tpu_torch.entropy.bit_estimator import (
    build_factorized_tables,
    decode_factorized,
    encode_factorized,
)
from dcvc_tpu_torch.entropy.coder import AsyncEntropyCoder, EntropyCoder
from dcvc_tpu_torch.entropy.gaussian import GaussianConditionalCoder
from dcvc_tpu_torch.utils.convert import FlaxToTorch


def _estimators(C, seed):
    jm = JBitEstimator(channels=C)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2, 2, C)))
    m = FlaxToTorch(jax.tree_util.tree_map(np.asarray, params))
    m.bit_estimator("")
    est = BitEstimator(C)
    est.load_state_dict({k.lstrip("."): v for k, v in m.finish().items()},
                        strict=True)
    return jm, params, est


@pytest.mark.parametrize("C,seed", [(16, 0), (64, 1), (128, 2)])
def test_factorized_tables_byte_identical(C, seed):
    jm, params, est = _estimators(C, seed)
    jt = j_tables(params, C)
    tt = build_factorized_tables(est)
    for name in ("quantized_cdf", "cdf_length", "offset"):
        a, b = getattr(tt, name), getattr(jt, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), (
            f"{name}: {(a != b).sum()} entries differ")
    # the estimator's CDF itself, NCHW vs NHWC
    x = np.linspace(-6, 6, 13, dtype=np.float32)
    xj = np.broadcast_to(x[None, :, None, None], (1, 13, 1, C))
    ref = np.asarray(jm.apply(params, jnp.asarray(xj)))
    with torch.no_grad():
        out = est(torch.from_numpy(xj.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("distribution", ["laplace", "gaussian"])
def test_gaussian_tables_byte_identical_and_indexes_equal(distribution):
    g = GaussianConditionalCoder(distribution)
    g.update()
    jg = j_gaussian(distribution)
    for name in ("quantized_cdf", "cdf_length", "offset"):
        assert getattr(g.table, name).tobytes() == getattr(jg.table, name).tobytes()
    rng = np.random.default_rng(0)
    scales = np.concatenate([rng.uniform(0, 70, 5000),
                             [1e-9, 0.01, 0.11, 64.0, 1e5]]).astype(np.float32)
    idx = g.build_indexes(torch.from_numpy(scales)).numpy()
    assert idx.dtype == np.int16
    mismatch = int((idx != np.asarray(jg.build_indexes(jnp.asarray(scales)))).sum())
    print(f"{distribution} scale-index mismatches vs JAX: {mismatch}/{idx.size}")
    assert mismatch == 0


@pytest.mark.parametrize("stream_part", [1, 2])
def test_rans_roundtrip_and_same_bytes_as_jax(stream_part):
    g = GaussianConditionalCoder("laplace")
    g.update()
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 256, 4096).astype(np.int16)
    y_q = np.round(rng.laplace(0, 3.0, 4096)).astype(np.float32)
    y_q[::97] = 500.0                                   # bypass-coded escapes
    coder = EntropyCoder(stream_part=stream_part)
    coder.reset()
    g.encode_with_indexes(coder, y_q, idx)
    coder.flush()
    stream = coder.get_encoded_stream()

    jcoder = JEntropyCoder(stream_part=stream_part)
    jcoder.reset()
    jcoder.encode_with_indexes(y_q, idx, g.table)
    jcoder.flush()
    assert stream == jcoder.get_encoded_stream()

    coder.set_stream(stream)
    np.testing.assert_array_equal(g.decode_with_indexes(coder, idx), y_q)


def test_factorized_roundtrip_and_async_coder():
    _, _, est = _estimators(16, 0)
    table = build_factorized_tables(est)
    z = np.random.default_rng(0).integers(-8, 8, (1, 6, 10, 16)).astype(np.float32)
    coder = AsyncEntropyCoder()
    try:
        coder.reset()
        encode_factorized(coder, z, table)
        coder.flush()
        stream = coder.get_encoded_stream()
        coder.set_stream(stream)
        np.testing.assert_array_equal(
            decode_factorized(coder, z.shape, table), z)
    finally:
        coder.close()
    assert not coder._worker.is_alive()


@pytest.mark.parametrize("distribution", ["laplace", "gaussian"])
def test_estimated_bits_match_real_stream(distribution):
    g = GaussianConditionalCoder(distribution)
    g.update()
    rng = np.random.default_rng(2)
    scales = rng.uniform(0.3, 8.0, size=(1, 32, 32, 64)).astype(np.float32)
    y = rng.laplace(0, scales) if distribution == "laplace" else rng.normal(0, scales)
    y_q = np.round(y).astype(np.float32)
    est_t = (tbits.y_laplace_bits if distribution == "laplace"
             else tbits.y_gaussian_bits)
    est_j = (jbits.y_laplace_bits if distribution == "laplace"
             else jbits.y_gaussian_bits)
    est = float(est_t(torch.from_numpy(y_q), torch.from_numpy(scales)).sum())
    ref = float(jnp.sum(est_j(jnp.asarray(y_q), jnp.asarray(scales))))
    np.testing.assert_allclose(est, ref, rtol=1e-5)

    coder = EntropyCoder()
    coder.reset()
    g.encode_with_indexes(coder, y_q,
                          g.build_indexes(torch.from_numpy(scales)).numpy())
    coder.flush()
    real = len(coder.get_encoded_stream()) * 8
    assert est * 0.85 < real < est * 1.05 + 128


def test_xla_f32_math_is_bit_exact():
    """The table bake's exp / sigmoid / softplus / tanh repeat XLA:CPU's f32
    results bit for bit (torch's own differ in the last ulp)."""
    from dcvc_tpu_torch.entropy import _xla_f32 as xf

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 3, 100000), rng.uniform(-30, 30, 50000),
                        rng.normal(0, 0.02, 20000),
                        [0.0, -0.0, 1e-30, -100.0, 100.0]]).astype(np.float32)
    for jf, tf in [(jnp.exp, xf.exp), (jax.nn.sigmoid, xf.sigmoid),
                   (jax.nn.softplus, xf.softplus), (jnp.tanh, xf.tanh)]:
        np.testing.assert_array_equal(tf(x), np.asarray(jax.jit(jf)(x)))
