"""Port four-part prior (dcvc_tpu_torch/models/priors.py) against the JAX one.

The same numpy-seeded latents, prior params and spatial-prior functions (a
per-step linear map with the same weights in both frameworks) go through
both. Symbol planes must be identical; float planes agree to atol 1e-5
(matmul summation order). The decode chain, fed the encoder's symbols,
reproduces the encoder's scales and y_hat.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models import priors as J
from dcvc_tpu_torch.models import priors as T
from _flax_init import flax_param_checks  # noqa: F401 (autouse)

B, H, W, C = 1, 6, 8, 16


def _setup(seed):
    rng = np.random.default_rng(seed)
    y = rng.normal(0, 3, (B, H, W, C)).astype(np.float32)
    params = rng.normal(0, 1, (B, H, W, 3 * C)).astype(np.float32)
    params[..., :C] = rng.uniform(0.2, 2.0, (B, H, W, C))   # quant steps
    mats = [rng.normal(0, 0.2, (4 * C, 2 * C)).astype(np.float32)
            for _ in range(3)]
    j_fns = [lambda p, m=m: jnp.split(jnp.einsum("bhwc,cd->bhwd", p, m), 8,
                                      axis=-1) for m in mats]
    t_fns = [lambda p, m=torch.from_numpy(m): torch.einsum(
        "bchw,cd->bdhw", p, m).chunk(8, 1) for m in mats]
    return y, params, j_fns, t_fns


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_write_planes_and_decode_chain_match_jax(seed):
    y, params, j_fns, t_fns = _setup(seed)
    jq, js, jy = J.forward_four_part_prior(jnp.asarray(y), jnp.asarray(params),
                                           j_fns, write=True)
    tq, ts, ty = T.forward_four_part_prior(_nchw(y), _nchw(params), t_fns,
                                           write=True)
    for step in range(4):
        np.testing.assert_array_equal(_nhwc(tq[step]), np.asarray(jq[step]))
        np.testing.assert_allclose(_nhwc(ts[step]), np.asarray(js[step]),
                                   atol=1e-5)
    np.testing.assert_allclose(_nhwc(ty), np.asarray(jy), atol=1e-5)

    # decode chain on the encoder's symbols, in both packages
    tp = _nchw(params)
    so_far = torch.zeros(B, C, H, W)
    jso = jnp.zeros((B, H, W, C))
    for step in range(4):
        scales, means = T.four_part_decode_scales(tp, so_far, t_fns, step)
        jscales, jmeans = J.four_part_decode_scales(jnp.asarray(params), jso,
                                                    j_fns, step)
        np.testing.assert_array_equal(scales.numpy(), ts[step].numpy())
        np.testing.assert_allclose(_nhwc(scales), np.asarray(jscales), atol=1e-5)
        so_far = T.four_part_decode_update(tp, so_far, tq[step], means, step)
        jso = J.four_part_decode_update(jnp.asarray(params), jso,
                                        jnp.asarray(_nhwc(tq[step])), jmeans,
                                        step)
    y_hat = T.four_part_finalize(tp, so_far)
    np.testing.assert_array_equal(y_hat.numpy(), ty.numpy())
    np.testing.assert_allclose(
        _nhwc(y_hat), np.asarray(J.four_part_finalize(jnp.asarray(params), jso)),
        atol=1e-5)


def test_estimate_mode_matches_jax():
    y, params, j_fns, t_fns = _setup(2)
    jout = J.forward_four_part_prior(jnp.asarray(y), jnp.asarray(params), j_fns)
    tout = T.forward_four_part_prior(_nchw(y), _nchw(params), t_fns)
    for a, b in zip(tout, jout):      # y_res, y_q, y_hat, scales_hat
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=1e-5)


def test_masks_rounding_and_quantizers():
    for p in range(4):
        np.testing.assert_array_equal(
            _nhwc(T.spatial_phase_mask(5, 7, p)),
            np.asarray(J.spatial_phase_mask(5, 7, p)))
    x = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], requires_grad=True)
    np.testing.assert_array_equal(T.quant_round(x).detach().numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x.detach().numpy()))))
    T.resolve_quant("ste")(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(6))
    # "noise" keeps the STE recon path, as the JAX package's resolve_quant
    assert T.resolve_quant("noise") is T.quant_ste
    assert J.resolve_quant("noise") is J.quant_ste
    with pytest.raises(ValueError):
        T.resolve_quant("nearest")
