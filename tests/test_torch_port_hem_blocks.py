"""Port HEM-generation blocks (``dcvc_tpu_torch/models/hem_common.py``)
and the HEM converters against the JAX package, on the CPU.

The blocks take seeded *port* weights carried to JAX with
``dcvc_tpu/utils/port_hem.py``; tolerance atol 2e-5 (f32 convolutions in
another summation order). The converters' test uses seeded port weights at
full width and no JAX: ``intra_hem_from_jax`` / ``dmc_hem_from_jax`` must
invert ``port_hem``'s converters exactly, and a reference-named
``state_dict`` saved as ``.pth`` must load with ``strict=True``. The models
and runtimes are tests/test_torch_port_hem.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from dcvc_tpu.models import hem_common as jhem
from dcvc_tpu.utils import port_hem
from dcvc_tpu_torch.models import hem_common
from dcvc_tpu_torch.models.registry import build
from dcvc_tpu_torch.utils.checkpoint import load_state_dict
from dcvc_tpu_torch.utils.convert import dmc_hem_from_jax, intra_hem_from_jax


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


class _Holder(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.m = m


def _map_se(m):
    m._set(("fc1", "kernel"), m._take("m.fc.0.weight").T)
    m._set(("fc2", "kernel"), m._take("m.fc.2.weight").T)


def _map_dq(m):
    m.conv("m.conv1", "conv1")
    for i in range(2):
        m.conv(f"m.resblock.{i}.0", f"res{i}_c1")
        m.conv(f"m.resblock.{i}.2", f"res{i}_c2")
    m.conv("m.conv2", "conv2")
    m.conv("m.conv3", "conv3")


# (port block, flax block, mapper, input NHWC shape)
BLOCKS = {
    "encoder": (lambda: hem_common.HemEncoder(3, 8),
                lambda: jhem.HemEncoder(8), lambda m: m.enc_stack("m"),
                (1, 32, 48, 3)),
    "decoder": (lambda: hem_common.HemDecoder(8, 5),
                lambda: jhem.HemDecoder(8, 5), lambda m: m.dec_stack("m"),
                (1, 3, 4, 8)),
    "hyper_dec": (lambda: hem_common.HemHyperDec(6, 8),
                  lambda: jhem.HemHyperDec(8),
                  lambda m: m.hyper_dec_stack("m"), (1, 3, 5, 6)),
    "conv3_stack": (lambda: hem_common.Conv3Stack(10, (12, 12, 8)),
                    lambda: jhem.Conv3Stack((12, 12, 8)),
                    lambda m: m.conv_stack3("m"), (1, 6, 7, 10)),
    "se_layer": (lambda: hem_common.SELayer(32), lambda: jhem.SELayer(),
                 _map_se, (1, 6, 7, 32)),
    "conv_block_residual": (lambda: hem_common.ConvBlockResidual(6, 32),
                            lambda: jhem.ConvBlockResidual(32),
                            lambda m: m.cbr("m"), (1, 6, 7, 6)),
    "unet": (lambda: hem_common.HemUNet(6, 8), lambda: jhem.HemUNet(8),
             lambda m: m.hem_unet("m"), (1, 8, 12, 6)),
    "dequantization": (lambda: hem_common.DeQuantizationModule(3, 3, 8, 2),
                       lambda: jhem.DeQuantizationModule(3, 8, 2), _map_dq,
                       (1, 6, 7, 3)),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_hem_blocks_match_jax(name):
    port_fn, jax_fn, mapper, shape = BLOCKS[name]
    torch.manual_seed(21)
    block = port_fn().eval()
    m = port_hem._HemMapper(_sd(_Holder(block)))
    mapper(m)
    params = m.finish()
    x = np.random.default_rng(22).normal(size=shape).astype(np.float32)
    jout = jax.jit(jax_fn().apply)(params, jnp.asarray(x))
    with torch.no_grad():
        tout = block(_nchw(x))
    assert _nhwc(tout).shape == jout.shape
    np.testing.assert_allclose(_nhwc(tout), np.asarray(jout), atol=2e-5)


@pytest.mark.parametrize("model", ["intra_hem", "dmc_hem"])
def test_weights_convert_is_exact_inverse_and_pth_loads(model, tmp_path):
    """utils/convert.py inverts port_hem's converter at full width, and a
    reference-named state_dict saved as .pth (wrapped, with a module.
    prefix) loads with strict=True."""
    convert, back_fn = {
        "intra_hem": (port_hem.convert_intra_hem, intra_hem_from_jax),
        "dmc_hem": (port_hem.convert_dmc_hem, dmc_hem_from_jax)}[model]
    module, _ = build(model, seed=23, device="cpu")
    sd = _sd(module)
    back = back_fn(convert(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    path = tmp_path / f"{model}.pth.tar"
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in module.state_dict().items()}}, path)
    loaded, _ = build(model, seed=24, device="cpu",
                      state_dict=load_state_dict(str(path), model))
    for k, v in loaded.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
