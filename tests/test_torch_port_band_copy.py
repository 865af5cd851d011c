"""Port K2 (dcvc_tpu_torch/ops/band_copy.py, tools/diag_dma.py) against the
JAX package's Pallas probe, on the CPU.

The TPU kernel (``tools/diag_dma.py:make_bench``) runs in TPU interpret
mode: ``pl.pallas_call`` is wrapped with ``interpret=pltpu.InterpretParams()``
for the test only. The port's wrapper takes its plain version on CPU
tensors. Both copy f32 values, so they must agree exactly (atol 0).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dcvc_tpu_torch.ops import band_copy as bc
from dcvc_tpu_torch.tools import diag_dma as tdiag

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jdiag():
    """tools/diag_dma.py as a module; its import-time compilation-cache
    setting is undone so that no cache is written outside the checkout."""
    prev = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "diag_dma", ROOT / "tools" / "diag_dma.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax.config.update("jax_compilation_cache_dir", prev)
    return mod


def _inputs(H, Wp, C, A, seed):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((H + A, C, Wp)).astype(np.float32)
    by = np.clip(rng.integers(-8, 8, H) + np.arange(H), 0, H - 1)
    by = by.astype(np.int32)
    by[0], by[-1] = 0, H - 1              # the first and the last band
    return src, by


@pytest.mark.parametrize("H,Wp,C,A", [
    (16, 128, 4, 4),      # 16-byte copies (row pitch a multiple of 16 B)
    (16, 130, 3, 4),      # Wp % 4 != 0: 4-byte copies
    (24, 64, 2, 3),       # three grid steps, odd band height
])
def test_band_copy_matches_pallas_interpret(jdiag, monkeypatch, H, Wp, C, A):
    monkeypatch.setattr(jdiag.pl, "pallas_call", functools.partial(
        jdiag.pl.pallas_call, interpret=pltpu.InterpretParams()))
    src, by = _inputs(H, Wp, C, A, seed=H + Wp)
    ref = np.asarray(jdiag.make_bench(H, Wp, C, A)(jnp.asarray(by),
                                                    jnp.asarray(src)))
    before = bc.band_copy.launches
    out = bc.band_copy(torch.from_numpy(src), torch.from_numpy(by), A)
    assert bc.band_copy.launches == before       # CPU: the plain version
    assert out.shape == (H, Wp) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        bc.band_copy_plain(torch.from_numpy(src), torch.from_numpy(by)).numpy(),
        ref)


def test_band_copy_preconditions_raise():
    src = torch.zeros(20, 2, 32)
    by = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of rows_per_step"):
        bc.band_copy(src, by[:12], 4)
    with pytest.raises(ValueError, match="leave src rows"):
        bc.band_copy(src, torch.full((16,), 17, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="leave src rows"):
        bc.band_copy(src, torch.full((16,), -1, dtype=torch.int32), 4)
    with pytest.raises(TypeError):
        bc.band_copy(src, by.long(), 4)
    with pytest.raises(TypeError):
        bc.band_copy(src.double(), by, 4)
    with pytest.raises(ValueError, match=r"\[Hs, C, Wp\]"):
        bc.band_copy(src[0], by, 4)
    # the last band that fits is accepted
    out = bc.band_copy(src, torch.full((16,), 16, dtype=torch.int32), 4)
    assert out.shape == (16, 32)


def test_diag_tool_runs_on_cpu_and_counts_no_launch():
    before = bc.band_copy.launches
    row = tdiag.run(H=16, Wp=128, C=4, A=4, iters=2, device="cpu",
                    verbose=False)
    assert bc.band_copy.launches == before
    assert row["card"] == "cpu" and row["out_finite"]
    assert row["requested_bytes"] == 16 * 4 * 128 * 4 * 4
    src, by = tdiag.make_inputs(720, 64, 1, 4, torch.device("cpu"))
    assert src.shape == (724, 1, 64) and by.dtype == torch.int32
    assert int(by.min()) >= 0 and int(by.max()) <= 719
