"""The port's (data, tile) mesh and sharded inference against JAX and the
dc_p pin, on four gloo ranks of the CPU.

One spawn of ``tests/_mesh_ranks.py`` (4 processes, one torch thread
each, joined by a gloo group on localhost) serves the whole file through
a module fixture; it has its own time limit, after which the test fails
with the ranks' output. While the ranks run their first cases, the
parent makes the dc_p pin's weights (``tests/_flax_init.init_params``,
as ``test_torch_port_dmc.py`` does) and computes the references: JAX's
unsharded ``EVCIntra.apply`` on the seeded port EVC carried over with
``port_dc.convert_evc``, and the port's own unsharded DMC runs (which
``test_torch_port_dmc.py`` holds against JAX). The cases mirror
``tests/test_sharding.py``, ``test_sharding_coding.py`` and
``test_sharding_dmc.py``.

EVC's and DMC's sharded streams are byte-equal to the unsharded ones.
Tolerances: EVC x_hat atol 2e-5 and bpp rtol 1e-5 against JAX; the DMC
forward's recon atol 3e-5 and bpp rtol 2e-4 against the unsharded port;
sharded decode recon / ref_feature atol 3e-5 against the unsharded
decode; the sharded encoder and decoder agree exactly; streams are
byte-equal; the tile primitives are bit-exact.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.evc import EVCIntra as JEVCIntra
from dcvc_tpu.models.video_dc import DMC as JDMC
from dcvc_tpu.utils import port_dc
from dcvc_tpu_torch.entropy.coder import EntropyCoder
from dcvc_tpu_torch.entropy.gaussian import GaussianConditionalCoder
from dcvc_tpu_torch.models.runtime import DmcRuntime, EvcCodecRuntime
from dcvc_tpu_torch.models.video_dc import build_dmc
from dcvc_tpu_torch.parallel import mesh as M
from dcvc_tpu_torch.utils import stream
from dcvc_tpu_torch.utils.convert import dmc_from_jax
from _flax_init import init_params
import _mesh_ranks as R
from _waits import communicate_all

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"
SPAWN_TIMEOUT_S = 300


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _coding_inputs():
    """dc_p's weights (the golden init) and frames, and a 256 x 256 pair."""
    from test_golden_bins import _img

    x0 = jnp.zeros((1, 64, 64, 3))
    qs = {k: jnp.ones(()) for k in ("mv_enc", "mv_dec", "y_enc", "y_dec")}
    params = init_params(JDMC(), x0, R.dpb0(x0), qs, 0)
    sd = dmc_from_jax(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(11)
    x256 = rng.random((1, 3, 256, 256), dtype=np.float32)
    ref256 = (np.roll(x256, 3, axis=3) * 0.9
              + 0.1 * rng.random(x256.shape, dtype=np.float32))
    return {"sd": sd, "ref": _nchw(_img(192, 192, seed=12, gain=3.0)),
            "x": _nchw(_img(192, 192, seed=112, gain=3.0)),
            "x256": torch.from_numpy(x256),
            "ref256": torch.from_numpy(ref256.astype(np.float32))}


def _references(coding):
    """JAX's unsharded EVC and the port's unsharded DMC runs."""
    ref = {}
    evc = R.build_evc()
    params = port_dc.convert_evc(
        {k: v.detach().numpy() for k, v in evc.state_dict().items()})
    jout = jax.jit(JEVCIntra(R.EVC_CH, R.EVC_CH, R.EVC_N).apply)(
        params, jnp.asarray(R.evc_input().transpose(0, 2, 3, 1)),
        jnp.ones(()))
    ref["evc_x_hat"] = _nchw(jout["x_hat"])
    ref["evc_bpp"] = np.asarray(jout["bpp"])
    rt = EvcCodecRuntime(evc, device="cpu")
    rt.update()
    ref["evc_coding"] = rt.compress(
        torch.from_numpy(R.evc_input()[:1]), 1.0)

    module = build_dmc(seed=R.DMC_SEED, device="cpu")
    rt = DmcRuntime(module, device="cpu")
    x, r = R.dmc_forward_inputs()
    for name, mode in R.DMC_MODES.items():
        module.align.warp_mode = mode
        out = rt.forward_one_frame(x, R.dpb0(r), True, 0, 1)
        ref[f"dmc_forward_{name}"] = {"ref_frame": out["dpb"]["ref_frame"],
                                      "bpp": out["bpp"]}

    pin = build_dmc(device="cpu", od_warp_mode="exact")
    pin.load_state_dict(coding["sd"], strict=True)
    rt = DmcRuntime(pin, device="cpu")
    rt.update()
    golden = (GOLDEN / "dc_p.bin").read_bytes()
    _, _, _, s = stream.unpack_p(golden)
    dec = rt.decompress(R.dpb0(coding["ref"]), s, 192, 192, True, 0, 1)
    ref["dc_p_dec"] = dec["dpb"]
    ref["bytes_256"] = rt.compress(coding["x256"], R.dpb0(coding["ref256"]),
                                   True, 0, 1)["bit_stream"]
    return ref


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Spawn the 4 gloo ranks, compute the references meanwhile, then
    collect the ranks' results within SPAWN_TIMEOUT_S."""
    work = tmp_path_factory.mktemp("mesh")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_mesh_ranks.py"), str(r), "4",
         str(port), str(work)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(4)]
    deadline = time.time() + SPAWN_TIMEOUT_S
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        coding = _coding_inputs()
        torch.save(coding, work / "coding.tmp")
        os.replace(work / "coding.tmp", work / "coding.pt")
        with torch.no_grad():
            ref = _references(coding)
        outs = communicate_all(procs, max(deadline - time.time(), 1))
    finally:
        torch.set_num_threads(n)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{o[-3000:]}"
                    for r, (p, o) in enumerate(zip(procs, outs)))
    assert all(p.returncode == 0 for p in procs), log
    res = torch.load(work / "results.pt", weights_only=False)
    print("rank case seconds:", res["times"])
    return res, ref


def test_make_mesh_shapes_placements_and_refusals(sharded):
    from torch.distributed.tensor import Replicate, Shard

    m = sharded[0]["mesh"]
    assert m["names"] == ("data", "tile")
    assert m["default"] == (2, 2) and m["tile4"] == (1, 4)
    assert m["tile3"][0] == "AssertionError", m["tile3"]
    assert "data=1, tile=3" in m["tile3"][1]
    assert m["cuda"][0] == "RuntimeError" and "CUDA" in m["cuda"][1]
    assert m["frame"] == (Shard(0), Shard(2))
    assert m["tile"] == (Replicate(), Shard(2))
    assert m["replicated"] == (Replicate(), Replicate())
    assert m["scalar"] == (Shard(0), Replicate())


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        M.make_mesh(4, device_type="cpu")


@pytest.mark.parametrize("name", R.PRIMITIVES)
def test_tile_primitive_is_bit_exact(sharded, name):
    assert sharded[0]["primitives"][name] == 0.0


def test_evc_tile4_matches_jax(sharded):
    res, ref = sharded
    np.testing.assert_allclose(res["evc_tile4_x_hat"].numpy(),
                               ref["evc_x_hat"][:2].numpy(), atol=2e-5)


def test_evc_data4_bpp_matches_jax(sharded):
    res, ref = sharded
    np.testing.assert_allclose(res["evc_data4_bpp"].numpy(), ref["evc_bpp"],
                               rtol=1e-5)


def test_evc_sharded_coding_gives_unsharded_bytes(sharded):
    """EVC's compress on tile 4 writes the unsharded stream, and the
    sharded decoder gives the sharded encoder's recon exactly."""
    res, ref = sharded
    got = res["evc_coding_tile4"]
    assert got["bytes"] == ref["evc_coding"]["bit_stream"]
    np.testing.assert_array_equal(got["dec"].numpy(), got["enc"].numpy())
    np.testing.assert_allclose(got["enc"].numpy(),
                               ref["evc_coding"]["x_hat"].numpy(), atol=1e-5)


@pytest.mark.parametrize("mode", list(R.DMC_MODES))
def test_dmc_forward_sharded_matches_unsharded(sharded, mode):
    res, ref = sharded
    got, want = res[f"dmc_forward_{mode}"], ref[f"dmc_forward_{mode}"]
    np.testing.assert_allclose(got["ref_frame"].numpy(),
                               want["ref_frame"].numpy(), atol=3e-5)
    np.testing.assert_allclose(got["bpp"].numpy(), want["bpp"].numpy(),
                               rtol=2e-4)


def test_block_od_warp_under_tile_axis_raises(sharded):
    msg = sharded[0]["block_under_tile"]
    assert msg is not None and "tile axis of 2 ranks" in msg


@pytest.mark.parametrize("name", [n for n, _ in R.CODINGS])
def test_dmc_sharded_compress_gives_golden_bytes(sharded, name):
    container = sharded[0][f"coding_{name}"]["container"]
    manifest = json.loads((GOLDEN / "manifest.json").read_text())["dc_p"]
    assert hashlib.sha256(container).hexdigest() == manifest["sha256"]
    assert container == (GOLDEN / "dc_p.bin").read_bytes()


def test_dmc_sharded_compress_256_tile4_gives_unsharded_bytes(sharded):
    res, ref = sharded
    assert res["coding_256_tile4"] == ref["bytes_256"]


@pytest.mark.parametrize("name", [n for n, _ in R.CODINGS])
def test_dmc_sharded_decompress_matches(sharded, name):
    res, ref = sharded
    got = res[f"coding_{name}"]
    for k in ("ref_frame", "ref_feature"):
        # the sharded decoder reproduces the sharded encoder exactly ...
        np.testing.assert_array_equal(got[f"dec_{k}"].numpy(),
                                      got[f"enc_{k}"].numpy(), err_msg=k)
        # ... and the unsharded decode of the same (golden) stream
        np.testing.assert_allclose(got[f"dec_{k}"].numpy(),
                                   ref["dc_p_dec"][k].numpy(), atol=3e-5,
                                   err_msg=k)


def test_stream_parts_align_to_latent_tiles():
    """With stream_part == tiles and yh % parts == 0 the coder's
    contiguous parts are the H tiles of the plane
    (test_sharding_coding.py:120)."""
    parts, yh, yw, ch = 4, 16, 16, 32
    rng = np.random.default_rng(5)
    sym = rng.integers(-40, 40, size=(yh, yw, ch)).astype(np.int16)
    g = GaussianConditionalCoder(distribution="laplace")
    g.update(force=True)
    scales = np.abs(rng.normal(2.0, 1.0, size=(yh, yw, ch))).astype(
        np.float32) + 0.3
    idx = g.build_indexes_np(scales).astype(np.int16).reshape(-1)
    coder = EntropyCoder(stream_part=parts)
    g.encode_with_indexes(coder, sym.reshape(-1), idx)
    coder.flush()
    dec = EntropyCoder(stream_part=parts)
    dec.set_stream(coder.get_encoded_stream())
    out = np.asarray(g.decode_with_indexes(dec, idx))
    np.testing.assert_array_equal(out.reshape(yh, yw, ch), sym)
    each = yh * yw * ch // parts
    assert each % (yw * ch) == 0, "part boundary must land on a row"
    rows = each // (yw * ch)
    assert rows == yh // parts
    for p in range(parts):
        np.testing.assert_array_equal(
            sym.reshape(-1)[p * each:(p + 1) * each],
            sym[p * rows:(p + 1) * rows].reshape(-1))
