"""Port DMC + DmcRuntime against the JAX package, on the CPU.

Every test that needs the JAX DMC shares ONE module-scoped fixture (its
init is the expensive part). DMC runs at its fixed full widths on 64x64
frames, two chained P-frames, with od_warp_mode "block:4,4,64,128,median4"
on both sides; the golden case (tests/golden/dc_p.bin) uses the exact warp
as the golden generator does. Weights come from the golden init
(``DMC().init`` at PRNGKey(0), replayed by ``tests/_flax_init.py`` with no
init compile) through utils/convert.py.

Tolerances: x_hat and DPB tensors atol 1e-4 (f32 convolutions in another
summation order, compounded over a deep network and two frames); bits
rtol 1e-4; symbol planes and int16 scale indexes identical (mismatch counts
are printed).
"""

import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.runtime import DmcRuntime as JDmcRuntime
from dcvc_tpu.models.video_dc import DMC as JDMC
from dcvc_tpu.utils import port_dc
from dcvc_tpu_torch.models.runtime import DmcRuntime
from dcvc_tpu_torch.models.video_dc import DMC, build_dmc
from dcvc_tpu_torch.utils import stream
from dcvc_tpu_torch.utils.convert import dmc_from_jax
from _flax_init import init_params
from _flax_init import flax_param_checks  # noqa: F401 (autouse)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six pytest workers on one host: two torch threads each
    keeps torch's spinning OpenMP pool from starving the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

BLOCK = "block:4,4,64,128,median4"
GOLDEN = Path(__file__).parent / "golden"
DPB_KEYS = ("ref_frame", "ref_feature", "ref_mv_feature", "ref_y", "ref_mv_y")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _dpb0(ref):
    return {"ref_frame": ref, "ref_feature": None, "ref_mv_feature": None,
            "ref_y": None, "ref_mv_y": None}


@pytest.fixture(scope="module")
def dmc():
    jm = JDMC(od_warp_mode=BLOCK)
    x0 = jnp.zeros((1, 64, 64, 3))
    qs = {k: jnp.ones(()) for k in ("mv_enc", "mv_dec", "y_enc", "y_dec")}
    params = init_params(JDMC(), x0, _dpb0(x0), qs, 0)
    jrt = JDmcRuntime(jm, params)
    jrt.update(force=True)
    sd = dmc_from_jax(jax.tree_util.tree_map(np.asarray, params))
    ports = {}
    for mode in (BLOCK, "exact"):
        tm = DMC(od_warp_mode=mode)
        tm.load_state_dict(sd, strict=True)
        ports[mode] = DmcRuntime(tm, device="cpu")
        ports[mode].update()
    rng = np.random.default_rng(5)
    frames = [rng.random((1, 64, 64, 3)).astype(np.float32) for _ in range(3)]
    return {"jm": jm, "params": params, "jrt": jrt, "qs": qs, "ports": ports,
            "frames": frames}


def _close_dpb(tdpb, jdpb, atol=1e-4):
    for k in DPB_KEYS:
        np.testing.assert_allclose(_nhwc(tdpb[k]), np.asarray(jdpb[k]),
                                   atol=atol, err_msg=k)


def test_forward_two_chained_p_frames_match_jax(dmc):
    jm, params, qs = dmc["jm"], dmc["params"], dmc["qs"]
    tm = dmc["ports"][BLOCK].module
    ref, x1, x2 = dmc["frames"]
    fwd = jax.jit(jm.apply)
    jdpb, tdpb = _dpb0(jnp.asarray(ref)), _dpb0(_nchw(ref))
    tqs = {k: torch.tensor(1.0) for k in qs}
    for fi, x in ((1, x1), (2, x2)):
        jout = fwd(params, jnp.asarray(x), jdpb, qs, fi)
        with torch.no_grad():
            tout = tm(_nchw(x), tdpb, tqs, fi)
        for k in ("bpp", "bpp_y", "bpp_z", "bpp_mv_y", "bpp_mv_z"):
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        _close_dpb(tout["dpb"], jout["dpb"])
        jdpb, tdpb = jout["dpb"], tout["dpb"]


def _jax_symbols(jrt, x, dpb, fi):
    """The JAX runtime's own int16 symbols and scale indexes (its compress
    program's packed output)."""
    qs = jrt.get_q_for_inference(True, 0)
    out = jrt._compress_dev(jrt.params, jnp.asarray(x), dpb, qs,
                            jnp.asarray(fi, jnp.int32))
    packed = np.asarray(out["packed"])
    n_z = (64 + 128) * 1 * 1
    bits = np.ascontiguousarray(packed[n_z:]).view(np.uint32)
    return ((bits & 0xFFFF).astype(np.uint16).view(np.int16),
            (bits >> 16).astype(np.uint16).view(np.int16))


def _port_symbols(rt, x, dpb, fi):
    from dcvc_tpu_torch.models.runtime import _symbols_nhwc, _to_host_nhwc

    qs = rt.get_q_for_inference(True, 0)
    with torch.no_grad():
        out = rt.module.compress_device(_nchw(x), dpb, qs, fi)
    planes = out["mv_y_q_planes"] + out["y_q_planes"]
    scales = out["mv_scales_planes"] + out["scales_planes"]
    return (np.concatenate([_symbols_nhwc(q) for q in planes]),
            np.concatenate([_to_host_nhwc(rt.gaussian.build_indexes(s)).reshape(-1)
                            for s in scales]))


def test_write_stream_matches_jax_and_streams_cross_decode(dmc):
    """Two chained P-frames through both runtimes: DPBs agree, symbol
    planes and scale indexes are identical, and each package decodes the
    other's stream (port<-JAX both frames, JAX<-port the first)."""
    jrt, trt = dmc["jrt"], dmc["ports"][BLOCK]
    ref, x1, x2 = dmc["frames"]
    jdpb, tdpb = _dpb0(jnp.asarray(ref)), _dpb0(_nchw(ref))
    for fi, x in ((1, x1), (2, x2)):
        jsym, jidx = _jax_symbols(jrt, x, jdpb, fi)
        tsym, tidx = _port_symbols(trt, x, tdpb, fi)
        print(f"frame {fi}: symbol mismatches {(jsym != tsym).sum()}/{jsym.size}, "
              f"scale-index mismatches {(jidx != tidx).sum()}/{jidx.size}")
        np.testing.assert_array_equal(tsym, jsym)
        np.testing.assert_array_equal(tidx, jidx)

        jc = jrt.compress(jnp.asarray(x), jdpb, True, 0, fi)
        tc = trt.compress(_nchw(x), tdpb, True, 0, fi)
        _close_dpb(tc["dpb"], jc["dpb"])
        assert tc["bit_stream"] == jc["bit_stream"]
        # the port decodes the JAX package's stream
        td = trt.decompress(tdpb, jc["bit_stream"], 64, 64, True, 0, fi)
        _close_dpb(td["dpb"], jc["dpb"])
        if fi == 1:  # and the reverse
            jd = jrt.decompress(jdpb, tc["bit_stream"], 64, 64, True, 0, fi)
            _close_dpb(tc["dpb"], jd["dpb"])
        jdpb, tdpb = jc["dpb"], tc["dpb"]


def test_port_runtime_roundtrip_exact(dmc):
    trt = dmc["ports"][BLOCK]
    ref, x1, x2 = dmc["frames"]
    enc_dpb = dec_dpb = _dpb0(_nchw(ref))
    for fi, x in ((1, x1), (2, x2)):
        comp = trt.compress(_nchw(x), enc_dpb, False, 40, fi)
        q_in_ckpt, q_index, frame_idx, s = stream.unpack_p(
            stream.pack_p(comp["bit_stream"], False, 40, fi))
        assert (q_in_ckpt, q_index, frame_idx) == (False, 40, fi)
        dec = trt.decompress(dec_dpb, s, 64, 64, q_in_ckpt, q_index, frame_idx)
        for k in DPB_KEYS:
            np.testing.assert_allclose(dec["dpb"][k].numpy(),
                                       comp["dpb"][k].numpy(), atol=1e-5,
                                       err_msg=k)
        enc_dpb, dec_dpb = comp["dpb"], dec["dpb"]


def test_golden_dc_p(dmc):
    """The committed dcvc_tpu P stream (tests/golden/dc_p.bin): the port
    re-encodes the golden input (byte match recorded) and decodes it."""
    from test_golden_bins import _img

    trt = dmc["ports"]["exact"]
    golden = (GOLDEN / "dc_p.bin").read_bytes()
    manifest = json.loads((GOLDEN / "manifest.json").read_text())["dc_p"]
    assert hashlib.sha256(golden).hexdigest() == manifest["sha256"]
    ref = _nchw(_img(192, 192, seed=12, gain=3.0))
    x = _nchw(_img(192, 192, seed=112, gain=3.0))
    comp = trt.compress(x, _dpb0(ref), True, 0, 1)
    data = stream.pack_p(comp["bit_stream"], True, 0, 1)
    n = min(len(data), len(golden))
    diff = sum(a != b for a, b in zip(data[:n], golden[:n])) + abs(len(data) - len(golden))
    print(f"dc_p: port stream {len(data)} B vs golden {len(golden)} B, "
          f"{diff} bytes differ")
    q_in_ckpt, q_index, frame_idx, s = stream.unpack_p(golden)
    dec = trt.decompress(_dpb0(ref), s, 192, 192, q_in_ckpt, q_index, frame_idx)
    np.testing.assert_allclose(dec["dpb"]["ref_frame"].numpy(),
                               comp["dpb"]["ref_frame"].numpy(), atol=1e-4)
    assert data == golden


def test_weights_convert_is_exact_inverse_and_cpu_default_warp():
    tm = build_dmc(seed=3, device="cpu")
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    back = dmc_from_jax(port_dc.convert_dmc(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    DMC().load_state_dict(back, strict=True)
    assert tm.align.warp_mode is None  # resolves per device: exact on CPU
