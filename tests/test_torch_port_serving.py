"""The port's warm codec server (``dcvc_tpu_torch/serving``,
``python -m dcvc_tpu_torch.tools.serve``) against the JAX package, on the
CPU.

* Protocol: the port's ``send_msg`` writes the bytes of
  ``dcvc_tpu.serving.protocol.send_msg`` over a ``socketpair``, and each
  package's ``recv_msg`` reads the other's.
* An in-process ``CodecServer(device="cpu")`` for ``intra_dc`` + ``dmc_dc``
  (full widths) at 64 x 96, from seeded port weights loaded as ``.pth``
  files, driven by the port's ``CodecClient`` over a Unix socket. The
  weights are carried to the JAX package with ``dcvc_tpu/utils/port_dc.py``
  (no JAX model init). Its image containers (a 56 x 88 image, edge-padded to
  64 x 96 as the JAX server pads) and its session I-frame container equal
  the JAX ``IntraDcRuntime``'s ``pack_i`` bytes. Its P-frame containers
  are held against the port runtimes' direct compress on the same weights
  (the encoder's own DPB, as ``chip_smoke.py``'s runtimes phase codes),
  which ``tests/test_torch_port_runner.py`` holds against the JAX
  runtimes byte for byte: the JAX DMC's two P programs at this shape cost
  ~20 s of compiling. A decode session's recons equal the ``want_recon``
  ones byte for byte.
* The JAX package's ``CodecClient`` drives a port server subprocess
  (``--device cpu``): an image round trip, an unknown op answered with
  ``ok: false`` while the server keeps serving, a client that dies
  mid-message, then ``shutdown`` and exit code 0.
"""

import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from dcvc_tpu.models.intra_dc import IntraNoAR as JIntraNoAR
from dcvc_tpu.models.runtime import IntraDcRuntime as JIntraDcRuntime
from dcvc_tpu.serving import protocol as jprotocol
from dcvc_tpu.serving.server import _pad_hwc as jpad_hwc
from dcvc_tpu.utils import port_dc
from dcvc_tpu.utils import stream as jstream
from dcvc_tpu_torch.models.registry import build
from dcvc_tpu_torch.serving import CodecClient, CodecServer, ServerError
from dcvc_tpu_torch.serving import protocol
from dcvc_tpu_torch.utils import stream
from _flax_init import flax_param_checks  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
H, W = 64, 96
IMG_H, IMG_W = 56, 88        # edge-padded to 64 x 96 by both servers
Q_IMAGE = (True, 1)          # (q_in_ckpt, q_index)
Q_VIDEO = (False, 32)
FRAMES = 3
REQUEST_TIMEOUT_S = 120     # a client waits this long for a reply


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six pytest workers on one host: two torch threads each
    keeps torch's spinning OpenMP pool from starving the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _u8(rng, h, w):
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


# -- protocol -----------------------------------------------------------------

MESSAGES = {
    "header_only": ({"op": "ping"}, []),
    "one_payload": ({"op": "decode_image", "x": [1, 2.5, None]}, [b"\x00\xff" * 7]),
    "payloads": ({"op": "encode_frame", "session": 3, "kind": "p",
                  "name": "café"}, [b"", b"abc", bytes(range(256)) * 40]),
}


def _wire(send, header, payloads) -> bytes:
    a, b = socket.socketpair()
    with a, b:
        send(a, header, payloads)
        a.shutdown(socket.SHUT_WR)
        out = bytearray()
        while chunk := b.recv(65536):
            out.extend(chunk)
    return bytes(out)


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_protocol_bytes_equal_jax(name):
    header, payloads = MESSAGES[name]
    wire = _wire(protocol.send_msg, header, payloads)
    assert wire == _wire(jprotocol.send_msg, header, payloads)
    # each package reads the other's message
    for send, recv in ((jprotocol.send_msg, protocol.recv_msg),
                       (protocol.send_msg, jprotocol.recv_msg)):
        a, b = socket.socketpair()
        with a, b:
            send(a, header, payloads)
            got = recv(b)
            a.close()
            assert recv(b) is None          # clean EOF
        assert got == (header, [bytes(p) for p in payloads])


def test_protocol_peer_closed_mid_message():
    a, b = socket.socketpair()
    with a, b:
        a.sendall(_wire(protocol.send_msg, *MESSAGES["payloads"])[:40])
        a.close()
        with pytest.raises(ConnectionError):
            protocol.recv_msg(b)


# -- in-process server against the JAX runtimes -------------------------------

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_w")
    sd = {"i": build("intra_dc", seed=5, device="cpu")[0].state_dict(),
          "p": build("dmc_dc", seed=6, device="cpu")[0].state_dict()}
    torch.save(sd["i"], d / "i.pth")
    torch.save(sd["p"], d / "p.pth")
    jp_i = port_dc.convert_intra_dc({k: v.numpy() for k, v in sd["i"].items()})
    return {"dir": d, "sd": sd, "jax_i": jp_i}


@pytest.fixture(scope="module")
def served(weights, tmp_path_factory):
    """One in-process server session: an image with its recon and decode,
    an I + 2 P encode session with recons and a decode session."""
    d = weights["dir"]
    server = CodecServer("intra_dc", "dmc_dc", model_path_i=str(d / "i.pth"),
                         model_path_p=str(d / "p.pth"), device="cpu")
    server.warmup(H, W)
    sock = str(tmp_path_factory.mktemp("sock") / "s.sock")
    thread = threading.Thread(target=server.serve, args=(sock,), daemon=True)
    thread.start()
    rng = np.random.default_rng(11)
    img = _u8(rng, IMG_H, IMG_W)
    frames = [_u8(rng, H, W) for _ in range(FRAMES)]
    out = {"img": img, "frames": frames}
    with CodecClient(sock, connect_timeout=60) as c:
        c.sock.settimeout(REQUEST_TIMEOUT_S)
        out["ping"] = c.ping()
        out["img_container"], out["img_recon"], out["img_bpp"] = \
            c.encode_image(img, q_index=Q_IMAGE[1], q_in_ckpt=Q_IMAGE[0],
                           want_recon=True)
        out["img_decoded"] = c.decode_image(out["img_container"])
        sid = c.open_video()
        out["containers"], out["recons"] = [], []
        for i, f in enumerate(frames):
            s, r, _ = c.encode_frame(sid, f, kind="i" if i == 0 else "p",
                                     frame_idx=i, q_index=Q_VIDEO[1],
                                     q_in_ckpt=Q_VIDEO[0], want_recon=True)
            out["containers"].append(s)
            out["recons"].append(r)
        did = c.open_video()
        out["decoded"] = [c.decode_frame(did, s, kind="i" if i == 0 else "p")
                          for i, s in enumerate(out["containers"])]
        c.close_video(sid)
        c.close_video(did)
        out["sessions_left"] = len(server.sessions)
        with pytest.raises(ServerError, match="KeyError"):
            c.encode_frame(sid, frames[1], frame_idx=1)     # a closed session
        out["still_serving"] = c.ping()["ok"]
        c.shutdown()
    thread.join(timeout=60)
    out["stopped"] = not thread.is_alive()
    return out


@pytest.fixture(scope="module")
def jax_intra(weights):
    rt = JIntraDcRuntime(JIntraNoAR(), weights["jax_i"])
    rt.update(force=True)
    return rt


def _jax_pack_i(rt, img_u8, q_in_ckpt, q_index):
    """The JAX server's encode_image container for ``img_u8``."""
    import jax.numpy as jnp

    h, w = img_u8.shape[:2]
    x = jnp.asarray(jpad_hwc(img_u8.astype(np.float32) / 255.0, 16))[None]
    comp = rt.compress(x, q_in_ckpt, q_index)
    return jstream.pack_i(h, w, q_in_ckpt, q_index, comp["bit_stream"])


def test_server_image_container_equals_jax(served, jax_intra):
    assert served["ping"]["pad"] == 16 and served["ping"]["ok"]
    want = _jax_pack_i(jax_intra, served["img"], *Q_IMAGE)
    assert served["img_container"] == want
    h, w, qc, qi, _ = stream.unpack_i(served["img_container"])
    assert (h, w, qc, qi) == (IMG_H, IMG_W, *Q_IMAGE)
    assert served["img_bpp"] == len(want) * 8 / (IMG_H * IMG_W)


def test_server_decoded_image_equals_want_recon(served):
    assert served["img_recon"].shape == (IMG_H, IMG_W, 3)
    np.testing.assert_array_equal(served["img_decoded"], served["img_recon"])


def test_server_session_i_container_equals_jax(served, jax_intra):
    assert served["containers"][0] == _jax_pack_i(
        jax_intra, served["frames"][0], *Q_VIDEO)


def test_server_session_p_containers_equal_direct_compress(served, weights):
    """The port runtimes' own compress on the same frames and weights, each
    P-frame predicted from the encoder's DPB (compress's own), must give
    the server's containers (whose DPB is refreshed from a decompress)."""
    qc, qi = Q_VIDEO
    _, irt = build("intra_dc", device="cpu", state_dict=weights["sd"]["i"])
    _, prt = build("dmc_dc", device="cpu", state_dict=weights["sd"]["p"])
    irt.update()
    prt.update()
    xs = [torch.from_numpy(f.astype(np.float32) / 255.0).permute(2, 0, 1)[None]
          .contiguous() for f in served["frames"]]
    comp = irt.compress(xs[0], qc, qi)
    want = [stream.pack_i(H, W, qc, qi, comp["bit_stream"])]
    dpb = {"ref_frame": comp["x_hat"], "ref_feature": None,
           "ref_mv_feature": None, "ref_y": None, "ref_mv_y": None}
    for i in range(1, FRAMES):
        comp = prt.compress(xs[i], dpb, qc, qi, i)
        want.append(stream.pack_p(comp["bit_stream"], qc, qi, i % 4))
        dpb = comp["dpb"]
    assert served["containers"] == want


def test_server_decode_session_recons_equal_encoder_recons(served):
    for i in range(FRAMES):
        assert served["recons"][i].shape == (H, W, 3)
        np.testing.assert_array_equal(served["decoded"][i],
                                      served["recons"][i])
    assert served["sessions_left"] == 0 and served["still_serving"]
    assert served["stopped"]


@pytest.mark.parametrize("dtype,hw", [("u8", (37, 50)), ("f32", (37, 50)),
                                      ("u8", (48, 64)), ("f32", (48, 64))])
def test_server_conversions_equal_jax(dtype, hw):
    """The port pads a u8 frame before its x / 255 and transposes on the
    device; the values are the JAX server's (convert, then pad) exactly,
    and the recon's u8 bytes are its ``_to_u8`` of the cropped HWC recon."""
    from dcvc_tpu.serving.server import CodecServer as JCodecServer

    h, w = hw
    rng = np.random.default_rng(h + w)
    img = (_u8(rng, h, w) if dtype == "u8"
           else rng.random((h, w, 3)).astype(np.float32))
    server = CodecServer.__new__(CodecServer)
    server.pad, server.device = 16, torch.device("cpu")
    got = server._host_frame(img.tobytes(), h, w, dtype)
    want = jpad_hwc(JCodecServer._to_float_hwc(None, img.tobytes(), h, w,
                                               dtype), 16)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    x = server._device_in(got)
    assert x.is_contiguous() and x.shape == (1, 3, *want.shape[:2])
    np.testing.assert_array_equal(x[0].permute(1, 2, 0).numpy(), want)
    x_hat = torch.from_numpy(rng.random(x.shape).astype(np.float32) * 1.2
                             - 0.1)
    assert server._host_u8(x_hat, h, w) == JCodecServer._to_u8(
        x_hat[0].permute(1, 2, 0).numpy()[:h, :w])


def test_server_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CodecServer("evc_SS")
    from dcvc_tpu_torch.tools import serve

    with pytest.raises(SystemExit, match="device='cpu'"):
        serve.main(["--socket", "unused.sock"])
    with pytest.raises(ValueError, match="padding generation"):
        CodecServer("intra_dc", "dmc_hem", device="cpu")


# -- a port server process driven by the JAX client ---------------------------

def test_jax_client_drives_port_server_process(weights, tmp_path):
    from dcvc_tpu.serving import CodecClient as JCodecClient
    from dcvc_tpu.serving import ServerError as JServerError

    sock = str(tmp_path / "p.sock")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dcvc_tpu_torch.tools.serve", "--socket", sock,
         "--device", "cpu", "--i_frame_model", "intra_dc", "--model_path_i",
         str(weights["dir"] / "i.pth")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        img = _u8(np.random.default_rng(4), 40, 56)
        with JCodecClient(sock, connect_timeout=120.0) as c:
            c.sock.settimeout(REQUEST_TIMEOUT_S)
            assert c.ping()["i_model"] == "intra_dc"
            container, recon, bpp = c.encode_image(img, q_index=2,
                                                   want_recon=True)
            assert jstream.unpack_i(container)[:4] == (40, 56, True, 2)
            assert bpp > 0
            np.testing.assert_array_equal(c.decode_image(container), recon)
            with pytest.raises(JServerError, match="unknown op"):
                c._call({"op": "nope"})
            assert c.ping()["pad"] == 16
        # a client that dies mid-message drops only its own connection
        dying = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        dying.connect(sock)
        dying.sendall(b"\x00\x00\x01\x00{")
        dying.close()
        with JCodecClient(sock, connect_timeout=60.0) as c:
            c.sock.settimeout(REQUEST_TIMEOUT_S)
            np.testing.assert_array_equal(c.decode_image(container), recon)
            c.shutdown()
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out.decode()[-3000:]
        assert not os.path.exists(sock)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
