"""Port tests that need an NVIDIA card (marker ``cuda``; they skip without
one). Run on the card with:

    DCVC_TPU_TEST_ON_TPU=1 python -m pytest -m cuda tests/test_torch_port_cuda.py

(DCVC_TPU_TEST_ON_TPU=1 keeps tests/conftest.py from importing JAX, which
the machine with the card does not need.) The block-warp kernel is held
against its plain PyTorch version on the card: the same arithmetic with
each op rounded separately, so f32 and bf16 outputs agree exactly (atol 0).
The band-copy kernel copies values, so it too agrees exactly.
"""

import pytest
import torch

from dcvc_tpu_torch.ops import band_copy as bc
from dcvc_tpu_torch.ops import block_warp as bw

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("base_mode", ["median", "mean", "median4"])
@pytest.mark.parametrize("shape,blk", [
    ((2, 3, 24, 48), (4, 2, 8, 16)),
    ((3, 1, 17, 33), (4, 2, 8, 16)),        # pad-to-block path
    ((4, 3, 130, 260), (4, 4, 64, 128)),     # the OffsetDiversity block
    ((3, 3, 130, 262), (4, 4, 64, 128)),     # border blocks, W % 4 != 0
    ((2, 3, 20, 600), (8, 2, 8, 512)),       # the JAX default block
    ((2, 1, 70, 136), (4, 4, 64, 128)),      # C = 1
    ((2, 5, 70, 136), (4, 4, 64, 128)),      # C = 5: channel groups in f32
    # 75 units a row (no shift); median4 sorts 2400 samples in shared
    # memory, median's 38400 take the PyTorch prep
    ((1, 2, 128, 300), (8, 2, 128, 300)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, shape, blk, base_mode, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    M, C, H, W = shape
    im = torch.rand(shape, generator=g, device=cuda).to(dtype)
    # the last two shifts push whole windows to the clamp
    for scale, shift in [(0.5, 3.0), (8.0, 0.0), (0.3, -40.0), (2.0, 300.0),
                         (2.0, -300.0)]:
        flow = torch.randn(M, 2, H, W, generator=g, device=cuda) * scale + shift
        before = bw.block_warp_nchw.launches
        out = bw.block_warp_nchw(im, flow, *blk, base_mode)
        torch.cuda.synchronize()
        assert bw.block_warp_nchw.launches == before + 1
        plain = bw.block_warp_plain_nchw(im, flow, *blk, base_mode)
        assert out.dtype == dtype
        torch.testing.assert_close(out, plain, atol=0, rtol=0)


def _prep_flows(M, H, W, device):
    """Flows whose block medians need care: a checkerboard of 4x4 cells of
    two values per component, so every even-count median averages two
    distinct middle values, some of them exactly at .5 (round half to
    even), and a noisy flow that pushes windows to the clamp."""
    g = torch.Generator(device=device).manual_seed(3)
    yy = torch.arange(H, device=device).view(H, 1) // 4
    xx = torch.arange(W, device=device).view(1, W) // 4
    cell = ((yy + xx) % 2 == 0).expand(M, H, W)
    flows = []
    for (a, b), (c, d) in [((1.2, 2.9), (-0.7, 0.4)),    # distinct middles
                           ((1.0, 2.0), (2.0, 3.0)),     # 1.5 -> 2, 2.5 -> 2
                           ((-3.0, -2.0), (-1.0, 0.0))]:  # -2.5, -0.5 -> -0
        fx = torch.where(cell, torch.tensor(a, device=device),
                         torch.tensor(b, device=device))
        fy = torch.where(cell, torch.tensor(c, device=device),
                         torch.tensor(d, device=device))
        flows.append(torch.stack([fx, fy], 1).float())
    flows.append(torch.randn(M, 2, H, W, generator=g, device=device) * 6.0
                 + 30.0)
    return flows


@pytest.mark.parametrize("base_mode", ["median", "median4"])
@pytest.mark.parametrize("shape,blk", [
    ((3, 130, 260), (4, 4, 64, 128)),
    ((2, 20, 600), (8, 2, 8, 512)),
    ((2, 17, 33), (4, 2, 8, 16)),            # pad-to-block path
])
def test_card_prep_matches_block_prep(cuda, shape, blk, base_mode):
    M, H, W = shape
    Dh, Rv, BH, BW = blk
    BH, BW = bw._block_dims(H, W, BH, BW)
    for flow in _prep_flows(M, H, W, cuda):
        card = bw._prep_card(flow, BH, BW, Dh, Rv, base_mode, 16)
        torch.cuda.synchronize()
        ref = bw._block_prep(flow, BH, BW, Dh, Rv, base_mode, 16)
        assert card[4:] == ref[4:]
        for a, b in zip(card[:4], ref[:4]):
            assert a.dtype == b.dtype and a.shape == b.shape
            torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_kernel_rejects_mismatched_flow(cuda):
    im = torch.rand(1, 3, 16, 32, device=cuda)
    with pytest.raises(ValueError):
        bw.block_warp_nchw(im, torch.zeros(1, 2, 16, 31, device=cuda))


def test_runtime_roundtrip_on_card(cuda):
    from dcvc_tpu_torch.models.intra_dc import build_intra_dc
    from dcvc_tpu_torch.models.runtime import DmcRuntime, IntraDcRuntime
    from dcvc_tpu_torch.models.video_dc import build_dmc

    irt = IntraDcRuntime(build_intra_dc(N=32, ch_a=16, ch_b=24))
    prt = DmcRuntime(build_dmc())
    irt.update()
    prt.update()
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand(1, 3, 128, 128, generator=g, device=cuda)
    comp = irt.compress(x, False, 10)
    dec = irt.decompress(comp["bit_stream"], 128, 128, False, 10)
    assert torch.equal(comp["x_hat"], dec["x_hat"])
    enc_dpb = {"ref_frame": comp["x_hat"], "ref_feature": None,
               "ref_mv_feature": None, "ref_y": None, "ref_mv_y": None}
    dec_dpb = dict(enc_dpb, ref_frame=dec["x_hat"])
    before = bw.block_warp_nchw.launches
    c = prt.compress(torch.roll(x, 3, 3), enc_dpb, False, 10, 1)
    d = prt.decompress(dec_dpb, c["bit_stream"], 128, 128, False, 10, 1)
    assert bw.block_warp_nchw.launches == before + 2
    for k, v in c["dpb"].items():
        assert torch.equal(v, d["dpb"][k]), k


def test_offset_diversity_bf16_launches_k1_matching_plain(cuda,
                                                         monkeypatch):
    """A bf16 OffsetDiversity on the card launches K1 once, on its bf16
    maps and f32-cast flow, and K1 equals its plain version there."""
    from dcvc_tpu_torch.models.video_net import OffsetDiversity
    from dcvc_tpu_torch.ops.warp import RD_GATED_BLOCK_MODE

    torch.manual_seed(0)
    od = OffsetDiversity(dtype=torch.bfloat16).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.rand(1, 48, 128, 256, generator=g, device=cuda)
    aux = torch.rand(1, 53, 128, 256, generator=g, device=cuda)
    flow = 3 * torch.randn(1, 2, 128, 256, generator=g, device=cuda)
    calls = []
    launch = bw._launch          # behind the wrapper's launch counter

    def spy(im, fl, *spec):
        calls.append((im.clone(), fl.clone(), spec))
        return launch(im, fl, *spec)

    monkeypatch.setattr(bw, "_launch", spy)
    before = bw.block_warp_nchw.launches
    with torch.no_grad():
        out = od(x.bfloat16(), aux.bfloat16(), flow.bfloat16())
    torch.cuda.synchronize()
    assert bw.block_warp_nchw.launches == before + 1 and len(calls) == 1
    assert out.dtype == torch.float32      # the f32 fusion bias, as in JAX
    im, fl, spec = calls[0]             # Dh, Rv, BH, BW, base_mode, pad
    assert im.dtype == torch.bfloat16 and im.shape == (32, 3, 128, 256)
    assert RD_GATED_BLOCK_MODE.endswith(",".join(map(str, spec[:5])))
    monkeypatch.undo()
    ker = bw.block_warp_nchw(im, fl, *spec)
    plain = bw.block_warp_plain_nchw(im, fl, *spec)
    assert ker.dtype == torch.bfloat16
    assert torch.equal(ker, plain)


def _evc_input(cuda, seed=2):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.rand(1, 3, 256, 256, generator=g, device=cuda) * 4 - 1.5


def test_evc_roundtrip_on_card(cuda):
    """EVC at narrow widths: the card's decode gives the encoder's recon
    (gap <= 1e-5) and no K1 / K2 launch."""
    from dcvc_tpu_torch.models.evc import EVCIntra
    from dcvc_tpu_torch.models.runtime import EvcCodecRuntime

    torch.manual_seed(0)
    rt = EvcCodecRuntime(EVCIntra((16, 16, 24, 32), (16, 16, 24, 32), 32))
    rt.update()
    x = _evc_input(cuda)
    k1, k2 = bw.block_warp_nchw.launches, bc.band_copy.launches
    comp = rt.compress(x, 0.85)
    dec = rt.decompress(comp["bit_stream"], 256, 256, 0.85)
    assert (comp["x_hat"] - dec["x_hat"]).abs().max().item() <= 1e-5
    assert (bw.block_warp_nchw.launches, bc.band_copy.launches) == (k1, k2)


def test_evc_forward_card_matches_cpu(cuda):
    from dcvc_tpu_torch.models.evc import EVCIntra

    torch.manual_seed(1)
    m = EVCIntra((16, 16, 24, 32), (16, 16, 24, 32), 32).eval()
    x = _evc_input(cuda, 3)
    q = torch.tensor(0.85)
    with torch.no_grad():
        cpu = m(x.cpu(), q)
        card = m.to(cuda)(x, q.to(cuda))
    for k in ("x_hat", "bpp"):
        gap = (card[k].cpu() - cpu[k]).abs().max().item()
        assert gap <= 1e-4, (k, gap)


def test_scalable_evc_roundtrip_on_card(cuda):
    from dcvc_tpu_torch.models.evc_scalable import build_evc_scalable
    from dcvc_tpu_torch.models.runtime import ScalableEvcRuntime

    rt = ScalableEvcRuntime(build_evc_scalable(
        enc_channels=(8, 8, 12, 16), dec_channels=(16, 16, 16, 16), N=16,
        seed=4), rate_idx=3)
    rt.update()
    comp = rt.compress(_evc_input(cuda, 5), 0.7)
    dec = rt.decompress(comp["bit_stream"], 256, 256, 0.7)
    assert 0 <= comp["enc_id"] < 4
    assert (comp["x_hat"] - dec["x_hat"]).abs().max().item() <= 1e-5


def test_hem_roundtrip_on_card(cuda):
    """intra_hem + dmc_hem at narrow widths on 128x192: I recon equal, P
    DPB gap <= 1e-4; no K1 launch with exact mc, 4 + 4 with the block mc
    (the frame warp and three context warps, each side)."""
    from dcvc_tpu_torch.models.intra_hem import build_intra_hem
    from dcvc_tpu_torch.models.runtime import EvcCodecRuntime, HemVideoRuntime
    from dcvc_tpu_torch.models.video_hem import build_dmc_hem
    from dcvc_tpu_torch.ops.warp import RD_GATED_BLOCK_MODE

    irt = EvcCodecRuntime(build_intra_hem(N=32, seed=1))
    prt = HemVideoRuntime(build_dmc_hem(seed=2, channel_mv=16, channel_N=16,
                                        channel_M=24))
    irt.update()
    prt.update()
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.rand(1, 3, 128, 192, generator=g, device=cuda)
    comp = irt.compress(x, 0.73)
    dec = irt.decompress(comp["bit_stream"], 128, 192, 0.73)
    assert torch.equal(comp["x_hat"], dec["x_hat"])
    enc_dpb = {"ref_frame": comp["x_hat"], "ref_feature": None,
               "ref_y": None, "ref_mv_y": None}
    dec_dpb = dict(enc_dpb, ref_frame=dec["x_hat"])
    for mode, launches in ((None, 0), (RD_GATED_BLOCK_MODE, 8)):
        prt.module.mc_warp_mode = mode
        before = bw.block_warp_nchw.launches
        c = prt.compress(torch.roll(x, 3, 3) * 3 - 1, enc_dpb, 0.9, 0.8)
        d = prt.decompress(dec_dpb, c["bit_stream"], 128, 192, 0.9, 0.8)
        assert bw.block_warp_nchw.launches == before + launches
        for k, v in c["dpb"].items():
            assert (v - d["dpb"][k]).abs().max().item() <= 1e-4, (mode, k)
        enc_dpb, dec_dpb = c["dpb"], d["dpb"]


def test_kernel_matches_plain_at_hem_mc_shape(cuda):
    """K1 on one 64-channel map (channel groups), the 1080p context3 shape
    of dmc_hem's block mc, with a smooth flow and per-pixel jitter."""
    g = torch.Generator(device=cuda).manual_seed(4)
    im = torch.rand(1, 64, 272, 480, generator=g, device=cuda)
    yy = torch.linspace(0, 1, 272, device=cuda).view(1, 272, 1)
    xx = torch.linspace(0, 1, 480, device=cuda).view(1, 1, 480)
    flow = torch.stack([3.0 * torch.sin(4.0 * yy + xx) + 1.5,
                        2.0 * torch.cos(3.0 * xx - yy)], 1)
    flow = flow + 0.7 * torch.randn(1, 2, 272, 480, generator=g, device=cuda)
    before = bw.block_warp_nchw.launches
    out = bw.block_warp_nchw(im, flow, 4, 4, 64, 128, "median4")
    torch.cuda.synchronize()
    assert bw.block_warp_nchw.launches == before + 1
    plain = bw.block_warp_plain_nchw(im, flow, 4, 4, 64, 128, "median4")
    torch.testing.assert_close(out, plain, atol=0, rtol=0)

@pytest.mark.parametrize("name", ["bmshj2018-hyperprior", "mbt2018"])
def test_zoo_roundtrip_on_card(cuda, name):
    """A one-shot and a wavefront-AR zoo model at narrow widths on
    128x192: the decoder's recon equals the encoder's; no kernel."""
    from dcvc_tpu_torch.models.intra_zoo import build_zoo
    from dcvc_tpu_torch.models.runtime import IntraZooRuntime

    rt = IntraZooRuntime(build_zoo(name, seed=5, N=32, M=48))
    rt.update()
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.rand(1, 3, 128, 192, generator=g, device=cuda) * 6 - 2.5
    before = bw.block_warp_nchw.launches
    comp = rt.compress(x)
    dec = rt.decompress(comp["strings"], rt.latent_shape(128, 192))
    assert bw.block_warp_nchw.launches == before
    assert all(len(s) > 0 for s in comp["strings"])
    assert torch.equal(comp["x_hat"], dec["x_hat"])


def _p_roundtrips(cuda, prt, code, per_frame):
    """Two P-frames through ``code(x, enc_dpb, dec_dpb) -> (enc, dec
    recon)``, exact mc then the block mc: K1 launches 0, then
    ``per_frame``; recon gap <= 1e-4."""
    from dcvc_tpu_torch.ops.warp import RD_GATED_BLOCK_MODE

    g = torch.Generator(device=cuda).manual_seed(7)
    ref = torch.rand(1, 3, 128, 192, generator=g, device=cuda)
    x = torch.roll(ref, 3, 3) * 3 - 1
    for mode, launches in ((None, 0), (RD_GATED_BLOCK_MODE, per_frame)):
        prt.module.mc_warp_mode = mode
        before = bw.block_warp_nchw.launches
        enc, dec = code(x, ref)
        assert bw.block_warp_nchw.launches == before + launches
        assert (enc - dec).abs().max().item() <= 1e-4, mode


def test_tcm_roundtrip_on_card(cuda):
    """dmc_tcm at narrow widths: K1 4 + 4 under the block mc."""
    from dcvc_tpu_torch.models.runtime import TcmVideoRuntime
    from dcvc_tpu_torch.models.video_tcm import build_dmc_tcm

    prt = TcmVideoRuntime(build_dmc_tcm(seed=8, channel_mv=16, channel_N=16,
                                        channel_M=24))
    prt.update()

    def code(x, ref):
        c = prt.compress(x, ref, None)
        d = prt.decompress(ref, None, c["bit_stream"], 128, 192)
        assert (c["feature"] - d["feature"]).abs().max().item() <= 1e-4
        return c["x_hat"], d["x_hat"]

    _p_roundtrips(cuda, prt, code, 8)


def test_gen1_roundtrip_on_card(cuda):
    """dcvc_gen1 at narrow widths (AR mv and y on the host): K1 1 + 1
    under the block mc."""
    from dcvc_tpu_torch.models.runtime import DcvcGen1Runtime
    from dcvc_tpu_torch.models.video_dcvc import build_dcvc_gen1

    prt = DcvcGen1Runtime(build_dcvc_gen1(seed=9, channel_mv=16,
                                          channel_N=16, channel_M=24))
    prt.update()

    def code(x, ref):
        c = prt.compress(ref, x)
        d = prt.decompress(ref, c["mv_y_string"], c["mv_z_string"],
                           c["y_string"], c["z_string"], 128, 192)
        return c["recon_image"], d["recon_image"]

    _p_roundtrips(cuda, prt, code, 2)


def test_kernel_matches_plain_at_gen1_mc_shape(cuda):
    """K1 on gen-1's 1080p mc shape, one 64-channel full-resolution map."""
    g = torch.Generator(device=cuda).manual_seed(10)
    im = torch.rand(1, 64, 1088, 1920, generator=g, device=cuda)
    yy = torch.linspace(0, 1, 1088, device=cuda).view(1, 1088, 1)
    xx = torch.linspace(0, 1, 1920, device=cuda).view(1, 1, 1920)
    flow = torch.stack([6.0 * torch.sin(3.0 * yy + 2.0 * xx) - 2.0,
                        4.0 * torch.cos(2.0 * xx - yy)], 1)
    flow = flow + 1.5 * torch.randn(1, 2, 1088, 1920, generator=g, device=cuda)
    before = bw.block_warp_nchw.launches
    out = bw.block_warp_nchw(im, flow, 4, 4, 64, 128, "median4")
    torch.cuda.synchronize()
    assert bw.block_warp_nchw.launches == before + 1
    plain = bw.block_warp_plain_nchw(im, flow, 4, 4, 64, 128, "median4")
    torch.testing.assert_close(out, plain, atol=0, rtol=0)


@pytest.mark.parametrize("rows_per_step", [1, 8, 16])
@pytest.mark.parametrize("H,Wp,C,A", [
    (720, 1408, 16, 4),    # the probe's shape: bulk copies, 7 chunks/band
    (16, 130, 3, 4),       # C * Wp * 4 % 16 != 0: 4-byte copies
    (64, 1004, 5, 7),      # 8 row groups; chunks 46,848 / 46,864 B
    (720, 1408, 1, 1),     # one-row, one-channel bands: 1 chunk each
    (16, 20000, 2, 2),     # band row 0 spans two chunks
])
def test_band_copy_kernel_matches_plain(cuda, H, Wp, C, A, rows_per_step):
    from dcvc_tpu_torch.tools.diag_dma import make_inputs

    src, by = make_inputs(H, Wp, C, A, cuda)
    for first, last in [(0, H - 1), (H, 0)]:   # both ends of src
        by[0], by[-1] = first, last
        before = bc.band_copy.launches
        out = bc.band_copy(src, by, A, rows_per_step)
        torch.cuda.synchronize()
        assert bc.band_copy.launches == before + 1
        torch.testing.assert_close(out, bc.band_copy_plain(src, by), atol=0,
                                   rtol=0)
    plan = bc.plan_for(src, by, A, rows_per_step)
    assert plan.grid == min(plan.stages, bc.sm_count(src.device))


def test_band_copy_kernel_misaligned_src_takes_4_byte_copies(cuda):
    from dcvc_tpu_torch.tools.diag_dma import make_inputs

    base, by = make_inputs(64, 1004, 5, 7, cuda)
    flat = torch.empty(base.numel() + 1, device=cuda)
    src = flat[1:].view(base.shape)            # 4 bytes past 16-byte alignment
    src.copy_(base)
    assert not bc.plan_for(src, by, 7, 8).bulk
    out = bc.band_copy(src, by, 7)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, bc.band_copy_plain(base, by), atol=0,
                               rtol=0)


def test_band_copy_refused_shared_memory_raises(cuda):
    """A launch the card refuses (here: more dynamic shared memory than a
    CTA may have) raises; the wrapper does not fall back to the plain
    version, counts no launch, and the next launch works."""
    import dataclasses

    from dcvc_tpu_torch.tools.diag_dma import make_inputs

    src, by = make_inputs(720, 1408, 16, 4, cuda)
    plan = bc.plan_for(src, by, 4, 8)
    big = dataclasses.replace(plan, slot_bytes=plan.slot_bytes + 8192)
    assert big.smem > bc.SMEM_MAX
    before = bc.band_copy.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        bc._launch(src, by, 4, 8, big)
    assert bc.band_copy.launches == before
    out = bc.band_copy(src, by, 4)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, bc.band_copy_plain(src, by), atol=0,
                               rtol=0)


def test_block_warp_refuses_autograd_on_card(cuda):
    """K1 has no backward (nor has the TPU kernel): on the card it raises
    for inputs that need a gradient, counts no launch, and launches under
    no_grad. DMC's card default (the block OD warp) cannot train; the
    exact warps of build_train_module can, with no K1 launch."""
    from dcvc_tpu_torch.training.trainer import build_train_module

    im = torch.rand(2, 3, 64, 128, device=cuda, requires_grad=True)
    flow = torch.zeros(2, 2, 64, 128, device=cuda)
    before = bw.block_warp_nchw.launches
    for a, b in ((im, flow), (im.detach(), flow.requires_grad_(True))):
        with pytest.raises(RuntimeError, match="no backward"):
            bw.block_warp_nchw(a, b, 4, 4, 64, 128, "median4")
    assert bw.block_warp_nchw.launches == before
    with torch.no_grad():
        bw.block_warp_nchw(im, flow, 4, 4, 64, 128, "median4")
    assert bw.block_warp_nchw.launches == before + 1
    from dcvc_tpu_torch.models.video_dc import build_dmc

    x = torch.rand(1, 3, 64, 64, device=cuda)
    dpb = {"ref_frame": torch.rand_like(x), "ref_feature": None,
           "ref_mv_feature": None, "ref_y": None, "ref_mv_y": None}
    q = torch.ones(1, 1, 1, 1, device=cuda)
    qs = {k: q for k in ("mv_enc", "mv_dec", "y_enc", "y_dec")}
    with pytest.raises(RuntimeError, match="no backward"):
        build_dmc(seed=0)(x, dpb, qs, 1, "ste")
    before = bw.block_warp_nchw.launches
    out = build_train_module("dmc_dc", seed=0)(x, dpb, qs, 1, "ste")
    out["bpp"].sum().backward()
    assert bw.block_warp_nchw.launches == before


def _train_loss_and_grads(device, dtype, clip, lambdas, seed=71):
    import tempfile

    from dcvc_tpu_torch.training.trainer import (PFrameTrainer, Stage,
                                                 build_train_module)

    with tempfile.TemporaryDirectory() as tmp:
        tr = PFrameTrainer(build_train_module("dmc_dc", seed=seed,
                                              device=device).to(dtype),
                           workdir=tmp, device=device)
        loss = tr.loss(tr._clip(clip).to(dtype), lambdas.to(device, dtype),
                       Stage("s", 1, 1))
        loss.backward()
        grads = {n: (torch.zeros(p.shape, dtype=torch.float64)
                     if p.grad is None else p.grad.double().cpu())
                 for n, p in tr.module.named_parameters()}
    return float(loss.detach()), grads


def test_train_step_on_card_matches_cpu(cuda):
    """One cascade-1 STE step of full-width DMC at 64 x 64, B = 2, on the
    card and on the CPU from the same seeded weights and clip: the f32
    loss within 1e-4 relative; every parameter's gradient within 1e-3
    relative L2, compared in float64 (in float32 the bit estimators' clamps
    make this gradient ill-conditioned: the CPU's own float32 gradient is
    ~1e-3 off its float64 one)."""
    import numpy as np

    rng = np.random.default_rng(70)
    base = rng.random((2, 1, 16, 16, 3))
    big = np.repeat(np.repeat(base, 8, axis=2), 8, axis=3)
    clip = np.concatenate([big[:, :, s:s + 64, s:s + 64] for s in (0, 3)],
                          axis=1).astype(np.float32)
    lambdas = torch.tensor([85.0, 840.0])
    l32 = {d: _train_loss_and_grads(d, torch.float32, clip, lambdas)[0]
           for d in ("cpu", "cuda")}
    assert abs(l32["cuda"] - l32["cpu"]) <= 1e-4 * abs(l32["cpu"])
    cpu = _train_loss_and_grads("cpu", torch.float64, clip, lambdas)
    card = _train_loss_and_grads("cuda", torch.float64, clip, lambdas)
    assert abs(card[0] - cpu[0]) <= 1e-4 * abs(cpu[0])
    for n, g in cpu[1].items():
        den = g.norm().item()
        gap = (card[1][n] - g).norm().item()
        assert gap <= 1e-3 * den, (n, gap, den)


def test_server_thread_codes_i_and_p_on_card(cuda, tmp_path):
    """The warm server on the card, serving from a thread of this process:
    an I + P session at 256 x 256 whose decode session gives the encoder's
    u8 recons byte for byte; K1 launches twice per P encode_frame (compress
    and the DPB refresh) and once per P decode_frame; closing both sessions
    gives their DPBs back."""
    import threading

    import numpy as np

    from dcvc_tpu_torch.serving import CodecClient, CodecServer

    server = CodecServer("intra_dc", "dmc_dc")
    server.warmup(256, 256)
    sock = str(tmp_path / "s.sock")
    thread = threading.Thread(target=server.serve, args=(sock,), daemon=True)
    thread.start()
    rng = np.random.default_rng(0)
    base = rng.random((40, 40, 3))
    frames = [(np.kron(np.roll(base, i, axis=1), np.ones((8, 8, 1)))[:256, :256]
               * 255).astype(np.uint8) for i in range(2)]
    torch.cuda.synchronize()
    before_mem = torch.cuda.memory_allocated()
    with CodecClient(sock) as c:
        sid = c.open_video()
        streams, recons, launches = [], [], []
        for i, f in enumerate(frames):
            k0 = bw.block_warp_nchw.launches
            s, r, _ = c.encode_frame(sid, f, kind="pi"[i == 0], frame_idx=i,
                                     q_index=2, want_recon=True)
            launches.append(bw.block_warp_nchw.launches - k0)
            streams.append(s)
            recons.append(r)
        did = c.open_video()
        for i, s in enumerate(streams):
            k0 = bw.block_warp_nchw.launches
            np.testing.assert_array_equal(
                c.decode_frame(did, s, kind="pi"[i == 0]), recons[i])
            launches.append(bw.block_warp_nchw.launches - k0)
        c.close_video(sid)
        c.close_video(did)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() <= before_mem * 1.01
        c.shutdown()
    thread.join(timeout=60)
    assert launches == [0, 2, 0, 1]
