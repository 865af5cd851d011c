"""Port tests that need an NVIDIA card (marker ``cuda``; they skip without
one). Run on the card with:

    DCVC_TPU_TEST_ON_TPU=1 python -m pytest -m cuda tests/test_torch_port_cuda.py

(DCVC_TPU_TEST_ON_TPU=1 keeps tests/conftest.py from importing JAX, which
the machine with the card does not need.) The block-warp kernel is held
against its plain PyTorch version on the card: the same arithmetic with
each op rounded separately, so f32 and bf16 outputs agree exactly (atol 0).
"""

import pytest
import torch

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
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, shape, blk, base_mode, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    M, C, H, W = shape
    im = torch.rand(shape, generator=g, device=cuda).to(dtype)
    for scale, shift in [(0.5, 3.0), (8.0, 0.0), (0.3, -40.0)]:
        flow = torch.randn(M, 2, H, W, generator=g, device=cuda) * scale + shift
        before = bw.block_warp_nchw.launches
        out = bw.block_warp_nchw(im, flow, *blk, base_mode)
        torch.cuda.synchronize()
        assert bw.block_warp_nchw.launches == before + 1
        plain = bw.block_warp_plain_nchw(im, flow, *blk, base_mode)
        assert out.dtype == dtype
        torch.testing.assert_close(out, plain, atol=0, rtol=0)


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
