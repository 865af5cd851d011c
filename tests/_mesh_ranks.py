"""One gloo rank of ``tests/test_torch_port_mesh.py`` (imports torch and
the port only).

    python tests/_mesh_ranks.py RANK WORLD PORT WORKDIR

The test spawns four of these, one thread each. Every rank runs the same
cases in the same order (their collectives must meet); rank 0 gathers
each case's arrays and saves them to ``WORKDIR/results.pt`` for the
parent, which holds them against JAX and the port's unsharded runs. The
dc_p pin's weights and frames arrive in ``WORKDIR/coding.pt``, written by
the parent while the first cases run.
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dcvc_tpu_torch.layers import blocks  # noqa: E402
from dcvc_tpu_torch.models import priors  # noqa: E402
from dcvc_tpu_torch.models.evc import EVCIntra  # noqa: E402
from dcvc_tpu_torch.models.runtime import DmcRuntime, EvcCodecRuntime  # noqa: E402
from dcvc_tpu_torch.models.video_dc import build_dmc  # noqa: E402
from dcvc_tpu_torch.ops import warp  # noqa: E402
from dcvc_tpu_torch.parallel import mesh as M  # noqa: E402
from dcvc_tpu_torch.parallel import tile  # noqa: E402
from dcvc_tpu_torch.utils import stream  # noqa: E402

EVC_CH, EVC_N, EVC_SEED = (8, 8, 16, 32), 32, 31
DMC_SEED = 17
BLOCK = "block:4,4,64,128,median4"
DMC_MODES = {"exact": "exact", "tile": "tile:16,2,median"}
# (name, mesh tile size) of the dc_p pin's sharded coding runs
CODINGS = (("tile2", 2), ("tile4", 4))
WAIT_S = 240

# ops held against their whole-tensor results, bit for bit
PRIMITIVES = (
    "conv_k1_s1", "conv_k1_s2", "conv_k2_s2", "conv_k3_s1", "conv_k3_s2",
    "conv_k5_s1", "conv_k7_s1", "conv_k7_s1_wide_halo", "conv_depthwise",
    "conv_bf16", "conv_transpose", "avg_pool2", "max_pool2", "up2",
    "up2_bf16", "down2", "down2_bf16", "flow_warp", "flow_warp_bf16",
    "tile_warp", "phase_masks", "checkerboards", "halo_zeros_wide",
    "gather_own_rows", "sum_tiles",
)


def build_evc() -> EVCIntra:
    """The seeded EVC of the EVC cases (the parent converts its weights
    to JAX)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(EVC_SEED)
        return EVCIntra(EVC_CH, EVC_CH, EVC_N).eval()


def evc_input() -> np.ndarray:
    return np.random.default_rng(21).random((8, 3, 128, 64), dtype=np.float32)


def dmc_forward_inputs():
    """B = 2 P-frame at 128 x 64 whose reference is the frame shifted
    (``tests/test_sharding_dmc.py:_inputs``)."""
    rng = np.random.default_rng(7)
    x = rng.random((2, 3, 128, 64), dtype=np.float32)
    ref = np.roll(x, 2, axis=2) * 0.9 + 0.1 * rng.random(x.shape,
                                                           dtype=np.float32)
    return torch.from_numpy(x), torch.from_numpy(ref.astype(np.float32))


def dpb0(ref):
    return {"ref_frame": ref, "ref_feature": None, "ref_mv_feature": None,
            "ref_y": None, "ref_mv_y": None}


def _primitive_ops(H: int):
    """name -> (whole input, op): each op runs on the whole input, and on
    this rank's slab of it under a tile context."""
    g = torch.Generator().manual_seed(3)
    x = torch.rand(2, 6, H, 24, generator=g)
    im = torch.rand(2, 6, H, 24, generator=g)
    flow = torch.randn(2, 2, H, 24, generator=g) * 5

    def conv(k, s, groups=1, dtype=None):
        torch.manual_seed(k * 10 + s + groups)
        c = blocks.Conv2d(6, 6, k, stride=s, padding=(k - 1) // 2 if k > 2
                          else 0, groups=groups)
        return blocks.set_compute_dtype(c, dtype)

    def src(t):
        return t if tile.current() is None else tile.own_rows(t)

    torch.manual_seed(5)
    convt = blocks.ConvTranspose2d(6, 4, 3, stride=2, padding=1,
                                   output_padding=1)
    ops = {
        "conv_k1_s1": (x, conv(1, 1)), "conv_k1_s2": (x, conv(1, 2)),
        "conv_k2_s2": (x, conv(2, 2)), "conv_k3_s1": (x, conv(3, 1)),
        "conv_k3_s2": (x, conv(3, 2)), "conv_k5_s1": (x, conv(5, 1)),
        "conv_k7_s1": (x, conv(7, 1)),
        "conv_depthwise": (x, conv(3, 1, groups=6)),
        "conv_bf16": (x, conv(3, 1, dtype=torch.bfloat16)),
        "conv_transpose": (x, convt),
        "avg_pool2": (x, blocks.avg_pool2), "max_pool2": (x, blocks.max_pool2),
        "up2": (x, warp.bilinear_up2),
        "up2_bf16": (x.bfloat16(), warp.bilinear_up2),
        "down2": (x, warp.bilinear_down2),
        "down2_bf16": (x.bfloat16(), warp.bilinear_down2),
        "flow_warp": (flow, lambda f: warp.flow_warp(src(im), f)),
        "flow_warp_bf16": (flow, lambda f: warp.flow_warp(
            src(im.bfloat16()), f)),
        "tile_warp": (flow, lambda f: warp.tile_warp(src(im), f, 8, 2)),
        "phase_masks": (x, lambda t: torch.cat(priors._masks(t), 1)),
        "checkerboards": (x, lambda t: torch.cat(priors._checkerboards(t), 1)),
    }
    return ops


def case_mesh(out):
    m22 = M.make_mesh(4, device_type="cpu")
    m14 = M.make_mesh(4, tile=4, device_type="cpu")
    res = {"default": (m22.size(0), m22.size(1)), "names": m22.mesh_dim_names,
           "tile4": (m14.size(0), m14.size(1)),
           "frame": M.frame_sharding(m22), "replicated": M.replicated(m22),
           "scalar": M.scalar_sharding(m22), "tile": M.tile_sharding(m22)}
    for key, call in (("tile3", lambda: M.make_mesh(4, tile=3,
                                                    device_type="cpu")),
                      ("cuda", lambda: M.make_mesh(4))):
        try:
            call()
            res[key] = None
        except Exception as e:          # the test checks the type
            res[key] = (type(e).__name__, str(e))
    out["mesh"] = res
    return m22, m14


def case_primitives(out, m14):
    """Each primitive on tile 4: slabs of 8 rows (and of 2 rows for the
    7 x 7 convolution, whose 3-row halo is wider than a slab)."""
    res = {}
    for H, names in ((32, None), (8, ("conv_k7_s1",))):
        for name, (x, op) in _primitive_ops(H).items():
            if names is not None and name not in names:
                continue
            key = name if names is None else name + "_wide_halo"
            with torch.no_grad():
                ref = op(x)
                with tile.context(m14, H):
                    got = tile.gather_rows(op(tile.own_rows(x)))
            res[key] = float((got.float() - ref.float()).abs().max()) \
                if got.shape == ref.shape else float("inf")
    x = torch.arange(4 * 8, dtype=torch.float32).view(1, 1, 8, 4)
    with tile.context(m14, 8) as ctx:
        own = tile.own_rows(x)
        h = ctx.halo(own, 3, 3, "zeros")
        lo = ctx.row_offset() - 3
        want = torch.stack([x[:, :, i] if 0 <= i < 8 else torch.zeros(1, 1, 4)
                            for i in range(lo, lo + 8)], dim=2)
        res["halo_zeros_wide"] = float((h - want).abs().max())
        res["gather_own_rows"] = float((tile.gather_rows(own) - x).abs().max())
        res["sum_tiles"] = float((tile.sum_tiles(own.sum().view(1))
                                  - x.sum()).abs().max())
    assert set(res) == set(PRIMITIVES), sorted(set(res) ^ set(PRIMITIVES))
    out["primitives"] = res


def case_evc(out, m14):
    module = build_evc()
    x = torch.from_numpy(evc_input())
    # H over 4 tiles (data 1): test_sharding.py:27
    rt = EvcCodecRuntime(module, device="cpu", mesh=m14)
    xs = M.shard(m14, x[:2], M.frame_sharding(m14))
    x_hat = rt.forward(xs, 1.0)["x_hat"]
    out["evc_tile4_x_hat"] = M.gather(m14, x_hat, M.frame_sharding(m14))
    # one image coded and decoded on tile 4
    rt.update()
    ts = M.tile_sharding(m14)
    comp = rt.compress(M.shard(m14, x[:1], ts), 1.0)
    dec = rt.decompress(comp["bit_stream"], x.shape[2], x.shape[3], 1.0)
    out["evc_coding_tile4"] = {"bytes": comp["bit_stream"],
                               "enc": M.gather(m14, comp["x_hat"], ts),
                               "dec": M.gather(m14, dec["x_hat"], ts)}
    # the batch over 4 data ranks: test_sharding.py:47
    m41 = M.make_mesh(4, tile=1, device_type="cpu")
    rt = EvcCodecRuntime(module, device="cpu", mesh=m41)
    bpp = rt.forward(M.shard(m41, x, M.frame_sharding(m41)), 1.0)["bpp"]
    out["evc_data4_bpp"] = M.gather(m41, bpp, M.scalar_sharding(m41))


def case_dmc_forward(out, m22):
    """B = 2 on data 2 x tile 2 in the exact and tile: OD warps
    (test_sharding_dmc.py:61, :111), then the block warp, which raises."""
    module = build_dmc(seed=DMC_SEED, device="cpu")
    rt = DmcRuntime(module, device="cpu", mesh=m22)
    x, ref = dmc_forward_inputs()
    fs = M.frame_sharding(m22)
    xs, dpb = M.shard(m22, x, fs), dpb0(M.shard(m22, ref, fs))
    for name, mode in DMC_MODES.items():
        module.align.warp_mode = mode
        res = rt.forward_one_frame(xs, dpb, True, 0, 1)
        out[f"dmc_forward_{name}"] = {
            "ref_frame": M.gather(m22, res["dpb"]["ref_frame"], fs),
            "bpp": M.gather(m22, res["bpp"], M.scalar_sharding(m22))}
    module.align.warp_mode = BLOCK
    try:
        rt.forward_one_frame(xs, dpb, True, 0, 1)
        out["block_under_tile"] = None
    except ValueError as e:
        out["block_under_tile"] = str(e)


def _wait_coding(workdir):
    path = os.path.join(workdir, "coding.pt")
    deadline = time.time() + WAIT_S
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"no {path} after {WAIT_S} s")
        time.sleep(0.1)
    return torch.load(path)


def case_coding(out, m22, m14, workdir):
    """The dc_p pin's frame coded on tile 2 (data 2 x tile 2, B = 1
    replicated over data) and tile 4 (data 1 x tile 4), its stream decoded
    by the sharded decoder; then a 256 x 256 frame on tile 4."""
    inp = _wait_coding(workdir)
    module = build_dmc(device="cpu", od_warp_mode="exact")
    module.load_state_dict(inp["sd"], strict=True)
    for name, mesh in zip((n for n, _ in CODINGS), (m22, m14)):
        ts = M.tile_sharding(mesh)
        rt = DmcRuntime(module, device="cpu", mesh=mesh)
        rt.update()
        ref = M.shard(mesh, inp["ref"], ts)
        comp = rt.compress(M.shard(mesh, inp["x"], ts), dpb0(ref), True, 0, 1)
        dec = rt.decompress(dpb0(ref), comp["bit_stream"], 192, 192, True, 0,
                            1)
        out[f"coding_{name}"] = {
            "container": stream.pack_p(comp["bit_stream"], True, 0, 1),
            **{f"{side}_{k}": M.gather(mesh, d["dpb"][k], ts)
               for side, d in (("enc", comp), ("dec", dec))
               for k in ("ref_frame", "ref_feature")}}
    ts = M.tile_sharding(m14)
    rt = DmcRuntime(module, device="cpu", mesh=m14)
    rt.update()
    comp = rt.compress(M.shard(m14, inp["x256"], ts),
                       dpb0(M.shard(m14, inp["ref256"], ts)), True, 0, 1)
    out["coding_256_tile4"] = comp["bit_stream"]


def main(rank: int, world: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    out = {}
    times = {}
    t = time.time()
    m22, m14 = case_mesh(out)
    for name, run in (("primitives", lambda: case_primitives(out, m14)),
                      ("evc", lambda: case_evc(out, m14)),
                      ("dmc_forward", lambda: case_dmc_forward(out, m22)),
                      ("coding", lambda: case_coding(out, m22, m14,
                                                     workdir))):
        with torch.no_grad():
            run()
        times[name] = time.time() - t
        t = time.time()
    if rank == 0:
        out["times"] = times
        tmp = os.path.join(workdir, "results.tmp")
        torch.save(out, tmp)
        os.replace(tmp, os.path.join(workdir, "results.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
             sys.argv[4])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
