"""One gloo rank of ``tests/test_torch_port_mesh.py`` (imports torch and
the port only).

    python tests/_mesh_ranks.py RANK WORLD PORT WORKDIR

The test spawns four of these, one thread each. Every rank runs the same
cases in the same order (their collectives must meet); rank 0 gathers
each case's arrays and saves them to ``WORKDIR/results.pt`` for the
parent, which holds them against JAX and the port's unsharded runs. The
dc_p pin's weights and frames arrive in ``WORKDIR/coding.pt``, written by
the parent while the first cases run.

The train cases (last, with autograd) hold the tile primitives'
backwards against autograd of the whole tensor on every rank, and DMC's
float64 sharded loss, gradients and update against the port's unsharded
ones, which the parent writes to ``WORKDIR/train_ref.pt`` (gradients are
19.8 M float64 values a set, so rank 0 compares them and sends back only
the gaps).
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
import torch.nn.functional as F

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
from dcvc_tpu_torch.training import step as S  # noqa: E402
from dcvc_tpu_torch.training.trainer import build_train_module  # noqa: E402
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

TRAIN_SEED, NOISE_SEED = 23, 5
TRAIN_LAMBDAS = (85.0, 380.0)       # test_sharding_dmc.py:83
TRAIN_LR = 1e-4
# tile primitives (and ops built on them) whose gradients under tile 4
# are held against autograd of the whole tensor
TRAIN_PRIMITIVES = (
    "halo_zeros", "halo_none", "halo_one_sided", "halo_wide", "gather_rows",
    "own_rows", "sum_tiles", "once", "conv_k3_s1", "conv_k3_s2",
    "conv_k7_s1_wide_halo", "conv_transpose", "up2", "flow_warp",
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


def _wait_for(workdir, name):
    path = os.path.join(workdir, name)
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
    inp = _wait_for(workdir, "coding.pt")
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


def train_module():
    """The float64 DMC of the train cases: seeded, exact warps."""
    return build_train_module("dmc_dc", seed=TRAIN_SEED,
                              device="cpu").double()


def train_inputs():
    """``dmc_forward_inputs`` as a float64 clip [2, 2, 3, 128, 64]
    (reference, frame), unit q scales and per-sample lambdas."""
    x, ref = dmc_forward_inputs()
    clip = torch.stack([ref, x], dim=1).double()
    qs = {k: torch.ones(2, 1, 1, 1, dtype=torch.float64)
          for k in ("mv_enc", "mv_dec", "y_enc", "y_dec")}
    return clip, qs, torch.tensor(TRAIN_LAMBDAS, dtype=torch.float64)


def _grads(module) -> dict:
    return {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for n, p in module.named_parameters()}


def loss_and_grads(module, mesh, clip, qs, lam, **kw):
    """DMC's cascade-1 loss (``make_dmc_cascade_loss``; ``kw``: remat,
    quant_mode, distortion) and its gradients, reduced over ``mesh``:
    (loss, bpp, {name: gradient})."""
    module.zero_grad(set_to_none=True)
    loss, aux = S.make_dmc_cascade_loss(module, 1, mesh=mesh, **kw)(
        clip, qs, lam, seed=NOISE_SEED)
    loss.backward()
    if mesh is not None:
        M.reduce_gradients(mesh, module.parameters())
    return float(aux["loss"]), float(aux["bpp"]), _grads(module)


def train_step(module, mesh, clip, qs, lam):
    """One ``make_dmc_train_step`` update (cascade 1, STE, MSE, lr
    TRAIN_LR): (loss, bpp, the gradients it stepped on, before the
    clip)."""
    opt = S.ClipAdamW(module.parameters(), lr=TRAIN_LR)
    seen = {}
    step = opt.step

    def record():
        seen.update(_grads(module))
        step()

    opt.step = record
    loss, aux = S.make_dmc_train_step(module, opt, 1, mesh=mesh)(
        clip, qs, lam)
    return float(loss), float(aux["bpp"]), seen


def ssim_inputs():
    """A float64 B = 2 frame pair at 192 x 192 (MS-SSIM needs more than
    160 px a side) and a seeded 3 x 3 convolution giving the recon."""
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.random((2, 3, 192, 192)))
    y = (x + 0.1 * torch.from_numpy(rng.standard_normal(x.shape))).clamp(
        0, 1)
    torch.manual_seed(19)
    net = blocks.Conv2d(3, 3, 3, padding=1).double()
    return x, y, net


def ssim_loss_and_grads(mesh, x, y, net, lam):
    """``rd_loss(..., "ssim")`` of ``x`` against ``x + net(y)`` (bpp 0)
    under ``mesh``'s tile context: (loss, gradients of net's weights and of
    y)."""
    net.zero_grad(set_to_none=True)
    y = y.detach().clone().requires_grad_(True)
    with tile.context(mesh, tile.tiles(mesh) * x.shape[2]):
        loss = S.rd_loss(x, x + net(y), torch.zeros_like(lam), lam, "ssim")
    loss.backward()
    if mesh is not None:
        M.reduce_gradients(mesh, net.parameters())
    return (float(loss.detach()),
            {n: p.grad.clone() for n, p in net.named_parameters()}, y.grad)


def _rel_gaps(got: dict, want: dict) -> dict:
    """Per-tensor relative L2 gap of ``got`` to ``want`` (0 where both are
    zero)."""
    res = {}
    for k, w in want.items():
        num = float(torch.linalg.vector_norm(got[k] - w))
        den = float(torch.linalg.vector_norm(w))
        res[k] = num / den if den else (0.0 if not num else float("inf"))
    return res


def _worst(gaps: dict):
    return max((v, k) for k, v in gaps.items())


def _primitive_grad_gaps(m14) -> dict:
    """Each primitive's (and op's) input and parameter gradients on tile
    4 against autograd of the whole tensor, float64; the relative max-abs
    gap, the worst over the ranks. Each rank's loss is its share of the
    whole loss (a seeded cotangent per rank), except ``sum_tiles`` and
    ``once``, whose loss every rank holds whole."""
    H, n = 32, m14.size(1)
    g = torch.Generator().manual_seed(13)
    X = torch.rand(2, 3, H, 12, generator=g, dtype=torch.float64)
    flow = torch.randn(2, 2, H, 12, generator=g, dtype=torch.float64) * 5

    def cot(r, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            100 + r), dtype=torch.float64)

    def gap(a, b):
        if a is None:                   # no gradient came back
            return float("inf")
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    res = {}
    with tile.context(m14, H) as ctx:
        r, h = ctx.rank, H // n
        own = slice(r * h, (r + 1) * h)

        def halo_case(Xw, top, bottom, fill):
            Hw, hw = Xw.shape[2], Xw.shape[2] // n

            def whole_mid(Z, q):
                lo, hi = q * hw - top, (q + 1) * hw + bottom
                if fill == "zeros":
                    return F.pad(Z, (0, 0, top, bottom))[:, :, lo + top:
                                                         hi + top]
                return Z[:, :, max(lo, 0):min(hi, Hw)]

            Z = leaf(Xw)
            sum((whole_mid(Z, q) * cot(q, whole_mid(Z, q).shape)).sum()
                for q in range(n)).backward()
            x = leaf(Xw[:, :, r * hw:(r + 1) * hw])
            mid = ctx.halo(x, top, bottom, fill)
            (mid * cot(r, mid.shape)).sum().backward()
            return gap(x.grad, Z.grad[:, :, r * hw:(r + 1) * hw])

        def gather_case():
            Z = leaf(X)
            sum((Z * cot(q, Z.shape)).sum() for q in range(n)).backward()
            x = leaf(X[:, :, own])
            (tile.gather_rows(x) * cot(r, X.shape)).sum().backward()
            return gap(x.grad, Z.grad[:, :, own])

        def own_case():
            want = torch.cat([cot(q, X[:, :, own].shape)
                              for q in range(n)], 2)
            Z = leaf(X)
            (tile.own_rows(Z) * cot(r, X[:, :, own].shape)).sum().backward()
            dist.all_reduce(Z.grad, group=ctx.group)
            return gap(Z.grad, want)

        Wt = cot(-1, X.shape)

        def sum_case():
            x = leaf(X[:, :, own])
            (3.0 * tile.sum_tiles((x * Wt[:, :, own]).sum().view(1))).sum(
                ).backward()
            return gap(x.grad, 3.0 * Wt[:, :, own])

        def once_case():
            Z = leaf(X)
            tile.once((Z * Wt).sum().view(1)).sum().backward()
            dist.all_reduce(Z.grad, group=ctx.group)
            return gap(Z.grad, Wt)

        def op_case(make, inputs):
            """``make()`` -> (module or None, op of the inputs); the
            whole-tensor loss sum(op(X) * C) against each rank's share
            sum(op(x) * own rows of C)."""
            mod, op = make()
            Hs = inputs[0].shape[2]
            hs = Hs // n
            with tile.whole():
                Zs = [leaf(t) for t in inputs]
                y = op(*Zs)
                C = cot(-2, y.shape)
                (y * C).sum().backward()
            want = [z.grad for z in Zs] + ([p.grad.clone() for p in
                                            mod.parameters()] if mod else [])
            if mod:
                mod.zero_grad(set_to_none=True)
            xs = [leaf(t[:, :, r * hs:(r + 1) * hs]) for t in inputs]
            y = op(*xs)
            (y * tile.own_rows(C)).sum().backward()
            got = [x.grad for x in xs]
            want = [w[:, :, r * hs:(r + 1) * hs] for w in want[:len(xs)]] \
                + want[len(xs):]
            if mod:
                for p in mod.parameters():
                    dist.all_reduce(p.grad, group=ctx.group)
                got += [p.grad for p in mod.parameters()]
            return max(gap(a, b) for a, b in zip(got, want))

        def conv(k, s, transpose=False):
            def make():
                torch.manual_seed(k * 10 + s)
                c = (blocks.ConvTranspose2d(3, 4, k, stride=s, padding=1,
                                            output_padding=1) if transpose
                     else blocks.Conv2d(3, 4, k, stride=s,
                                        padding=(k - 1) // 2)).double()
                return c, c
            return make

        def wide_conv_case():
            with tile.context(m14, 8):
                return op_case(conv(7, 1), [X[:, :, :8]])

        cases = {
            "halo_zeros": lambda: halo_case(X, 1, 1, "zeros"),
            "halo_none": lambda: halo_case(X, 1, 1, None),
            "halo_one_sided": lambda: halo_case(X, 2, 0, "zeros"),
            "halo_wide": lambda: halo_case(X[:, :, :8], 3, 3, "zeros"),
            "gather_rows": gather_case, "own_rows": own_case,
            "sum_tiles": sum_case, "once": once_case,
            "conv_k3_s1": lambda: op_case(conv(3, 1), [X]),
            "conv_k3_s2": lambda: op_case(conv(3, 2), [X]),
            "conv_k7_s1_wide_halo": wide_conv_case,
            "conv_transpose": lambda: op_case(conv(3, 2, True), [X]),
            "up2": lambda: op_case(lambda: (None, warp.bilinear_up2), [X]),
            "flow_warp": lambda: op_case(lambda: (None, warp.flow_warp),
                                         [X, flow]),
        }
        errors = {}
        for name in TRAIN_PRIMITIVES:
            try:
                res[name] = cases[name]()
            except RuntimeError as e:   # e.g. no graph to differentiate
                res[name], errors[name] = float("inf"), str(e)
    worst = torch.tensor([res[k] for k in TRAIN_PRIMITIVES],
                         dtype=torch.float64)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return {"gaps": dict(zip(TRAIN_PRIMITIVES, worst.tolist())),
            "errors": errors}


def case_train(out, m22, m14) -> dict:
    """With autograd: the primitives' backwards, then DMC (float64, B = 2,
    128 x 64, cascade 1, STE) on m22 (one ``make_dmc_train_step`` update)
    and on m14 with remat (each frame recomputed in backward), the noise
    loss on m22, and the "ssim" loss on m14. Returns what ``check_train``
    holds against the unsharded references (rank 0's; the other ranks'
    copies are dropped)."""
    res = {"primitives": _primitive_grad_gaps(m14)}
    clip, qs, lam = train_inputs()

    def cut(mesh):
        return (M.shard(mesh, clip, M.clip_sharding(mesh)),
                {k: M.shard(mesh, v, M.scalar_sharding(mesh))
                 for k, v in qs.items()},
                M.shard(mesh, lam, M.scalar_sharding(mesh)))

    module = train_module()
    loss, bpp, g22 = train_step(module, m22, *cut(m22))
    # every rank took the same update: against rank 0's, broadcast
    names, params = zip(*module.named_parameters())
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    flat0 = flat.clone()
    dist.broadcast(flat0, 0)
    after = {n: t.view_as(p) for n, p, t in zip(
        names, params, flat0.split([p.numel() for p in params]))}
    res["m22"] = {"loss": loss, "bpp": bpp,
                  "params_rank_gap": float((flat - flat0).abs().max())}

    module = train_module()
    loss, bpp, g14 = loss_and_grads(module, m14, *cut(m14), remat=True)
    res["m14"] = {"loss": loss, "bpp": bpp, "remat": True}
    with torch.no_grad():
        loss, aux = S.make_dmc_cascade_loss(
            module, 1, quant_mode="noise", mesh=m22)(*cut(m22),
                                                     seed=NOISE_SEED)
    res["m22_noise"] = {"loss": float(aux["loss"]), "bpp": float(aux["bpp"])}
    x, y, net = ssim_inputs()
    s14 = M.frame_sharding(m14)
    loss, g, gy = ssim_loss_and_grads(m14, M.shard(m14, x, s14),
                                      M.shard(m14, y, s14), net, lam)
    res["m14_ssim"] = {"loss": loss, "grads": g,
                       "y_grad": M.gather(m14, gy, s14)}
    out["train"] = res
    return ({"g22": g22, "after": after, "g14": g14}
            if dist.get_rank() == 0 else {})


def check_train(out, state, workdir) -> None:
    """Rank 0: the sharded gradients and update against the unsharded
    ones in ``train_ref.pt``, kept as gaps."""
    if not state:
        return
    ref = _wait_for(workdir, "train_ref.pt")
    res = out["train"]
    res["m22"]["worst_grad"] = _worst(_rel_gaps(state["g22"], ref["grads"]))
    res["m22"]["update_gap"] = max(
        float((state["after"][k] - v).abs().max())
        for k, v in ref["params_after"].items())
    res["m14"]["worst_grad"] = _worst(_rel_gaps(state["g14"], ref["grads"]))


def main(rank: int, world: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    out = {}
    times = {}
    t = time.time()
    m22, m14 = case_mesh(out)
    state = {}
    for name, run in (("primitives", lambda: case_primitives(out, m14)),
                      ("evc", lambda: case_evc(out, m14)),
                      ("dmc_forward", lambda: case_dmc_forward(out, m22)),
                      ("train", lambda: state.update(case_train(out, m22,
                                                                m14))),
                      ("coding", lambda: case_coding(out, m22, m14,
                                                     workdir)),
                      ("train_check", lambda: check_train(out, state,
                                                          workdir))):
        # the train cases run with autograd, before the coding case waits
        # for the parent's coding inputs
        with torch.set_grad_enabled(name == "train"):
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
