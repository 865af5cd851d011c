"""Sharded P-frame coding on a (data, tile) mesh, held to unsharded coding.

    python -m dcvc_tpu_torch.tools.mesh_check [--nproc N] [--device cuda|cpu]
        [--height 1080 --width 1920] [--meshes 1x1:block 1x1:exact ...]
        [--out result.json]

Spawns N ranks (default: one per visible card; NCCL on ``cuda``, gloo on
``cpu``) joined by a process group on localhost. For each mesh spec
``DxT:mode`` every rank builds full-width DMC (seeded weights, OD warp
``mode``: ``block`` = K1, ``exact``, or ``tile`` = ``tile:16,2,median``) on
``make_mesh(N, tile=T)``; each data group codes its own seeded panning
content, padded to a multiple of 64: after an untimed warm-up round trip,
two chained P-frames through the sharded ``DmcRuntime`` (compress ->
decompress, timed), with the kernels' launch counts set to 0 just before
and read just after. Then, not counted or timed, the same frames through
the unsharded runtime on the same card:
bytes equal or not, symbol and scale-index mismatches between the sharded
and unsharded encoders (on the same input DPB), and the DPB gaps
(sharded decoder vs sharded encoder, sharded vs unsharded encoder).

Prints (and with ``--out`` writes) one JSON object, one row per (mesh,
rank). Exits non-zero when a rank fails, a decoded DPB is off its
encoder's by more than 1e-4 or not finite, the block mode launched no K1,
or another mode launched one.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.nn.functional as F

OD_MODES = {"block": "block:4,4,64,128,median4", "exact": "exact",
            "tile": "tile:16,2,median"}
DPB_KEYS = ("ref_frame", "ref_feature", "ref_mv_feature", "ref_y",
            "ref_mv_y")
RECON_TOL = 1e-4
Q_INDEX = 32


def default_meshes(n: int) -> list:
    """The data axis with K1 (data-only mesh), the widest tile axis in
    the exact and tile modes, and data 2 x tile 2 on four ranks."""
    specs = [f"{n}x1:block", f"1x{n}:exact", f"1x{n}:tile"]
    if n == 4:
        specs += ["2x2:exact", "2x2:tile"]
    return specs


def frames(n: int, height: int, width: int, seed: int, device):
    """``n`` seeded frames of a texture panning (5, 3) px a frame, edge-
    padded to a multiple of 64 as the video runner pads."""
    from ..ops.warp import get_padding_size, replicate_pad

    g = torch.Generator().manual_seed(seed)
    base = torch.rand(1, 3, height // 16 + 8, width // 16 + 8, generator=g)
    big = F.interpolate(base, size=(height + 128, width + 128),
                        mode="bicubic", align_corners=False)
    big = (big + 0.08 * torch.rand(big.shape, generator=g)).clamp(0, 1)
    pad = get_padding_size(height, width, 64)
    return [replicate_pad(big[:, :, 3 * i:3 * i + height,
                              5 * i:5 * i + width], pad).to(device)
            .contiguous() for i in range(n)]


def _dpb0(ref):
    return {"ref_frame": ref, "ref_feature": None, "ref_mv_feature": None,
            "ref_y": None, "ref_mv_y": None}


def _gap(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max())
               for k in DPB_KEYS if a[k] is not None)


def _finite(d: dict) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in d.values()
               if v is not None)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _code_config(spec: str, world: int, args, device) -> dict:
    from ..models.runtime import DmcRuntime
    from ..models.video_dc import build_dmc
    from ..ops import band_copy as bc
    from ..ops import block_warp as bw
    from ..parallel import mesh as M

    shape, mode = spec.split(":")
    data, tiles = (int(v) for v in shape.split("x"))
    if data * tiles != world:
        raise ValueError(f"mesh {shape} needs {data * tiles} ranks, "
                         f"not {world}")
    mesh = M.make_mesh(world, tile=tiles, device_type=device.type)
    ts = M.tile_sharding(mesh)
    d = mesh.get_local_rank("data")
    xs = frames(3, args.height, args.width, d, device)
    H, W = xs[0].shape[2], xs[0].shape[3]
    module = build_dmc(seed=0, device=device,
                       od_warp_mode=OD_MODES[mode])
    sharded = DmcRuntime(module, device=device, mesh=mesh)
    plain = DmcRuntime(module, device=device)
    sharded.update()
    plain.update()

    def cut(dpb):
        return {k: None if v is None else M.shard(mesh, v, ts)
                for k, v in dpb.items()}

    def whole(dpb):
        return {k: None if v is None else M.gather(mesh, v, ts)
                for k, v in dpb.items()}

    row = {"mesh": [data, tiles], "mode": mode, "od_warp": OD_MODES[mode],
           "rank": dist.get_rank(), "data_index": d,
           "tile_index": mesh.get_local_rank("tile"), "frame": [H, W],
           "launches": {"block_warp": 0, "band_copy": 0}, "frames": []}
    enc = dec = cut(_dpb0(xs[0]))
    plain_enc = _dpb0(xs[0])
    # a warm-up round trip (cuDNN's first calls), neither timed nor counted
    warm = sharded.compress(M.shard(mesh, xs[1], ts), enc, False, Q_INDEX, 1)
    sharded.decompress(dec, warm["bit_stream"], H, W, False, Q_INDEX, 1)
    del warm
    for fi in (1, 2):
        x = M.shard(mesh, xs[fi], ts)
        bw.block_warp_nchw.launches = 0
        bc.band_copy.launches = 0
        _sync(device)
        t0 = time.perf_counter()
        comp = sharded.compress(x, enc, False, Q_INDEX, fi)
        _sync(device)
        enc_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        out = sharded.decompress(dec, comp["bit_stream"], H, W, False,
                                 Q_INDEX, fi)
        _sync(device)
        dec_ms = (time.perf_counter() - t0) * 1e3
        row["launches"]["block_warp"] += bw.block_warp_nchw.launches
        row["launches"]["band_copy"] += bc.band_copy.launches
        # not counted or timed: the unsharded twin on the same inputs
        enc_w, dec_w = whole(comp["dpb"]), whole(out["dpb"])
        _, s_sh, i_sh = sharded.code_planes(x, enc, False, Q_INDEX, fi)
        _, s_un, i_un = plain.code_planes(xs[fi], whole(enc), False,
                                          Q_INDEX, fi)
        ref = plain.compress(xs[fi], plain_enc, False, Q_INDEX, fi)
        row["frames"].append({
            "frame_idx": fi, "encode_ms": enc_ms, "decode_ms": dec_ms,
            "bytes": len(comp["bit_stream"]),
            "bytes_equal_unsharded": comp["bit_stream"] == ref["bit_stream"],
            "symbols": int(sum(s.size for s in s_sh)),
            "symbol_mismatches": int(sum(int((a != b).sum())
                                         for a, b in zip(s_sh, s_un))),
            "index_mismatches": int(sum(int((a != b).sum())
                                        for a, b in zip(i_sh, i_un))),
            "dpb_gap_dec_vs_enc": _gap(dec_w, enc_w),
            "dpb_gap_vs_unsharded_enc": _gap(enc_w, ref["dpb"]),
            "finite": _finite(enc_w) and _finite(dec_w)})
        enc, dec, plain_enc = comp["dpb"], out["dpb"], ref["dpb"]
    return row


def _rank_main(args) -> None:
    world = args.nproc
    if args.device == "cuda":
        device = torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                                f"{args.port}", rank=args.rank,
                                world_size=world, device_id=device,
                                timeout=timedelta(seconds=args.timeout))
        from ..ops import block_warp as bw

        bw.load_kernel()
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                                f"{args.port}", rank=args.rank,
                                world_size=world,
                                timeout=timedelta(seconds=args.timeout))
    rows = []
    with torch.no_grad():
        for spec in args.meshes:
            t0 = time.perf_counter()
            rows.append(_code_config(spec, world, args, device))
            rows[-1]["seconds"] = time.perf_counter() - t0
    with open(os.path.join(args.workdir, f"rank{args.rank}.json"), "w") as f:
        json.dump(rows, f)
    dist.destroy_process_group()


def check(result: dict) -> list:
    """The limits each row must meet: failures as strings (none: ok)."""
    bad = []
    for row in result["rows"]:
        tag = f"{row['mesh'][0]}x{row['mesh'][1]}:{row['mode']} rank {row['rank']}"
        k1 = row["launches"]["block_warp"]
        if row["mode"] == "block" and k1 < 1:
            bad.append(f"{tag}: K1 launched {k1} times on the block mode")
        if row["mode"] != "block" and k1:
            bad.append(f"{tag}: K1 launched {k1} times off the block mode")
        if row["launches"]["band_copy"]:
            bad.append(f"{tag}: K2 launched on a codec path")
        for fr in row["frames"]:
            if not fr["finite"] or fr["dpb_gap_dec_vs_enc"] > RECON_TOL:
                bad.append(f"{tag} P{fr['frame_idx']}: decoded DPB off the "
                           f"encoder's by {fr['dpb_gap_dec_vs_enc']}")
    return bad


def run(nproc: int | None = None, device: str = "cuda", height: int = 1080,
        width: int = 1920, meshes=None, timeout: int = 600) -> dict:
    """Spawn the ranks, wait for them (``timeout`` s), and return
    ``{"rows": [...], "failures": [...], "seconds": s}``; raises when a
    rank fails or does not exit in time (its output in the message)."""
    if nproc is None:
        if not torch.cuda.is_available() and device == "cuda":
            raise RuntimeError("CUDA is not available; pass device='cpu'")
        nproc = torch.cuda.device_count() if device == "cuda" else 1
    meshes = list(meshes or default_meshes(nproc))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        cmd = [sys.executable, "-m", "dcvc_tpu_torch.tools.mesh_check",
               "--nproc", str(nproc), "--device", device, "--height",
               str(height), "--width", str(width), "--timeout", str(timeout),
               "--port", str(port), "--workdir", work, "--meshes", *meshes]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=root, env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for r in range(nproc)]
        outs = []
        try:
            for p in procs:
                left = max(timeout - (time.perf_counter() - t0), 1)
                try:
                    outs.append(p.communicate(timeout=left)[0].decode())
                except subprocess.TimeoutExpired:
                    outs.append(f"(no exit within {timeout} s)")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError("\n".join(
                f"--- rank {r} (exit {p.returncode}) ---\n{o[-4000:]}"
                for r, (p, o) in enumerate(zip(procs, outs))))
        rows = []
        for r in range(nproc):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                rows += json.load(f)
    result = {"nproc": nproc, "device": device, "meshes": meshes,
              "rows": rows, "seconds": time.perf_counter() - t0}
    result["failures"] = check(result)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--meshes", nargs="+", default=None)
    ap.add_argument("--timeout", type=int, default=600)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return 0
    result = run(args.nproc, args.device, args.height, args.width,
                 args.meshes, args.timeout)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    for line in result["failures"]:
        print(f"mesh_check: {line}", file=sys.stderr)
    return 1 if result["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
