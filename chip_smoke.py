#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dcvc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero and prints
no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of the path from this checkout (block_warp.cu with
     nvcc, the rANS core with g++), in parallel, and print the build time;
  3. hold the block-warp kernel against its plain PyTorch version on the
     card at the OffsetDiversity shape of 1080p (32 maps x 3 x 1088 x 1920,
     f32 and bf16) and at two edge shapes; time kernel, plain version and
     the exact warp (F.grid_sample, the yardstick: another function);
  4. check the card's model numerics against the CPU on a small input;
  5. the main path at full width: IntraNoAR (N=256) codes one I-frame, DMC
     codes P-frames, 1920x1080 padded to 1088, seeded random weights and
     seeded moving content; every frame goes compress -> pack -> bytes ->
     unpack -> decompress, and the decoder's DPB feeds the next frame;
     then one more P-frame under torch.profiler (device time by kernel,
     the card's busy share);
  6. one JSON line per kernel, then the result line.

Imports nothing of JAX. Needs one card; without one it exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HEIGHT, WIDTH = 1080, 1920
P_FRAMES = 2
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS = 67e12                  # H100 SXM f32, outside the tensor cores
F32_TOL, BF16_TOL, RECON_TOL = 1e-5, 1e-2, 1e-4


def _card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _od_inputs(M, C, H, W, dtype, shift, gen):
    """Feature maps and OffsetDiversity-like flows: a smooth motion field
    plus per-map offsets of up to +-40 px (40 * tanh of a half-resolution
    field, upsampled as the model does)."""
    import torch
    import torch.nn.functional as F

    dev = "cuda"
    im = torch.rand(M, C, H, W, generator=gen, device=dev).to(dtype)
    yy = torch.linspace(0, 1, H, device=dev).view(1, H, 1)
    xx = torch.linspace(0, 1, W, device=dev).view(1, 1, W)
    motion = torch.stack([6.0 * torch.sin(3.0 * yy + 2.0 * xx) + shift[0],
                          4.0 * torch.cos(2.0 * xx - yy) + shift[1]], 1)
    raw = torch.randn(M, 2, (H + 1) // 2, (W + 1) // 2, generator=gen,
                      device=dev)
    off = 40.0 * torch.tanh(0.6 * F.interpolate(
        raw, size=(H, W), mode="bilinear", align_corners=False))
    return im, (motion + off).contiguous()


def kernel_phase(results: dict):
    """K1 against its plain version; fills results['block_warp']."""
    import torch

    from dcvc_tpu_torch.ops import block_warp as bw
    from dcvc_tpu_torch.ops.warp import flow_warp

    gen = torch.Generator(device="cuda").manual_seed(1234)
    Dh, Rv, BH, BW, base = 4, 4, 64, 128, "median4"
    cases = [("od_1080p_f32", (32, 3, 1088, 1920), torch.float32, (0.0, 0.0)),
             ("od_1080p_bf16", (32, 3, 1088, 1920), torch.bfloat16, (0.0, 0.0)),
             ("edge_270x481_f32", (8, 3, 270, 481), torch.float32, (60.0, -35.0)),
             ("edge_67x130_bf16", (5, 2, 67, 130), torch.bfloat16, (-90.0, 70.0))]
    rows = {}
    for name, (M, C, H, W), dtype, shift in cases:
        im, flow = _od_inputs(M, C, H, W, dtype, shift, gen)
        ker = bw.block_warp_nchw(im, flow, Dh, Rv, BH, BW, base)
        torch.cuda.synchronize()
        plain = bw.block_warp_plain_nchw(im, flow, Dh, Rv, BH, BW, base)
        err = (ker.float() - plain.float()).abs().max().item()
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        if not (err <= tol and torch.isfinite(ker.float()).all()):
            raise AssertionError(f"block_warp {name}: max abs err {err} > {tol}")
        row = {"max_abs_err": err, "tol": tol}
        if name.startswith("od_"):
            row["ms"] = _time_ms(lambda: bw.block_warp_nchw(
                im, flow, Dh, Rv, BH, BW, base), 10, 2)
            row["plain_ms"] = _time_ms(lambda: bw.block_warp_plain_nchw(
                im, flow, Dh, Rv, BH, BW, base), 3)
            row["grid_sample_exact_warp_ms"] = _time_ms(
                lambda: flow_warp(im, flow), 10, 2)
            nbytes = (im.numel() * im.element_size() + flow.numel() * 4
                      + ker.numel() * ker.element_size())
            flops = M * H * W * (12 + 9 * C)  # taps + 3 lerps per channel
            row["bytes"] = nbytes
            row["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            row["ops_ms"] = flops / F32_FLOPS * 1e3
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                               else "operations")
        rows[name] = row
        print(f"block_warp {name}: {json.dumps(row)}", flush=True)
        del im, flow, ker, plain
        torch.cuda.empty_cache()
    results["block_warp"] = rows


def reference_phase():
    """The card's model numerics against the CPU on a small input (the CPU
    path is the one the test suite holds against the JAX package)."""
    import torch

    from dcvc_tpu_torch.models.intra_dc import build_intra_dc
    from dcvc_tpu_torch.models.video_dc import build_dmc

    gen = torch.Generator().manual_seed(7)
    x = torch.rand(1, 3, 64, 64, generator=gen)
    ref = torch.rand(1, 3, 64, 64, generator=gen)
    with torch.no_grad():
        for name, build, fn in [
                ("intra enc", lambda d: build_intra_dc(seed=0, device=d),
                 lambda m, a, b: m.enc(a, m.q_basic_enc)),
                ("dmc optic_flow", lambda d: build_dmc(seed=1, device=d),
                 lambda m, a, b: m.optic_flow(a, b))]:
            out = {}
            for d in ("cpu", "cuda"):
                m = build(d)
                out[d] = fn(m, x.to(d), ref.to(d)).float().cpu()
            gap = (out["cuda"] - out["cpu"]).abs().max().item()
            scale = out["cpu"].abs().max().item()
            print(f"reference {name}: max abs gap {gap:.3e} (max |x| "
                  f"{scale:.3e})", flush=True)
            if not gap <= 1e-4 * max(1.0, scale):
                raise AssertionError(f"{name}: card vs CPU gap {gap}")


def _content(n_frames: int):
    """Seeded moving synthetic frames in [0, 1], NCHW on the card: a smooth
    texture with fine detail, panning a few px per frame."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(42)
    base = torch.rand(1, 3, HEIGHT // 16 + 8, WIDTH // 16 + 8, generator=gen,
                      device="cuda")
    big = F.interpolate(base, size=(HEIGHT + 128, WIDTH + 128),
                        mode="bicubic", align_corners=False)
    detail = 0.08 * torch.rand(1, 3, HEIGHT + 128, WIDTH + 128,
                               generator=gen, device="cuda")
    big = (big + detail).clamp(0, 1)
    return [big[:, :, 3 * i:3 * i + HEIGHT, 5 * i:5 * i + WIDTH].contiguous()
            for i in range(n_frames)]


class _SymbolTap:
    """Records the symbol planes a runtime hands to rANS / gets back."""

    def __init__(self, rt):
        self.enc, self.dec = [], []
        enc_y, dec_y = rt.gaussian.encode_with_indexes, rt.gaussian.decode_with_indexes
        enc_z, dec_z = rt._encode_z, rt._decode_z

        def encode_y(coder, y_q, idx):
            self.enc.append(y_q.reshape(-1).copy())
            return enc_y(coder, y_q, idx)

        def decode_y(coder, idx):
            out = dec_y(coder, idx)
            self.dec.append(out.reshape(-1).astype("int16"))
            return out

        def encode_z(name, z):
            self.enc.append(z.permute(0, 2, 3, 1).reshape(-1).cpu().numpy()
                            .astype("int16"))
            return enc_z(name, z)

        def decode_z(name, shape):
            out = dec_z(name, shape)
            self.dec.append(out.permute(0, 2, 3, 1).reshape(-1).cpu().numpy()
                            .astype("int16"))
            return out

        rt.gaussian.encode_with_indexes = encode_y
        rt.gaussian.decode_with_indexes = decode_y
        rt._encode_z, rt._decode_z = encode_z, decode_z

    def equal(self) -> bool:
        import numpy as np

        ok = len(self.enc) == len(self.dec) and all(
            np.array_equal(np.clip(a, -30000, 30000).astype("int16"), b)
            for a, b in zip(self.enc, self.dec))
        self.enc, self.dec = [], []
        return ok


def main_path_phase(results: dict):
    import torch
    import torch.nn.functional as F

    from dcvc_tpu_torch.models.intra_dc import build_intra_dc
    from dcvc_tpu_torch.models.runtime import DmcRuntime, IntraDcRuntime
    from dcvc_tpu_torch.models.video_dc import build_dmc
    from dcvc_tpu_torch.ops import block_warp as bw
    from dcvc_tpu_torch.ops.warp import get_padding_size
    from dcvc_tpu_torch.utils import stream

    t0 = time.time()
    irt = IntraDcRuntime(build_intra_dc(N=256, ch_a=128, ch_b=192, seed=0))
    prt = DmcRuntime(build_dmc(seed=1))
    irt.update()
    prt.update()
    taps = {"i": _SymbolTap(irt), "p": _SymbolTap(prt)}
    _, pr, _, pb = get_padding_size(HEIGHT, WIDTH, 16)
    hp, wp = HEIGHT + pb, WIDTH + pr
    frames = _content(1 + P_FRAMES)
    print(f"main path: models + tables ready in {time.time() - t0:.1f} s; "
          f"od warp default {prt.module.align.warp_mode or 'block (card)'}",
          flush=True)

    def sync_ms(t):
        torch.cuda.synchronize()
        return (time.time() - t) * 1e3

    per_frame = []
    q_index = 32
    bw.block_warp_nchw.launches = 0
    dpb_enc = dpb_dec = None
    for i, x in enumerate(frames):
        xp = F.pad(x, (0, pr, 0, pb), mode="replicate")
        l0 = bw.block_warp_nchw.launches
        t = time.time()
        if i == 0:
            comp = irt.compress(xp, False, q_index)
            data = stream.pack_i(hp, wp, False, q_index, comp["bit_stream"])
            enc_ms = sync_ms(t)
            l1 = bw.block_warp_nchw.launches
            t = time.time()
            h, w, qc, qi, s = stream.unpack_i(bytes(data))
            dec = irt.decompress(s, h, w, qc, qi)
            dec_ms = sync_ms(t)
            enc_dpb = {"ref_frame": comp["x_hat"]}
            dec_dpb = {"ref_frame": dec["x_hat"]}
            x_hat = dec["x_hat"]
            sym_ok = taps["i"].equal()
        else:
            comp = prt.compress(xp, dpb_enc, False, q_index, i)
            data = stream.pack_p(comp["bit_stream"], False, q_index, i)
            enc_ms = sync_ms(t)
            l1 = bw.block_warp_nchw.launches
            t = time.time()
            qc, qi, fi, s = stream.unpack_p(bytes(data))
            dec = prt.decompress(dpb_dec, s, hp, wp, qc, qi, fi)
            dec_ms = sync_ms(t)
            enc_dpb, dec_dpb = comp["dpb"], dec["dpb"]
            x_hat = dec_dpb["ref_frame"]
            sym_ok = taps["p"].equal()
        l2 = bw.block_warp_nchw.launches
        gap = max((enc_dpb[k] - dec_dpb[k]).abs().max().item()
                  for k in enc_dpb if enc_dpb[k] is not None)
        crop = x_hat[:, :, :HEIGHT, :WIDTH]
        if crop.shape != x.shape or not torch.isfinite(x_hat).all():
            raise AssertionError(f"frame {i}: bad recon {tuple(x_hat.shape)}")
        mse = F.mse_loss(crop, x).item()
        row = {"frame": i, "type": "I" if i == 0 else "P",
               "bytes": len(data), "bpp": len(data) * 8 / (HEIGHT * WIDTH),
               "psnr": 10 * math.log10(1.0 / max(mse, 1e-12)),
               "encode_ms": enc_ms, "decode_ms": dec_ms,
               "symbols_equal": sym_ok, "max_recon_gap": gap,
               "k1_launches_compress": l1 - l0,
               "k1_launches_decompress": l2 - l1}
        print(f"frame {json.dumps(row)}", flush=True)
        per_frame.append(row)
        if i == 0:
            dpb_enc = {"ref_frame": comp["x_hat"], "ref_feature": None,
                       "ref_mv_feature": None, "ref_y": None, "ref_mv_y": None}
            dpb_dec = dict(dpb_enc, ref_frame=dec["x_hat"])
        else:
            dpb_enc, dpb_dec = enc_dpb, dec_dpb
    launches = bw.block_warp_nchw.launches
    for row in per_frame:
        if not row["symbols_equal"]:
            raise AssertionError(f"frame {row['frame']}: rANS symbols differ")
        if not row["max_recon_gap"] <= RECON_TOL:
            raise AssertionError(f"frame {row['frame']}: recon gap "
                                 f"{row['max_recon_gap']}")
        if row["type"] == "P" and row["k1_launches_compress"] < 1:
            raise AssertionError(f"frame {row['frame']}: K1 not launched")
    if launches < P_FRAMES:
        raise AssertionError(f"K1 launched {launches} times for {P_FRAMES} "
                             f"P-frames")
    results["launches"] = {"block_warp": launches}
    results["frames"] = per_frame

    # one more P-frame (encode + decode) under torch.profiler: where the
    # device time goes and how much of the wall time the card is busy
    from torch.profiler import ProfilerActivity, profile

    x = F.pad(frames[-1].roll(4, dims=3), (0, pr, 0, pb), mode="replicate")
    fi = len(frames)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        comp = prt.compress(x, dpb_enc, False, q_index, fi)
        prt.decompress(dpb_dec, comp["bit_stream"], hp, wp, False, q_index, fi)
        wall_ms = sync_ms(t)
    # device-side rows only (kernels, copies): the CPU-side aten rows carry
    # the same device time again
    rows = [(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    device_ms = sum(r[0] for r in rows)
    print("profile " + json.dumps({
        "what": "one P-frame compress + decompress, profiler on",
        "wall_ms": wall_ms, "device_ms": device_ms or None,
        "device_busy_share": device_ms / wall_ms if device_ms else None,
        "block_warp_ms": sum(r[0] for r in rows if "block_warp" in r[2]),
        "top": [{"ms": ms, "count": n, "name": k[:80]}
                for ms, n, k in rows[:10]]}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dcvc_tpu_torch.device import exact_numerics
    from dcvc_tpu_torch.ops import block_warp as bw
    from dcvc_tpu_torch.ops import rans

    print(_card_line(), flush=True)
    exact_numerics()
    t = time.time()
    with ThreadPoolExecutor(2) as ex:
        builds = [ex.submit(bw.load_kernel), ex.submit(rans._load_library)]
        for f in builds:
            f.result()
    print(f"build: {time.time() - t:.1f} s (block_warp.cu + rans.cpp)",
          flush=True)
    for line in bw.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    results: dict = {}
    kernel_phase(results)
    reference_phase()
    main_path_phase(results)

    k = results["block_warp"]
    od = k["od_1080p_f32"]
    print(json.dumps({"kernels": [{
        "name": "block_warp", "route": "cuda",
        "source": "dcvc_tpu_torch/csrc/block_warp.cu",
        "replaces": "dcvc_tpu/ops/block_warp.py:164",
        "tpu_kernel": "dcvc_tpu/ops/block_warp.py:_kernel",
        "launches": results["launches"]["block_warp"],
        "max_abs_err": max(r["max_abs_err"] for n, r in k.items()
                           if n.endswith("f32")),
        "max_abs_err_bf16": max(r["max_abs_err"] for n, r in k.items()
                                if n.endswith("bf16")),
        "ms": od["ms"], "plain_ms": od["plain_ms"],
        "bound_ms": od["bound_ms"], "bound_by": od["bound_by"],
        "library_ms": None,
        "grid_sample_exact_warp_ms": od["grid_sample_exact_warp_ms"],
        "ms_bf16": k["od_1080p_bf16"]["ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
