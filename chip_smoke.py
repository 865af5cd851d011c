#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dcvc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero and prints
no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of the paths from this checkout (block_warp.cu and
     band_copy.cu with nvcc, the rANS core with g++), in parallel, and
     print the build time;
  3. hold the block warp (K1: its prep and warp kernels) against its plain
     PyTorch version on the card (atol 0) at the OffsetDiversity shape of
     1080p (32 maps x 3 x 1088 x 1920, f32 and bf16) and at two edge
     shapes; time the whole wrapper call, the prep and the warp kernel
     apart, the plain version and the exact warp (F.grid_sample, the
     yardstick: another function), with GB/s and the share of the bound;
  4. hold the band-copy kernel (K2) against its plain version (atol 0) at
     the probe's shape (720 rows, [4, 16, 1408] f32 bands), an edge shape
     with 4-byte copies, a shape with fewer row groups than SMs and
     unequal chunks, and one-row single-channel bands; print each launch
     plan, the ptxas registers and the kernel's time (CUDA-graph replay)
     beside the unique-bytes and requested-bytes bounds; at the probe's
     shape also time the plain version and torch.index_select (the
     yardstick: it reads one channel, not the band);
  5. the tile warp (tile:32,2,median, plain PyTorch) at the OffsetDiversity
     shape, timed beside K1 and the exact warp, and its card-vs-CPU gap;
  6. check the card's model numerics against the CPU on a small input;
  7. the runtimes at full width: IntraNoAR (N=256) codes one I-frame, DMC
     codes P-frames, 1920x1080 padded to 1088, seeded random weights and
     seeded moving content; every frame goes compress -> pack -> bytes ->
     unpack -> decompress, and the decoder's DPB feeds the next frame;
     then one more P-frame under torch.profiler (device time by kernel,
     the card's busy share);
  8. the video CLI (dcvc_tpu_torch.tools.test_video, in process) on a
     seeded synthetic 1920x1080 YUV420 sequence of 3 frames: write-stream
     (every .bin decoded again by a fresh runtime pair must give the CLI's
     recon YUV byte for byte), the same with --aligned_enc 1 (identical
     .bin files) and estimated bits;
  9. the K2 probe tool (dcvc_tpu_torch.tools.diag_dma.run) at its shape;
 10. the EVC runtimes at full width: evc_LL and evc_SS code one seeded
     synthetic 1920x1080 image, edge-padded to 1088x1920 as the image CLI
     pads, at q = get_rounded_q(0.85): compress -> encode_i_ushort_q ->
     decode_i_ushort_q -> decompress by a fresh runtime, symbols equal on
     both planes and z, recon gap <= 1e-5; bytes, bpp, encode / decode ms
     (median of 3 after a warm-up), peak memory, one encode and one decode
     under torch.profiler (device ms, busy share, top five kernels), and
     the convolution FLOPs reckoned from the shapes beside the f32 peak;
 11. evc_scalable (4 S-grid encoders, L decoder) on a seeded 768x512
     image: each encoder's RD cost, the chosen one, an exact round trip;
 12. the image CLI (dcvc_tpu_torch.tools.test_image, in process) on two
     seeded 768x512 PNGs written by utils/png.py: evc_LL at 2 rates with
     streams and MS-SSIM and intra_hem at 1 rate with streams (every .bin
     decoded again by a fresh runtime must give the CLI's recon exactly),
     then intra_dc at 1 rate with streams;
 13. the HEM runtimes at full width: intra_hem (N=192) codes one I-frame
     and dmc_hem (64 / 64 / 96) two chained P-frames of the seeded panning
     content at 1920x1080 edge-padded to 1088, through the HEM containers
     (ushort q for I, rounded mv / y q for P); aligned_enc off, then on.
     Symbols equal, I recon gap 0.0, DPB gap <= 1e-4; encode / decode ms
     (median of 3 after a warm-up), bytes, peak memory and one profiled
     P-frame (device ms, busy share, top kernels). mc warps exact;
 14. one more dmc_hem P-frame with mc_warp_mode = the block warp: K1
     launches 4 times per compress and 4 per decompress, symbols exact
     (encode / decode ms: median of 3 after that call);
     K1 against its plain version (atol 0) at the four mc shapes
     ([1, 3, 1088, 1920] and [1, 64, 1088 / 544 / 272, 1920 / 960 / 480])
     on the tensors compress warped, and K1's time at the 64-channel
     full-resolution shape beside its bytes bound;
 15. intra_hem I + one canfvc_dmc P-frame at 1080p full width, exact as 13;
 16. the video CLI on a seeded 1080p PNG sequence of 3 frames: intra_hem +
     dmc_hem writing streams and decoded PNGs (utils/png.write_png; read
     back, they must equal a fresh runtime pair's re-decode of the .bin
     files), then evc_SS with --force_intra;
 17. the five CompressAI zoo models at full width on one seeded 1080p
     image padded to 1088 through IntraZooRuntime (a warm-up round trip,
     then a timed one): symbols equal, recon gap 0.0 (limit 1e-5), bytes,
     encode / decode ms, peak memory, and for mbt2018 / cheng2020-anchor
     the host wavefront AR loop's ms apart from the rest (the image CLI
     phase, 12, also codes the two PNGs with mbt2018);
 18. mbt2018-mean I + dmc_tcm (128 / 64 / 96) two chained P-frames of the
     panning content at 1080p padded to 1088, aligned_enc off (P2 a
     warm-up + 3) then on; DPB gap <= 1e-4; mc exact, no kernel;
 19. one more dmc_tcm P-frame with the block mc: K1 4 + 4, then K1
     against its plain version (atol 0) at the four mc shapes;
 20. cheng2020-anchor I + dcvc_gen1 (128 / 64 / 96) two chained P-frames
     (P2 a warm-up + 3), mc exact, no kernel: per-substream host ms (mv_z
     and z rANS, mv_y and y wavefront AR loops); then one block-mc
     P-frame: K1 1 + 1, K1 vs plain at [1, 64, 1088, 1920], timed;
 21. the video CLI on the 1080p PNG sequence: mbt2018-mean + dmc_tcm
     writing streams and decoded PNGs equal to a fresh re-decode;
 22. training, card against CPU: one cascade-1 STE step of full-width DMC
     (exact warps) at 128x128, B = 2, from the same seeded weights and
     clip: the f32 loss within 1e-4 relative, every parameter's gradient
     within 1e-3 relative L2 compared in float64 (the f32 gradient gaps
     are printed beside the CPU's own f32-vs-f64 gap: in f32 this
     gradient is ill-conditioned at seeded weights);
 23. PFrameTrainer.fit on full-width DMC over MotionClips (256 px, 5
     frames, B = 4), the three DEFAULT_SCHEDULE stages cut to 3 steps
     each: step ms (median of the last two), peak memory and loss per
     stage; losses finite, parameters moved, K1 not launched; then one
     more cascade-1 step under torch.profiler (device ms, busy share,
     the convolution and grid_sample shares, top kernels);
 24. one cascade-2 undetached step with and without remat (noise rate
     surrogate, 5-level MS-SSIM, 256 px, B = 4): loss and gradients within
     1e-5 relative, peak memory of both;
 25. two make_intra_train_step steps of full-width IntraNoAR at 256 px,
     B = 4: step ms and peak memory;
 26. phase 23's last checkpoint loaded through utils/checkpoint into
     DmcRuntime: intra_dc I + 2 P of a 256 px motion clip through the
     containers, symbols equal and DPB gap 0.0 (K1 2 + 2);
 27. the training CLI (python -m dcvc_tpu_torch.tools.train --model
     dmc_hem --steps_per_epoch 2 --max_epochs 1 --batch_size 2) in process
     in a temporary workdir: a checkpoint and history.json;
 28. the warm server (dcvc_tpu_torch.serving) in process: CodecServer
     (intra_dc + dmc_dc, the weights of 7 loaded from .pth files) warmed
     at 1080p and serving from a thread over a Unix socket to the port's
     CodecClient: 3 rounds of an image (encode with recon, decode) and an
     I + 2 P session (u8 payloads, want_recon) decoded by a second
     session, then one session with f32 payloads of 7's frames. Decoded
     u8 recons equal the encoder's; the f32 session's containers equal
     7's bytes; K1 launches 2 per P encode_frame and 1 per P
     decode_frame; device memory after close_video within 1% of before
     open_video; each request's client ms (median of 3) beside the same
     calls on the server's runtimes in process, and the DPB bytes held
     per session;
 29. the serve CLI (python -m dcvc_tpu_torch.tools.serve --warmup 1080
     1920) in a process of its own: an image and an I + 1 P session coded
     there, then shutdown (exit code 0); this process codes the same
     frames with its own seed-0 runtimes and decodes the server's
     containers: containers equal, symbols equal, gap 0.0, recons equal;
 30. the video CLI with --worker_num 2 on the card (two spawned workers
     on cuda:0; 2 sequences x 1 rate, 2 frames at 1080p, write-stream):
     results keys and bpp, and .bin files, equal to the same items coded
     in this process; every worker .bin decoded here with the symbols this
     process's encoder wrote and the worker's recon YUV; then run_sharded
     across two spawned gloo ranks (every item merged, written by both);
 31. model_complexity for intra_dc and dmc_dc at 1088 x 1920 (parameters,
     convolution GFLOPs, wall); data_to_png on a 1080p YUV sequence
     (pixels equal the direct conversion);
 32. the dtype option: IntraNoAR (N=256) + DMC built through the registry
     with dtype=torch.bfloat16 (7's seeds) code I + 2 P of 7's content at
     1080p padded to 1088, aligned_enc off (the default), then on: symbols
     equal in every plane, every recon / DPB gap <= 4e-3 and no value above
     0.05 (tools/check_tpu_roundtrip.py's TOL and DESYNC), the encoder's
     coding indexes that differ from the decoder's counted; K1 1 + 1 per
     P-frame off (2 + 1 on: the aligned replay warps again), and against
     its plain version (atol 0) on the bf16 maps the first P compress gave
     it, timed there; then bf16 against f32 on the same weights and
     frames (I and P encode / decode ms, median of 3 after a warm-up;
     bytes, PSNR, peak memory; one profiled P-frame each: device ms, busy
     share, top kernels, cuDNN's FFT kernels); then evc_SS and evc_LL in
     bf16 on 10's image (warm-up + 3 round trips, the same limits, peak
     memory beside 10's f32 figures, one profiled evc_LL encode); then
     the other generations in bf16 on the seeds and content of 13-20:
     intra_hem and the four zoo models code one image (a warm-up, then a
     timed round trip; the AR loop's host ms apart), dmc_hem,
     canfvc_dmc, dmc_tcm and dcvc_gen1 code I + 2 P after their bf16 I
     models (intra_hem, intra_hem, mbt2018-mean, cheng2020-anchor), mc
     exact and no kernel, dmc_hem's and dmc_tcm's last P-frame a warm-up
     + 3 against f32 twins coded the same way here; then one bf16
     block-mc P-frame each of dmc_hem, dmc_tcm (K1 4 + 4) and dcvc_gen1
     (1 + 1), K1 against its plain version (atol 0) on the maps compress
     warped and timed at the 64-channel full-resolution map. Every frame:
     symbols equal, every gap <= 4e-3, none above 0.05;
 33. sharded inference (dcvc_tpu_torch.tools.mesh_check, the port's own
     entry point): one NCCL rank per visible card, each a process of its
     own, on make_mesh over every rank. DMC at full width codes two
     chained P-frames of seeded panning 1080p content (padded to 1088; each
     data group its own content) through the sharded DmcRuntime: on the
     data-only mesh with the block OD warp (K1 launches counted on each
     rank, at least one each), then on the widest tile axis with the exact
     and the tile:16,2,median OD warps (K1 counted 0), and on four cards
     also data 2 x tile 2. Encode / decode ms; the sharded decoder's DPB
     within 1e-4 of the sharded encoder's (the stream decodes); against
     the unsharded runtime on the same card: bytes equal or not, symbol
     and scale-index mismatches on the same input DPB, and the DPB gap.
     On one card every mesh is (1, 1): the halo code runs with only
     global edges, and no collective moves a row;
 34. one JSON line per kernel, then the result line.

Every path (7 to 33) runs with the kernels' launch counts set to 0 just
before it and read just after. The server process of 29 and the pool's
workers of 30 cannot report their counts: K1's are given as what the
same calls launch in process (28, and 30's in-process run). Paths 7, 8, 9, 14, 19, 20's block-mc
frame, 26 and 32's DC runtimes fail if they launched none of their
kernels (14 and 19: not exactly 4 + 4; 20: not 1 + 1; 32: not 1 + 1 per
P-frame, 2 + 1 with aligned_enc, and its bf16 block-mc frames not 4 + 4,
4 + 4 and 1 + 1); paths 10-13, 15-18, 20's exact frames, 21, 32's EVC and
exact-mc frames and the training paths 22-25 and 27 have no kernel
(convolutions, elementwise ops, host rANS and host AR loops only) and
fail if either count is not 0. Launches made to compare a kernel with its plain version
are not counted.

Imports nothing of JAX. Needs one card; without one it exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HEIGHT, WIDTH = 1080, 1920
P_FRAMES = 2
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS = 67e12                  # H100 SXM f32, outside the tensor cores
F32_TOL, RECON_TOL = 1e-5, 1e-4


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


def _reset_counts():
    from dcvc_tpu_torch.ops import band_copy as bc
    from dcvc_tpu_torch.ops import block_warp as bw

    bw.block_warp_nchw.launches = 0
    bc.band_copy.launches = 0


def _counts() -> dict:
    from dcvc_tpu_torch.ops import band_copy as bc
    from dcvc_tpu_torch.ops import block_warp as bw

    return {"block_warp": bw.block_warp_nchw.launches,
            "band_copy": bc.band_copy.launches}


def kernel_phase(results: dict):
    """K1 against its plain version (atol 0); fills results['block_warp']."""
    import torch

    from dcvc_tpu_torch.ops import block_warp as bw
    from dcvc_tpu_torch.ops.warp import flow_warp

    gen = torch.Generator(device="cuda").manual_seed(1234)
    Dh, Rv, BH, BW, base, pad = 4, 4, 64, 128, "median4", 16
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
        if not (err == 0.0 and torch.isfinite(ker.float()).all()):
            raise AssertionError(f"block_warp {name}: max abs err {err} > 0")
        row = {"max_abs_err": err, "tol": 0.0}
        if name.startswith("od_"):
            # the whole wrapper call, then its two kernels apart: the prep
            # (window origins and bases) and the warp on a fixed prep
            row["ms"] = _time_ms(lambda: bw.block_warp_nchw(
                im, flow, Dh, Rv, BH, BW, base), 20, 3)
            row["ms_prep"] = _time_ms(lambda: bw._prep_card(
                flow, BH, BW, Dh, Rv, base, pad), 20, 3)
            prep = bw._prep_card(flow, BH, BW, Dh, Rv, base, pad)
            row["ms_warp"] = _time_ms(lambda: bw._warp_card(
                im, flow, prep, Dh, Rv, BH, BW), 20, 3)
            row["plain_ms"] = _time_ms(lambda: bw.block_warp_plain_nchw(
                im, flow, Dh, Rv, BH, BW, base), 3)
            row["grid_sample_exact_warp_ms"] = _time_ms(
                lambda: flow_warp(im, flow), 10, 2)
            nbytes = (im.numel() * im.element_size() + flow.numel() * 4
                      + ker.numel() * ker.element_size())
            flops = M * H * W * (12 + 9 * C)  # taps + 3 lerps per channel
            plan = bw.plan_warp(C, BH, BW, Dh, Rv, im.element_size(), 4)
            row["bytes"] = nbytes
            row["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            row["ops_ms"] = flops / F32_FLOPS * 1e3
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                               else "operations")
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["warp_share_of_bound"] = row["bound_ms"] / row["ms_warp"]
            row["gb_per_s"] = nbytes / row["ms"] / 1e6
            row["warp_gb_per_s"] = nbytes / row["ms_warp"] / 1e6
            row["plan"] = {"px": plan.px, "S": plan.S, "stages": plan.NST,
                           "channels_per_group": plan.Cg,
                           "smem_bytes": plan.smem}
        rows[name] = row
        print(f"block_warp {name}: {json.dumps(row)}", flush=True)
        del im, flow, ker, plain
        torch.cuda.empty_cache()
    results["block_warp"] = rows


def _ptxas_registers(log: str) -> dict:
    """Registers per K2 instance from the ptxas lines of its build log."""
    regs, inst = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inst = "bulk" if "ILb1E" in line else "4-byte"
        elif "registers" in line and inst:
            regs[inst] = int(line.split("Used")[1].split()[0])
    return regs


def band_copy_phase(results: dict):
    """K2 against its plain version (atol 0) at four shapes, each with its
    launch plan and time beside its two bounds; fills results['band_copy'].
    ``ms`` is the kernel's card time (CUDA-graph replay), ``wrapper_ms``
    the wrapper called back to back (the host's launch cost included)."""
    import torch

    from dcvc_tpu_torch.ops import band_copy as bc
    from dcvc_tpu_torch.tools.diag_dma import graph_ms, make_inputs

    rows = {}
    for name, (H, Wp, C, A) in [
            ("tool_720x1408x16x4", (720, 1408, 16, 4)),
            ("edge_16x130x3x4", (16, 130, 3, 4)),       # 4-byte copies
            # 8 row groups on 132 SMs; chunks of 46,848 / 46,864 B
            ("uneven_64x1004x5x7", (64, 1004, 5, 7)),
            ("thin_720x1408x1x1", (720, 1408, 1, 1))]:
        src, by = make_inputs(H, Wp, C, A, "cuda")
        if not name.startswith("tool"):
            by[0], by[-1] = 0, H - 1          # the first and the last band
        out = bc.band_copy(src, by, A)
        torch.cuda.synchronize()
        plain = bc.band_copy_plain(src, by)
        err = (out - plain).abs().max().item()
        if not (err == 0.0 and torch.isfinite(out).all()):
            raise AssertionError(f"band_copy {name}: max abs err {err} > 0")
        plan = bc.plan_for(src, by, A, 8)
        rows_touched = torch.unique(
            (by.long()[:, None] + torch.arange(A, device="cuda"))
            .reshape(-1)).numel()
        unique = (rows_touched * C * Wp + H + H * Wp) * 4
        requested = H * A * C * Wp * 4
        # by is in range (checked above), so the timed calls skip the
        # host-side range check
        call = lambda: bc.band_copy(src, by, A, check_range=False)  # noqa: E731
        ms = graph_ms(call)
        row = {"max_abs_err": err, "tol": 0.0,
               "copies": "bulk" if plan.bulk else "4-byte",
               "ms": ms, "wrapper_ms": _time_ms(call, 50, 5),
               "unique_bytes": unique,
               "requested_band_bytes": requested,
               "bound_ms": unique / HBM_BYTES_PER_S * 1e3,
               "requested_bound_ms": requested / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes",
               "share_of_bound": unique / HBM_BYTES_PER_S * 1e3 / ms,
               "requested_gb_per_s": requested / ms / 1e6,
               "plan": {"ctas": plan.grid, "stages": plan.stages,
                        "chunks_per_band": plan.n_chunks,
                        "chunk_bytes": sorted({plan.chunk(k)[1] for k in
                                               range(plan.n_chunks)}),
                        "ring_stages": plan.NST, "smem_bytes": plan.smem},
               "sms": bc.sm_count(src.device),
               "ptxas_registers": _ptxas_registers(bc.build_log)}
        if name.startswith("tool"):
            row["plain_ms"] = graph_ms(lambda: bc.band_copy_plain(src, by))
            src0 = src[:, 0]
            row["index_select_ms"] = graph_ms(
                lambda: torch.index_select(src0, 0, by))
        rows[name] = row
        print(f"band_copy {name}: {json.dumps(row)}", flush=True)
        del src, by, out, plain
    results["band_copy"] = rows


def tile_warp_phase(results: dict):
    """The tile warp (plain PyTorch) at the OD shape beside K1 and the
    exact warp, and its card-vs-CPU gap on a small input."""
    import torch

    from dcvc_tpu_torch.ops import block_warp as bw
    from dcvc_tpu_torch.ops.warp import flow_warp, tile_warp

    gen = torch.Generator(device="cuda").manual_seed(99)
    im, flow = _od_inputs(8, 3, 67, 130, torch.float32, (20.0, -10.0), gen)
    gap = (tile_warp(im, flow, 32, 2, "median").cpu()
           - tile_warp(im.cpu(), flow.cpu(), 32, 2, "median")).abs().max().item()
    if not gap <= F32_TOL:
        raise AssertionError(f"tile warp card vs CPU gap {gap} > {F32_TOL}")
    im, flow = _od_inputs(32, 3, 1088, 1920, torch.float32, (0.0, 0.0), gen)
    row = {"mode": "tile:32,2,median", "shape": [32, 3, 1088, 1920],
           "card_vs_cpu_gap_8x3x67x130": gap,
           "tile_ms": _time_ms(lambda: tile_warp(im, flow, 32, 2, "median"),
                               3, 1),
           "block_warp_k1_ms": _time_ms(lambda: bw.block_warp_nchw(
               im, flow, 4, 4, 64, 128, "median4"), 10, 2),
           "grid_sample_exact_warp_ms": _time_ms(lambda: flow_warp(im, flow),
                                                 10, 2)}
    exact = flow_warp(im, flow)
    row["tile_vs_exact_max_abs"] = (tile_warp(im, flow, 32, 2, "median")
                                    - exact).abs().max().item()
    print(f"tile_warp {json.dumps(row)}", flush=True)
    results["tile_warp"] = row
    del im, flow, exact
    torch.cuda.empty_cache()


def reference_phase(_results=None):
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


def _device_rows(averages) -> list:
    """(device ms, count, name) per kernel of a torch.profiler run's
    ``key_averages()``, largest first; device-side rows only (kernels,
    copies): the CPU-side aten rows carry the same device time again."""
    rows = [(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3, e.count, e.key)
            for e in averages
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            # a user annotation (the optimizer's step range) spans kernels
            # counted on their own rows
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]
    return sorted((r for r in rows if r[0] > 0), reverse=True)


class _SymbolTap:
    """Records the symbols a runtime's rANS coders encode and the ones a
    runtime's coders (``dec_rt``'s, by default the same) decode, every
    substream in order; they are compared concatenated (the wavefront AR
    decode asks for one wavefront at a time). The AR runtimes code their
    wavefront strings with a second, one-part coder (``_ar_coder``),
    tapped into the same lists."""

    def __init__(self, rt, dec_rt=None):
        self.enc, self.dec, self.enc_idx, self.dec_idx = [], [], [], []
        dec_rt = dec_rt or rt
        for name in ("entropy_coder", "_ar_coder"):
            if getattr(rt, name, None) is not None:
                self._tap(getattr(rt, name), getattr(dec_rt, name))

    def _tap(self, enc_coder, dec_coder):
        import numpy as np

        encode, decode = enc_coder.encode_with_indexes, dec_coder.decode_stream

        def tap_encode(symbols, indexes, table):
            self.enc.append(np.clip(np.asarray(symbols).reshape(-1), -30000,
                                    30000).astype(np.int16))
            self.enc_idx.append(np.asarray(indexes).reshape(-1))
            return encode(symbols, indexes, table)

        def tap_decode(indexes, table):
            out = decode(indexes, table)
            self.dec.append(np.asarray(out).reshape(-1).astype(np.int16))
            self.dec_idx.append(np.asarray(indexes).reshape(-1))
            return out

        enc_coder.encode_with_indexes = tap_encode
        dec_coder.decode_stream = tap_decode

    def index_mismatches(self) -> int:
        """Coding indexes the encoder used that differ from the decoder's
        (call before ``equal``, which clears both)."""
        import numpy as np

        a, b = np.concatenate(self.enc_idx), np.concatenate(self.dec_idx)
        return int((a != b).sum()) if a.shape == b.shape else a.size

    def equal(self) -> bool:
        import numpy as np

        ok = bool(self.enc) and np.array_equal(np.concatenate(self.enc),
                                               np.concatenate(self.dec))
        self.enc, self.dec, self.enc_idx, self.dec_idx = [], [], [], []
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

    per_frame, streams = [], []
    q_index = 32
    _reset_counts()
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
        # the serving phase holds the server's containers against these
        streams.append(bytes(comp["bit_stream"]) if i == 0 else bytes(data))
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
    counts = _counts()
    launches = counts["block_warp"]
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
    if counts["band_copy"]:
        raise AssertionError("K2 launched on the codec path")
    results["launches"] = {"runtimes": counts}
    results["frames"] = per_frame
    results["main_path"] = {
        "q_index": q_index, "streams": streams,
        "weights": {name: {k: v.cpu() for k, v in rt.module.state_dict().items()}
                    for name, rt in (("intra_dc", irt), ("dmc_dc", prt))}}

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
    rows = _device_rows(prof.key_averages())
    device_ms = sum(r[0] for r in rows)
    print("profile " + json.dumps({
        "what": "one P-frame compress + decompress, profiler on",
        "wall_ms": wall_ms, "device_ms": device_ms or None,
        "device_busy_share": device_ms / wall_ms if device_ms else None,
        "block_warp_ms": sum(r[0] for r in rows if "block_warp" in r[2]
                             or "block_prep" in r[2]),
        "top": [{"ms": ms, "count": n, "name": k[:80]}
                for ms, n, k in rows[:10]]}), flush=True)


CLI_FRAMES = 3
CLI_SEQ = "synthetic_1080p"
# per-frame keys of a YUV420 source's summary, as dcvc_tpu/runner/video.py
# records them; dcvc_tpu/utils/results.py averages each over all / I / P
# frames and, at --verbose 2, lists it per frame
_FRAME_KEYS = ("bits", "bpp", "encoding_time", "decoding_time", "psnr_y",
               "psnr_u", "psnr_v", "psnr")


def _jax_summary_keys() -> set:
    keys = {"frame_num", "i_frame_num", "p_frame_num", "frame_type",
            "test_time", "name"}
    for k in _FRAME_KEYS:
        keys |= {f"ave_all_frame_{k}", f"ave_i_frame_{k}",
                 f"ave_p_frame_{k}", f"frame_{k}"}
    return keys


def _write_yuv_sequence(path: str, n_frames: int, mirror: bool = False):
    """The panning content of _content as 8-bit planar YUV420 (mirrored
    left to right with ``mirror``)."""
    import numpy as np

    from dcvc_tpu_torch.utils import color

    with open(path, "wb") as f:
        for x in _content(n_frames):
            if mirror:
                x = x.flip(3)
            y, uv = color.rgb_to_ycbcr420(x[0].permute(1, 2, 0).cpu().numpy())
            for plane in (y, uv):
                f.write(np.clip(np.rint(plane * 255), 0, 255)
                        .astype(np.uint8).tobytes())


def _i_dpb(x_hat):
    """An I-frame's DPB as the server builds it: the recon, clamped."""
    from dcvc_tpu_torch.serving.server import _i_dpb

    return _i_dpb(x_hat)


def _redecode_yuv(stream_dir: str, out_path: str, seq: str = CLI_SEQ,
                  n_frames: int = CLI_FRAMES):
    """Decode the CLI's .bin files again in a fresh runtime pair (built as
    the CLI builds them) and write the recon as the CLI's writer does.
    Returns the symbols the pair decoded, every plane in order."""
    import torch

    from dcvc_tpu_torch.models.registry import build
    from dcvc_tpu_torch.ops.warp import default_coding_warp_modes
    from dcvc_tpu_torch.utils import color, stream
    from dcvc_tpu_torch.utils.video_io import YUVWriter

    od, mc, me = default_coding_warp_modes(torch.device("cuda"))
    _, irt = build("intra_dc")
    _, prt = build("dmc_dc", od_warp_mode=od, mc_warp_mode=mc,
                   me_warp_mode=me)
    irt.update()
    prt.update()
    taps = [_SymbolTap(irt), _SymbolTap(prt)]
    writer = YUVWriter(out_path, WIDTH, HEIGHT)
    dpb = None
    for i in range(n_frames):
        path = os.path.join(stream_dir, f"{seq}_{i}.bin")
        if i == 0:
            h, w, qc, qi, s = stream.decode_i(path)
            dpb = _i_dpb(irt.decompress(s, h, w, qc, qi)["x_hat"])
            x_hat = dpb["ref_frame"]
        else:
            qc, qi, fi, s = stream.decode_p(path)
            dpb = dict(prt.decompress(dpb, s, HEIGHT, WIDTH, qc, qi, fi)["dpb"])
            x_hat = dpb["ref_frame"] = dpb["ref_frame"].clamp(0.0, 1.0)
        recon = x_hat[0, :, :HEIGHT, :WIDTH].permute(1, 2, 0).cpu().numpy()
        writer.write_one_frame(*color.ycbcr444_to_420(recon))
    writer.close()
    return [sym for tap in taps for sym in tap.dec]


def cli_phase(results: dict):
    """The port's video CLI in process on a 1080p YUV420 sequence."""
    import tempfile

    from dcvc_tpu_torch.tools import test_video

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        _write_yuv_sequence(os.path.join(tmp, CLI_SEQ + ".yuv"), CLI_FRAMES)
        cfg_path = os.path.join(tmp, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump({"root_path": tmp, "test_classes": {"smoke": {
                "test": 1, "base_path": "", "src_type": "yuv420",
                "sequences": {CLI_SEQ: {"width": WIDTH, "height": HEIGHT,
                                        "frames": CLI_FRAMES,
                                        "gop": 32}}}}}, f)

        def run(tag, *extra):
            args = ["--test_config", cfg_path, "--force_frame_num",
                    str(CLI_FRAMES), "--rate_num", "1", "--q_indexes", "32",
                    "--stream_path", os.path.join(tmp, tag), "--output_path",
                    os.path.join(tmp, tag + ".json"), "--verbose", "2", *extra]
            _reset_counts()
            t = time.time()
            res = test_video.main(args)
            wall = time.time() - t
            counts = _counts()
            if set(res) != {CLI_SEQ} or set(res[CLI_SEQ]) != {"rate_0"}:
                raise AssertionError(f"cli {tag}: results nesting {res.keys()}")
            sm = res[CLI_SEQ]["rate_0"]
            if set(sm) != _jax_summary_keys():
                raise AssertionError(f"cli {tag}: summary keys differ from "
                                     f"the JAX schema: "
                                     f"{set(sm) ^ _jax_summary_keys()}")
            frames = [{"frame": i, "type": "PI"[sm["frame_type"][i] == 0],
                       "encode_ms": sm["frame_encoding_time"][i] * 1e3,
                       "decode_ms": sm["frame_decoding_time"][i] * 1e3,
                       "bpp": sm["frame_bpp"][i], "psnr": sm["frame_psnr"][i]}
                      for i in range(sm["frame_num"])]
            if sm["frame_num"] != CLI_FRAMES or not all(
                    math.isfinite(r["psnr"]) and r["bpp"] > 0 for r in frames):
                raise AssertionError(f"cli {tag}: bad frames {frames}")
            if counts["block_warp"] < sm["p_frame_num"]:
                raise AssertionError(f"cli {tag}: K1 launched "
                                     f"{counts['block_warp']} times for "
                                     f"{sm['p_frame_num']} P-frames")
            if counts["band_copy"]:
                raise AssertionError(f"cli {tag}: K2 launched on the codec path")
            row = {"wall_s": wall, "launches": counts, "frames": frames}
            print(f"cli {tag}: {json.dumps(row)}", flush=True)
            runs[tag] = row

        def bins(tag):
            return [open(os.path.join(tmp, tag, f"{CLI_SEQ}_{i}.bin"),
                         "rb").read() for i in range(CLI_FRAMES)]

        run("write_stream", "--write_stream", "1", "--decoded_frame_path",
            os.path.join(tmp, "decoded"))
        _redecode_yuv(os.path.join(tmp, "write_stream"),
                      os.path.join(tmp, "redecoded", CLI_SEQ))
        with open(os.path.join(tmp, "decoded", CLI_SEQ + ".yuv"), "rb") as f:
            cli_yuv = f.read()
        with open(os.path.join(tmp, "redecoded", CLI_SEQ + ".yuv"), "rb") as f:
            again = f.read()
        if len(cli_yuv) != CLI_FRAMES * HEIGHT * WIDTH * 3 // 2 \
                or cli_yuv != again:
            raise AssertionError("re-decoded recon YUV differs from the CLI's")
        run("aligned_enc", "--write_stream", "1", "--aligned_enc", "1")
        if bins("aligned_enc") != bins("write_stream"):
            raise AssertionError("--aligned_enc 1 wrote other .bin files")
        run("estimated_bits", "--write_stream", "0")
        print("cli checks: re-decoded recon YUV byte-equal to the CLI's; "
              "aligned and direct .bin files identical "
              f"({[len(b) for b in bins('write_stream')]} bytes)", flush=True)
    results["cli"] = runs


def diag_phase(results: dict):
    """K2 through the port's probe tool (its own path)."""
    from dcvc_tpu_torch.tools import diag_dma

    _reset_counts()
    row = diag_dma.run()
    counts = _counts()
    if counts["band_copy"] < 1:
        raise AssertionError("the probe tool did not launch K2")
    if counts["block_warp"]:
        raise AssertionError("the probe tool launched K1")
    row["launches"] = counts["band_copy"]
    results["diag_dma"] = row


EVC_Q = 0.85                # q_scale of the EVC phases, rounded to 1/100
SCALABLE_H, SCALABLE_W = 512, 768


def _no_kernel_launched(path: str) -> dict:
    """The launch counts of a path that has no kernel: both must be 0."""
    counts = _counts()
    if any(counts.values()):
        raise AssertionError(f"{path}: kernels launched {counts}")
    return counts


def _conv_shapes(averages) -> list:
    """Convolutions of a torch.profiler run recorded with shapes (its
    ``key_averages(group_by_input_shape=True)``), largest device time
    first."""
    rows = [{"ms": getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0)) / 1e3,
             "count": e.count, "input_shapes": e.input_shapes[:2]}
            for e in averages if e.key == "aten::convolution"]
    return sorted(rows, key=lambda r: -r["ms"])


def _image(h: int, w: int, seed: int):
    """Seeded synthetic RGB image in [0, 1], NCHW on the card: a smooth
    texture with fine detail."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.rand(1, 3, h // 16 + 2, w // 16 + 2, generator=gen,
                      device="cuda")
    big = F.interpolate(base, size=(h, w), mode="bicubic", align_corners=False)
    detail = 0.08 * torch.rand(1, 3, h, w, generator=gen, device="cuda")
    return (big + detail).clamp(0, 1)


def _evc_roundtrip(rt, dec_rt, tap, x, h, w, path, tol=F32_TOL):
    """compress -> encode_i_ushort_q -> decode_i_ushort_q -> decompress by
    ``dec_rt``; returns (bytes, encode ms, decode ms, recon gap, the
    compress output)."""
    import torch

    from dcvc_tpu_torch.utils import stream

    q, q_index = stream.get_rounded_q(EVC_Q)
    t = time.time()
    comp = rt.compress(x, q)
    stream.encode_i_ushort_q(h, w, q_index, comp["bit_stream"], path)
    torch.cuda.synchronize()
    enc_ms = (time.time() - t) * 1e3
    t = time.time()
    hh, ww, qi, s = stream.decode_i_ushort_q(path)
    dec = dec_rt.decompress(s, hh, ww, qi / 100)
    torch.cuda.synchronize()
    dec_ms = (time.time() - t) * 1e3
    if not tap.equal():
        raise AssertionError(f"{path}: rANS symbols differ")
    gap = (comp["x_hat"].float() - dec["x_hat"].float()).abs().max().item()
    if not (gap <= tol and torch.isfinite(dec["x_hat"]).all()
            and dec["x_hat"].shape == x.shape):
        raise AssertionError(f"{path}: recon gap {gap}")
    with open(path, "rb") as f:
        return f.read(), enc_ms, dec_ms, gap, comp


def evc_phase(results: dict):
    """EVC_LL and EVC_SS at full width on a 1080p image padded to 1088 as
    the image CLI pads: encode, bytes, decode by a fresh runtime."""
    import tempfile

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from dcvc_tpu_torch.models.evc import build_evc
    from dcvc_tpu_torch.models.runtime import EvcCodecRuntime
    from dcvc_tpu_torch.ops.warp import get_padding_size
    from dcvc_tpu_torch.tools.model_complexity import conv_flops
    from dcvc_tpu_torch.utils import stream

    _, pr, _, pb = get_padding_size(HEIGHT, WIDTH, 64)
    x = F.pad(_image(HEIGHT, WIDTH, 5), (0, pr, 0, pb), mode="replicate")
    hp, wp = HEIGHT + pb, WIDTH + pr
    q, _ = stream.get_rounded_q(EVC_Q)
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for variant in ("LL", "SS"):
            steps = {}
            t_step = time.time()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            module = build_evc(variant, seed=21)
            rt, dec_rt = EvcCodecRuntime(module), EvcCodecRuntime(module)
            rt.update()
            dec_rt.update()
            tap = _SymbolTap(rt, dec_rt)
            path = os.path.join(tmp, f"evc_{variant}.bin")
            steps["build_s"], t_step = time.time() - t_step, time.time()
            _reset_counts()
            runs = [_evc_roundtrip(rt, dec_rt, tap, x, HEIGHT, WIDTH, path)
                    for _ in range(4)]               # one warm-up + 3
            steps["roundtrips_s"], t_step = time.time() - t_step, time.time()
            counts = _no_kernel_launched(f"evc_{variant}")
            if any(r[0] != runs[0][0] for r in runs):
                raise AssertionError(f"evc_{variant}: streams differ between "
                                     f"runs")
            peak = torch.cuda.max_memory_allocated()
            enc_ms = sorted(r[1] for r in runs[1:])[1]
            dec_ms = sorted(r[2] for r in runs[1:])[1]

            prof_rows = {}
            for what, fn in (
                    ("encode", lambda: rt.compress(x, q)),
                    ("decode", lambda: dec_rt.decompress(
                        runs[0][0][14:], hp, wp, q))):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             record_shapes=True) as prof:
                    t = time.time()
                    fn()
                    torch.cuda.synchronize()
                    wall = (time.time() - t) * 1e3
                averages = prof.key_averages(group_by_input_shape=True)
                dev = _device_rows(averages)
                device_ms = sum(r[0] for r in dev)
                prof_rows[what] = {
                    "wall_ms": wall, "device_ms": device_ms or None,
                    "busy_share": device_ms / wall if device_ms else None,
                    "top5": [{"ms": ms, "count": n, "name": k[:80]}
                             for ms, n, k in dev[:5]],
                    "conv_top3": _conv_shapes(averages)[:3]}
            tap.enc, tap.dec = [], []
            steps["profile_s"], t_step = time.time() - t_step, time.time()
            flops = {"encode": conv_flops(module, lambda: rt.compress(x, q)),
                     "decode": conv_flops(module, lambda: dec_rt.decompress(
                         runs[0][0][14:], hp, wp, q))}
            tap.enc, tap.dec = [], []
            steps["flops_s"] = time.time() - t_step
            row = {"model": f"evc_{variant}", "shape": [hp, wp],
                   "bytes": len(runs[0][0]),
                   "bpp": len(runs[0][0]) * 8 / (HEIGHT * WIDTH),
                   "encode_ms_median3": enc_ms, "decode_ms_median3": dec_ms,
                   "encode_ms_runs": [r[1] for r in runs],
                   "decode_ms_runs": [r[2] for r in runs],
                   "symbols_equal": True,
                   "max_recon_gap": max(r[3] for r in runs),
                   "peak_mem_gib": peak / 2 ** 30, "launches": counts,
                   "profile": prof_rows, "phase_steps": steps}
            for what in ("encode", "decode"):
                ms = row[f"{what}_ms_median3"]
                row[f"{what}_conv_gflop"] = flops[what] / 1e9
                row[f"{what}_conv_bound_ms"] = flops[what] / F32_FLOPS * 1e3
                row[f"{what}_conv_share_of_f32_peak"] = (
                    flops[what] / F32_FLOPS * 1e3 / ms)
                dev_ms = prof_rows[what]["device_ms"]
                row[f"{what}_conv_share_of_f32_peak_device"] = (
                    flops[what] / F32_FLOPS * 1e3 / dev_ms if dev_ms else None)
            print(f"evc {json.dumps(row)}", flush=True)
            rows[variant] = row
            del module, rt, dec_rt, tap
    results["evc"] = rows


def evc_scalable_phase(results: dict):
    """evc_scalable (4 S-grid encoders, L decoder) on a 768x512 image: the
    RD cost of each encoder, the chosen one, and an exact round trip."""
    import tempfile

    import torch

    from dcvc_tpu_torch.models.evc_scalable import LMBDAS, build_evc_scalable
    from dcvc_tpu_torch.models.runtime import ScalableEvcRuntime
    from dcvc_tpu_torch.utils import stream

    module = build_evc_scalable(seed=22)
    rt, dec_rt = ScalableEvcRuntime(module), ScalableEvcRuntime(module)
    rt.update()
    dec_rt.update()
    tap = _SymbolTap(rt, dec_rt)
    x = _image(SCALABLE_H, SCALABLE_W, 6)
    q, _ = stream.get_rounded_q(EVC_Q)
    _reset_counts()
    with torch.no_grad():
        bank = module(x, torch.tensor(q, device=x.device))
    cost = (LMBDAS[rt.rate_idx] * 255 * 255 * bank["mse"] + bank["bpp"]).tolist()
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(2):                                  # warm-up, then timed
            data, enc_ms, dec_ms, gap, comp = _evc_roundtrip(
                rt, dec_rt, tap, x, SCALABLE_H, SCALABLE_W,
                os.path.join(tmp, "scalable.bin"))
    enc_id = comp["enc_id"]
    counts = _no_kernel_launched("evc_scalable")
    if enc_id != min(range(len(cost)), key=cost.__getitem__):
        raise AssertionError(f"evc_scalable: enc_id {enc_id}, costs {cost}")
    row = {"model": "evc_scalable", "shape": [SCALABLE_H, SCALABLE_W],
           "rate_idx": rt.rate_idx, "enc_id": enc_id, "cost_by_encoder": cost,
           "bytes": len(data), "bpp": len(data) * 8 / (SCALABLE_H * SCALABLE_W),
           "encode_ms": enc_ms, "decode_ms": dec_ms, "symbols_equal": True,
           "max_recon_gap": gap, "launches": counts}
    print(f"evc_scalable {json.dumps(row)}", flush=True)
    results["evc_scalable"] = row


def image_cli_phase(results: dict):
    """The image CLI in process on two seeded 768x512 PNGs: evc_LL at 2
    rates, intra_hem and mbt2018 (a zoo model: one rate, wavefront AR) at 1
    writing streams (each .bin decoded again by a fresh runtime must give
    the CLI's recon exactly), then intra_dc at 1 rate."""
    import tempfile

    import torch

    from dcvc_tpu_torch.models import runtime as rtm
    from dcvc_tpu_torch.models.registry import build
    from dcvc_tpu_torch.tools import test_image
    from dcvc_tpu_torch.utils import png, stream

    names = ["im_a.png", "im_b.png"]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "imgs")
        os.makedirs(folder)
        for i, name in enumerate(names):
            img = _image(SCALABLE_H, SCALABLE_W, 30 + i)[0].permute(1, 2, 0)
            png.write_png(os.path.join(folder, name), (img * 255).round()
                          .to(torch.uint8).cpu().numpy())

        def run(tag, *extra, cls=rtm.EvcCodecRuntime):
            recons = []
            decompress = cls.decompress

            def recording(self, *a, **k):
                out = decompress(self, *a, **k)
                recons.append(out["x_hat"].clone())
                return out

            cls.decompress = recording
            _reset_counts()
            t = time.time()
            try:
                res = test_image.main([
                    "--img_folder", folder, "--stream_path",
                    os.path.join(tmp, tag), "--output_path",
                    os.path.join(tmp, tag + ".json"), "--verbose", "0", *extra])
            finally:
                cls.decompress = decompress
            wall = time.time() - t
            counts = _no_kernel_launched(f"image_cli {tag}")
            rates = {f"rate_{r}" for r in range(len(res["average"]))}
            if set(res) != {"per_image", "average"} or \
                    set(res["per_image"]) != set(names) or any(
                        set(v) != rates for v in res["per_image"].values()):
                raise AssertionError(f"image_cli {tag}: results nesting")
            for v in res["per_image"].values():
                for fr in v.values():
                    if not (all(math.isfinite(x) for x in fr.values())
                            and fr["bpp"] > 0):
                        raise AssertionError(f"image_cli {tag}: {fr}")
            runs[tag] = {"wall_s": wall, "launches": counts,
                         "per_image": res["per_image"]}
            print(f"image_cli {tag}: {json.dumps(runs[tag])}", flush=True)
            return recons

        def redecode(tag, recons, rates):
            """Each .bin of ``tag`` decoded by a fresh runtime must give
            the CLI's recon exactly; returns the .bin sizes."""
            _, fresh = build(tag)
            fresh.update()
            again = []
            for name in names:
                for r in range(rates):
                    path = os.path.join(tmp, tag, f"{name}_{r}.bin")
                    if isinstance(fresh, rtm.IntraZooRuntime):
                        h, w, strings = stream.decode_i_strings(path)
                        again.append(fresh.decompress(
                            strings, fresh.latent_shape(h, w))["x_hat"])
                        continue
                    h, w, qi, s = stream.decode_i_ushort_q(path)
                    again.append(fresh.decompress(s, h, w, qi / 100)["x_hat"])
            if len(recons) != len(again) or not all(
                    torch.equal(a, b) for a, b in zip(recons, again)):
                raise AssertionError(f"image_cli {tag}: re-decoded recon "
                                     f"differs from the CLI's")
            sizes = [os.path.getsize(os.path.join(tmp, tag, f"{n}_{r}.bin"))
                     for n in names for r in range(rates)]
            if min(sizes) <= 14:                   # a header and no stream
                raise AssertionError(f"image_cli {tag}: .bin sizes {sizes}")
            return sizes

        sizes = redecode("evc_LL", run(
            "evc_LL", "--model", "evc_LL", "--rate_num", "2",
            "--write_stream", "1", "--calc_ssim", "1"), 2)
        hem_sizes = redecode("intra_hem", run(
            "intra_hem", "--model", "intra_hem", "--rate_num", "1",
            "--write_stream", "1"), 1)
        zoo_sizes = redecode("mbt2018", run(
            "mbt2018", "--model", "mbt2018", "--rate_num", "1",
            "--write_stream", "1", cls=rtm.IntraZooRuntime), 1)
        run("intra_dc", "--model", "intra_dc", "--rate_num", "1",
            "--write_stream", "1")
        print(f"image_cli checks: {len(sizes)} evc_LL, {len(hem_sizes)} "
              f"intra_hem and {len(zoo_sizes)} mbt2018 .bin files re-decoded "
              f"by a fresh runtime equal the CLI's recon ({sizes}, "
              f"{hem_sizes}, {zoo_sizes} bytes)", flush=True)
    results["image_cli"] = runs


HEM_I_Q, HEM_MV_Q, HEM_Y_Q = 0.73, 0.9, 0.8   # q_scales, rounded to 1/100
HEM_SEEDS = {"intra_hem": 40, "dmc_hem": 41, "canfvc_dmc": 42}


def _sync_ms(t0: float) -> float:
    import torch

    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3


def _median3(runs, key):
    """The median of the 3 runs after the first (the warm-up)."""
    return sorted(r[key] for r in runs[1:])[1]


def _dpb_gap(enc: dict, dec: dict) -> float:
    return max((enc[k].float() - dec[k].float()).abs().max().item()
               for k in enc if enc[k] is not None)


def _hem_frames():
    """The panning content of _content, edge-padded to a multiple of 64
    (the HEM / EVC pad contract): 1920x1080 -> 1920x1088."""
    import torch.nn.functional as F

    from dcvc_tpu_torch.ops.warp import get_padding_size

    _, pr, _, pb = get_padding_size(HEIGHT, WIDTH, 64)
    return [F.pad(x, (0, pr, 0, pb), mode="replicate")
            for x in _content(1 + P_FRAMES)]


def _hem_i_frame(irt, tap, x, tol=0.0):
    """intra_hem compress -> ushort-q container -> decompress: the
    encoder's and the decoder's recon must be equal (gap 0.0; bf16: within
    ``tol``)."""
    from dcvc_tpu_torch.utils import stream

    q, q_index = stream.get_rounded_q(HEM_I_Q)
    hp, wp = x.shape[2], x.shape[3]
    t = time.time()
    comp = irt.compress(x, q)
    data = stream.pack_i_ushort_q(hp, wp, q_index, comp["bit_stream"])
    enc_ms = _sync_ms(t)
    t = time.time()
    h, w, qi, s = stream.unpack_i_ushort_q(data)
    dec = irt.decompress(s, h, w, qi / 100)
    dec_ms = _sync_ms(t)
    gap = (comp["x_hat"].float() - dec["x_hat"].float()).abs().max().item()
    if not (tap.equal() and gap <= tol):
        raise AssertionError(f"intra_hem I-frame: symbols equal "
                             f"{tap.equal()}, recon gap {gap}")
    return {"bytes": len(data), "encode_ms": enc_ms, "decode_ms": dec_ms,
            "max_recon_gap": gap}, comp, dec


def _hem_p_frame(prt, tap, x, dpb_enc, dpb_dec, what, tol=RECON_TOL):
    """A HEM / CANF P-frame: compress -> rounded-q P container (the
    hem_p pin's header) -> decompress from the decoder's DPB; symbols
    equal and DPB gap <= ``tol``."""
    import struct

    from dcvc_tpu_torch.utils import stream

    mv_q, mv_i = stream.get_rounded_q(HEM_MV_Q)
    y_q, y_i = stream.get_rounded_q(HEM_Y_Q)
    t = time.time()
    comp = prt.compress(x, dpb_enc, mv_q, y_q)
    data = (struct.pack(">2H", y_i, mv_i)
            + struct.pack(">I", len(comp["bit_stream"]))
            + bytes(comp["bit_stream"]))
    enc_ms = _sync_ms(t)
    t = time.time()
    y_i, mv_i = struct.unpack(">2H", data[:4])
    dec = prt.decompress(dpb_dec, data[8:], x.shape[2], x.shape[3],
                         mv_i / 100, y_i / 100)
    dec_ms = _sync_ms(t)
    sym_ok = tap.equal()
    gap = _dpb_gap(comp["dpb"], dec["dpb"])
    if not (sym_ok and gap <= tol and _finite(dec["dpb"]["ref_frame"])):
        raise AssertionError(f"{what}: symbols equal {sym_ok}, DPB gap {gap}")
    return {"bytes": len(data), "encode_ms": enc_ms, "decode_ms": dec_ms,
            "max_dpb_gap": gap}, comp, dec


def _finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def _hem_profile(fn) -> dict:
    """One call under torch.profiler: wall / device ms, busy share, the
    top five kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        wall = _sync_ms(t)
    rows = _device_rows(prof.key_averages())
    device_ms = sum(r[0] for r in rows)
    return {"wall_ms": wall, "device_ms": device_ms or None,
            "busy_share": device_ms / wall if device_ms else None,
            "top5": [{"ms": ms, "count": n, "name": k[:80]}
                     for ms, n, k in rows[:5]]}


def hem_phase(results: dict):
    """intra_hem (N=192) + dmc_hem (64 / 64 / 96) at 1080p padded to 1088:
    one I-frame (a warm-up + 3) and two chained P-frames through the
    runtimes, with aligned_enc off (the last P-frame a warm-up + 3) and
    then on, and one more P-frame under torch.profiler. mc warps exact: no
    kernel launches."""
    import torch

    from dcvc_tpu_torch.models.intra_hem import build_intra_hem
    from dcvc_tpu_torch.models.runtime import EvcCodecRuntime, HemVideoRuntime
    from dcvc_tpu_torch.models.video_hem import build_dmc_hem
    from dcvc_tpu_torch.utils import stream

    t0 = time.time()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    irt = EvcCodecRuntime(build_intra_hem(seed=HEM_SEEDS["intra_hem"]))
    prt = HemVideoRuntime(build_dmc_hem(seed=HEM_SEEDS["dmc_hem"]))
    irt.update()
    prt.update()
    taps = {"i": _SymbolTap(irt), "p": _SymbolTap(prt)}
    xs = _hem_frames()
    build_s = time.time() - t0
    _reset_counts()
    i_runs = [_hem_i_frame(irt, taps["i"], xs[0]) for _ in range(4)]
    _, comp_i, dec_i = i_runs[-1]
    i_runs = [r[0] for r in i_runs]
    dpb0_enc = {"ref_frame": comp_i["x_hat"], "ref_feature": None,
                "ref_y": None, "ref_mv_y": None}
    dpb0_dec = dict(dpb0_enc, ref_frame=dec_i["x_hat"])
    chains, streams = {}, {}
    for aligned in (False, True):
        prt.aligned_enc = aligned
        de, dd = dpb0_enc, dpb0_dec
        rows = []
        for i in range(1, 1 + P_FRAMES):
            reps = 4 if (i == P_FRAMES and not aligned) else 1
            runs = [_hem_p_frame(prt, taps["p"], xs[i], de, dd,
                                 f"dmc_hem P{i}") for _ in range(reps)]
            row, comp, dec = runs[-1]
            if reps > 1:
                row = dict(row, encode_ms_median3=_median3(
                    [r[0] for r in runs], "encode_ms"),
                    decode_ms_median3=_median3([r[0] for r in runs],
                                               "decode_ms"))
            rows.append(row)
            streams.setdefault(aligned, []).append(comp["bit_stream"])
            de, dd = comp["dpb"], dec["dpb"]
        chains["aligned_enc" if aligned else "direct"] = rows
    prt.aligned_enc = False
    counts = _no_kernel_launched("hem runtimes")
    peak = torch.cuda.max_memory_allocated()
    x = xs[-1].roll(4, dims=3)
    mv_q, _ = stream.get_rounded_q(HEM_MV_Q)
    y_q, _ = stream.get_rounded_q(HEM_Y_Q)
    profile = _hem_profile(lambda: prt.decompress(
        dd, prt.compress(x, de, mv_q, y_q)["bit_stream"], x.shape[2],
        x.shape[3], mv_q, y_q))
    taps["p"].enc, taps["p"].dec = [], []
    row = {"models": {"intra_hem": "N=192", "dmc_hem": "64/64/96"},
           "shape": list(xs[0].shape[2:]), "build_s": build_s,
           "i_frame": dict(i_runs[-1],
                           encode_ms_median3=_median3(i_runs, "encode_ms"),
                           decode_ms_median3=_median3(i_runs, "decode_ms"),
                           bpp=i_runs[-1]["bytes"] * 8 / (HEIGHT * WIDTH)),
           "p_frames": chains,
           "aligned_streams_identical": streams[True] == streams[False],
           "symbols_equal": True, "peak_mem_gib": peak / 2 ** 30,
           "launches": counts,
           "profile_p_frame": profile}
    print(f"hem {json.dumps(row)}", flush=True)
    results["hem"] = row
    results["_hem_state"] = (prt, taps["p"], x, de, dd)


K1_HEM_MODE = "block:4,4,64,128,median4"   # ops/warp.py RD_GATED_BLOCK_MODE
K1_MC_SPEC = (4, 4, 64, 128, "median4")     # the same, as arguments


def hem_block_phase(results: dict):
    """One more dmc_hem P-frame with mc_warp_mode = the block warp: K1
    launches 4 times per compress and 4 per decompress (the frame warp and
    the three context warps), symbols exact; that call is the warm-up of
    three timed ones (median). Then K1 against its plain version (atol 0)
    at the four mc shapes on the inputs that compress warped, and K1's
    time at the 64-channel full-resolution one."""
    import torch

    from dcvc_tpu_torch.ops import block_warp as bw
    from dcvc_tpu_torch.ops.warp import bilinear_down2

    from dcvc_tpu_torch.utils import stream

    prt, tap, x, de, dd = results.pop("_hem_state")
    m = prt.module
    mv_q, _ = stream.get_rounded_q(HEM_MV_Q)
    y_q, _ = stream.get_rounded_q(HEM_Y_Q)
    seen = {}
    hooks = [m.mv_decoder.register_forward_hook(
                 lambda mod, i, out: seen.setdefault("mv", out)),
             m.feature_extractor.register_forward_hook(
                 lambda mod, i, out: seen.setdefault("features", out))]
    m.mc_warp_mode = K1_HEM_MODE
    try:
        _reset_counts()
        t = time.time()
        comp = prt.compress(x, de, mv_q, y_q)
        enc_ms = _sync_ms(t)
        n_compress = bw.block_warp_nchw.launches
        t = time.time()
        dec = prt.decompress(dd, comp["bit_stream"], x.shape[2], x.shape[3],
                             mv_q, y_q)
        dec_ms = _sync_ms(t)
        counts = _counts()
        sym_ok, gap = tap.equal(), _dpb_gap(comp["dpb"], dec["dpb"])
        reps = [_hem_p_frame(prt, tap, x, de, dd, "dmc_hem block mc")[0]
                for _ in range(3)]
    finally:
        m.mc_warp_mode = None
        for h in hooks:
            h.remove()
    per_side = {"compress": n_compress,
                "decompress": counts["block_warp"] - n_compress}
    if not (sym_ok and gap <= RECON_TOL):
        raise AssertionError(f"hem block mc: symbols equal {sym_ok}, DPB "
                             f"gap {gap}")
    if per_side != {"compress": 4, "decompress": 4} or counts["band_copy"]:
        raise AssertionError(f"hem block mc: K1 launches {per_side}, K2 "
                             f"{counts['band_copy']}; expected 4 + 4 and 0")
    row = {"bytes": len(comp["bit_stream"]), "encode_ms": enc_ms,
           "decode_ms": dec_ms, "max_dpb_gap": gap, "symbols_equal": True,
           "encode_ms_median3": sorted(r["encode_ms"] for r in reps)[1],
           "decode_ms_median3": sorted(r["decode_ms"] for r in reps)[1]}
    mv = seen["mv"]
    mv2 = bilinear_down2(mv) / 2
    mv3 = bilinear_down2(mv2) / 2
    f1, f2, f3 = seen["features"]
    spec = K1_MC_SPEC
    checks = {}
    for name, im, flow in (("frame_3ch", de["ref_frame"], mv),
                           ("context1_64ch", f1, mv), ("context2_64ch", f2, mv2),
                           ("context3_64ch", f3, mv3)):
        ker = bw.block_warp_nchw(im, flow, *spec)
        torch.cuda.synchronize()
        plain = bw.block_warp_plain_nchw(im, flow, *spec)
        err = (ker - plain).abs().max().item()
        if not (err == 0.0 and _finite(ker)):
            raise AssertionError(f"K1 hem {name} {tuple(im.shape)}: max abs "
                                 f"err {err} > 0")
        checks[name] = {"shape": list(im.shape), "max_abs_err": err}
    nbytes = (f1.numel() * 4 + mv.numel() * 4 + f1.numel() * 4)
    M, C, H, W = f1.shape
    flops = M * H * W * (12 + 9 * C)
    k1 = {"shape": list(f1.shape),
          "ms": _time_ms(lambda: bw.block_warp_nchw(f1, mv, *spec), 20, 3),
          "plain_ms": _time_ms(lambda: bw.block_warp_plain_nchw(
              f1, mv, *spec), 3),
          "bytes": nbytes, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
          "ops_ms": flops / F32_FLOPS * 1e3}
    k1["bound_ms"] = max(k1["bytes_ms"], k1["ops_ms"])
    k1["bound_by"] = ("bytes" if k1["bytes_ms"] >= k1["ops_ms"]
                      else "operations")
    k1["share_of_bound"] = k1["bound_ms"] / k1["ms"]
    row.update(launches=counts, k1_launches=per_side, k1_vs_plain=checks,
               k1_64ch_full_res=k1)
    print(f"hem_block_mc {json.dumps(row)}", flush=True)
    results["hem_block"] = row


def canf_phase(results: dict):
    """intra_hem I + one canfvc_dmc P-frame (a warm-up + 3) at 1080p padded
    to 1088, full width; exact as the HEM phase, no kernel launches."""
    import torch

    from dcvc_tpu_torch.models.intra_hem import build_intra_hem
    from dcvc_tpu_torch.models.runtime import EvcCodecRuntime, HemVideoRuntime
    from dcvc_tpu_torch.models.video_canf import build_canf

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    irt = EvcCodecRuntime(build_intra_hem(seed=HEM_SEEDS["intra_hem"]))
    crt = HemVideoRuntime(build_canf(seed=HEM_SEEDS["canfvc_dmc"]))
    irt.update()
    crt.update()
    taps = {"i": _SymbolTap(irt), "p": _SymbolTap(crt)}
    xs = _hem_frames()
    _reset_counts()
    i_row, comp_i, dec_i = _hem_i_frame(irt, taps["i"], xs[0])
    dpb_enc = {"ref_frame": comp_i["x_hat"], "ref_feature": None,
               "ref_y": None, "ref_mv_y": None}
    dpb_dec = dict(dpb_enc, ref_frame=dec_i["x_hat"])
    runs = [_hem_p_frame(crt, taps["p"], xs[1], dpb_enc, dpb_dec,
                         "canfvc_dmc P1")[0] for _ in range(4)]
    counts = _no_kernel_launched("canf runtimes")
    row = {"models": {"intra_hem": "N=192", "canfvc_dmc": "64/64/96"},
           "i_frame": i_row, "p_frame": runs[-1],
           "p_encode_ms_median3": _median3(runs, "encode_ms"),
           "p_decode_ms_median3": _median3(runs, "decode_ms"),
           "p_bpp": runs[-1]["bytes"] * 8 / (HEIGHT * WIDTH),
           "symbols_equal": True,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": counts}
    print(f"canf {json.dumps(row)}", flush=True)
    results["canf"] = row


def _write_png_sequence(folder: str, n_frames: int):
    """The panning content of _content as im1.png .. imN.png."""
    import torch

    from dcvc_tpu_torch.utils import png

    os.makedirs(folder, exist_ok=True)
    for i, x in enumerate(_content(n_frames)):
        png.write_png(os.path.join(folder, f"im{i + 1}.png"),
                      (x[0].permute(1, 2, 0) * 255).round().to(torch.uint8)
                      .cpu().numpy())


def _redecode_pngs(stream_dir: str, seq: str, i_model: str,
                   p_model: str) -> list:
    """Decode the CLI's .bin files again in a fresh runtime pair built as
    the CLI builds them, the DPB kept as the GOP runner keeps it; the
    recons as the CLI's PNG writer rounds them."""
    import numpy as np

    from dcvc_tpu_torch.models.registry import build
    from dcvc_tpu_torch.runner.adapters import adapt_i_runtime, adapt_p_runtime
    from dcvc_tpu_torch.utils import stream

    irt, prt = (adapt_i_runtime(build(i_model)[1]),
                adapt_p_runtime(build(p_model)[1]))
    irt.update()
    prt.update()
    out, dpb = [], None
    for i in range(CLI_FRAMES):
        path = os.path.join(stream_dir, f"{seq}_{i}.bin")
        if i == 0:
            h, w, qc, qi, s = stream.decode_i(path)
            dpb = _i_dpb(irt.decompress(s, h, w, qc, qi)["x_hat"])
            x_hat = dpb["ref_frame"]
        else:
            qc, qi, fi, s = stream.decode_p(path)
            dpb = dict(prt.decompress(dpb, s, HEIGHT, WIDTH, qc, qi, fi)["dpb"])
            x_hat = dpb["ref_frame"] = dpb["ref_frame"].clamp(0.0, 1.0)
        recon = x_hat[0, :, :HEIGHT, :WIDTH].permute(1, 2, 0).cpu().numpy()
        out.append(np.clip(np.rint(recon * 255.0), 0, 255).astype(np.uint8))
    return out


def _png_sequence_config(tmp: str, seq: str) -> str:
    """The panning content as a PNG sequence under ``tmp`` and a dataset
    config naming it; the config's path."""
    _write_png_sequence(os.path.join(tmp, seq), CLI_FRAMES)
    cfg_path = os.path.join(tmp, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump({"root_path": tmp, "test_classes": {"smoke": {
            "test": 1, "base_path": "", "src_type": "png",
            "sequences": {seq: {"width": WIDTH, "height": HEIGHT,
                                "frames": CLI_FRAMES, "gop": 32}}}}}, f)
    return cfg_path


def _cli_row(sm: dict, wall: float, counts: dict, tag: str) -> dict:
    """A video CLI run's frames as its summary records them; fails on a
    missing frame or a non-finite one."""
    frames = [{"type": "PI"[sm["frame_type"][i] == 0],
               "encode_ms": sm["frame_encoding_time"][i] * 1e3,
               "decode_ms": sm["frame_decoding_time"][i] * 1e3,
               "bpp": sm["frame_bpp"][i], "psnr": sm["frame_psnr"][i]}
              for i in range(sm["frame_num"])]
    if sm["frame_num"] != CLI_FRAMES or not all(
            math.isfinite(r["psnr"]) and r["bpp"] > 0 for r in frames):
        raise AssertionError(f"cli {tag}: bad frames {frames}")
    return {"wall_s": wall, "launches": counts, "frames": frames}


def hem_cli_phase(results: dict):
    """The video CLI on a 1080p PNG sequence: intra_hem + dmc_hem writing
    streams and the decoded PNGs (re-decoded by a fresh runtime pair, the
    PNGs read back must equal them), then evc_SS with --force_intra."""
    import tempfile

    import numpy as np

    from dcvc_tpu_torch.tools import test_video
    from dcvc_tpu_torch.utils import png

    seq, runs = "synthetic_1080p_png", {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = _png_sequence_config(tmp, seq)

        def run(tag, *extra):
            _reset_counts()
            t = time.time()
            res = test_video.main([
                "--test_config", cfg_path, "--force_frame_num",
                str(CLI_FRAMES), "--rate_num", "1", "--q_indexes", "32",
                "--write_stream", "1", "--stream_path",
                os.path.join(tmp, tag), "--output_path",
                os.path.join(tmp, tag + ".json"), "--verbose", "2", *extra])
            sm = res[seq]["rate_0"]
            runs[tag] = _cli_row(sm, time.time() - t,
                                 _no_kernel_launched(f"cli {tag}"), tag)
            print(f"cli {tag}: {json.dumps(runs[tag])}", flush=True)
            return sm

        run("hem", "--i_frame_model", "intra_hem", "--p_frame_model",
            "dmc_hem", "--decoded_frame_path", os.path.join(tmp, "decoded"))
        again = _redecode_pngs(os.path.join(tmp, "hem"), seq, "intra_hem",
                               "dmc_hem")
        for i, recon in enumerate(again):
            written = png.read_png(os.path.join(tmp, "decoded", seq,
                                                f"im{i + 1:05d}.png"))
            if not np.array_equal(written, recon):
                raise AssertionError(f"cli hem: decoded PNG {i} differs from "
                                     f"the re-decoded recon")
        sm = run("evc_force_intra", "--i_frame_model", "evc_SS",
                 "--force_intra")
        if sm["i_frame_num"] != CLI_FRAMES:
            raise AssertionError(f"cli evc --force_intra: {sm['frame_type']}")
    print(f"cli checks: {CLI_FRAMES} intra_hem + dmc_hem decoded PNGs equal "
          f"a fresh runtime pair's re-decode; evc_SS --force_intra coded "
          f"{CLI_FRAMES} I-frames", flush=True)
    results["hem_cli"] = runs


ZOO_SEEDS = {"bmshj2018-factorized": 50, "bmshj2018-hyperprior": 51,
             "mbt2018-mean": 52, "mbt2018": 53, "cheng2020-anchor": 54}
TCM_I, GEN1_I = "mbt2018-mean", "cheng2020-anchor"   # their I-frame models
P_SEEDS = {"dmc_tcm": 55, "dcvc_gen1": 56}
GEN1_LATENT_GAIN = 10.0


class _ArClock:
    """Host ms of each wavefront AR call (``runtime.ar_encode`` /
    ``ar_decode``), in call order, while installed."""

    def __enter__(self):
        from dcvc_tpu_torch.models import runtime as rtm

        self.calls = []
        self._saved = rtm.ar_encode, rtm.ar_decode

        def clocked(fn, side):
            def run(*a, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                self.calls.append((side, (time.perf_counter() - t) * 1e3))
                return out
            return run

        rtm.ar_encode = clocked(self._saved[0], "encode")
        rtm.ar_decode = clocked(self._saved[1], "decode")
        return self

    def __exit__(self, *exc):
        from dcvc_tpu_torch.models import runtime as rtm

        rtm.ar_encode, rtm.ar_decode = self._saved

    def take(self) -> dict:
        """{"encode": [ms, ...], "decode": [ms, ...]} since the last take."""
        out = {"encode": [], "decode": []}
        for side, ms in self.calls:
            out[side].append(ms)
        self.calls = []
        return out


def _pad64(x):
    import torch.nn.functional as F

    from dcvc_tpu_torch.ops.warp import get_padding_size

    _, pr, _, pb = get_padding_size(x.shape[2], x.shape[3], 64)
    return F.pad(x, (0, pr, 0, pb), mode="replicate")


def _zoo_i_frame(rt, tap, x, what, tol=F32_TOL):
    """compress -> packed substreams -> decompress: symbols equal, recon
    gap 0.0 (limit ``tol``)."""
    from dcvc_tpu_torch.utils import stream

    t = time.time()
    comp = rt.compress(x)
    data = stream.pack_strings(comp["strings"])
    enc_ms = _sync_ms(t)
    t = time.time()
    dec = rt.decompress(stream.unpack_strings(data),
                        rt.latent_shape(x.shape[2], x.shape[3]))
    dec_ms = _sync_ms(t)
    sym_ok = tap.equal()
    gap = (comp["x_hat"].float() - dec["x_hat"].float()).abs().max().item()
    if not (sym_ok and gap <= tol and _finite(dec["x_hat"])):
        raise AssertionError(f"{what}: symbols equal {sym_ok}, recon gap {gap}")
    return {"bytes": len(data), "encode_ms": enc_ms, "decode_ms": dec_ms,
            "max_recon_gap": gap}, comp, dec


def zoo_phase(results: dict):
    """The five zoo models at full width on one seeded 1080p image padded
    to 1088: a warm-up round trip, then a timed one; symbols equal, recon
    gap 0.0; the AR models' host wavefront loop timed apart. No kernel."""
    import torch

    from dcvc_tpu_torch.models.intra_zoo import build_zoo
    from dcvc_tpu_torch.models.runtime import IntraZooRuntime

    x = _pad64(_image(HEIGHT, WIDTH, 7))
    rows = {}
    with _ArClock() as clock:
        for name, seed in ZOO_SEEDS.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            rt = IntraZooRuntime(build_zoo(name, seed=seed))
            rt.update()
            tap = _SymbolTap(rt)
            _reset_counts()
            _zoo_i_frame(rt, tap, x, name)
            clock.take()
            row, _, _ = _zoo_i_frame(rt, tap, x, name)
            ar = clock.take()
            row.update(bpp=row["bytes"] * 8 / (HEIGHT * WIDTH),
                       symbols_equal=True,
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       launches=_no_kernel_launched(f"zoo {name}"))
            if ar["encode"]:
                row["ar_host_ms"] = {"encode": sum(ar["encode"]),
                                     "decode": sum(ar["decode"])}
                row["device_and_rest_ms"] = {
                    "encode": row["encode_ms"] - sum(ar["encode"]),
                    "decode": row["decode_ms"] - sum(ar["decode"])}
            rows[name] = row
            print(f"zoo {name}: {json.dumps(row)}", flush=True)
            del rt
    results["zoo"] = rows


def _zoo_dpb(irt, tap, x, name):
    """A zoo I-frame: the encoder's and the decoder's first DPB."""
    row, comp, dec = _zoo_i_frame(irt, tap, x, name)
    return row, {"ref_frame": comp["x_hat"], "ref_feature": None}, \
        {"ref_frame": dec["x_hat"], "ref_feature": None}


def _tcm_p_frame(prt, tap, x, de, dd, what, tol=RECON_TOL):
    """A dmc_tcm P-frame: compress -> the bare payload -> decompress from
    the decoder's DPB; symbols equal, DPB gap <= ``tol``."""
    t = time.time()
    comp = prt.compress(x, de["ref_frame"], de["ref_feature"])
    data = bytes(comp["bit_stream"])
    enc_ms = _sync_ms(t)
    t = time.time()
    dec = prt.decompress(dd["ref_frame"], dd["ref_feature"], data,
                         x.shape[2], x.shape[3])
    dec_ms = _sync_ms(t)
    enc = {"ref_frame": comp["x_hat"], "ref_feature": comp["feature"]}
    dec = {"ref_frame": dec["x_hat"], "ref_feature": dec["feature"]}
    sym_ok, gap = tap.equal(), _dpb_gap(enc, dec)
    if not (sym_ok and gap <= tol and _finite(dec["ref_frame"])):
        raise AssertionError(f"{what}: symbols equal {sym_ok}, DPB gap {gap}")
    return {"bytes": len(data), "encode_ms": enc_ms, "decode_ms": dec_ms,
            "max_dpb_gap": gap}, enc, dec, data


def tcm_phase(results: dict):
    """A zoo I-frame (mbt2018-mean) + dmc_tcm (128 / 64 / 96) at 1080p
    padded to 1088: two chained P-frames with aligned_enc off (the last a
    warm-up + 3) and then on; mc warps exact, no kernel launches."""
    import torch

    from dcvc_tpu_torch.models.intra_zoo import build_zoo
    from dcvc_tpu_torch.models.runtime import IntraZooRuntime, TcmVideoRuntime
    from dcvc_tpu_torch.models.video_tcm import build_dmc_tcm

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    irt = IntraZooRuntime(build_zoo(TCM_I, seed=ZOO_SEEDS[TCM_I]))
    prt = TcmVideoRuntime(build_dmc_tcm(seed=P_SEEDS["dmc_tcm"]))
    irt.update()
    prt.update()
    taps = {"i": _SymbolTap(irt), "p": _SymbolTap(prt)}
    xs = _hem_frames()
    _reset_counts()
    i_row, dpb0_enc, dpb0_dec = _zoo_dpb(irt, taps["i"], xs[0], TCM_I)
    chains, streams = {}, {}
    for aligned in (False, True):
        prt.aligned_enc = aligned
        de, dd = dpb0_enc, dpb0_dec
        rows = []
        for i in range(1, 1 + P_FRAMES):
            reps = 4 if (i == P_FRAMES and not aligned) else 1
            runs = [_tcm_p_frame(prt, taps["p"], xs[i], de, dd,
                                 f"dmc_tcm P{i}") for _ in range(reps)]
            row, enc, dec, data = runs[-1]
            if reps > 1:
                row = dict(row, encode_ms_median3=_median3(
                    [r[0] for r in runs], "encode_ms"),
                    decode_ms_median3=_median3([r[0] for r in runs],
                                               "decode_ms"))
            rows.append(row)
            streams.setdefault(aligned, []).append(data)
            de, dd = enc, dec
        chains["aligned_enc" if aligned else "direct"] = rows
    prt.aligned_enc = False
    if streams[True] != streams[False]:
        raise AssertionError("dmc_tcm: aligned_enc wrote other streams")
    row = {"models": {TCM_I: "N=128 M=192", "dmc_tcm": "128/64/96"},
           "i_frame": i_row, "p_frames": chains,
           "p_bpp": chains["direct"][-1]["bytes"] * 8 / (HEIGHT * WIDTH),
           "aligned_streams_identical": True, "symbols_equal": True,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": _no_kernel_launched("tcm runtimes")}
    print(f"tcm {json.dumps(row)}", flush=True)
    results["tcm"] = row
    results["_tcm_state"] = (prt, taps["p"], xs[-1].roll(4, dims=3), de, dd)


def _k1_checks(pairs, what) -> dict:
    """K1 against its plain version (atol 0) on each (name, im, flow)."""
    import torch

    from dcvc_tpu_torch.ops import block_warp as bw

    checks = {}
    for name, im, flow in pairs:
        ker = bw.block_warp_nchw(im, flow, *K1_MC_SPEC)
        torch.cuda.synchronize()
        plain = bw.block_warp_plain_nchw(im, flow, *K1_MC_SPEC)
        err = (ker - plain).abs().max().item()
        if not (err == 0.0 and _finite(ker)):
            raise AssertionError(f"K1 {what} {name} {tuple(im.shape)}: max "
                                 f"abs err {err} > 0")
        checks[name] = {"shape": list(im.shape), "max_abs_err": err}
    return checks


def _k1_timing(im, flow) -> dict:
    """K1's time at ``im``'s shape and dtype beside its bound (the image
    read and the output written in ``im``'s dtype, the flow read in its
    own) and its plain version."""
    from dcvc_tpu_torch.ops import block_warp as bw

    M, C, H, W = im.shape
    nbytes = 2 * im.numel() * im.element_size() + flow.numel() * \
        flow.element_size()
    flops = M * H * W * (12 + 9 * C)
    row = {"shape": list(im.shape), "dtype": str(im.dtype),
           "ms": _time_ms(lambda: bw.block_warp_nchw(im, flow, *K1_MC_SPEC),
                          20, 3),
           "plain_ms": _time_ms(lambda: bw.block_warp_plain_nchw(
               im, flow, *K1_MC_SPEC), 3),
           "bytes": nbytes, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "ops_ms": flops / F32_FLOPS * 1e3}
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                       else "operations")
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return row


def _block_mc(m, tap, compress, decompress, gap_fn, expected: dict, what,
              tol=RECON_TOL):
    """One P-frame with ``m.mc_warp_mode`` = the block warp, counting K1
    per side (must be ``expected``), symbols exact and ``gap_fn(comp,
    dec)`` <= ``tol``; that call is the warm-up of three timed round
    trips (median)."""
    from dcvc_tpu_torch.ops import block_warp as bw

    def round_trip():
        t = time.time()
        comp = compress()
        enc_ms = _sync_ms(t)
        n = bw.block_warp_nchw.launches
        t = time.time()
        dec = decompress(comp)
        dec_ms = _sync_ms(t)
        sym_ok, gap = tap.equal(), gap_fn(comp, dec)
        if not (sym_ok and gap <= tol):
            raise AssertionError(f"{what}: symbols equal {sym_ok}, gap {gap}")
        return {"encode_ms": enc_ms, "decode_ms": dec_ms, "max_gap": gap}, n

    m.mc_warp_mode = K1_HEM_MODE
    try:
        _reset_counts()
        row, n_compress = round_trip()
        counts = _counts()
        reps = [round_trip()[0] for _ in range(3)]
    finally:
        m.mc_warp_mode = None
    per_side = {"compress": n_compress,
                "decompress": counts["block_warp"] - n_compress}
    if per_side != expected or counts["band_copy"]:
        raise AssertionError(f"{what}: K1 launches {per_side}, K2 "
                             f"{counts['band_copy']}; expected {expected}, 0")
    return dict(row, symbols_equal=True,
                encode_ms_median3=sorted(r["encode_ms"] for r in reps)[1],
                decode_ms_median3=sorted(r["decode_ms"] for r in reps)[1],
                launches=counts, k1_launches=per_side)


def tcm_block_phase(results: dict):
    """One more dmc_tcm P-frame with the block mc: K1 4 + 4 (the frame
    warp and the three context warps, each side), symbols exact; then K1
    against its plain version at the four mc shapes on the tensors that
    compress warped."""
    from dcvc_tpu_torch.ops.warp import bilinear_down2

    prt, tap, x, de, dd = results.pop("_tcm_state")
    m = prt.module
    seen = {}
    hooks = [m.mv_decoder.register_forward_hook(
                 lambda mod, i, out: seen.setdefault("mv", out)),
             m.feature_extractor.register_forward_hook(
                 lambda mod, i, out: seen.setdefault("features", out))]
    try:
        row = _block_mc(
            m, tap, lambda: prt.compress(x, de["ref_frame"], de["ref_feature"]),
            lambda c: prt.decompress(dd["ref_frame"], dd["ref_feature"],
                                     c["bit_stream"], x.shape[2], x.shape[3]),
            lambda c, d: max((c[k] - d[k]).abs().max().item()
                             for k in ("x_hat", "feature")),
            {"compress": 4, "decompress": 4}, "tcm block mc")
    finally:
        for h in hooks:
            h.remove()
    mv = seen["mv"]
    mv2 = bilinear_down2(mv) / 2
    mv3 = bilinear_down2(mv2) / 2
    f1, f2, f3 = seen["features"]
    row["k1_vs_plain"] = _k1_checks(
        (("frame_3ch", de["ref_frame"], mv), ("context1_64ch", f1, mv),
         ("context2_64ch", f2, mv2), ("context3_64ch", f3, mv3)), "tcm")
    print(f"tcm_block_mc {json.dumps(row)}", flush=True)
    results["tcm_block"] = row


def _gen1_p_frame(prt, tap, x, ref_enc, ref_dec, clock, what,
                  tol=RECON_TOL):
    """A dcvc_gen1 P-frame: compress -> four packed substreams ->
    decompress from the decoder's reference; symbols equal, recon gap <=
    ``tol``. The host ms of each substream's entropy coding: mv_z and z
    (bit-estimator rANS), mv_y and y (the wavefront AR loops)."""
    from dcvc_tpu_torch.utils import stream

    zt = []
    encode_z = prt._encode_z

    def timed_z(name, z):
        t = time.perf_counter()
        encode_z(name, z)
        zt.append((time.perf_counter() - t) * 1e3)

    prt._encode_z = timed_z
    try:
        t = time.time()
        comp = prt.compress(ref_enc, x)
        data = stream.pack_strings([comp["mv_z_string"], comp["mv_y_string"],
                                    comp["z_string"], comp["y_string"]])
        enc_ms = _sync_ms(t)
    finally:
        del prt._encode_z
    mv_z, mv_y, z, y = stream.unpack_strings(data)
    t = time.time()
    dec = prt.decompress(ref_dec, mv_y, mv_z, y, z, x.shape[2], x.shape[3])
    dec_ms = _sync_ms(t)
    ar = clock.take()
    sym_ok = tap.equal()
    gap = (comp["recon_image"].float() - dec["recon_image"].float()).abs() \
        .max().item()
    if not (sym_ok and gap <= tol and _finite(dec["recon_image"])):
        raise AssertionError(f"{what}: symbols equal {sym_ok}, gap {gap}")
    return {"bytes": len(data), "encode_ms": enc_ms, "decode_ms": dec_ms,
            "max_recon_gap": gap,
            "substream_bytes": {k: len(s) for k, s in zip(
                ("mv_z", "mv_y", "z", "y"), (mv_z, mv_y, z, y))},
            "substream_encode_host_ms": {"mv_z": zt[0], "mv_y": ar["encode"][0],
                                         "z": zt[1], "y": ar["encode"][1]},
            "ar_decode_host_ms": {"mv_y": ar["decode"][0],
                                  "y": ar["decode"][1]}}, comp, dec


def gen1_phase(results: dict):
    """A zoo I-frame (cheng2020-anchor) + dcvc_gen1 (128 / 64 / 96) at
    1080p padded to 1088: two chained P-frames, mc exact, no kernel; the
    last a warm-up + 3 timed. Then one block-mc P-frame: K1 1 + 1 (the
    context warp each side), and K1 against its plain version at that
    [1, 64, 1088, 1920] shape, timed beside its bound. The last layers of
    the mv and contextual encoders are scaled x GEN1_LATENT_GAIN: at the
    seeded init both AR latents round to zeros, and the AR coder would
    code nothing but zero symbols."""
    import torch

    from dcvc_tpu_torch.models.intra_zoo import build_zoo
    from dcvc_tpu_torch.models.runtime import DcvcGen1Runtime, IntraZooRuntime
    from dcvc_tpu_torch.models.video_dcvc import build_dcvc_gen1

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    irt = IntraZooRuntime(build_zoo(GEN1_I, seed=ZOO_SEEDS[GEN1_I]))
    module = build_dcvc_gen1(seed=P_SEEDS["dcvc_gen1"])
    with torch.no_grad():
        module.mvEncoder[-1].weight.mul_(GEN1_LATENT_GAIN)
        module.contextualEncoder[-1].weight.mul_(GEN1_LATENT_GAIN)
    prt = DcvcGen1Runtime(module)
    irt.update()
    prt.update()
    taps = {"i": _SymbolTap(irt), "p": _SymbolTap(prt)}
    xs = _hem_frames()
    with _ArClock() as clock:
        _reset_counts()
        i_row, comp_i, dec_i = _zoo_i_frame(irt, taps["i"], xs[0], GEN1_I)
        i_ar = clock.take()
        i_row["ar_host_ms"] = {k: sum(v) for k, v in i_ar.items()}
        ref_enc, ref_dec = comp_i["x_hat"], dec_i["x_hat"]
        rows = []
        for i in range(1, 1 + P_FRAMES):
            reps = 4 if i == P_FRAMES else 1
            runs = [_gen1_p_frame(prt, taps["p"], xs[i], ref_enc, ref_dec,
                                  clock, f"dcvc_gen1 P{i}")
                    for _ in range(reps)]
            row, comp, dec = runs[-1]
            if reps > 1:
                row = dict(row, encode_ms_median3=_median3(
                    [r[0] for r in runs], "encode_ms"),
                    decode_ms_median3=_median3([r[0] for r in runs],
                                               "decode_ms"))
            rows.append(row)
            ref_enc, ref_dec = comp["recon_image"], dec["recon_image"]
        counts = _no_kernel_launched("gen1 runtimes")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        m = prt.module
        seen = {}
        mc = m.motion_compensation

        def spy(ref, mv):
            seen.setdefault("mc", (ref, mv))
            return mc(ref, mv)

        m.motion_compensation = spy
        x = xs[-1].roll(4, dims=3)
        try:
            block = _block_mc(
                m, taps["p"], lambda: prt.compress(ref_enc, x),
                lambda c: prt.decompress(ref_dec, c["mv_y_string"],
                                         c["mv_z_string"], c["y_string"],
                                         c["z_string"], x.shape[2],
                                         x.shape[3]),
                lambda c, d: (c["recon_image"] - d["recon_image"]).abs()
                .max().item(), {"compress": 1, "decompress": 1},
                "gen1 block mc")
        finally:
            del m.motion_compensation
        clock.take()
    ref, mv = seen["mc"]
    with torch.no_grad():
        feat = m.feature_extract(ref)
    block["k1_vs_plain"] = _k1_checks((("context_64ch", feat, mv),), "gen1")
    block["k1_64ch_full_res"] = _k1_timing(feat, mv)
    row = {"models": {GEN1_I: "N=M=192", "dcvc_gen1": "128/64/96",
                      "latent_gain": GEN1_LATENT_GAIN},
           "i_frame": i_row, "p_frames": rows,
           "p_bpp": rows[-1]["bytes"] * 8 / (HEIGHT * WIDTH),
           "symbols_equal": True, "peak_mem_gib": peak, "launches": counts}
    print(f"gen1 {json.dumps(row)}", flush=True)
    print(f"gen1_block_mc {json.dumps(block)}", flush=True)
    results["gen1"] = row
    results["gen1_block"] = block


def zoo_tcm_cli_phase(results: dict):
    """The video CLI on the 1080p PNG sequence of hem_cli_phase: a zoo
    I-frame model (mbt2018-mean) + dmc_tcm writing streams and the decoded
    PNGs, which read back must equal a fresh runtime pair's re-decode of
    the .bin files."""
    import tempfile

    import numpy as np

    from dcvc_tpu_torch.tools import test_video
    from dcvc_tpu_torch.utils import png

    seq = "synthetic_1080p_png"
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = _png_sequence_config(tmp, seq)
        _reset_counts()
        t = time.time()
        res = test_video.main([
            "--test_config", cfg_path, "--force_frame_num", str(CLI_FRAMES),
            "--rate_num", "1", "--q_indexes", "32", "--write_stream", "1",
            "--i_frame_model", TCM_I, "--p_frame_model", "dmc_tcm",
            "--stream_path", os.path.join(tmp, "tcm"), "--output_path",
            os.path.join(tmp, "tcm.json"), "--decoded_frame_path",
            os.path.join(tmp, "decoded"), "--verbose", "2"])
        row = _cli_row(res[seq]["rate_0"], time.time() - t,
                       _no_kernel_launched("cli zoo + tcm"), "zoo + tcm")
        again = _redecode_pngs(os.path.join(tmp, "tcm"), seq, TCM_I,
                               "dmc_tcm")
        for i, recon in enumerate(again):
            written = png.read_png(os.path.join(tmp, "decoded", seq,
                                                f"im{i + 1:05d}.png"))
            if not np.array_equal(written, recon):
                raise AssertionError(f"cli zoo + tcm: decoded PNG {i} "
                                     f"differs from the re-decoded recon")
    print(f"cli zoo_tcm: {json.dumps(row)}", flush=True)
    print(f"cli zoo_tcm checks: {CLI_FRAMES} {TCM_I} + dmc_tcm decoded PNGs "
          f"equal a fresh runtime pair's re-decode", flush=True)
    results["zoo_tcm_cli"] = row


TRAIN_CROP, TRAIN_BATCH, TRAIN_STEPS = 256, 4, 3
TRAIN_GRAD_TOL, TRAIN_LOSS_TOL, REMAT_TOL = 1e-3, 1e-4, 1e-5


def _gib(n: int) -> float:
    return n / 2 ** 30


def _card() -> str:
    """The card's name and power limit, printed beside every training
    figure (nvidia-smi asked once)."""
    from dcvc_tpu_torch.device import card_line

    if not hasattr(_card, "line"):
        _card.line = card_line()
    return _card.line


def _grads(module) -> dict:
    """Every parameter's gradient (zeros where none reached it), float64
    on the host."""
    import torch

    return {n: (torch.zeros(p.shape, dtype=torch.float64) if p.grad is None
                else p.grad.detach().double().cpu())
            for n, p in module.named_parameters()}


def _worst_rel_l2(a: dict, b: dict):
    """(worst relative L2 gap of b against a, its parameter name)."""
    worst = (0.0, None)
    for n, ga in a.items():
        den = ga.norm().item()
        num = (b[n] - ga).norm().item()
        rel = num / den if den > 0 else (0.0 if num == 0 else math.inf)
        worst = max(worst, (rel, n))
    return worst


def _train_clip(crop: int, frames: int, batch: int, seed: int):
    """One seeded MotionClips batch [B, T, H, W, 3] (numpy)."""
    from dcvc_tpu_torch.training.data import MotionClips

    data = MotionClips(crop=crop, frames=frames, pool=batch, seed=seed)
    return next(data.batches(batch, 1))


def _train_step_grads(device: str, dtype, clip, lambdas):
    """(loss, every parameter's gradient, kernel launches) of one cascade-1
    STE step of full-width DMC (seed 71) in ``dtype`` on ``device``; no
    update."""
    import tempfile

    import torch

    from dcvc_tpu_torch.training.trainer import (PFrameTrainer, Stage,
                                                 build_train_module)

    with tempfile.TemporaryDirectory() as tmp:
        tr = PFrameTrainer(build_train_module("dmc_dc", seed=71,
                                              device=device).to(dtype),
                           workdir=tmp, device=device)
        _reset_counts()
        loss = tr.loss(tr._clip(clip).to(dtype), lambdas.to(device, dtype),
                       Stage("s", 1, 1))
        loss.backward()
        return float(loss.detach()), _grads(tr.module), _counts()


def train_card_cpu_phase(results: dict):
    """One cascade-1 STE step of full-width DMC at 128x128, B = 2, on the
    card and on the CPU from the same seeded weights and clip: the f32
    loss, and every parameter's gradient compared in float64 (in float32
    the bit estimators' clamps make this gradient ill-conditioned; the f32
    gaps are printed beside the CPU's own f32-vs-f64 gap)."""
    import torch

    clip = _train_clip(128, 2, 2, seed=70)
    lambdas = torch.tensor([85.0, 840.0])
    run = {(d, dt): _train_step_grads(d, dt, clip, lambdas)
           for d in ("cpu", "cuda") for dt in (torch.float32, torch.float64)}

    def loss_gap(a, b):
        return abs(run[a][0] - run[b][0]) / abs(run[b][0])

    c32, c64 = ("cpu", torch.float32), ("cpu", torch.float64)
    g32, g64 = ("cuda", torch.float32), ("cuda", torch.float64)
    worst64, name64 = _worst_rel_l2(run[c64][1], run[g64][1])
    worst32, name32 = _worst_rel_l2(run[c32][1], run[g32][1])
    floor32, floor_name = _worst_rel_l2(run[c64][1], run[c32][1])
    launches = {k: sum(run[(d, dt)][2][k] for d, dt in run)
                for k in run[c32][2]}
    row = {"loss_cpu": run[c32][0], "loss_card": run[g32][0],
           "loss_rel_gap": loss_gap(g32, c32),
           "loss_rel_gap_f64": loss_gap(g64, c64), "loss_tol": TRAIN_LOSS_TOL,
           "worst_grad_rel_l2_f64": worst64, "worst_grad_tensor_f64": name64,
           "grad_tol": TRAIN_GRAD_TOL,
           "worst_grad_rel_l2_f32": worst32, "worst_grad_tensor_f32": name32,
           "cpu_f32_vs_f64_worst": floor32, "cpu_f32_vs_f64_tensor": floor_name,
           "tensors": len(run[c32][1]), "launches": launches,
           "card": _card()}
    print(f"train card_vs_cpu {json.dumps(row)}", flush=True)
    if not (row["loss_rel_gap"] <= TRAIN_LOSS_TOL
            and row["loss_rel_gap_f64"] <= TRAIN_LOSS_TOL):
        raise AssertionError(f"training loss card vs CPU: {row}")
    if not worst64 <= TRAIN_GRAD_TOL:
        raise AssertionError(f"training gradient card vs CPU: {name64} "
                             f"{worst64}")
    _no_kernel(launches, "train card_vs_cpu")
    results["train_card_cpu"] = row


def _no_kernel(counts: dict, what: str):
    if any(counts.values()):
        raise AssertionError(f"{what}: kernels launched {counts}")


def train_fit_phase(results: dict):
    """PFrameTrainer.fit on full-width DMC over MotionClips (256 px, 5
    frames, B = 4): the three DEFAULT_SCHEDULE stages cut to 3 steps each.
    Step ms per stage (median of the last two), peak memory, loss."""
    import tempfile
    from dataclasses import replace

    import torch

    from dcvc_tpu_torch.training.data import MotionClips
    from dcvc_tpu_torch.training.trainer import (DEFAULT_SCHEDULE,
                                                 PFrameTrainer,
                                                 build_train_module)

    tmp = tempfile.mkdtemp(prefix="train_fit_")
    module = build_train_module("dmc_dc", seed=72)
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    schedule = [replace(st, epochs=1) for st in DEFAULT_SCHEDULE]
    tr = PFrameTrainer(module, schedule=schedule, workdir=tmp)
    data = MotionClips(crop=TRAIN_CROP, frames=5, pool=16, seed=73)
    stages: dict = {}
    step = tr.train_step

    def timed_step(opt, stage, clip, lambdas):
        if stage.name not in stages:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stages[stage.name] = {"ms": [], "loss": []}
        t = time.time()
        loss = step(opt, stage, clip, lambdas)
        stages[stage.name]["ms"].append(_sync_ms(t))
        stages[stage.name]["loss"].append(loss)
        stages[stage.name]["peak_gib"] = _gib(
            torch.cuda.max_memory_allocated())
        return loss

    tr.train_step = timed_step
    _reset_counts()
    t0 = time.time()
    tr.fit(data, batch_size=TRAIN_BATCH, steps_per_epoch=TRAIN_STEPS)
    wall = time.time() - t0
    counts = _counts()
    rows = {}
    for st in schedule:
        s = stages[st.name]
        rows[st.name] = {
            "cascade": st.cascade_frames, "detach": st.detach, "lr": st.lr,
            "step_ms": sum(s["ms"][-2:]) / 2,
            "step_ms_all": s["ms"], "peak_gib": s["peak_gib"],
            "loss": s["loss"], "card": _card()}
        print(f"train fit {st.name} {json.dumps(rows[st.name])}", flush=True)
    moved = sum(int(not torch.equal(before[n], p.detach()))
                for n, p in module.named_parameters())
    losses = [v for s in stages.values() for v in s["loss"]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"training losses not finite: {losses}")
    if moved == 0:
        raise AssertionError("training moved no parameter")
    _no_kernel(counts, "train fit")
    # one more cascade-1 step under torch.profiler: where a step's device
    # time goes and how much of its wall time the card is busy
    from torch.profiler import ProfilerActivity, profile

    from dcvc_tpu_torch.training.step import q_levels_for_batch

    clip = tr._clip(next(data.batches(TRAIN_BATCH, 1)))
    _, lambdas = q_levels_for_batch(TRAIN_BATCH, 0, "cuda")
    opt = tr.build_optimizer(schedule[0])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        step(opt, schedule[0], clip, lambdas)
        wall_ms = _sync_ms(t)
    rows_p = _device_rows(prof.key_averages())
    device_ms = sum(r[0] for r in rows_p)

    def share(keys):
        ms = sum(r[0] for r in rows_p if any(k in r[2].lower() for k in keys))
        return ms / device_ms if device_ms else None

    conv_keys = ("conv", "xmma", "cudnn", "gemm", "cutlass", "fft",
                 "winograd", "wgrad", "dgrad")
    prof_row = {
        "what": "one cascade-1 training step (forward, backward, AdamW), "
                "profiler on", "wall_ms": wall_ms,
        "device_ms": device_ms or None,
        "device_busy_share": device_ms / wall_ms if device_ms else None,
        "kernels": sum(r[1] for r in rows_p),
        "conv_gemm_share": share(conv_keys),
        "grid_sample_share": share(("grid_sampler",)),
        "top": [{"ms": ms, "count": n, "name": k[:80]}
                for ms, n, k in rows_p[:8]], "card": _card()}
    print("train profile " + json.dumps(prof_row), flush=True)
    ckpt = os.path.join(tmp, f"{schedule[-1].name}_ep0.pth")
    if not (os.path.isfile(ckpt)
            and os.path.isfile(os.path.join(tmp, "history.json"))):
        raise AssertionError(f"fit wrote no checkpoint / history in {tmp}")
    results["train_fit"] = {"stages": rows, "wall_s": wall,
                            "tensors_moved": moved, "launches": counts,
                            "profile": prof_row,
                            "checkpoint": ckpt, "workdir": tmp}
    print(f"train fit: {moved} of {len(before)} tensors moved, fit "
          f"{wall:.1f} s, launches {counts}", flush=True)


def train_remat_phase(results: dict):
    """One cascade-2 undetached step's loss and gradients with and without
    remat (noise + MS-SSIM, 256 px, B = 4), same weights, clip and noise
    seed; their peak memory."""
    import tempfile

    import torch

    from dcvc_tpu_torch.training.trainer import (PFrameTrainer, Stage,
                                                 build_train_module)

    clip = _train_clip(TRAIN_CROP, 3, TRAIN_BATCH, seed=74)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tr = PFrameTrainer(build_train_module("dmc_dc", seed=75), workdir=tmp,
                           quant_mode="noise", distortion="ssim")
        x = tr._clip(clip)
        lambdas = torch.tensor([85.0, 170.0, 380.0, 840.0], device="cuda")
        _reset_counts()
        # each twice, alternating, and the second of each kept: the first
        # call at these shapes picks the convolution algorithms
        for remat in (False, True, False, True):
            tr.module.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.time()
            loss = tr.loss(x, lambdas, Stage("s", 1, 2, detach=False,
                                             remat=remat), key=76)
            loss.backward()
            ms = _sync_ms(t)
            out[remat] = (float(loss.detach()), _grads(tr.module), ms,
                          _gib(torch.cuda.max_memory_allocated()))
        counts = _counts()
    loss_gap = abs(out[True][0] - out[False][0]) / abs(out[False][0])
    worst, name = _worst_rel_l2(out[False][1], out[True][1])
    row = {"loss": out[False][0], "loss_remat": out[True][0],
           "loss_rel_gap": loss_gap, "worst_grad_rel_l2": worst,
           "worst_grad_tensor": name, "tol": REMAT_TOL,
           "ms": out[False][2], "ms_remat": out[True][2],
           "peak_gib": out[False][3], "peak_gib_remat": out[True][3],
           "launches": counts, "card": _card()}
    print(f"train remat {json.dumps(row)}", flush=True)
    if not (loss_gap <= REMAT_TOL and worst <= REMAT_TOL):
        raise AssertionError(f"remat changes the step: loss {loss_gap}, "
                             f"{name} {worst}")
    _no_kernel(counts, "train remat")
    results["train_remat"] = row


def train_intra_phase(results: dict):
    """Two make_intra_train_step steps of full-width IntraNoAR (N = 256) at
    256 px, B = 4."""
    import torch

    from dcvc_tpu_torch.models.intra_dc import build_intra_dc
    from dcvc_tpu_torch.training.step import (make_intra_train_step,
                                              make_optimizer,
                                              q_levels_for_batch)

    module = build_intra_dc(seed=77)
    opt = make_optimizer(module.parameters())
    step = make_intra_train_step(module, opt)
    x = torch.rand(TRAIN_BATCH, 3, TRAIN_CROP, TRAIN_CROP,
                   generator=torch.Generator(device="cuda").manual_seed(78),
                   device="cuda")
    q = torch.ones(TRAIN_BATCH, 1, 1, 1, device="cuda")
    _, lambdas = q_levels_for_batch(TRAIN_BATCH, device="cuda")
    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(2):
        t = time.time()
        loss, aux = step(x, q, lambdas)
        losses.append(float(loss))
        ms.append(_sync_ms(t))
    row = {"step_ms": ms, "loss": losses,
           "peak_gib": _gib(torch.cuda.max_memory_allocated()),
           "launches": _counts(), "card": _card()}
    print(f"train intra {json.dumps(row)}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"intra losses not finite: {losses}")
    _no_kernel(row["launches"], "train intra")
    results["train_intra"] = row


def train_ckpt_phase(results: dict):
    """The fit phase's last checkpoint loaded into DmcRuntime through
    utils/checkpoint: intra_dc I + 2 P of the 256 px motion clip, through
    the containers; symbols equal and DPB gap 0.0."""
    import torch

    from dcvc_tpu_torch.models.registry import build
    from dcvc_tpu_torch.utils import stream
    from dcvc_tpu_torch.utils.checkpoint import load_state_dict

    sd = load_state_dict(results["train_fit"]["checkpoint"], "dmc_dc")
    _, irt = build("intra_dc", seed=79)
    _, prt = build("dmc_dc", state_dict=sd)
    irt.update()
    prt.update()
    taps = {"i": _SymbolTap(irt), "p": _SymbolTap(prt)}
    clip = _train_clip(TRAIN_CROP, 3, 1, seed=80)[0]
    # fresh NCHW tensors (a permuted host array keeps channels-last strides)
    frames = [torch.empty((1, 3, TRAIN_CROP, TRAIN_CROP), device="cuda")
              .copy_(torch.from_numpy(f).permute(2, 0, 1)[None]) for f in clip]
    h = w = TRAIN_CROP
    q_index = 32
    rows = []
    _reset_counts()
    for i, x in enumerate(frames):
        if i == 0:
            comp = irt.compress(x, False, q_index)
            data = stream.pack_i(h, w, False, q_index, comp["bit_stream"])
            _, _, qc, qi, s = stream.unpack_i(bytes(data))
            dec = irt.decompress(s, h, w, qc, qi)
            gap = (comp["x_hat"] - dec["x_hat"]).abs().max().item()
            dpb_enc = {"ref_frame": comp["x_hat"], "ref_feature": None,
                       "ref_mv_feature": None, "ref_y": None,
                       "ref_mv_y": None}
            dpb_dec = dict(dpb_enc, ref_frame=dec["x_hat"])
            ok = taps["i"].equal()
        else:
            comp = prt.compress(x, dpb_enc, False, q_index, i)
            data = stream.pack_p(comp["bit_stream"], False, q_index, i)
            qc, qi, fi, s = stream.unpack_p(bytes(data))
            dec = prt.decompress(dpb_dec, s, h, w, qc, qi, fi)
            gap = _dpb_gap(comp["dpb"], dec["dpb"])
            dpb_enc, dpb_dec = comp["dpb"], dec["dpb"]
            ok = taps["p"].equal()
        rows.append({"frame": i, "bytes": len(data), "symbols_equal": ok,
                     "gap": gap})
    counts = _counts()
    print(f"train checkpoint -> coder {json.dumps(rows)}; launches "
          f"{counts}", flush=True)
    for r in rows:
        if not (r["symbols_equal"] and r["gap"] == 0.0):
            raise AssertionError(f"trained checkpoint frame {r['frame']}: "
                                 f"symbols equal {r['symbols_equal']}, gap "
                                 f"{r['gap']}")
    if counts["band_copy"] or counts["block_warp"] < 2:
        raise AssertionError(f"trained checkpoint coding launches {counts}")
    results["train_ckpt"] = {"frames": rows, "launches": counts}


def train_cli_phase(results: dict):
    """python -m dcvc_tpu_torch.tools.train --model dmc_hem
    --steps_per_epoch 2 --max_epochs 1 --batch_size 2, in process, in a
    temporary workdir: a checkpoint and history.json."""
    import tempfile

    from dcvc_tpu_torch.tools import train

    with tempfile.TemporaryDirectory() as tmp:
        _reset_counts()
        t = time.time()
        tr = train.main(["--model", "dmc_hem", "--steps_per_epoch", "2",
                         "--max_epochs", "1", "--batch_size", "2",
                         "--workdir", tmp])
        wall = time.time() - t
        counts = _counts()
        files = sorted(os.listdir(tmp))
        with open(os.path.join(tmp, "history.json")) as f:
            history = json.load(f)
    row = {"wall_s": wall, "files": files, "history": history,
           "launches": counts, "card": _card()}
    print(f"train cli {json.dumps(row)}", flush=True)
    if "train_2frames_ep0.pth" not in files or len(history) != 1 \
            or not math.isfinite(history[0]["loss"]) or tr.updates != 2:
        raise AssertionError(f"train CLI: {row}")
    _no_kernel(counts, "train cli")
    results["train_cli"] = row


# -- serving, the serve CLI, the pool and the tools (phases 28-31) ----------

SERVE_ROUNDS = 3        # timed request rounds after the server's warm-up
POOL_SEQS = ("pool_a", "pool_b")
POOL_FRAMES = 2


def _socket_path(tmp: str) -> str:
    """A Unix socket path in ``tmp``; relative to the working directory
    when the absolute one passes sockaddr_un's 108-byte limit."""
    path = os.path.join(tmp, "s.sock")
    if len(path.encode()) >= 100:
        path = os.path.relpath(path)
    if len(path.encode()) >= 100:
        raise AssertionError(f"socket path too long for AF_UNIX: {path}")
    return path


_COUNTING_SITECUSTOMIZE = '''\
"""Kernel launch counts of a process: at exit, a process that imported
the port's kernels writes their K1 and K2 counters (zero at import, as no
one resets them) to launches_<pid>.json beside this file. Then the
installation's own sitecustomize, which this file shadows, runs as it
would have."""
import atexit
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))


def _dump():
    bw = sys.modules.get("dcvc_tpu_torch.ops.block_warp")
    bc = sys.modules.get("dcvc_tpu_torch.ops.band_copy")
    if bw is None and bc is None:     # e.g. multiprocessing's tracker
        return
    counts = {"block_warp": bw.block_warp_nchw.launches if bw else 0,
              "band_copy": bc.band_copy.launches if bc else 0}
    with open(os.path.join(_HERE, f"launches_{os.getpid()}.json"), "w") as f:
        json.dump(counts, f)


atexit.register(_dump)
_me = sys.modules[__name__]
_path = sys.path[:]
sys.path[:] = [p for p in sys.path if os.path.abspath(p or os.curdir) != _HERE]
del sys.modules[__name__]
try:
    import sitecustomize  # noqa: F401
except ImportError:
    pass
finally:
    sys.path[:] = _path
    sys.modules[__name__] = _me
'''


def _counting_pythonpath(tmp: str) -> str:
    """A PYTHONPATH for processes whose kernel launches are counted: the
    repo, then a directory whose sitecustomize writes each process's K1 and
    K2 counts at its exit (read back by _process_counts), then the
    inherited PYTHONPATH. Spawned children inherit it."""
    d = os.path.join(tmp, "counted")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "sitecustomize.py"), "w") as f:
        f.write(_COUNTING_SITECUSTOMIZE)
    root = os.path.dirname(os.path.abspath(__file__))
    return os.pathsep.join(p for p in (root, d, os.environ.get("PYTHONPATH"))
                           if p)


def _process_counts(tmp: str) -> dict:
    """The launch counts that the processes started with
    _counting_pythonpath(tmp) wrote at exit: per process that imported the
    port's kernels, and summed."""
    import glob

    procs = []
    for path in sorted(glob.glob(os.path.join(tmp, "counted",
                                              "launches_*.json"))):
        with open(path) as f:
            procs.append(json.load(f))
    return {"processes": procs,
            "block_warp": sum(c["block_warp"] for c in procs),
            "band_copy": sum(c["band_copy"] for c in procs)}


def _hwc(x):
    """An NCHW frame as an HWC f32 host array: an f32 payload."""
    return x[0].permute(1, 2, 0).cpu().numpy()


def _u8(x):
    """A 1080p NCHW frame in [0, 1] as an HWC u8 array: the server's own
    conversion of its recons."""
    import numpy as np

    from dcvc_tpu_torch.serving.server import CodecServer

    return np.frombuffer(CodecServer._host_u8(x, HEIGHT, WIDTH),
                         np.uint8).reshape(HEIGHT, WIDTH, 3)


def _device_frame(x_hwc):
    """An HWC host frame as the DC server takes it: edge-padded to 16 on
    the host, then a fresh NCHW tensor on the card."""
    import torch

    from dcvc_tpu_torch.serving.server import _pad_hwc

    t = torch.from_numpy(_pad_hwc(x_hwc, 16)).permute(2, 0, 1)[None]
    return torch.empty(t.shape, device="cuda").copy_(t)


def _host_ms(fn, n: int = 3) -> float:
    """Median host-clock ms of ``n`` calls of ``fn`` after a warm-up, each
    ended by a synchronize."""
    import torch

    fn()
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.time()
        fn()
        torch.cuda.synchronize()
        ts.append((time.time() - t) * 1e3)
    return statistics.median(ts)


def serving_phase(results: dict):
    """The warm server in process: a CodecServer on the card serving from a
    thread of this process (so K1's counter sees its launches), driven by
    the port's CodecClient over a Unix socket; weights of the runtimes
    phase (7), loaded from .pth files."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from dcvc_tpu_torch.ops import block_warp as bw
    from dcvc_tpu_torch.serving import CodecClient, CodecServer, ServerError
    from dcvc_tpu_torch.utils import stream

    main = results["main_path"]
    q = main["q_index"]
    content = _content(1 + P_FRAMES)
    frames = [_hwc(x) for x in content]
    frames_u8 = [_u8(x) for x in content]
    image_u8 = _u8(_image(HEIGHT, WIDTH, 61))
    row = {"card": _card()}
    walls, launches, mem = {}, {}, []

    def call(what, fn):
        k0 = bw.block_warp_nchw.launches
        t = time.time()
        out = fn()
        walls.setdefault(what, []).append((time.time() - t) * 1e3)
        launches.setdefault(what, set()).add(bw.block_warp_nchw.launches - k0)
        return out

    def allocated():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    with tempfile.TemporaryDirectory() as tmp:
        for name, sd in main["weights"].items():
            torch.save(sd, os.path.join(tmp, f"{name}.pth"))
        t = time.time()
        server = CodecServer("intra_dc", "dmc_dc",
                             model_path_i=os.path.join(tmp, "intra_dc.pth"),
                             model_path_p=os.path.join(tmp, "dmc_dc.pth"))
        row["build_s"] = time.time() - t
        _reset_counts()
        t = time.time()
        server.warmup(HEIGHT, WIDTH)
        row["warmup_s"] = time.time() - t
        row["warmup_launches"] = _counts()
        sock = _socket_path(tmp)
        thread = threading.Thread(target=server.serve, args=(sock,),
                                  daemon=True)
        thread.start()
        _reset_counts()
        with CodecClient(sock, connect_timeout=60) as c:
            call("ping", c.ping)
            for _ in range(SERVE_ROUNDS):
                cont, recon, _ = call("encode_image", lambda: c.encode_image(
                    image_u8, q, False, True))
                if not np.array_equal(call("decode_image", lambda: (
                        c.decode_image(cont))), recon):
                    raise AssertionError("decode_image != encode_image's "
                                         "recon")
                m0 = allocated()
                sid = c.open_video()
                conts, recons = [], []
                for i, f in enumerate(frames_u8):
                    kind = "pi"[i == 0]
                    s, r, _ = call(f"encode_frame_{kind}", lambda: (
                        c.encode_frame(sid, f, kind, i, q, False, True)))
                    conts.append(s)
                    recons.append(r)
                m1 = allocated()
                did = c.open_video()
                for i, s in enumerate(conts):
                    kind = "pi"[i == 0]
                    r = call(f"decode_frame_{kind}", lambda: c.decode_frame(
                        did, s, kind))
                    if not np.array_equal(r, recons[i]):
                        raise AssertionError(f"decode_frame {i}: recon "
                                             f"differs from the encoder's")
                m2 = allocated()
                c.close_video(sid)
                c.close_video(did)
                mem.append((m0, m1, m2, allocated()))
            # f32 payloads of the runtimes phase's frames: its containers
            sid = c.open_video()
            f32 = [call(f"encode_frame_{'pi'[i == 0]}_f32", lambda: (
                c.encode_frame(sid, f, "pi"[i == 0], i, q, False)))[0]
                for i, f in enumerate(frames)]
            c.close_video(sid)
            try:
                c._call({"op": "no_such_op"})
                raise AssertionError("an unknown op was answered ok")
            except ServerError as e:
                row["unknown_op_reply"] = str(e)
            call("ping", c.ping)
            # the socket alone: a ping carrying a 1080p frame's u8 / f32
            # bytes (the server ignores them)
            row["socket_upload_ms"] = {
                what: _host_ms(lambda: c._call({"op": "ping"}, [payload]))
                for what, payload in (("u8", frames_u8[1].tobytes()),
                                      ("f32", frames[1].tobytes()))}
            c.shutdown()
        thread.join(timeout=60)
        counts = _counts()
        if thread.is_alive():
            raise AssertionError("the serve loop did not stop on shutdown")

    want = [stream.pack_i(HEIGHT, WIDTH, False, q, main["streams"][0]),
            *main["streams"][1:]]
    row["f32_containers_equal_runtimes_phase"] = f32 == want
    row["container_bytes"] = [len(b) for b in f32]
    row["u8_container_bytes"] = [len(b) for b in conts]
    row["k1_launches_per_request"] = {k: sorted(v)
                                      for k, v in launches.items()}
    row["client_ms"] = {k: statistics.median(v) for k, v in walls.items()}
    row["dpb_mb_per_session"] = statistics.median(
        (m[1] - m[0]) / 1e6 for m in mem)
    row["dpb_mb_two_sessions"] = statistics.median(
        (m[2] - m[0]) / 1e6 for m in mem)
    row["allocated_after_close_vs_before_open"] = max(
        abs(m[3] - m[0]) / m[0] for m in mem)

    # the server's conversions alone: payload -> device frame, recon -> u8
    payload = frames_u8[1].tobytes()
    x_host = server._host_frame(payload, HEIGHT, WIDTH, "u8")
    x_dev = server._device_in(x_host)
    row["conversion_ms"] = {
        "host_frame_u8": _host_ms(lambda: server._host_frame(
            payload, HEIGHT, WIDTH, "u8")),
        "device_in": _host_ms(lambda: server._device_in(x_host)),
        "host_u8": _host_ms(lambda: server._host_u8(x_dev, HEIGHT, WIDTH))}

    # the same calls on the server's runtimes in process, on device tensors
    # converted as the server converts them: the socket + conversion
    # overhead is the client's wall time less these
    irt, prt = server.i_rt, server.p_rt
    rt_ms = {}

    def timed(what, fn):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        rt_ms.setdefault(what, []).append((time.time() - t) * 1e3)
        return out

    def code_i(x):
        comp = irt.compress(x, False, q)
        return comp, irt.decompress(comp["bit_stream"], HEIGHT, WIDTH, False, q)

    def code_p(x, dpb, i):
        comp = prt.compress(x, dpb, False, q, i)
        return comp, prt.decompress(dpb, comp["bit_stream"], HEIGHT, WIDTH,
                                    False, q, i % 4)

    dev = [_device_frame(f.astype(np.float32) / 255.0)
           for f in [image_u8, *frames_u8]]
    for _ in range(1 + SERVE_ROUNDS):             # a warm-up round first
        comp, _ = timed("encode_image", lambda: code_i(dev[0]))
        timed("decode_image", lambda: irt.decompress(
            comp["bit_stream"], HEIGHT, WIDTH, False, q))
        comp, dec = timed("encode_frame_i", lambda: code_i(dev[1]))
        bits = [comp["bit_stream"]]
        dpb = _i_dpb(dec["x_hat"])
        for i in range(1, 1 + P_FRAMES):
            comp, dec = timed("encode_frame_p", lambda: code_p(dev[1 + i],
                                                               dpb, i))
            bits.append(comp["bit_stream"])
            dpb = dec["dpb"]
        dec = timed("decode_frame_i", lambda: irt.decompress(
            bits[0], HEIGHT, WIDTH, False, q))
        dpb = _i_dpb(dec["x_hat"])
        for i in range(1, 1 + P_FRAMES):
            dpb = timed("decode_frame_p", lambda: prt.decompress(
                dpb, bits[i], HEIGHT, WIDTH, False, q, i % 4))["dpb"]
    per_round = {"encode_frame_p": P_FRAMES, "decode_frame_p": P_FRAMES}
    row["runtime_ms"] = {k: statistics.median(v[per_round.get(k, 1):])
                         for k, v in rt_ms.items()}
    row["overhead_ms"] = {k: row["client_ms"][k] - row["runtime_ms"][k]
                          for k in row["runtime_ms"]}
    row["launches"] = counts
    del server, irt, prt, dev, dpb, dec, comp, x_dev
    print(f"serving {json.dumps(row)}", flush=True)
    if not row["f32_containers_equal_runtimes_phase"]:
        raise AssertionError(f"served containers differ from the runtimes "
                             f"phase's: {[len(b) for b in want]} bytes "
                             f"there, {row['container_bytes']} here")
    expected = {"ping": [0], "encode_image": [0], "decode_image": [0],
                "encode_frame_i": [0], "encode_frame_p": [2],
                "decode_frame_i": [0], "decode_frame_p": [1],
                "encode_frame_i_f32": [0], "encode_frame_p_f32": [2]}
    if row["k1_launches_per_request"] != expected:
        raise AssertionError(f"K1 launches per request "
                             f"{row['k1_launches_per_request']}, expected "
                             f"{expected}")
    if counts["band_copy"]:
        raise AssertionError("K2 launched on the serving path")
    if not row["allocated_after_close_vs_before_open"] <= 0.01:
        raise AssertionError(f"close_video kept device memory: "
                             f"{row['allocated_after_close_vs_before_open']}")
    results["serving"] = row


def serve_cli_phase(results: dict):
    """``python -m dcvc_tpu_torch.tools.serve`` in a process of its own on
    the card (seed-0 weights, warmed at 1080p): an image and an I + 1 P
    session coded there, then decoded here by this process's own runtimes
    (the first stream written by one process and read by another)."""
    import subprocess
    import tempfile

    import numpy as np
    import torch

    from dcvc_tpu_torch.models.registry import build
    from dcvc_tpu_torch.ops.warp import default_coding_warp_modes
    from dcvc_tpu_torch.serving import CodecClient
    from dcvc_tpu_torch.utils import stream

    q = results["main_path"]["q_index"]
    frames_u8 = [_u8(x) for x in _content(2)]
    image_u8 = _u8(_image(HEIGHT, WIDTH, 62))
    row = {"card": _card()}
    torch.cuda.empty_cache()      # the card's memory for the other process
    with tempfile.TemporaryDirectory() as tmp:
        # the server process counts its own launches from its start (its
        # warm-up included) to its exit
        env = dict(os.environ, PYTHONPATH=_counting_pythonpath(tmp))
        sock = _socket_path(tmp)
        log_path = os.path.join(tmp, "serve.log")
        t = time.time()
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "dcvc_tpu_torch.tools.serve",
                 "--socket", sock, "--i_frame_model", "intra_dc",
                 "--p_frame_model", "dmc_dc", "--warmup", str(HEIGHT),
                 str(WIDTH)], env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            with CodecClient(sock, connect_timeout=600) as c:
                row["start_to_serving_s"] = time.time() - t
                t = time.time()
                img, img_recon, _ = c.encode_image(image_u8, q, False, True)
                row["encode_image_ms"] = (time.time() - t) * 1e3
                sid = c.open_video()
                conts, recons = [], []
                for i, f in enumerate(frames_u8):
                    t = time.time()
                    s, r, _ = c.encode_frame(sid, f, "pi"[i == 0], i, q,
                                             False, True)
                    row[f"encode_frame_{'pi'[i == 0]}_ms"] = \
                        (time.time() - t) * 1e3
                    conts.append(s)
                    recons.append(r)
                c.close_video(sid)
                c.shutdown()
            row["exit_code"] = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(log_path) as f:
            log_text = f.read()
        server_counts = _process_counts(tmp)
    if row["exit_code"] != 0:
        raise AssertionError(f"serve CLI exited {row['exit_code']}:\n"
                             f"{log_text[-3000:]}")

    # this process's own runtimes (seed 0, as the server built them)
    od, mc, me = default_coding_warp_modes(torch.device("cuda"))
    _, irt = build("intra_dc")
    _, prt = build("dmc_dc", od_warp_mode=od, mc_warp_mode=mc,
                   me_warp_mode=me)
    irt.update()
    prt.update()
    taps = {"i": _SymbolTap(irt), "p": _SymbolTap(prt)}

    def dev(u8):
        return _device_frame(u8.astype(np.float32) / 255.0)

    checks = []
    _reset_counts()
    comp = irt.compress(dev(image_u8), False, q)
    h, w, qc, qi, s = stream.unpack_i(img)
    dec = irt.decompress(s, h, w, qc, qi)
    checks.append({"what": "image", "container_equal": img == stream.pack_i(
        HEIGHT, WIDTH, False, q, comp["bit_stream"]),
        "symbols_equal": taps["i"].equal(),
        "gap": (comp["x_hat"] - dec["x_hat"]).abs().max().item(),
        "recon_equal": np.array_equal(_u8(dec["x_hat"]), img_recon)})
    comp = irt.compress(dev(frames_u8[0]), False, q)
    h, w, qc, qi, s = stream.unpack_i(conts[0])
    dec = irt.decompress(s, h, w, qc, qi)
    dpb_enc = _i_dpb(comp["x_hat"])
    dpb_dec = _i_dpb(dec["x_hat"])
    checks.append({"what": "frame 0 (I)", "container_equal": conts[0] ==
                   stream.pack_i(HEIGHT, WIDTH, False, q, comp["bit_stream"]),
                   "symbols_equal": taps["i"].equal(),
                   "gap": _dpb_gap(dpb_enc, dpb_dec),
                   "recon_equal": np.array_equal(_u8(dpb_dec["ref_frame"]),
                                                 recons[0])})
    comp = prt.compress(dev(frames_u8[1]), dpb_enc, False, q, 1)
    qc, qi, fi, s = stream.unpack_p(conts[1])
    dec = prt.decompress(dpb_dec, s, HEIGHT, WIDTH, qc, qi, fi)
    checks.append({"what": "frame 1 (P)", "container_equal": conts[1] ==
                   stream.pack_p(comp["bit_stream"], False, q, 1),
                   "symbols_equal": taps["p"].equal(),
                   "gap": _dpb_gap(comp["dpb"], dec["dpb"]),
                   "recon_equal": np.array_equal(
                       _u8(dec["dpb"]["ref_frame"].clamp(0.0, 1.0)),
                       recons[1])})
    local = _counts()
    row["launches"] = {k: server_counts[k] for k in ("block_warp",
                                                     "band_copy")}
    row["server_processes_counted"] = len(server_counts["processes"])
    # what the same calls launch in process (phase 28): the warm-up's plus
    # 2 per P encode_frame
    serving = results["serving"]
    row["k1_launches_in_process"] = (
        serving["warmup_launches"]["block_warp"]
        + serving["k1_launches_per_request"]["encode_frame_p"][0])
    row["local_verify_launches"] = local
    row["checks"] = checks
    row["bytes"] = [len(img)] + [len(b) for b in conts]
    print(f"serve cli {json.dumps(row)}", flush=True)
    for ch in checks:
        if not (ch["container_equal"] and ch["symbols_equal"]
                and ch["gap"] == 0.0 and ch["recon_equal"]):
            raise AssertionError(f"cross-process decode: {ch}")
    if local["block_warp"] != 2 or local["band_copy"]:
        raise AssertionError(f"in-process re-code launched {local}")
    if (row["server_processes_counted"] != 1 or row["launches"] != {
            "block_warp": row["k1_launches_in_process"], "band_copy": 0}):
        raise AssertionError(f"the server process launched {server_counts}, "
                             f"expected K1 {row['k1_launches_in_process']} "
                             f"and no K2")
    results["serve_cli"] = row


_RANK_SCRIPT = """
import json, os, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
import torch.distributed as dist
from dcvc_tpu_torch.parallel.jobs import (WorkItem, maybe_init_distributed,
                                          run_sharded)

rank, world = maybe_init_distributed()
assert world == 2, world
ranks = [None, None]
dist.all_gather_object(ranks, rank)
assert sorted(ranks) == [0, 1], ranks
items = [WorkItem(n, r, {}) for n, r in json.loads(os.environ["ITEMS"])]
out = os.environ["OUT_DIR"]
run_sharded(items, lambda it: {"rank": rank}, out_dir=out)
dist.barrier()
merged = run_sharded(items, lambda it: {"rank": rank}, out_dir=out)
if rank == 0:
    with open(os.path.join(out, "merged.json"), "w") as f:
        json.dump(merged, f)
dist.destroy_process_group()
"""


def _gloo_run_sharded(tmp: str, items: list) -> dict:
    """run_sharded in two spawned processes joined by a gloo group."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(tmp, "shards")
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(rank), WORLD_SIZE="2", OUT_DIR=out,
                   ITEMS=json.dumps(items),
                   REPO_ROOT=os.path.dirname(os.path.abspath(__file__)))
        procs.append(subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"gloo rank exited {p.returncode}:\n"
                                 f"{o[-3000:]}")
    with open(os.path.join(out, "merged.json")) as f:
        return json.load(f)


def pool_phase(results: dict):
    """The video CLI with --worker_num 2 on the card (both workers on
    cuda:0, spawned), against the same items coded in this process; every
    .bin a worker wrote decoded here; then run_sharded across two gloo
    ranks."""
    import tempfile

    import numpy as np
    import torch

    from dcvc_tpu_torch.runner.video import load_dataset_config
    from dcvc_tpu_torch.tools import test_video

    q = results["main_path"]["q_index"]
    row = {"card": _card()}
    torch.cuda.empty_cache()      # the card's memory for the workers
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(POOL_SEQS):
            _write_yuv_sequence(os.path.join(tmp, name + ".yuv"), POOL_FRAMES,
                                mirror=bool(i))
        cfg = {"root_path": tmp, "test_classes": {"smoke": {
            "test": 1, "base_path": "", "src_type": "yuv420",
            "sequences": {name: {"width": WIDTH, "height": HEIGHT,
                                 "frames": POOL_FRAMES, "gop": 32}
                          for name in POOL_SEQS}}}}
        cfg_path = os.path.join(tmp, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)

        def args(tag, workers):
            return ["--test_config", cfg_path, "--force_frame_num",
                    str(POOL_FRAMES), "--rate_num", "1", "--q_indexes",
                    str(q), "--write_stream", "1", "--verbose", "2",
                    "--worker_num", str(workers), "--stream_path",
                    os.path.join(tmp, tag), "--output_path",
                    os.path.join(tmp, tag + ".json"),
                    "--decoded_frame_path", os.path.join(tmp, tag + "_dec")]

        # the spawned workers inherit this PYTHONPATH and count their own
        # launches from their start to their exit
        pythonpath = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = _counting_pythonpath(tmp)
        _reset_counts()
        t = time.time()
        try:
            pool = test_video.main(args("pool", 2))
        finally:
            if pythonpath is None:
                del os.environ["PYTHONPATH"]
            else:
                os.environ["PYTHONPATH"] = pythonpath
        row["pool_wall_s"] = time.time() - t
        row["smoke_process_launches_during_pool"] = _counts()
        worker_counts = _process_counts(tmp)

        # the same items in this process, on runtimes built as the CLI
        # builds them, with their coders tapped
        one_args = test_video.parse_args(args("one", 1))
        i_rt, p_rt, pad = test_video._build_runtimes(one_args,
                                                     torch.device("cuda"))
        taps = [_SymbolTap(i_rt), _SymbolTap(p_rt)]
        one, enc_syms = {}, {}
        _reset_counts()
        t = time.time()
        for seq in load_dataset_config(cfg):
            one[seq.name] = {"rate_0": test_video._eval_one(
                i_rt, p_rt, pad, seq, q, one_args)}
            enc_syms[seq.name] = np.concatenate(
                [a for tap in taps for a in tap.enc])
            for tap in taps:
                tap.enc, tap.dec = [], []
        row["in_process_wall_s"] = time.time() - t
        counts = _counts()
        del i_rt, p_rt, taps

        row["results_keys_equal"] = (
            set(pool) == set(one) == set(POOL_SEQS)
            and all(set(pool[s]) == {"rate_0"}
                    and set(pool[s]["rate_0"]) == _jax_summary_keys()
                    for s in POOL_SEQS))
        row["bpp"] = {s: [pool[s]["rate_0"]["frame_bpp"],
                          one[s]["rate_0"]["frame_bpp"]] for s in POOL_SEQS}
        row["bpp_equal"] = all(a == b for a, b in row["bpp"].values())
        bins = {}
        for tag in ("pool", "one"):
            bins[tag] = [open(os.path.join(tmp, tag, f"{s}_{i}.bin"),
                              "rb").read()
                         for s in POOL_SEQS for i in range(POOL_FRAMES)]
        row["bins_equal"] = bins["pool"] == bins["one"]
        row["bin_bytes"] = [len(b) for b in bins["pool"]]
        checks = {}
        for s in POOL_SEQS:
            dec = _redecode_yuv(os.path.join(tmp, "pool"),
                                os.path.join(tmp, "redecoded", s), s,
                                POOL_FRAMES)
            with open(os.path.join(tmp, "pool_dec", s + ".yuv"), "rb") as f:
                worker_yuv = f.read()
            with open(os.path.join(tmp, "redecoded", s + ".yuv"), "rb") as f:
                here_yuv = f.read()
            checks[s] = {
                "symbols_equal": np.array_equal(np.concatenate(dec),
                                                enc_syms[s]),
                "recon_yuv_equal": worker_yuv == here_yuv and len(here_yuv)
                == POOL_FRAMES * HEIGHT * WIDTH * 3 // 2}
        row["cross_process_decode"] = checks

        items = [[s, r] for s in POOL_SEQS for r in range(2)] + [["extra", 0]]
        t = time.time()
        merged = _gloo_run_sharded(tmp, items)
        row["gloo_wall_s"] = time.time() - t
    row["gloo_merged"] = merged
    row["launches"] = {k: worker_counts[k] for k in ("block_warp",
                                                     "band_copy")}
    row["launches_per_worker"] = worker_counts["processes"]
    row["in_process_launches"] = counts
    print(f"pool {json.dumps(row)}", flush=True)
    if not (row["results_keys_equal"] and row["bpp_equal"]
            and row["bins_equal"]):
        raise AssertionError("the pool's results or streams differ from "
                             "the single-process run's")
    for s, ch in checks.items():
        if not all(ch.values()):
            raise AssertionError(f"pool stream {s} decoded here: {ch}")
    want = {f"{s}/rate_{r}": i % 2 for i, (s, r) in enumerate(items)}
    if {k: v.get("rank") for k, v in merged.items()} != want:
        raise AssertionError(f"gloo run_sharded merged {merged}")
    if counts["block_warp"] != len(POOL_SEQS) * 2 or counts["band_copy"]:
        raise AssertionError(f"in-process pool items launched {counts}")
    if any(row["smoke_process_launches_during_pool"].values()):
        raise AssertionError("the pool launched kernels in this process")
    # a chunk goes to whichever worker is free: one worker may code both
    if not 1 <= len(worker_counts["processes"]) <= 2 \
            or row["launches"] != counts:
        raise AssertionError(f"the pool's workers launched {worker_counts}, "
                             f"the same items in process {counts}")
    results["pool"] = row


def tools_phase(results: dict):
    """model_complexity for intra_dc and dmc_dc at 1088 x 1920 on the card;
    data_to_png on the smoke's YUV sequence."""
    import tempfile

    import numpy as np

    from dcvc_tpu_torch.tools import data_to_png, model_complexity
    from dcvc_tpu_torch.utils import color
    from dcvc_tpu_torch.utils.png import read_png
    from dcvc_tpu_torch.utils.video_io import YUVReader

    row = {"card": _card(), "model_complexity": {}}
    h = -(-HEIGHT // 64) * 64                   # 1080 -> 1088
    _reset_counts()
    for name in ("intra_dc", "dmc_dc"):
        k0 = _counts()
        t = time.time()
        r = model_complexity.complexity(name, h, WIDTH)
        r["wall_s"] = time.time() - t
        r["launches"] = {k: v - k0[k] for k, v in _counts().items()}
        r["conv_gflops"] = r.pop("conv_flops") / 1e9
        row["model_complexity"][name] = r
    counts = _counts()
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, CLI_SEQ + ".yuv")
        _write_yuv_sequence(src, CLI_FRAMES)
        t = time.time()
        n = data_to_png.convert_one_seq_to_png(src, WIDTH, HEIGHT,
                                               os.path.join(tmp, "png"))
        row["data_to_png_s"] = time.time() - t
        reader = YUVReader(src, WIDTH, HEIGHT)
        equal = []
        for i in range(n):
            want = np.clip(np.rint(color.ycbcr420_to_rgb(
                *reader.read_one_frame()) * 255.0), 0, 255).astype(np.uint8)
            got = read_png(os.path.join(tmp, "png", f"im{i + 1:05d}.png"))
            equal.append(bool(np.array_equal(got, want)))
        reader.close()
    row["data_to_png_frames"] = n
    row["launches"] = counts
    print(f"tools {json.dumps(row)}", flush=True)
    if n != CLI_FRAMES or not all(equal):
        raise AssertionError(f"data_to_png: {n} frames, pixels equal {equal}")
    mc = row["model_complexity"]
    if (mc["intra_dc"]["launches"]["block_warp"]
            or mc["dmc_dc"]["launches"]["block_warp"] != 2
            or counts["band_copy"]):
        raise AssertionError(f"model_complexity launches {counts}")
    if not all(r["params"] > 0 and r["conv_gflops"] > 0 for r in mc.values()):
        raise AssertionError(f"model_complexity: {mc}")
    results["tools"] = row


BF16_TOL, BF16_DESYNC = 4e-3, 0.05   # tools/check_tpu_roundtrip.py:37-38
BF16_SEEDS = {"intra_dc": 0, "dmc_dc": 1}   # the runtimes phase's (7)


def _bf16_gaps(pairs) -> tuple:
    """Max abs gap and the count of values above BF16_DESYNC over (encoder,
    decoder) tensor pairs."""
    worst, n = 0.0, 0
    for a, b in pairs:
        d = (a.float() - b.float()).abs()
        worst = max(worst, d.max().item())
        n += int((d > BF16_DESYNC).sum())
    return worst, n


def _psnr(x_hat, x) -> float:
    import torch.nn.functional as F

    mse = F.mse_loss(x_hat[:, :, :HEIGHT, :WIDTH].float(), x).item()
    return 10 * math.log10(1.0 / max(mse, 1e-12))


def _dc_runtimes(dtype):
    """IntraDcRuntime + DmcRuntime through the registry, seeds of 7."""
    from dcvc_tpu_torch.models.registry import build

    rts = []
    for name in ("intra_dc", "dmc_dc"):
        _, rt = build(name, seed=BF16_SEEDS[name], dtype=dtype)
        rt.update()
        rts.append(rt)
    return rts


def _dc_bf16_chain(irt, prt, taps, frames, pad, capture=None):
    """I + P_FRAMES through the containers, each frame's decoder DPB the
    next frame's reference; per-frame rows. Fails on unequal symbols, a
    gap above BF16_TOL or a value above BF16_DESYNC. ``capture`` collects
    K1's inputs of the first P compress."""
    import torch.nn.functional as F

    from dcvc_tpu_torch.ops import block_warp as bw
    from dcvc_tpu_torch.utils import stream

    hp, wp = HEIGHT + pad[1], WIDTH + pad[0]
    q_index, rows = 32, []
    dpb_enc = dpb_dec = None
    for i, x in enumerate(frames):
        xp = F.pad(x, (0, pad[0], 0, pad[1]), mode="replicate")
        k0 = bw.block_warp_nchw.launches
        t = time.time()
        if i == 0:
            comp = irt.compress(xp, False, q_index)
            data = stream.pack_i(hp, wp, False, q_index, comp["bit_stream"])
            enc_ms, k1 = _sync_ms(t), bw.block_warp_nchw.launches
            t = time.time()
            h, w, qc, qi, s = stream.unpack_i(bytes(data))
            dec = irt.decompress(s, h, w, qc, qi)
            dec_ms = _sync_ms(t)
            enc, dc = {"ref_frame": comp["x_hat"]}, {"ref_frame": dec["x_hat"]}
            tap = taps["i"]
        else:
            launch = bw._launch      # K1's launch, behind the counter
            if capture is not None and i == 1:
                def spy(im, fl, *spec):
                    capture.append((im.clone(), fl.clone(), spec))
                    return launch(im, fl, *spec)
                bw._launch = spy
            try:
                comp = prt.compress(xp, dpb_enc, False, q_index, i)
            finally:
                bw._launch = launch
            data = stream.pack_p(comp["bit_stream"], False, q_index, i)
            enc_ms, k1 = _sync_ms(t), bw.block_warp_nchw.launches
            t = time.time()
            qc, qi, fi, s = stream.unpack_p(bytes(data))
            dec = prt.decompress(dpb_dec, s, hp, wp, qc, qi, fi)
            dec_ms = _sync_ms(t)
            enc, dc = comp["dpb"], dec["dpb"]
            tap = taps["p"]
        k2 = bw.block_warp_nchw.launches
        idx_diff = tap.index_mismatches()
        sym_ok = tap.equal()
        gap, desync = _bf16_gaps((enc[k], dc[k]) for k in enc
                                 if enc[k] is not None)
        recon = dc["ref_frame"]
        row = {"frame": i, "type": "I" if i == 0 else "P",
               "bytes": len(data), "encode_ms": enc_ms, "decode_ms": dec_ms,
               "symbols_equal": sym_ok, "index_mismatches": idx_diff,
               "max_gap": gap, "values_above_desync": desync,
               "dpb_dtypes": sorted({str(v.dtype) for v in dc.values()
                                     if v is not None}),
               "psnr": _psnr(recon, x), "k1_compress": k1 - k0,
               "k1_decompress": k2 - k1}
        if not (sym_ok and gap <= BF16_TOL and desync == 0
                and _finite(recon)):
            raise AssertionError(f"bf16 DC frame {i}: {row}")
        rows.append(row)
        if i == 0:
            dpb_enc = {"ref_frame": comp["x_hat"], "ref_feature": None,
                       "ref_mv_feature": None, "ref_y": None,
                       "ref_mv_y": None}
            dpb_dec = dict(dpb_enc, ref_frame=dec["x_hat"])
        else:
            dpb_enc, dpb_dec = enc, dc
    return rows


def _dc_timing(irt, prt, frames, pad) -> dict:
    """I and P encode / decode ms (median of 3 after a warm-up), bytes,
    PSNR and peak memory of one runtime pair: the I-frame of frames[0],
    then the P-frame of frames[1] on the I-frame's DPB."""
    import torch
    import torch.nn.functional as F

    hp, wp = HEIGHT + pad[1], WIDTH + pad[0]
    x0, x1 = (F.pad(x, (0, pad[0], 0, pad[1]), mode="replicate")
              for x in frames[:2])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {}

    def timed(fn):
        t = time.time()
        r = fn()
        return r, _sync_ms(t)

    runs = [timed(lambda: irt.compress(x0, False, 32)) for _ in range(4)]
    comp_i = runs[0][0]
    out["i_encode_ms"] = sorted(r[1] for r in runs[1:])[1]
    runs = [timed(lambda: irt.decompress(comp_i["bit_stream"], hp, wp, False,
                                         32)) for _ in range(4)]
    out["i_decode_ms"] = sorted(r[1] for r in runs[1:])[1]
    dpb = {"ref_frame": runs[0][0]["x_hat"], "ref_feature": None,
           "ref_mv_feature": None, "ref_y": None, "ref_mv_y": None}
    runs = [timed(lambda: prt.compress(x1, dpb, False, 32, 1))
            for _ in range(4)]
    comp_p = runs[0][0]
    out["p_encode_ms"] = sorted(r[1] for r in runs[1:])[1]
    runs = [timed(lambda: prt.decompress(dpb, comp_p["bit_stream"], hp, wp,
                                         False, 32, 1)) for _ in range(4)]
    out["p_decode_ms"] = sorted(r[1] for r in runs[1:])[1]
    out.update(i_bytes=len(comp_i["bit_stream"]),
               p_bytes=len(comp_p["bit_stream"]),
               i_psnr=_psnr(comp_i["x_hat"], frames[0]),
               p_psnr=_psnr(runs[0][0]["dpb"]["ref_frame"], frames[1]),
               peak_mem_gib=_gib(torch.cuda.max_memory_allocated()))
    out["p_profile"] = _p_profile(prt, x1, dpb, hp, wp)
    return out


def _p_profile(prt, x, dpb, hp, wp) -> dict:
    """One P-frame compress + decompress under torch.profiler: device ms,
    busy share, top kernels, and the FFT kernels' share (cuDNN's FFT
    convolution algorithms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        comp = prt.compress(x, dpb, False, 32, 1)
        prt.decompress(dpb, comp["bit_stream"], hp, wp, False, 32, 1)
        wall = _sync_ms(t)
    rows = _device_rows(prof.key_averages())
    device_ms = sum(r[0] for r in rows)
    fft = [r for r in rows if "fft" in r[2].lower()]
    return {"wall_ms": wall, "device_ms": device_ms or None,
            "busy_share": device_ms / wall if device_ms else None,
            "fft_ms": sum(r[0] for r in fft),
            "fft_launches": sum(r[1] for r in fft),
            "block_warp_ms": sum(r[0] for r in rows if "block_warp" in r[2]
                                 or "block_prep" in r[2]),
            "top": [{"ms": ms, "count": n, "name": k[:80]}
                    for ms, n, k in rows[:8]]}


def _evc_bf16(results: dict) -> dict:
    """evc_SS and evc_LL in bf16: one 1080p image write-stream (a warm-up
    + 3), symbols equal, recon gap within BF16_TOL, peak memory; one
    profiled evc_LL encode (its FFT kernels)."""
    import tempfile

    import torch
    import torch.nn.functional as F

    from dcvc_tpu_torch.models.evc import build_evc
    from dcvc_tpu_torch.models.runtime import EvcCodecRuntime
    from dcvc_tpu_torch.ops.warp import get_padding_size
    from dcvc_tpu_torch.utils import stream

    _, pr, _, pb = get_padding_size(HEIGHT, WIDTH, 64)
    x = F.pad(_image(HEIGHT, WIDTH, 5), (0, pr, 0, pb), mode="replicate")
    q, _ = stream.get_rounded_q(EVC_Q)
    rows = {}
    _reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for variant in ("SS", "LL"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            module = build_evc(variant, seed=21, dtype=torch.bfloat16)
            rt, dec_rt = EvcCodecRuntime(module), EvcCodecRuntime(module)
            rt.update()
            dec_rt.update()
            tap = _SymbolTap(rt, dec_rt)
            path = os.path.join(tmp, f"evc_{variant}_bf16.bin")
            # each round trip fails on unequal symbols or a gap above
            # BF16_TOL (so no value reaches BF16_DESYNC)
            runs = [_evc_roundtrip(rt, dec_rt, tap, x, HEIGHT, WIDTH, path,
                                   tol=BF16_TOL) for _ in range(4)]
            f32 = results.get("evc", {}).get(variant, {})
            row = {"model": f"evc_{variant}", "dtype": "bfloat16",
                   "bytes": len(runs[0][0]),
                   "encode_ms_median3": sorted(r[1] for r in runs[1:])[1],
                   "decode_ms_median3": sorted(r[2] for r in runs[1:])[1],
                   "symbols_equal": True, "max_gap": max(r[3] for r in runs),
                   "psnr": _psnr(runs[0][4]["x_hat"], x[:, :, :HEIGHT,
                                                        :WIDTH]),
                   "peak_mem_gib": _gib(torch.cuda.max_memory_allocated()),
                   **{f"f32_{k}": f32.get(k) for k in (
                       "peak_mem_gib", "encode_ms_median3",
                       "decode_ms_median3", "bytes")}}
            if variant == "LL":
                row["encode_profile"] = _hem_profile(
                    lambda: rt.compress(x, q))
                tap.enc, tap.dec, tap.enc_idx, tap.dec_idx = [], [], [], []
            print(f"bf16 evc {json.dumps(row)}", flush=True)
            rows[variant] = row
            del module, rt, dec_rt, tap
    rows["launches"] = _no_kernel_launched("evc bf16")
    return rows


BF16_IMAGES = ("intra_hem", "bmshj2018-factorized", "bmshj2018-hyperprior",
               "mbt2018-mean", "cheng2020-anchor")
BF16_VIDEO = {"dmc_hem": "intra_hem", "canfvc_dmc": "intra_hem",
              "dmc_tcm": TCM_I, "dcvc_gen1": GEN1_I}   # P model: I model
BF16_TWINS = ("dmc_hem", "dmc_tcm")      # P-frames timed against f32 twins


def _gen_build(name, dtype):
    """``name`` through the registry with its f32 phase's seed (gen-1 with
    13-20's latent gain) and ``dtype``; (module, updated runtime)."""
    import torch

    from dcvc_tpu_torch.models.registry import build

    module, rt = build(name, seed={**HEM_SEEDS, **ZOO_SEEDS, **P_SEEDS}[name],
                       dtype=dtype)
    if name == "dcvc_gen1":
        with torch.no_grad():
            module.mvEncoder[-1].weight.mul_(GEN1_LATENT_GAIN)
            module.contextualEncoder[-1].weight.mul_(GEN1_LATENT_GAIN)
    rt.update()
    return module, rt


def _gen_i_frame(name, rt, tap, x, tol):
    if name == "intra_hem":
        return _hem_i_frame(rt, tap, x, tol)
    return _zoo_i_frame(rt, tap, x, name, tol)


def _gen_p_frame(name, prt, tap, x, de, dd, clock, tol):
    """One P-frame of ``name``: (row, encoder DPB, decoder DPB); gen-1's
    DPB is {"ref_frame"}."""
    what = f"{name} {'bf16' if tol == BF16_TOL else 'f32'}"
    if name in ("dmc_hem", "canfvc_dmc"):
        row, comp, dec = _hem_p_frame(prt, tap, x, de, dd, what, tol)
        return row, comp["dpb"], dec["dpb"]
    if name == "dmc_tcm":
        row, enc, dec, _ = _tcm_p_frame(prt, tap, x, de, dd, what, tol)
        return row, enc, dec
    row, comp, dec = _gen1_p_frame(prt, tap, x, de["ref_frame"],
                                   dd["ref_frame"], clock, what, tol)
    return row, {"ref_frame": comp["recon_image"]}, \
        {"ref_frame": dec["recon_image"]}


def _gen_chain(name, dtype, xs, clock, p_reps):
    """I + P_FRAMES of P model ``name`` after its I model, each frame's
    decoder DPB the next frame's reference; the last P-frame ``p_reps``
    times (the first a warm-up). (rows, I model's runtime, P module,
    runtime, tap, encoder DPB, decoder DPB)."""
    import torch

    tol = BF16_TOL if dtype is not None else None
    iname = BF16_VIDEO[name]
    _, irt = _gen_build(iname, dtype)
    module, prt = _gen_build(name, dtype)
    taps = {"i": _SymbolTap(irt), "p": _SymbolTap(prt)}
    i_row, comp, dec = _gen_i_frame(
        iname, irt, taps["i"], xs[0],
        tol if tol else (0.0 if iname == "intra_hem" else F32_TOL))
    i_row["recon_dtype"] = str(comp["x_hat"].dtype)
    clock.take()
    de = {"ref_frame": comp["x_hat"], "ref_feature": None, "ref_y": None,
          "ref_mv_y": None}
    dd = dict(de, ref_frame=dec["x_hat"])
    if name == "dmc_tcm":
        de, dd = ({"ref_frame": d["ref_frame"], "ref_feature": None}
                  for d in (de, dd))
    rows = [dict(i_row, frame=0, type="I", model=iname)]
    for i in range(1, 1 + P_FRAMES):
        reps = p_reps if i == P_FRAMES else 1
        runs = []
        for _ in range(reps):
            runs.append(_gen_p_frame(name, prt, taps["p"], xs[i], de, dd,
                                     clock, tol or RECON_TOL))
            ar = clock.take()
        row, e, d = runs[-1]
        row = dict(row, frame=i, type="P", model=name,
                   dpb_dtypes={k: str(v.dtype) for k, v in d.items()
                               if v is not None})
        if ar["encode"]:
            row["ar_host_ms"] = {k: sum(v) for k, v in ar.items()}
        if reps > 2:
            row.update(encode_ms_median3=_median3([r[0] for r in runs],
                                                  "encode_ms"),
                       decode_ms_median3=_median3([r[0] for r in runs],
                                                  "decode_ms"))
        rows.append(row)
        de, dd = e, d
    torch.cuda.synchronize()
    return rows, irt, module, prt, taps["p"], de, dd


def _gen_block_mc(name, module, prt, tap, x, de, dd) -> dict:
    """One bf16 block-mc P-frame of dmc_hem / dmc_tcm (K1 4 + 4) or
    dcvc_gen1 (1 + 1), symbols equal and gaps within BF16_TOL; K1 against
    its plain version (atol 0) on the maps compress warped, and timed at
    the 64-channel full-resolution map (its bound with the flow in f32, the
    kernel's input; and the wrapper call with the model's own flow, its
    cast included)."""
    from dcvc_tpu_torch.ops import block_warp as bw
    from dcvc_tpu_torch.ops.warp import bilinear_down2
    from dcvc_tpu_torch.utils import stream

    seen, hooks = {}, []
    if name == "dcvc_gen1":
        expected = {"compress": 1, "decompress": 1}
        mc = module.motion_compensation

        def spy(ref, mv):
            seen.setdefault("mc", (ref, mv))
            return mc(ref, mv)

        module.motion_compensation = spy
        compress = lambda: prt.compress(de["ref_frame"], x)   # noqa: E731
        decompress = lambda c: prt.decompress(   # noqa: E731
            dd["ref_frame"], c["mv_y_string"], c["mv_z_string"],
            c["y_string"], c["z_string"], x.shape[2], x.shape[3])
        gap_fn = lambda c, d: (c["recon_image"].float()   # noqa: E731
                               - d["recon_image"].float()).abs().max().item()
    else:
        expected = {"compress": 4, "decompress": 4}
        hooks = [module.mv_decoder.register_forward_hook(
                     lambda mod, i, out: seen.setdefault("mv", out)),
                 module.feature_extractor.register_forward_hook(
                     lambda mod, i, out: seen.setdefault("features", out))]
        if name == "dmc_hem":
            mv_q, _ = stream.get_rounded_q(HEM_MV_Q)
            y_q, _ = stream.get_rounded_q(HEM_Y_Q)
            compress = lambda: prt.compress(x, de, mv_q, y_q)   # noqa: E731
            decompress = lambda c: prt.decompress(   # noqa: E731
                dd, c["bit_stream"], x.shape[2], x.shape[3], mv_q, y_q)
            gap_fn = lambda c, d: _dpb_gap(c["dpb"], d["dpb"])   # noqa: E731
        else:
            compress = lambda: prt.compress(   # noqa: E731
                x, de["ref_frame"], de["ref_feature"])
            decompress = lambda c: prt.decompress(   # noqa: E731
                dd["ref_frame"], dd["ref_feature"], c["bit_stream"],
                x.shape[2], x.shape[3])
            gap_fn = lambda c, d: max(   # noqa: E731
                (c[k].float() - d[k].float()).abs().max().item()
                for k in ("x_hat", "feature"))
    try:
        row = _block_mc(module, tap, compress, decompress, gap_fn, expected,
                        f"{name} bf16 block mc", BF16_TOL)
    finally:
        for h in hooks:
            h.remove()
        if name == "dcvc_gen1":
            del module.motion_compensation
    if name == "dcvc_gen1":
        import torch

        ref, mv = seen["mc"]
        with torch.no_grad():
            f1 = module.feature_extract(ref)
        pairs = (("context_64ch", f1, mv),)
    else:
        mv = seen["mv"]
        mv2 = bilinear_down2(mv) / 2
        mv3 = bilinear_down2(mv2) / 2
        f1, f2, f3 = seen["features"]
        pairs = (("frame_3ch", de["ref_frame"], mv), ("context1_64ch", f1, mv),
                 ("context2_64ch", f2, mv2), ("context3_64ch", f3, mv3))
    row["k1_vs_plain"] = _k1_checks(pairs, f"{name} bf16")
    k1 = _k1_timing(f1, mv.float())
    k1["flow_dtype"] = str(mv.dtype)
    k1["ms_model_flow"] = _time_ms(
        lambda: bw.block_warp_nchw(f1, mv, *K1_MC_SPEC), 20, 3)
    row["k1_64ch_full_res"] = k1
    return row


def _gens_bf16(results: dict) -> dict:
    """The dtype option of HEM, CANF-VC, TCM, gen-1 and the zoo at 1080p:
    intra_hem and the four zoo models code one image (a warm-up, then a
    timed round trip); dmc_hem, canfvc_dmc, dmc_tcm and dcvc_gen1 code I +
    P_FRAMES after their bf16 I models, mc exact (no kernel); dmc_hem's
    and dmc_tcm's last P-frame a warm-up + 3 against f32 twins coded the
    same way here, the others' a warm-up + 1; then one bf16 block-mc
    P-frame of dmc_hem, dmc_tcm and dcvc_gen1 (K1). Every frame: symbols
    equal, every recon / DPB gap <= BF16_TOL (so none above
    BF16_DESYNC); the host AR loops timed apart."""
    import torch

    bf = torch.bfloat16
    xs = _hem_frames()
    zoo_x = _pad64(_image(HEIGHT, WIDTH, 7))
    out = {"images": {}, "video": {}, "block_mc": {}}
    with _ArClock() as clock:
        for name in BF16_IMAGES:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            _, rt = _gen_build(name, bf)
            tap = _SymbolTap(rt)
            x = xs[0] if name == "intra_hem" else zoo_x
            _gen_i_frame(name, rt, tap, x, BF16_TOL)
            clock.take()
            row, comp, _ = _gen_i_frame(name, rt, tap, x, BF16_TOL)
            ar = clock.take()
            launches = _no_kernel_launched(f"{name} bf16 image")
            f32 = (results.get("hem", {}).get("i_frame", {})
                   if name == "intra_hem" else results.get("zoo", {})
                   .get(name, {}))
            row.update(dtype="bfloat16", recon_dtype=str(comp["x_hat"].dtype),
                       symbols_equal=True,
                       bpp=row["bytes"] * 8 / (HEIGHT * WIDTH),
                       psnr=_psnr(comp["x_hat"], x[:, :, :HEIGHT, :WIDTH]),
                       peak_mem_gib=_gib(torch.cuda.max_memory_allocated()),
                       f32_encode_ms=f32.get("encode_ms_median3",
                                             f32.get("encode_ms")),
                       f32_decode_ms=f32.get("decode_ms_median3",
                                             f32.get("decode_ms")),
                       f32_bytes=f32.get("bytes"), launches=launches)
            if ar["encode"]:
                row["ar_host_ms"] = {k: sum(v) for k, v in ar.items()}
            print(f"bf16 {name} {json.dumps(row)}", flush=True)
            out["images"][name] = row
            del rt, tap, comp
        for name in BF16_VIDEO:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reps = 4 if name in BF16_TWINS else 2
            _reset_counts()
            rows, irt, module, prt, tap, de, dd = _gen_chain(
                name, bf, xs, clock, reps)
            del irt
            peak = _gib(torch.cuda.max_memory_allocated())
            row = {"frames": rows, "peak_mem_gib": peak,
                   "launches": _no_kernel_launched(f"{name} bf16")}
            if name in BF16_TWINS:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                _reset_counts()
                f32_rows = _gen_chain(name, None, xs, clock, 4)[0]
                row["f32_twin"] = {
                    "launches": _no_kernel_launched(f"{name} f32 twin"),
                    "p_encode_ms_median3": f32_rows[-1]["encode_ms_median3"],
                    "p_decode_ms_median3": f32_rows[-1]["decode_ms_median3"],
                    "p_bytes": f32_rows[-1]["bytes"],
                    "peak_mem_gib": _gib(torch.cuda.max_memory_allocated())}
            if name != "canfvc_dmc":
                block = _gen_block_mc(name, module, prt, tap,
                                      xs[-1].roll(4, dims=3), de, dd)
                clock.take()
                out["block_mc"][name] = block
                print(f"bf16 {name} block_mc {json.dumps(block)}", flush=True)
            print(f"bf16 {name} {json.dumps(row)} ({_card()})", flush=True)
            out["video"][name] = row
            del module, prt, tap, de, dd
    return out


def bf16_phase(results: dict):
    """The dtype option on the card: IntraNoAR + DMC built with
    ``dtype=torch.bfloat16`` code I + P_FRAMES at 1080p with aligned_enc
    off, then on (K1 1 + 1 per P-frame off, 2 + 1 on); K1 against its
    plain version on the OD call's captured bf16 inputs; bf16 against f32
    on the same weights and frames; evc_SS and evc_LL in bf16."""
    import torch

    from dcvc_tpu_torch.ops import block_warp as bw
    from dcvc_tpu_torch.ops.warp import get_padding_size

    _, pr, _, pb = get_padding_size(HEIGHT, WIDTH, 16)
    frames = _content(1 + P_FRAMES)
    irt, prt = _dc_runtimes(torch.bfloat16)
    taps = {"i": _SymbolTap(irt), "p": _SymbolTap(prt)}
    captured = []
    _reset_counts()
    chains = {}
    for aligned in (False, True):
        prt.aligned_enc = aligned
        chains["aligned" if aligned else "default"] = _dc_bf16_chain(
            irt, prt, taps, frames, (pr, pb),
            None if aligned else captured)
    prt.aligned_enc = False
    counts = _counts()
    for name, rows in chains.items():
        want = (2 if name == "aligned" else 1, 1)
        for row in rows[1:]:
            if (row["k1_compress"], row["k1_decompress"]) != want:
                raise AssertionError(f"bf16 {name} P-frame {row['frame']}: "
                                     f"K1 {row['k1_compress']} + "
                                     f"{row['k1_decompress']}, want {want}")
        for row in rows:
            print(f"bf16 dc {name} {json.dumps(row)}", flush=True)
    if counts["band_copy"] or counts["block_warp"] != P_FRAMES * 5:
        raise AssertionError(f"bf16 runtimes: launches {counts}")

    im, fl, spec = captured[0]
    ker = bw.block_warp_nchw(im, fl, *spec)
    torch.cuda.synchronize()
    plain = bw.block_warp_plain_nchw(im, fl, *spec)
    k1 = {"shape": list(im.shape), "dtype": str(im.dtype),
          "flow_dtype": str(fl.dtype),
          "max_abs_err": (ker.float() - plain.float()).abs().max().item(),
          "ms": _time_ms(lambda: bw.block_warp_nchw(im, fl, *spec), 20, 3),
          "plain_ms": _time_ms(lambda: bw.block_warp_plain_nchw(
              im, fl, *spec), 3)}
    # the wrapper casts OD's bf16 offsets to f32 first: that cast, and
    # the call on a flow already in f32
    fl32 = fl.float()
    k1["ms_flow_cast"] = _time_ms(lambda: fl.float(), 20, 3)
    k1["ms_f32_flow"] = _time_ms(lambda: bw.block_warp_nchw(
        im, fl32, *spec), 20, 3)
    if not (im.dtype == torch.bfloat16 and k1["max_abs_err"] == 0.0
            and _finite(ker)):
        raise AssertionError(f"bf16 OD K1: {k1}")
    # the exact mc warp at context1's shape: bf16 takes the gather route
    # (positions in f32), f32 F.grid_sample
    from dcvc_tpu_torch.ops.warp import flow_warp

    gen = torch.Generator(device="cuda").manual_seed(3)
    feat, mv = _od_inputs(1, 48, HEIGHT + pb, WIDTH + pr, torch.float32,
                          (0.0, 0.0), gen)
    k1["exact_warp_48ch"] = {
        "shape": list(feat.shape),
        "bf16_gather_ms": _time_ms(lambda: flow_warp(
            feat.bfloat16(), mv.bfloat16()), 10, 2),
        "f32_grid_sample_ms": _time_ms(lambda: flow_warp(feat, mv), 10, 2)}
    del feat, mv
    print(f"bf16 k1_in_p_frame {json.dumps(k1)}", flush=True)
    del captured, ker, plain, im, fl, fl32

    timing = {"bfloat16": _dc_timing(irt, prt, frames, (pr, pb))}
    del irt, prt, taps
    torch.cuda.empty_cache()
    irt, prt = _dc_runtimes(None)
    timing["float32"] = _dc_timing(irt, prt, frames, (pr, pb))
    del irt, prt
    torch.cuda.empty_cache()
    for dt, row in timing.items():
        print(f"bf16 vs f32 dc {dt} {json.dumps(row)} ({_card()})",
              flush=True)
    results["bf16"] = {"dc": chains, "launches": counts, "k1": k1,
                       "timing": timing, "evc": _evc_bf16(results),
                       "gens": _gens_bf16(results)}


def sharded_phase(results: dict):
    """Sharded P-frame coding on a mesh of every visible card, through
    ``python -m dcvc_tpu_torch.tools.mesh_check``'s ``run`` (one process
    per rank); fails on any limit that tool checks."""
    import torch

    from dcvc_tpu_torch.tools import mesh_check

    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    res = mesh_check.run(nproc=n, height=HEIGHT, width=WIDTH, timeout=600)
    if res["failures"]:
        raise AssertionError("sharded: " + "; ".join(res["failures"]))
    paths = {}
    for row in res["rows"]:
        name = f"sharded_{row['mesh'][0]}x{row['mesh'][1]}_{row['mode']}"
        path = paths.setdefault(name, {
            "mesh": row["mesh"], "od_warp": row["od_warp"], "ranks": 0,
            "launches": {"block_warp": 0, "band_copy": 0}, "frames": []})
        path["ranks"] += 1
        for k, v in row["launches"].items():
            path["launches"][k] += v
        for fr in row["frames"]:
            path["frames"].append({"rank": row["rank"], **fr})
    for name, path in paths.items():
        fr = path["frames"]
        path["summary"] = {
            "encode_ms": [f["encode_ms"] for f in fr],
            "decode_ms": [f["decode_ms"] for f in fr],
            "bytes_equal_unsharded": all(f["bytes_equal_unsharded"]
                                         for f in fr),
            "symbol_mismatches": sum(f["symbol_mismatches"] for f in fr),
            "index_mismatches": sum(f["index_mismatches"] for f in fr),
            "symbols": sum(f["symbols"] for f in fr),
            "dpb_gap_dec_vs_enc": max(f["dpb_gap_dec_vs_enc"] for f in fr),
            "dpb_gap_vs_unsharded_enc": max(f["dpb_gap_vs_unsharded_enc"]
                                            for f in fr)}
        if n == 1:
            path["note"] = ("one card: a (1, 1) mesh; the halo code runs "
                            "with only global edges")
        print(f"sharded {name} {json.dumps(path)} ({_card()})", flush=True)
    results["sharded"] = {"paths": paths, "seconds": res["seconds"],
                          "nproc": n}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dcvc_tpu_torch.device import card_line, exact_numerics
    from dcvc_tpu_torch.ops import band_copy as bc
    from dcvc_tpu_torch.ops import block_warp as bw
    from dcvc_tpu_torch.ops import rans

    print(card_line(), flush=True)
    exact_numerics()
    t = time.time()
    with ThreadPoolExecutor(3) as ex:
        builds = [ex.submit(bw.load_kernel), ex.submit(bc.load_kernel),
                  ex.submit(rans._load_library)]
        for f in builds:
            f.result()
    print(f"build: {time.time() - t:.1f} s (block_warp.cu + band_copy.cu + "
          f"rans.cpp)", flush=True)
    for name, log in (("block_warp", bw.build_log), ("band_copy", bc.build_log)):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    results: dict = {}
    phases = [kernel_phase, band_copy_phase, tile_warp_phase,
              reference_phase, main_path_phase, cli_phase,
              diag_phase, evc_phase, evc_scalable_phase, image_cli_phase,
              hem_phase, hem_block_phase, canf_phase, hem_cli_phase,
              zoo_phase, tcm_phase, tcm_block_phase, gen1_phase,
              zoo_tcm_cli_phase, train_card_cpu_phase, train_fit_phase,
              train_remat_phase, train_intra_phase, train_ckpt_phase,
              train_cli_phase, serving_phase, serve_cli_phase, pool_phase,
              tools_phase, bf16_phase, sharded_phase]
    for i, phase in enumerate(phases):
        t = time.time()
        phase(results)
        print(f"phase {i + 3} ({phase.__name__}): {time.time() - t:.1f} s",
              flush=True)

    k1 = results["block_warp"]
    od = k1["od_1080p_f32"]
    k2 = results["band_copy"]["tool_720x1408x16x4"]
    cli_k1 = sum(r["launches"]["block_warp"] for r in results["cli"].values())

    def no_kernel_paths(kernel):
        """Launches on the EVC / image-CLI / exact-mc HEM, CANF, TCM and
        gen-1 / zoo paths and the CLI runs with exact mc (checked to be
        0)."""
        return {
            "evc_runtimes": sum(r["launches"][kernel]
                                for r in results["evc"].values()),
            "evc_scalable": results["evc_scalable"]["launches"][kernel],
            "image_cli": sum(r["launches"][kernel]
                             for r in results["image_cli"].values()),
            "hem_runtimes": results["hem"]["launches"][kernel],
            "canf_runtimes": results["canf"]["launches"][kernel],
            "hem_cli": sum(r["launches"][kernel]
                           for r in results["hem_cli"].values()),
            "zoo_runtimes": sum(r["launches"][kernel]
                                for r in results["zoo"].values()),
            "tcm_runtimes": results["tcm"]["launches"][kernel],
            "gen1_runtimes": results["gen1"]["launches"][kernel],
            "zoo_tcm_cli": results["zoo_tcm_cli"]["launches"][kernel],
            "evc_runtimes_bf16": results["bf16"]["evc"]["launches"][kernel],
            "gens_images_bf16": sum(
                r["launches"][kernel]
                for r in results["bf16"]["gens"]["images"].values()),
            "gens_exact_mc_bf16": sum(
                r["launches"][kernel]
                for r in results["bf16"]["gens"]["video"].values()),
            "gens_f32_twins": sum(
                r["f32_twin"]["launches"][kernel]
                for r in results["bf16"]["gens"]["video"].values()
                if "f32_twin" in r)}
    def bf16_block_mc(kernel):
        """Launches on the bf16 block-mc P-frames of HEM, TCM and gen-1."""
        rows = results["bf16"]["gens"]["block_mc"]
        return {f"{k}_block_mc_bf16": rows[n]["launches"][kernel]
                for k, n in (("hem", "dmc_hem"), ("tcm", "dmc_tcm"),
                             ("gen1", "dcvc_gen1"))}
    def training_launches(kernel):
        """Launches on the training paths (0 on all but the trained
        checkpoint's coding, checked in their phases)."""
        return {f"training_{k}": results[f"train_{k}"]["launches"][kernel]
                for k in ("card_cpu", "fit", "remat", "intra", "cli")} | {
            "training_checkpoint_coding":
                results["train_ckpt"]["launches"][kernel]}
    def sharded_launches(kernel):
        """Launches on the sharded paths, summed over their ranks (each
        rank counts its own from 0 around its path)."""
        return {name: p["launches"][kernel]
                for name, p in results["sharded"]["paths"].items()}
    def serving_launches(kernel):
        """Launches on the serving, serve-CLI, pool and tools paths; the
        server process and the pool's workers count their own and write
        them at exit."""
        return {path: results[ph]["launches"][kernel] for path, ph in (
            ("serving", "serving"), ("serve_cli", "serve_cli"),
            ("pool", "pool"), ("model_complexity", "tools"))}
    hem_k1 = results["hem_block"]["k1_64ch_full_res"]
    gen1_k1 = results["gen1_block"]["k1_64ch_full_res"]
    print(json.dumps({"kernels": [{
        "name": "block_warp", "route": "cuda",
        "source": "dcvc_tpu_torch/csrc/block_warp.cu",
        "replaces": "dcvc_tpu/ops/block_warp.py:164",
        "tpu_kernel": "dcvc_tpu/ops/block_warp.py:_kernel",
        "launches": cli_k1,
        "launches_by_path": {
            "runtimes": results["launches"]["runtimes"]["block_warp"],
            "runtimes_bf16": results["bf16"]["launches"]["block_warp"],
            "cli": cli_k1, "diag_dma": 0, **no_kernel_paths("block_warp"),
            "hem_block_mc": results["hem_block"]["launches"]["block_warp"],
            "tcm_block_mc": results["tcm_block"]["launches"]["block_warp"],
            "gen1_block_mc": results["gen1_block"]["launches"]["block_warp"],
            **bf16_block_mc("block_warp"),
            **training_launches("block_warp"),
            **serving_launches("block_warp"),
            **sharded_launches("block_warp")},
        "max_abs_err": max(r["max_abs_err"] for n, r in k1.items()
                           if n.endswith("f32")),
        "max_abs_err_bf16": max(r["max_abs_err"] for n, r in k1.items()
                                if n.endswith("bf16")),
        "ms": od["ms"], "plain_ms": od["plain_ms"],
        "bound_ms": od["bound_ms"], "bound_by": od["bound_by"],
        "library_ms": None,
        "ms_prep": od["ms_prep"], "ms_warp": od["ms_warp"],
        "share_of_bound": od["share_of_bound"],
        "grid_sample_exact_warp_ms": od["grid_sample_exact_warp_ms"],
        "ms_bf16": k1["od_1080p_bf16"]["ms"],
        "ms_prep_bf16": k1["od_1080p_bf16"]["ms_prep"],
        "ms_warp_bf16": k1["od_1080p_bf16"]["ms_warp"],
        "share_of_bound_bf16": k1["od_1080p_bf16"]["share_of_bound"],
        "bf16_p_frame_od": results["bf16"]["k1"],
        "hem_mc_64ch": {k: hem_k1[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound")},
        "hem_mc_max_abs_err": max(
            r["max_abs_err"]
            for r in results["hem_block"]["k1_vs_plain"].values()),
        "gen1_mc_64ch": {k: gen1_k1[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound")},
        "tcm_gen1_mc_max_abs_err": max(
            r["max_abs_err"] for ph in ("tcm_block", "gen1_block")
            for r in results[ph]["k1_vs_plain"].values()),
        "mc_64ch_bf16_models": {
            n: {k: r["k1_64ch_full_res"][k] for k in (
                "shape", "dtype", "flow_dtype", "ms", "ms_model_flow",
                "plain_ms", "bound_ms", "bound_by", "share_of_bound")}
            for n, r in results["bf16"]["gens"]["block_mc"].items()},
        "mc_bf16_models_max_abs_err": max(
            c["max_abs_err"]
            for r in results["bf16"]["gens"]["block_mc"].values()
            for c in r["k1_vs_plain"].values()),
    }, {
        "name": "band_copy", "route": "cuda",
        "source": "dcvc_tpu_torch/csrc/band_copy.cu",
        "replaces": "tools/diag_dma.py:27",
        "tpu_kernel": "tools/diag_dma.py:make_bench.kernel",
        "launches": results["diag_dma"]["launches"],
        "launches_by_path": {"runtimes": 0, "cli": 0,
                             "runtimes_bf16": results["bf16"]["launches"]
                             ["band_copy"],
                             "diag_dma": results["diag_dma"]["launches"],
                             **no_kernel_paths("band_copy"),
                             "hem_block_mc": results["hem_block"]["launches"]
                             ["band_copy"],
                             "tcm_block_mc": results["tcm_block"]["launches"]
                             ["band_copy"],
                             "gen1_block_mc": results["gen1_block"]
                             ["launches"]["band_copy"],
                             **bf16_block_mc("band_copy"),
                             **training_launches("band_copy"),
                             **serving_launches("band_copy"),
                             **sharded_launches("band_copy")},
        "max_abs_err": max(r["max_abs_err"]
                           for r in results["band_copy"].values()),
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "requested_bound_ms": k2["requested_bound_ms"],
        "library_ms": k2["index_select_ms"],
        "share_of_bound": k2["share_of_bound"],
        "wrapper_ms": k2["wrapper_ms"], "plan": k2["plan"],
        "ptxas_registers": k2["ptxas_registers"],
        "tool_ms": results["diag_dma"]["ms"],
        "tool_ns_per_band": results["diag_dma"]["ns_per_band"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
