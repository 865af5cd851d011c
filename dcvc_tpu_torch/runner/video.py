"""Sequence evaluation loop: GOP structure, DPB threading, metrics, timing.

Counterpart of ``dcvc_tpu/runner/video.py`` (parity target: run_test / main,
DCVC-DC/test_video.py:71-273): pad, never crop (to 16, replicate), an
I-frame every intra_period, the DPB threaded from frame to frame, PSNR /
MS-SSIM in RGB or weighted YUV, per-frame encode / decode times, JSON
dataset configs (dataset_config_example_rgb.json schema).

Frames are HWC numpy on the host and reach the runtimes as fresh NCHW f32
tensors on the runtime's device. The clock is read after
``torch.cuda.synchronize()`` on the card: the runtimes return device
tensors, and an unsynchronised read would count only the enqueue.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.warp import get_padding_size
from ..utils import color, metrics
from ..utils.results import summarize_sequence
from ..utils.stream import decode_i, decode_p, encode_i, encode_p, filesize
from ..utils.video_io import (PNGReader, PNGWriter, RGBReader, RGBWriter,
                              YUVReader, YUVWriter)


@dataclass
class SequenceSpec:
    name: str
    base_path: str
    width: int
    height: int
    frames: int
    gop: int
    src_type: str = "png"  # png | yuv420 | rgb
    bit_depth: int = 8  # rgb sources may be 10..16-bit (video_reader.py:83)


@dataclass
class EvalConfig:
    intra_period: int = 32
    frame_num: int = 96
    write_stream: bool = False
    stream_path: str = "bitstreams"
    decoded_path: str | None = None
    calc_ssim: bool = False
    yuv420_metrics: bool = False
    pad_multiple: int = 16
    verbose: int = 0
    rate_idx: int = 0
    q_in_ckpt: bool = False
    # 420->444 chroma upsample for the model input: 0 = nearest (the
    # reference's model-input path, DCVC-DC/test_video.py:112), 1 = bilinear
    chroma_upsample_order: int = 0


def _pad_frame(x_hwc: np.ndarray, p: int) -> tuple[np.ndarray, tuple]:
    h, w = x_hwc.shape[:2]
    l, r, t, b = get_padding_size(h, w, p)
    padded = np.pad(x_hwc, ((t, b), (l, r), (0, 0)), mode="edge")
    return padded, (l, r, t, b)


def _to_device(x_hwc: np.ndarray, dev: torch.device) -> torch.Tensor:
    """HWC host frame -> fresh [1, 3, H, W] f32 tensor (canonical NCHW
    strides, so convolutions take the same algorithm as the decoder's)."""
    t = torch.from_numpy(x_hwc).permute(2, 0, 1)[None]
    return torch.empty(t.shape, device=dev).copy_(t)


def _recon_hwc(x_hat: torch.Tensor, h: int, w: int) -> np.ndarray:
    return x_hat[0, :, :h, :w].permute(1, 2, 0).cpu().numpy()


def _open_io(seq: SequenceSpec, cfg: EvalConfig):
    if seq.src_type == "png":
        reader = PNGReader(seq.base_path, seq.width, seq.height)
    elif seq.src_type == "rgb":
        reader = RGBReader(seq.base_path, seq.width, seq.height,
                           bit_depth=seq.bit_depth)
    else:
        reader = YUVReader(seq.base_path, seq.width, seq.height)
    writer = None
    if cfg.decoded_path:
        dst = os.path.join(cfg.decoded_path, seq.name)
        if seq.src_type == "png":
            writer = PNGWriter(dst, seq.width, seq.height)
        elif seq.src_type == "rgb":
            writer = RGBWriter(dst, seq.width, seq.height,
                               bit_depth=seq.bit_depth)
        else:  # YUV sources get a YUV recon (DCVC-DC/test_video.py:86-88)
            writer = YUVWriter(dst, seq.width, seq.height)
    return reader, writer


def run_sequence(i_runtime, p_runtime, seq: SequenceSpec, cfg: EvalConfig,
                 q_index_i: int = 0, q_index_p: int = 0) -> dict:
    """Evaluate one sequence at one rate point. Returns the per-seq summary."""
    dev = i_runtime.device
    reader, recon_writer = _open_io(seq, cfg)

    def now() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.time()

    frame_num = min(cfg.frame_num, seq.frames)
    intra_period = cfg.intra_period if cfg.intra_period > 0 else frame_num

    frame_results = []
    seq_t0 = time.time()
    is_i = []
    dpb = None
    pixel_num = seq.width * seq.height

    os.makedirs(cfg.stream_path, exist_ok=True)

    # estimated-bits mode records each frame one frame behind: frame i's
    # recon and bits are read back after frame i+1 has been queued
    pending = None

    def _finish_pending():
        nonlocal pending
        if pending is None:
            return
        fr_idx, x_hat_dev, bit_dev, frame_np, t0_p, t1_p = pending
        pending = None
        recon = _recon_hwc(x_hat_dev, seq.height, seq.width)
        bit = float(bit_dev)
        _record_frame(frame_np, recon, bit, t0_p, t1_p, now(), fr_idx)

    def _record_frame(frame_np, recon, bit, t0, t1, t2, frame_idx):
        fr = {"bits": float(bit), "bpp": float(bit) / pixel_num,
              "encoding_time": t1 - t0, "decoding_time": t2 - t1}
        if cfg.yuv420_metrics or seq.src_type == "yuv420":
            # metric contract is the 420 domain: per-plane PSNR/MS-SSIM on
            # (y, subsampled u, v), weighted (6,1,1)/8
            # (DCVC-DC/test_video.py:169-186). RGB sources convert to
            # YCbCr first (even-cropped for the 2x2 chroma mean).
            f444, r444 = frame_np, recon
            if seq.src_type != "yuv420":
                he, we = frame_np.shape[0] // 2 * 2, frame_np.shape[1] // 2 * 2
                f444 = color.rgb_to_ycbcr(frame_np[:he, :we])
                r444 = color.rgb_to_ycbcr(recon[:he, :we])
            fy, fuv = color.ycbcr444_to_420(f444)
            ry, ruv = color.ycbcr444_to_420(r444)
            psnrs = [metrics.calc_psnr(fy, ry, data_range=1),
                     metrics.calc_psnr(fuv[0], ruv[0], data_range=1),
                     metrics.calc_psnr(fuv[1], ruv[1], data_range=1)]
            fr["psnr_y"], fr["psnr_u"], fr["psnr_v"] = psnrs
            fr["psnr"] = metrics.yuv_psnr_6_1_1(*psnrs)
            if cfg.calc_ssim:
                ssims = [metrics.calc_msssim(fy, ry, data_range=1),
                         metrics.calc_msssim(fuv[0], ruv[0], data_range=1),
                         metrics.calc_msssim(fuv[1], ruv[1], data_range=1)]
                fr["msssim_y"], fr["msssim_u"], fr["msssim_v"] = ssims
                fr["msssim"] = metrics.yuv_psnr_6_1_1(*ssims)
        else:
            fr["psnr"] = metrics.calc_psnr(frame_np, recon, data_range=1)
            if cfg.calc_ssim:
                fr["msssim"] = metrics.calc_msssim_rgb(frame_np, recon,
                                                       data_range=1)
        frame_results.append(fr)
        if recon_writer is not None:
            if seq.src_type in ("png", "rgb"):
                recon_writer.write_one_frame(recon)
            else:
                ry, ruv = color.ycbcr444_to_420(recon)
                recon_writer.write_one_frame(ry, ruv)
        if cfg.verbose >= 2:
            print(f"  frame {frame_idx}: bpp={fr['bpp']:.4f} "
                  f"psnr={fr['psnr']:.2f} "
                  f"enc={fr['encoding_time']:.3f}s "
                  f"dec={fr['decoding_time']:.3f}s")

    for frame_idx in range(frame_num):
        if seq.src_type in ("png", "rgb"):
            frame = reader.read_one_frame()
        else:
            y, uv = reader.read_one_frame()
            # order=0 (nearest) is the reference's model-input path
            # (DCVC-DC/test_video.py:112) and makes the 444->420 metric
            # round trip reproduce the source chroma planes exactly
            frame = (None if y is None else color.ycbcr420_to_444(
                y, uv, order=cfg.chroma_upsample_order))
        if frame is None:
            break
        if frame.shape[:2] != (seq.height, seq.width):
            raise ValueError(
                f"{seq.name} frame {frame_idx}: source is "
                f"{frame.shape[1]}x{frame.shape[0]} but the dataset config "
                f"declares {seq.width}x{seq.height} — wrong files in "
                f"{seq.base_path}? (PNGReader resolves im1.png before "
                f"im00001.png)")
        padded, _ = _pad_frame(frame.astype(np.float32), cfg.pad_multiple)
        x = _to_device(padded, dev)

        i_frame = frame_idx % intra_period == 0
        is_i.append(i_frame)
        bin_path = os.path.join(cfg.stream_path, f"{seq.name}_{frame_idx}.bin")

        t0 = now()
        if i_frame:
            if cfg.write_stream:
                _finish_pending()
                comp = i_runtime.compress(x, cfg.q_in_ckpt, q_index_i)
                encode_i(seq.height, seq.width, cfg.q_in_ckpt, q_index_i,
                         comp["bit_stream"], bin_path)
                bit = filesize(bin_path) * 8
                t1 = now()
                h, w, q_in_ckpt, q_idx, stream = decode_i(bin_path)
                dec = i_runtime.decompress(stream, h, w, q_in_ckpt, q_idx)
                x_hat = torch.clamp(dec["x_hat"], 0.0, 1.0)
            else:
                out = i_runtime.forward(x, cfg.q_in_ckpt, q_index_i)
                t1 = now()
                x_hat = torch.clamp(out["x_hat"], 0.0, 1.0)
                _finish_pending()
                pending = (frame_idx, x_hat, out["bit"], frame, t0, t1)
            dpb = {"ref_frame": x_hat, "ref_feature": None,
                   "ref_mv_feature": None, "ref_y": None, "ref_mv_y": None}
        else:
            if cfg.write_stream:
                _finish_pending()
                comp = p_runtime.compress(x, dpb, cfg.q_in_ckpt, q_index_p,
                                          frame_idx)
                encode_p(comp["bit_stream"], cfg.q_in_ckpt, q_index_p,
                         frame_idx % 4, bin_path)
                bit = filesize(bin_path) * 8
                t1 = now()
                q_in_ckpt, q_idx, fi, stream = decode_p(bin_path)
                dec = p_runtime.decompress(dpb, stream, seq.height, seq.width,
                                           q_in_ckpt, q_idx, fi)
                # the next frame's encoder predicts from the DECODER's DPB,
                # clamped like the reference (its in-place clamp_ reaches
                # the DPB)
                dpb = dict(dec["dpb"])
                x_hat = torch.clamp(dpb["ref_frame"], 0.0, 1.0)
                dpb["ref_frame"] = x_hat
            else:
                out = p_runtime.forward_one_frame(x, dpb, cfg.q_in_ckpt,
                                                  q_index_p, frame_idx)
                t1 = now()
                dpb = dict(out["dpb"])
                x_hat = torch.clamp(dpb["ref_frame"], 0.0, 1.0)
                dpb["ref_frame"] = x_hat
                _finish_pending()
                pending = (frame_idx, x_hat, out["bit"], frame, t0, t1)
        if cfg.write_stream:
            recon = _recon_hwc(x_hat, seq.height, seq.width)
            _record_frame(frame, recon, bit, t0, t1, now(), frame_idx)

    _finish_pending()
    reader.close()
    if recon_writer is not None:
        recon_writer.close()

    summary = summarize_sequence(frame_results, is_i,
                                 verbose=cfg.verbose >= 2,
                                 test_time=time.time() - seq_t0)
    summary["name"] = seq.name
    if cfg.verbose:
        print(f"{seq.name}: bpp={summary['ave_all_frame_bpp']:.4f} "
              f"psnr={summary['ave_all_frame_psnr']:.3f}")
    return summary


def load_dataset_config(cfg_json: dict) -> list[SequenceSpec]:
    """Reference dataset-config schema (dataset_config_example_rgb.json)."""
    specs = []
    root = cfg_json.get("root_path", "")
    for cls in cfg_json.get("test_classes", {}).values():
        if not cls.get("test", 1):
            continue
        for seq_name, s in cls.get("sequences", {}).items():
            src_type = cls.get("src_type", "png")
            base = os.path.join(root, cls.get("base_path", ""), seq_name)
            if src_type == "yuv420" and not base.lower().endswith(".yuv"):
                base += ".yuv"
            if src_type == "rgb" and not base.lower().endswith(".rgb"):
                base += ".rgb"
            specs.append(SequenceSpec(
                name=seq_name, base_path=base,
                width=s["width"], height=s["height"],
                frames=s["frames"], gop=s.get("gop", 32),
                src_type=src_type,
                bit_depth=int(cls.get("bit_depth", s.get("bit_depth", 8)))))
    return specs
