"""Image RD evaluation CLI of the port: parity with ``tools/test_image.py``
(and EVC/test_image.py:73-423).

Runs an intra codec over the ``*.png`` images of a folder x rate points,
reports bpp / PSNR / MS-SSIM and encode / decode latency, and writes the
results JSON ``{"per_image": {image: {rate_i: ...}}, "average": {rate_i:
...}}``.

    python -m dcvc_tpu_torch.tools.test_image --model evc_LL \\
        --img_folder imgs [--device cuda|cpu] [--write_stream 1] ...

Models: the EVC grid ``evc_XY``, ``evc_scalable``, ``intra_hem``,
``intra_dc`` and the CompressAI zoo (``bmshj2018-factorized``,
``bmshj2018-hyperprior``, ``mbt2018-mean``, ``mbt2018``,
``cheng2020-anchor``). Runs on the card unless ``--device cpu``; without a
card it exits with the device message. Weights are seeded random unless
``--model_path`` names a published ``.pth`` / ``.pth.tar`` or a
JAX-package ``.npz``. Images are read without Pillow (``utils/png.py``) and
edge-padded to a multiple of 64. Rate points: EVC and HEM models
log-interpolate ``rate_num`` q_scales between the first and last anchor of
the checkpoint's ``q_scale``, rounded to 1/100 for streams
(``get_rounded_q``) and decoded as ``q_index / 100``; ``intra_dc`` takes
``rate_num`` q_indexes of its 64-point fine table; a zoo model is one
checkpoint per rate, so it codes one rate point, its latents' strings in
``encode_i_strings``'s container.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", type=str, default="evc_LL")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--img_folder", type=str, required=True)
    p.add_argument("--rate_num", type=int, default=4)
    p.add_argument("--write_stream", type=int, default=0)
    p.add_argument("--stream_path", type=str, default="bitstreams")
    p.add_argument("--calc_ssim", type=int, default=0)
    p.add_argument("--output_path", type=str, default="out/image_results.json")
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _q_scales(rt, rate_num: int):
    """Rate points: fine-table q_indexes (intra_dc), log-interpolated
    q_scale anchors (EVC, HEM) or the zoo model's one rate (None)."""
    from ..models.runtime import IntraDcRuntime, IntraZooRuntime

    if isinstance(rt, IntraZooRuntime):
        if rate_num > 1:
            print(f"{type(rt.module).__name__} is a per-rate model; running "
                  f"1 rate point")
        return [None]
    if isinstance(rt, IntraDcRuntime):
        return ([int(round(v)) for v in np.linspace(0, 63, rate_num)]
                if rate_num > 1 else [0])
    anchors = rt.module.q_scale.detach().cpu().numpy().reshape(-1)
    return (np.exp(np.linspace(np.log(anchors[0]), np.log(anchors[-1]),
                               rate_num)) if rate_num > 1 else anchors[:1])


def _code(rt, x, h, w, q, bin_path, write_stream: bool):
    """One image at one rate point: ``(bits, x_hat, t_encoded)``;
    ``t_encoded`` is the clock after the encode (or the estimated-bits
    forward), read after the card finished it."""
    from ..models.runtime import IntraDcRuntime
    from ..utils import stream

    is_dc = isinstance(rt, IntraDcRuntime)
    if not write_stream:
        if q is None:
            out = rt.forward(x)
        elif is_dc:
            out = rt.forward(x, q_in_ckpt=False, q_index=int(q))
        else:
            out = rt.forward(x, float(q))
        return float(out["bit"]), out["x_hat"], _clock(x)
    if q is None:  # a per-rate zoo model
        comp = rt.compress(x)
        stream.encode_i_strings(h, w, comp["strings"], bin_path)
        t1 = _clock(x)
        hh, ww, strings = stream.decode_i_strings(bin_path)
        x_hat = rt.decompress(strings, rt.latent_shape(hh, ww))["x_hat"]
    elif is_dc:
        comp = rt.compress(x, q_in_ckpt=False, q_index=int(q))
        stream.encode_i(h, w, False, int(q), comp["bit_stream"], bin_path)
        t1 = _clock(x)
        hh, ww, q_in_ckpt, q_idx, s = stream.decode_i(bin_path)
        x_hat = rt.decompress(s, hh, ww, q_in_ckpt, q_idx)["x_hat"]
    else:
        q_rounded, q_index = stream.get_rounded_q(float(q))
        comp = rt.compress(x, q_rounded)
        stream.encode_i_ushort_q(h, w, q_index, comp["bit_stream"], bin_path)
        t1 = _clock(x)
        hh, ww, q_idx, s = stream.decode_i_ushort_q(bin_path)
        x_hat = rt.decompress(s, hh, ww, q_idx / 100)["x_hat"]
    return stream.filesize(bin_path) * 8, x_hat, t1


def _clock(x) -> float:
    import torch

    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return time.time()


def main(argv=None) -> dict:
    """Runs the CLI; returns the results dict it also writes as JSON."""
    args = parse_args(argv)
    import torch

    from ..device import resolve_device
    from ..models.registry import build
    from ..ops.warp import get_padding_size
    from ..utils import metrics
    from ..utils.checkpoint import load_state_dict
    from ..utils.png import read_png
    from ..utils.results import dump_json

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"error: {e}")
    images = sorted(glob.glob(os.path.join(args.img_folder, "*.png")))
    if not images:
        sys.exit(f"error: no .png images found in {args.img_folder}")

    state_dict = (load_state_dict(args.model_path, args.model)
                  if args.model_path else None)
    _, rt = build(args.model, device=device, state_dict=state_dict)
    rt.update(force=True)
    q_scales = _q_scales(rt, args.rate_num)
    if args.write_stream:
        os.makedirs(args.stream_path, exist_ok=True)

    results = {}
    for img_path in images:
        name = os.path.basename(img_path)
        img = read_png(img_path).astype(np.float32) / 255.0
        h, w = img.shape[:2]
        l, r, t, b = get_padding_size(h, w, 64)
        padded = np.pad(img, ((t, b), (l, r), (0, 0)), mode="edge")
        x = torch.from_numpy(padded.transpose(2, 0, 1)[None].copy()).to(device)

        for rate_idx, q in enumerate(q_scales):
            bin_path = os.path.join(args.stream_path, f"{name}_{rate_idx}.bin")
            t0 = _clock(x)
            bit, x_hat, t1 = _code(rt, x, h, w, q, bin_path,
                                   bool(args.write_stream))
            recon = x_hat[0, :, :h, :w].permute(1, 2, 0).cpu().numpy()
            t2 = time.time()
            fr = {
                "bpp": bit / (h * w),
                "psnr": metrics.calc_psnr(img, recon, data_range=1),
                "enc_time": t1 - t0,
                "dec_time": t2 - t1,
                "latency": t2 - t0,
            }
            if args.calc_ssim:
                fr["msssim"] = metrics.calc_msssim_rgb(img, recon, data_range=1)
            results.setdefault(name, {})[f"rate_{rate_idx}"] = fr
            if args.verbose:
                print(f"{name} rate{rate_idx}: bpp={fr['bpp']:.4f} "
                      f"psnr={fr['psnr']:.2f} latency={fr['latency']:.3f}s")

    # RD averaging over images per rate (avg_imagejson)
    avg = {}
    for rate_idx in range(len(q_scales)):
        keys = [v[f"rate_{rate_idx}"] for v in results.values()]
        avg[f"rate_{rate_idx}"] = {
            k: float(np.mean([f[k] for f in keys])) for k in keys[0]}
    out = {"per_image": results, "average": avg}
    dump_json(out, args.output_path)
    print(f"results -> {args.output_path}")
    return out


if __name__ == "__main__":
    main()
