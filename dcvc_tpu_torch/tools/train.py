"""P-frame training CLI of the port: parity with ``tools/train.py`` (the
fork's train_CANFVC_DMC.py surface).

    python -m dcvc_tpu_torch.tools.train [--model dmc_dc|dmc_hem|canfvc]
        [--device cuda|cpu] [--dataset_root VIMEO] [--steps_per_epoch N]
        [--max_epochs E] [--remat auto|0|1] [--ssim] [--quant_mode noise]

Stages, q-level cycling, cascaded losses and checkpoints live in
``training/trainer.py``; this wires the dataset and the model (seeded
random weights, exact warps) and writes ``<stage>_ep<n>.pth`` and
``history.json`` under ``--workdir``. Runs on the card unless ``--device
cpu``; without a card it exits with the device message.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace

import numpy as np
import torch

MODELS = {"dmc_dc": "dmc_dc", "dmc_hem": "dmc_hem", "canfvc": "canfvc_dmc"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="dmc_dc", choices=list(MODELS))
    p.add_argument("--dataset_root", default=None,
                   help="Vimeo-90k root; synthetic clips if omitted")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--workdir", default="out/train")
    p.add_argument("--restore", default=None,
                   help="a .pth of this trainer, a published checkpoint or "
                        "a JAX-package .npz")
    p.add_argument("--remat", choices=["auto", "0", "1"], default="auto",
                   help="recompute each frame's activations in backward. "
                        "auto: on for the card at crop >= 192")
    p.add_argument("--ssim", action="store_true",
                   help="train on (1 - MS-SSIM)/64 instead of MSE (the "
                        "fork's --ssim, train_CANFVC_DMC.py:74)")
    p.add_argument("--quant_mode", choices=["ste", "noise"], default="ste",
                   help="noise = the fork's training rate surrogate (bits "
                        "from noise-quantized residuals, HEM "
                        "video_model.py:466-471)")
    p.add_argument("--val_config", default=None,
                   help="dataset JSON (test_video schema): per-epoch "
                        "first-GOP validation + best-checkpoint monitor "
                        "(the fork's protocol, train_CANFVC_DMC.py:241)")
    p.add_argument("--val_iframe_model", default=None,
                   help="intra model that codes validation I-frames "
                        "(CodedIFrameData, the fork's BitstreamData / BPG "
                        "equivalent, DCVC-HEM/dataloader.py:216); pristine "
                        "I-frames if omitted")
    p.add_argument("--val_iframe_path", default=None,
                   help="checkpoint (.pth / .npz) for --val_iframe_model")
    p.add_argument("--val_steps", type=int, default=8)
    p.add_argument("--max_epochs", type=int, default=None,
                   help="truncate the stage schedule to this many total "
                        "epochs (the fork's trainer max_epochs)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def schedule_for(use_remat: bool, max_epochs: int | None):
    """``DEFAULT_SCHEDULE`` with ``remat`` set, cut to ``max_epochs`` total
    epochs."""
    from ..training.trainer import DEFAULT_SCHEDULE

    schedule = [replace(st, remat=use_remat) for st in DEFAULT_SCHEDULE]
    if max_epochs is None:
        return schedule
    budget, cut = max_epochs, []
    for st in schedule:
        take = min(st.epochs, budget)
        budget -= take
        if take:
            cut.append(replace(st, epochs=take))
    return cut


def iframe_coder(name: str, path: str | None, device):
    """``frame [H, W, 3] -> recon`` through the port's I-frame adapter of
    registry model ``name`` (rate 0 of its checkpoint anchors)."""
    from ..models.registry import build
    from ..ops.warp import crop_lrtb, get_padding_size, replicate_pad
    from ..runner.adapters import adapt_i_runtime, pad_for_model
    from ..utils.checkpoint import load_state_dict

    sd = load_state_dict(path, name) if path else None
    _, rt = build(name, device=device, state_dict=sd)
    rt.update(force=True)
    i_ad = adapt_i_runtime(rt)
    pad_m = pad_for_model(name)

    @torch.no_grad()
    def coder(frame):
        x = torch.from_numpy(np.asarray(frame, np.float32)).permute(2, 0, 1)
        x = torch.empty((1, *x.shape), device=device).copy_(x[None])
        pads = get_padding_size(x.shape[2], x.shape[3], pad_m)
        out = i_ad.forward(replicate_pad(x, pads), True, 0)
        return crop_lrtb(out["x_hat"], pads)[0].permute(1, 2, 0).cpu().numpy()

    return coder


def main(argv=None):
    """Runs the CLI; returns the trainer."""
    args = parse_args(argv)
    from ..device import resolve_device
    from ..training.data import (CodedIFrameData, SyntheticClips,
                                 VideoTestData, VimeoDataset)
    from ..training.trainer import (PFrameTrainer, build_train_module,
                                    dmc_dc_adapter, hem_adapter)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"error: {e}")
    module = build_train_module(MODELS[args.model], seed=0, device=device)
    if args.remat == "auto":
        use_remat = device.type == "cuda" and args.crop >= 192
    else:
        use_remat = args.remat == "1"
    adapter = dmc_dc_adapter if args.model == "dmc_dc" else hem_adapter
    trainer = PFrameTrainer(module, workdir=args.workdir,
                            apply_adapter=adapter,
                            schedule=schedule_for(use_remat, args.max_epochs),
                            distortion="ssim" if args.ssim else "mse",
                            quant_mode=args.quant_mode, device=device)
    if args.restore:
        trainer.restore(args.restore)

    if args.dataset_root:
        data = VimeoDataset(args.dataset_root, crop=args.crop)
    else:
        print("no --dataset_root: running on synthetic clips (smoke mode)")
        data = SyntheticClips(crop=min(args.crop, 64), frames=5)

    val_data = None
    if args.val_config:
        with open(args.val_config) as f:
            cfg = json.load(f)
        if args.val_iframe_model:
            val_data = CodedIFrameData(
                cfg, iframe_coder(args.val_iframe_model,
                                  args.val_iframe_path, device),
                tag=f"{args.val_iframe_model}_q0", first_gop=True)
        else:
            val_data = VideoTestData(cfg, first_gop=True)

    print(f"remat {'on' if use_remat else 'off'} on {device}")
    trainer.fit(data, batch_size=args.batch_size,
                steps_per_epoch=args.steps_per_epoch,
                val_dataset=val_data, val_steps=args.val_steps)
    return trainer


if __name__ == "__main__":
    main()
