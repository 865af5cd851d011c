"""Video RD evaluation CLI of the port: parity with ``tools/test_video.py``
(and DCVC-DC/test_video.py:26-56).

Reads a JSON dataset config (reference schema), codes each (sequence x
rate) item with the I/P codec pair through the GOP runner, and writes the
nested results JSON (``{seq: {rate_i: summary}}``). Rate points are
q_indexes of the checkpoint anchors (q_in_ckpt) or of the 64-point fine
table (rate_num up to 64).

    python -m dcvc_tpu_torch.tools.test_video --test_config cfg.json \\
        [--device cuda|cpu] [--write_stream 1] [--model_path_i I.pth] ...

I-frame models: ``intra_dc``, the EVC grid ``evc_XY``, ``evc_scalable``,
``intra_hem`` and the CompressAI zoo (``bmshj2018-factorized``,
``bmshj2018-hyperprior``, ``mbt2018-mean``, ``mbt2018``,
``cheng2020-anchor``); P-frame models: ``dmc_dc``, ``dmc_hem``,
``canfvc_dmc``, ``dmc_tcm`` and ``dcvc_gen1``. A write-stream pair pads
alike: ``intra_dc`` + ``dmc_dc`` pad to 16, every other pair to 64.
Runs on the card unless ``--device cpu``; without a card it exits with the
device message. ``--worker_num N`` codes the items in N spawned processes,
worker ``w`` on ``cuda:{w % device count}`` (or the CPU with ``--device
cpu``). Weights are seeded random unless ``--model_path_i`` /
``--model_path_p`` name a published ``.pth`` / ``.pth.tar`` or a JAX-package
``.npz``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_path_i", type=str, default=None)
    p.add_argument("--model_path_p", type=str, default=None)
    p.add_argument("--i_frame_model", type=str, default="intra_dc")
    p.add_argument("--p_frame_model", type=str, default="dmc_dc")
    p.add_argument("--rate_num", type=int, default=4)
    p.add_argument("--q_indexes", type=int, nargs="+", default=None)
    p.add_argument("--test_config", type=str, required=True)
    p.add_argument("--force_intra", action="store_true")
    p.add_argument("--force_intra_period", type=int, default=0)
    p.add_argument("--force_frame_num", type=int, default=-1)
    p.add_argument("--write_stream", type=int, default=0)
    p.add_argument("--stream_path", type=str, default="bitstreams")
    p.add_argument("--decoded_frame_path", type=str, default=None)
    p.add_argument("--calc_ssim", type=int, default=0)
    p.add_argument("--yuv420", type=int, default=0)
    p.add_argument("--ec_thread", type=int, default=0)
    p.add_argument("--stream_part_i", type=int, default=1)
    p.add_argument("--stream_part_p", type=int, default=1)
    p.add_argument("--aligned_enc", type=int, default=None,
                   help="1: derive P-frame coding indexes from the decoder's "
                        "own chain (the P runtime's aligned_enc). Defaults to "
                        "the DCVC_TPU_ALIGNED_ENC env setting")
    p.add_argument("--output_path", type=str, default="out/results.json")
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--worker_num", type=int, default=1,
                   help="process pool over (sequence x rate) items "
                        "(reference test_video.py:276-338): each spawned "
                        "worker builds its own runtimes once and codes a "
                        "round-robin share; worker w runs on cuda:{w %% "
                        "device count}, or on the CPU with --device cpu")
    p.add_argument("--chroma_upsample_order", type=int, default=0,
                   choices=[0, 1],
                   help="420->444 model-input chroma upsample: 0 nearest "
                        "(reference default), 1 bilinear (RD cross-check)")
    p.add_argument("--od_warp", default="auto",
                   help="OffsetDiversity warp mode (dmc_dc): 'auto' = the "
                        "block kernel on the card, exact on the CPU; or "
                        "'exact' / 'tile:T,R[,median|mean]' / "
                        "'block:Dh,Rv[,BH,BW[,base]]' explicitly")
    p.add_argument("--mc_warp", default="auto",
                   help="motion-compensation warp mode (warpframe + context "
                        "warps; dmc_dc, dmc_hem, dmc_tcm, dcvc_gen1): same "
                        "grammar as --od_warp")
    p.add_argument("--me_warp", default="auto",
                   help="SPyNet pyramid warp mode (dmc_dc): same grammar as "
                        "--od_warp")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def _pad_multiple(args) -> int:
    """The frames' pad-to-multiple; exits on a write-stream pair of two
    padding generations."""
    from ..runner.adapters import pad_for_model

    pad_i = pad_for_model(args.i_frame_model)
    pad_p = pad_for_model(args.p_frame_model)
    pad_multiple = pad_i if args.force_intra else max(pad_i, pad_p)
    if args.write_stream and not args.force_intra and pad_i != pad_p:
        # decompress derives latent shapes from each generation's own pad
        # contract; frames padded for the other generation desync the rANS
        # symbol counts. Estimated-bits mode is shape-agnostic and fine.
        sys.exit(f"error: --write_stream needs I/P models from the same "
                 f"padding generation ({args.i_frame_model} pads to {pad_i}, "
                 f"{args.p_frame_model} to {pad_p}); pick a matching intra "
                 f"or use --force_intra")
    return pad_multiple


def _build_runtimes(args, device):
    """Build and adapt the I/P runtimes."""
    from ..models.registry import build
    from ..ops.warp import default_coding_warp_modes
    from ..runner.adapters import adapt_i_runtime, adapt_p_runtime
    from ..utils.checkpoint import load_state_dict

    pad_multiple = _pad_multiple(args)

    def weights(path, model):
        return load_state_dict(path, model) if path else None

    _, i_rt = build(args.i_frame_model, device=device,
                    state_dict=weights(args.model_path_i, args.i_frame_model))
    i_rt.ec_thread, i_rt.stream_part = bool(args.ec_thread), args.stream_part_i
    i_rt.update(force=True)
    i_rt = adapt_i_runtime(i_rt)

    p_rt = None
    if not args.force_intra:
        od_d, mc_d, me_d = default_coding_warp_modes(device)

        def mode(flag, default):
            return default if flag == "auto" else flag

        # each P model takes the warp sites it has, as the JAX CLI passes
        # them (tools/test_video.py:128-138): DMC all three, DMCHem, DMCTcm
        # and DCVCNet the mc warps, CANF none (its warps are exact)
        p_kwargs = {}
        if args.p_frame_model == "dmc_dc":
            p_kwargs.update(od_warp_mode=mode(args.od_warp, od_d),
                            me_warp_mode=mode(args.me_warp, me_d))
        if args.p_frame_model in ("dmc_dc", "dmc_hem", "dmc_tcm",
                                  "dcvc_gen1"):
            p_kwargs["mc_warp_mode"] = mode(args.mc_warp, mc_d)
        _, p_rt = build(args.p_frame_model, device=device,
                        state_dict=weights(args.model_path_p,
                                           args.p_frame_model), **p_kwargs)
        p_rt.ec_thread, p_rt.stream_part = (bool(args.ec_thread),
                                            args.stream_part_p)
        if args.aligned_enc is not None and hasattr(p_rt, "aligned_enc"):
            p_rt.aligned_enc = bool(args.aligned_enc)
        p_rt.update(force=True)
        p_rt = adapt_p_runtime(p_rt)
    return i_rt, p_rt, pad_multiple


def _q_indexes(args):
    if args.q_indexes:
        return args.q_indexes
    if args.rate_num == 4:
        return [0, 1, 2, 3]
    return [int(v) for v in np.linspace(0, 63, args.rate_num)]


def _eval_one(i_rt, p_rt, pad_multiple, seq, q, args):
    from ..runner.video import EvalConfig, run_sequence

    cfg = EvalConfig(
        pad_multiple=pad_multiple,
        intra_period=(1 if args.force_intra else
                      (args.force_intra_period or seq.gop)),
        frame_num=(args.force_frame_num if args.force_frame_num > 0
                   else seq.frames),
        write_stream=bool(args.write_stream),
        stream_path=args.stream_path,
        decoded_path=args.decoded_frame_path,
        calc_ssim=bool(args.calc_ssim),
        yuv420_metrics=bool(args.yuv420),
        verbose=args.verbose,
        q_in_ckpt=(args.rate_num == 4 and not args.q_indexes),
        chroma_upsample_order=args.chroma_upsample_order,
    )
    return run_sequence(i_rt, p_rt, seq, cfg, q_index_i=q, q_index_p=q)


def _pool_worker(args_dict, device, names_rates):
    """One ``--worker_num`` pool process: builds the runtimes once on
    ``device`` and codes a round-robin share of (sequence, rate) items; an
    item's error is recorded in its place (as ``parallel/jobs.run_sharded``
    does) instead of ending the pool."""
    from ..device import resolve_device
    from ..runner.video import load_dataset_config

    args = argparse.Namespace(**args_dict)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with open(args.test_config) as f:
        specs = {s.name: s for s in load_dataset_config(json.load(f))}
    i_rt, p_rt, pad_multiple = _build_runtimes(args, dev)
    q_indexes = _q_indexes(args)
    out = []
    for name, rate_idx in names_rates:
        try:
            s = _eval_one(i_rt, p_rt, pad_multiple, specs[name],
                          q_indexes[rate_idx], args)
        except Exception as e:  # noqa: BLE001
            s = {"error": repr(e)}
        out.append((name, rate_idx, s))
    return out


def _run_pool(args, device, specs, q_indexes) -> dict:
    """The ``--worker_num > 1`` pool: spawned processes (CUDA cannot
    fork), round-robin ``shard_work`` chunks, results merged in the main
    process."""
    import concurrent.futures as cf
    import multiprocessing as mp

    from ..parallel.jobs import shard_work

    items = [(seq.name, r) for seq in specs for r in range(len(q_indexes))]
    n = args.worker_num
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        devices = [f"cuda:{w % cards}" for w in range(n)]
    else:
        devices = ["cpu"] * n
    chunks = [(devices[w], shard_work(items, w, n)) for w in range(n)]
    results = {}
    t0 = time.time()
    with cf.ProcessPoolExecutor(max_workers=n,
                                mp_context=mp.get_context("spawn")) as ex:
        futs = [ex.submit(_pool_worker, vars(args), dev, chunk)
                for dev, chunk in chunks if chunk]
        for f in futs:
            for name, rate_idx, summary in f.result():
                results.setdefault(name, {})[f"rate_{rate_idx}"] = summary
                if args.verbose and "error" not in summary:
                    _print_item(t0, name, rate_idx, summary)
    return results


def _print_item(t0, name, rate_idx, summary):
    print(f"[{time.time() - t0:7.1f}s] {name} rate {rate_idx} "
          f"bpp={summary['ave_all_frame_bpp']:.4f} "
          f"psnr={summary['ave_all_frame_psnr']:.3f}")


def main(argv=None) -> dict:
    """Runs the CLI; returns the results dict it also writes as JSON."""
    args = parse_args(argv)
    from ..device import resolve_device
    from ..runner.video import load_dataset_config
    from ..utils.results import dump_json

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"error: {e}")
    with open(args.test_config) as f:
        specs = load_dataset_config(json.load(f))
    q_indexes = _q_indexes(args)
    if args.worker_num > 1:
        _pad_multiple(args)      # refuse a mismatched pair before spawning
        results = _run_pool(args, device, specs, q_indexes)
        dump_json(results, args.output_path)
        print(f"results -> {args.output_path}")
        return results
    i_rt, p_rt, pad_multiple = _build_runtimes(args, device)

    results = {}
    t0 = time.time()
    for seq in specs:
        for rate_idx, q in enumerate(q_indexes):
            summary = _eval_one(i_rt, p_rt, pad_multiple, seq, q, args)
            results.setdefault(seq.name, {})[f"rate_{rate_idx}"] = summary
            if args.verbose:
                _print_item(t0, seq.name, rate_idx, summary)

    dump_json(results, args.output_path)
    print(f"results -> {args.output_path}")
    return results


if __name__ == "__main__":
    main()
