"""Warm codec server CLI of the port: parity with ``tools/serve.py``.

    python -m dcvc_tpu_torch.tools.serve --socket /tmp/dcvc.sock \\
        --i_frame_model intra_dc --p_frame_model dmc_dc \\
        [--model_path_i intra.pth --model_path_p dmc.pth] \\
        [--warmup 1080 1920] [--device cuda|cpu]

Builds the codec(s) once, optionally warms them at the given resolution
(the block-warp kernel's library is built at first use, the CDF tables
baked), then serves encode / decode requests until a client sends
``shutdown`` (``dcvc_tpu_torch/serving/``). Runs on the card unless
``--device cpu``; without a card it exits with the device message. Weights
are seeded random unless ``--model_path_i`` / ``--model_path_p`` name a
published ``.pth`` or a JAX-package ``.npz``.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--socket", required=True)
    p.add_argument("--i_frame_model", default="evc_SS")
    p.add_argument("--p_frame_model", default=None)
    p.add_argument("--model_path_i", default=None)
    p.add_argument("--model_path_p", default=None)
    p.add_argument("--ec_thread", type=int, default=0)
    p.add_argument("--stream_part", type=int, default=1)
    p.add_argument("--od_warp", default="auto",
                   help="OffsetDiversity warp mode (dmc_dc): 'auto' = the "
                        "block kernel on the card, exact on the CPU")
    p.add_argument("--warmup", type=int, nargs=2, metavar=("H", "W"),
                   default=None, help="warm the codecs at this resolution")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from ..serving import CodecServer

    try:
        server = CodecServer(
            i_frame_model=args.i_frame_model,
            p_frame_model=args.p_frame_model,
            model_path_i=args.model_path_i, model_path_p=args.model_path_p,
            ec_thread=bool(args.ec_thread), stream_part=args.stream_part,
            od_warp=args.od_warp, device=args.device)
    except RuntimeError as e:
        sys.exit(f"error: {e}")
    if args.warmup:
        print(f"warming up at {args.warmup[0]}x{args.warmup[1]} ...",
              flush=True)
        server.warmup(*args.warmup)
    print(f"serving on {args.socket}", flush=True)
    server.serve(args.socket)


if __name__ == "__main__":
    main()
