"""Compare measured RD results against the published reference anchors:
parity with ``tools/rd_compare.py`` (EVC/results/RD_numbers.py's anchors,
as a BD-rate / BD-PSNR report instead of a matplotlib figure). Host only.

    python -m dcvc_tpu_torch.tools.rd_compare --results out/image.json \\
        [--anchor EncS_DecS]

(an image results JSON of ``dcvc_tpu_torch.tools.test_image`` with
``--rate_num`` >= 4)
"""

from __future__ import annotations

import argparse
import json

from ..utils.rd_numbers import EVC_KODAK, bd_psnr, bd_rate


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--results", required=True,
                   help="image results JSON (the image CLI's output)")
    p.add_argument("--anchor", default="EncS_DecS", choices=sorted(EVC_KODAK))
    args = p.parse_args(argv)

    with open(args.results) as f:
        res = json.load(f)
    avg = res["average"]
    rates = sorted(avg, key=lambda k: int(k.split("_")[1]))
    bpp = [avg[r]["bpp"] for r in rates]
    psnr = [avg[r]["psnr"] for r in rates]
    print(f"measured: bpp={['%.3f' % b for b in bpp]} "
          f"psnr={['%.2f' % q for q in psnr]}")
    a = EVC_KODAK[args.anchor]
    print(f"anchor {args.anchor}: bpp={a['bpp']} psnr={a['psnr']}")
    if len(bpp) < 4:
        print("need >= 4 rate points for a stable BD fit; skipping deltas")
        return
    try:
        print(f"BD-rate vs anchor: {bd_rate(a['bpp'], a['psnr'], bpp, psnr):+.2f}%")
        print(f"BD-PSNR vs anchor: {bd_psnr(a['bpp'], a['psnr'], bpp, psnr):+.3f} dB")
    except ValueError as e:
        print(f"BD metrics unavailable: {e}")


if __name__ == "__main__":
    main()
