"""Convert YUV420 sequences to PNG frame folders: parity with
``tools/data_to_png.py`` (DCVC-DC/test_data_to_png.py). Host only; PNGs
are written by ``utils/png.py`` (no Pillow).

    python -m dcvc_tpu_torch.tools.data_to_png --src seq.yuv --width W \\
        --height H --dst frames/
    python -m dcvc_tpu_torch.tools.data_to_png --test_config cfg.json \\
        [--dst_root png_out]
"""

from __future__ import annotations

import argparse
import json
import os


def convert_one_seq_to_png(src_path, width, height, dst_path) -> int:
    """Writes ``dst_path/imNNNNN.png`` per frame; returns the frame count."""
    from ..utils import color
    from ..utils.video_io import PNGWriter, YUVReader

    reader = YUVReader(src_path, width, height)
    writer = PNGWriter(dst_path, width, height)
    n = 0
    while True:
        y, uv = reader.read_one_frame()
        if y is None:
            break
        writer.write_one_frame(color.ycbcr420_to_rgb(y, uv))
        n += 1
    reader.close()
    print(f"{src_path}: {n} frames -> {dst_path}")
    return n


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", help="one .yuv file")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--dst", help="destination folder for --src")
    p.add_argument("--test_config",
                   help="dataset config JSON: convert every yuv420 sequence "
                        "into <dst_root>/<seq>/imNNNNN.png")
    p.add_argument("--dst_root", default="png_out")
    args = p.parse_args(argv)

    if args.src:
        convert_one_seq_to_png(args.src, args.width, args.height, args.dst)
        return
    if not args.test_config:
        p.error("need --src or --test_config")
    with open(args.test_config) as f:
        cfg = json.load(f)
    root = cfg.get("root_path", "")
    for cls in cfg["test_classes"].values():
        if not cls.get("test", 1) or cls.get("src_type") != "yuv420":
            continue
        for name, seq in cls["sequences"].items():
            src = os.path.join(root, cls.get("base_path", ""), name)
            convert_one_seq_to_png(src, seq["width"], seq["height"],
                                   os.path.join(args.dst_root,
                                                os.path.splitext(name)[0]))


if __name__ == "__main__":
    main()
