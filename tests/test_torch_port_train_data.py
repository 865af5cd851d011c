"""The port's training datasets give the JAX package's batches bit for bit
(the same numpy code on the same seeds), on the CPU.

``SyntheticClips`` and ``MotionClips`` (with its ground-truth flow) from
their seeds; ``VimeoDataset`` over septuplet PNGs written in ``tmp_path``
(the port reads them with ``utils/png.py``, the JAX package with Pillow)
through its list file and its directory scan; ``VideoTestData`` over a
reference-schema config of a PNG and a YUV420 sequence; ``CodedIFrameData``
with the same I-frame coder (the 8-bit cached recon, a cache miss then a
hit). Tolerance: exact.
"""

import json

import numpy as np
import pytest

from dcvc_tpu.training import data as jdata
from dcvc_tpu_torch.training import data as tdata
from dcvc_tpu_torch.utils.png import write_png


def _same(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


def test_synthetic_and_motion_clips_bit_equal():
    _same(tdata.SyntheticClips(crop=32, frames=3, seed=5).batches(2, 3),
          jdata.SyntheticClips(crop=32, frames=3, seed=5).batches(2, 3))
    kw = dict(crop=32, frames=3, max_v=3.0, n_objects=2, pool=3, seed=6)
    t = list(tdata.MotionClips(**kw).batches_with_flow(2, 2))
    j = list(jdata.MotionClips(**kw).batches_with_flow(2, 2))
    _same([c for c, _ in t], [c for c, _ in j])
    _same([f for _, f in t], [f for _, f in j])
    _same(tdata.MotionClips(**kw).batches(2, 2),
          jdata.MotionClips(**kw).batches(2, 2))


def _septuplets(root, n_seq=3, H=40, W=48, seed=7):
    rng = np.random.default_rng(seed)
    items = []
    for s in range(n_seq):
        item = f"{s:05d}/{s + 1:04d}"
        d = root / "sequences" / item
        d.mkdir(parents=True)
        for i in range(1, 8):
            write_png(d / f"im{i}.png",
                      rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        items.append(item)
    return items


@pytest.mark.parametrize("with_list", [True, False])
def test_vimeo_dataset_bit_equal(tmp_path, with_list):
    items = _septuplets(tmp_path)
    if with_list:
        (tmp_path / "sep_trainlist.txt").write_text("\n".join(items) + "\n")
    t = tdata.VimeoDataset(str(tmp_path), crop=32, seed=8)
    j = jdata.VimeoDataset(str(tmp_path), crop=32, seed=8)
    assert t.items == j.items and len(t) == 3
    _same(t.batches(2, 3, num_workers=2), j.batches(2, 3, num_workers=2))


def _config(tmp_path, H=32, W=48, frames=5):
    rng = np.random.default_rng(9)
    png = tmp_path / "png" / "seqA"
    png.mkdir(parents=True)
    for i in range(1, frames + 1):
        write_png(png / f"im{i}.png",
                  rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    yuv = tmp_path / "yuv"
    yuv.mkdir()
    planes = rng.integers(0, 256, frames * H * W * 3 // 2, dtype=np.uint8)
    (yuv / "seqB.yuv").write_bytes(planes.tobytes())
    return {"root_path": str(tmp_path), "test_classes": {
        "P": {"test": 1, "base_path": "png", "src_type": "png",
              "sequences": {"seqA": {"width": W, "height": H,
                                     "frames": frames, "gop": 2}}},
        "Y": {"test": 1, "base_path": "yuv", "src_type": "yuv420",
              "sequences": {"seqB": {"width": W, "height": H,
                                     "frames": frames, "gop": 4}}}}}


def test_video_test_data_bit_equal(tmp_path):
    cfg = json.loads(json.dumps(_config(tmp_path)))
    for kw in ({}, {"first_gop": True}, {"gop": 3, "classes": ["P"]}):
        t, j = tdata.VideoTestData(cfg, **kw), jdata.VideoTestData(cfg, **kw)
        assert len(t) == len(j) > 0
        for i in range(len(j)):
            ti, ji = t[i], j[i]
            assert ti[:2] == ji[:2] and ti[3] == ji[3]
            np.testing.assert_array_equal(ti[2], ji[2])
        _same(t.batches(1, 4), j.batches(1, 4))


def test_coded_iframe_data_bit_equal(tmp_path):
    """The same coder (a deterministic filter standing in for an I-frame
    codec): the 8-bit round-tripped recon on a cache miss and on the hit
    that follows, in each package's own cache."""
    cfg = _config(tmp_path)

    def coder(frame):
        return np.clip(frame * 0.9 + 0.03, 0, 1)[None]

    for _ in ("miss", "hit"):
        t = tdata.CodedIFrameData(cfg, coder, cache_root=str(tmp_path / "t"),
                                  first_gop=True)
        j = jdata.CodedIFrameData(cfg, coder, cache_root=str(tmp_path / "j"),
                                  first_gop=True)
        for i in range(len(j)):
            np.testing.assert_array_equal(t[i][2], j[i][2])
        assert (tmp_path / "t" / "q0" / "seqA" / "frame_0.png").is_file()
