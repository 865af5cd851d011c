"""Training / validation datasets (numpy host pipeline).

The port's own copy of ``dcvc_tpu/training/data.py``: the same numpy code,
so the same seeds give bit-identical batches. Parity target: the fork's
dataloader (DCVC-HEM/dataloader.py:21-289): VimeoDataset (septuplet list,
random crop 256, hflip, shared per-gop augmentation seed) and VideoTestData
(per-GOP items over the standard test sets). Batches are NHWC float32 in
[0, 1], clip-shaped [B, T, H, W, 3]; the trainer moves them to NCHW on the
device. PNGs go through ``utils/png.py`` (no Pillow).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..utils.png import read_png, write_png


class VimeoDataset:
    """Vimeo-90k septuplet clips with shared-seed crop + hflip."""

    def __init__(self, root: str, list_file: str = "sep_trainlist.txt",
                 frames: int = 7, crop: int = 256, seed: int = 0):
        self.root = Path(root)
        list_path = self.root / list_file
        if list_path.is_file():
            with open(list_path) as f:
                self.items = [ln.strip() for ln in f if ln.strip()]
        else:  # fall back to directory scan
            seq_dir = self.root / "sequences"
            base = seq_dir if seq_dir.is_dir() else self.root
            self.items = sorted(
                str(p.relative_to(base))
                for p in base.glob("*/*") if p.is_dir())
            self.root = base
        self.frames = frames
        self.crop = crop
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.items)

    def _load_clip(self, item: str, rng: np.random.Generator) -> np.ndarray:
        base = self.root / "sequences" / item
        if not base.is_dir():
            base = self.root / item
        frames = []
        for i in range(1, self.frames + 1):
            frames.append(read_png(base / f"im{i}.png").astype(np.float32)
                          / 255.0)
        clip = np.stack(frames)  # [T, H, W, 3]
        T, H, W, _ = clip.shape
        c = self.crop
        # shared per-gop augmentation (dataloader.py: same seed for all frames)
        top = int(rng.integers(0, max(H - c, 0) + 1))
        left = int(rng.integers(0, max(W - c, 0) + 1))
        clip = clip[:, top:top + c, left:left + c]
        if rng.random() < 0.5:
            clip = clip[:, :, ::-1]
        if rng.random() < 0.5:
            clip = clip[::-1]  # temporal flip (common aug)
        return np.ascontiguousarray(clip)

    def batches(self, batch_size: int, steps: int, num_workers: int = 4):
        """Yield [B, T, c, c, 3] batches for ``steps`` iterations."""
        with ThreadPoolExecutor(num_workers) as pool:
            for _ in range(steps):
                picks = self.rng.choice(len(self.items), batch_size)
                seeds = self.rng.integers(0, 2 ** 31, batch_size)
                clips = list(pool.map(
                    lambda iv: self._load_clip(
                        self.items[iv[0]], np.random.default_rng(iv[1])),
                    zip(picks, seeds)))
                yield np.stack(clips)


class VideoTestData:
    """Per-GOP test-set items over the runner's JSON dataset config.

    Equivalent of the fork's ``VideoTestData`` (DCVC-HEM/dataloader.py:
    110-215): each item is one GOP of one test sequence,
    ``(dataset_name, seq_name, clip[T, H, W, 3] float32, frame_start)``.
    ``first_gop=True`` keeps only the first GOP of every sequence — the
    fork's per-epoch validation protocol (train_CANFVC_DMC.py:241-320).

    As in the JAX package: instead of the fork's hardcoded UVG/HEVC
    sequence tables, GOPs are enumerated from the same JSON schema the
    eval harness uses (``load_dataset_config``), so any configured test
    set works; frames come through the PNG/YUV readers (YUV converts to
    RGB like the eval path).
    """

    def __init__(self, cfg_json: dict, first_gop: bool = False,
                 gop: int | None = None, classes=None):
        from ..runner.video import load_dataset_config
        from ..utils import color as _color
        from ..utils.video_io import PNGReader, YUVReader

        self._color = _color
        self._PNGReader, self._YUVReader = PNGReader, YUVReader
        specs = load_dataset_config(cfg_json)
        if classes is not None:
            # map class label -> sequence membership from the raw config
            keep = set()
            for cls_name, cls in cfg_json.get("test_classes", {}).items():
                if cls_name in classes:
                    keep.update(cls.get("sequences", {}).keys())
            specs = [s for s in specs if s.name in keep]
        self._class_of = {}
        for cls_name, cls in cfg_json.get("test_classes", {}).items():
            for seq_name in cls.get("sequences", {}).keys():
                self._class_of[seq_name] = cls_name
        self.gop_list = []
        for spec in specs:
            g = gop or spec.gop
            n_gops = 1 if first_gop else max(spec.frames // g, 1)
            for gop_idx in range(n_gops):
                start = g * gop_idx
                end = min(start + g, spec.frames)
                self.gop_list.append((spec, start, end))

    def __len__(self):
        return len(self.gop_list)

    def _read_clip(self, spec, start: int, end: int) -> np.ndarray:
        frames = []
        if spec.src_type == "png":
            reader = self._PNGReader(spec.base_path, spec.width, spec.height,
                                     start_num=1 + start)
            for _ in range(end - start):
                frames.append(reader.read_one_frame())  # HWC [0,1]
        else:
            reader = self._YUVReader(spec.base_path, spec.width, spec.height,
                                     skip_frame=start)
            for _ in range(end - start):
                y, uv = reader.read_one_frame()
                frames.append(self._color.ycbcr420_to_rgb(y, uv, order=0))
        reader.close()
        return np.stack(frames).astype(np.float32)

    def __getitem__(self, idx: int):
        spec, start, end = self.gop_list[idx]
        clip = self._read_clip(spec, start, end)
        return (self._class_of.get(spec.name, ""), spec.name, clip, start)

    def batches(self, batch_size: int, steps: int, **_):
        """Trainer-validation surface: yields [1, T, H, W, 3] GOP clips,
        one sequence-GOP per batch (resolutions differ across sequences, so
        the fork also validates at batch size 1)."""
        for i in range(min(steps, len(self.gop_list))):
            _, _, clip, _ = self[i % len(self.gop_list)]
            yield clip[None]


class CodedIFrameData(VideoTestData):
    """``VideoTestData`` whose GOP items carry a CODEC-RECONSTRUCTED
    I-frame (P-frames stay pristine).

    Equivalent of the fork's ``BitstreamData(load_Iframe=True)``
    (DCVC-HEM/dataloader.py:216-253), which shells out to ``bpgenc``/
    ``bpgdec`` per I-frame and caches the decoded PNG under
    ``bpg/<qp>/decoded/``. As in the JAX package, the I-frame recon comes
    from one of the package's intra codecs (any ``coder(frame) -> recon``
    callable, e.g. a closure over a ``runner/adapters.py`` I-frame
    adapter), so P-frame training sees
    the same I-frame artifacts the deployed codec produces; recons are
    cached as 8-bit PNGs under ``<cache_root>/<tag>/<seq>/frame_<idx>.png``
    keyed by the caller's ``tag`` (the qp analogue).
    """

    def __init__(self, cfg_json: dict, coder, tag: str = "q0",
                 cache_root: str = "out/iframe_cache", **kw):
        super().__init__(cfg_json, **kw)
        self.coder = coder
        self.cache_dir = Path(cache_root) / tag

    def _coded_iframe(self, spec, start: int,
                      frame: np.ndarray) -> np.ndarray:
        path = self.cache_dir / spec.name / f"frame_{start}.png"
        if path.is_file():
            return read_png(path).astype(np.float32) / 255.0
        recon = np.asarray(self.coder(frame), np.float32)
        recon = recon.reshape(frame.shape)  # tolerate [1,H,W,3] returns
        path.parent.mkdir(parents=True, exist_ok=True)
        write_png(path, (np.clip(recon, 0, 1) * 255 + 0.5).astype(np.uint8))
        # return the round-tripped 8-bit frame so cache hits and misses are
        # bit-identical (the fork always reloads the decoded PNG)
        return (np.clip(recon, 0, 1) * 255 + 0.5).astype(np.uint8) \
            .astype(np.float32) / 255.0

    def __getitem__(self, idx: int):
        spec, start, end = self.gop_list[idx]
        clip = self._read_clip(spec, start, end)
        clip[0] = self._coded_iframe(spec, start, clip[0])
        return (self._class_of.get(spec.name, ""), spec.name, clip, start)


class MotionClips:
    """Synthetic clips with KNOWN per-pixel motion (global pan + layered
    moving rectangles), for motion-path training/evaluation without a
    dataset.

    Frame t samples a fixed textured base at ``x + t*v(x)``: the 0→1 flow
    field is exactly ``v`` for ANY spatially-varying v (``f1(x) =
    base(x + v(x)) = f0(x + v(x))``), so SPyNet can be supervised directly.
    ``batches`` yields [B, T, H, W, 3]; ``batches_with_flow`` adds the
    ground-truth 0→1 backward flow [B, H, W, 2].
    """

    def __init__(self, crop: int = 128, frames: int = 3, max_v: float = 5.0,
                 n_objects: int = 2, pool: int = 256, seed: int = 0):
        self.crop, self.frames, self.max_v = crop, frames, max_v
        self.n_objects, self.pool_size = n_objects, pool
        self.rng = np.random.default_rng(seed)
        self._pool: list[tuple[np.ndarray, np.ndarray]] | None = None

    def _make_clip(self):
        from scipy import ndimage

        c, T, rng = self.crop, self.frames, self.rng
        m = int(np.ceil(self.max_v * T)) + 2  # margin for sampling
        Hb, Wb = c + 2 * m, c + 2 * m
        # multi-scale texture (pure white noise has no trackable structure)
        base = np.zeros((Hb, Wb, 3), np.float32)
        for sigma, amp in ((1.5, 1.0), (6.0, 1.0), (24.0, 0.7)):
            base += amp * ndimage.gaussian_filter(
                rng.random((Hb, Wb, 3)).astype(np.float32), (sigma, sigma, 0))
        base = (base - base.min()) / (base.max() - base.min() + 1e-9)
        # velocity field: global pan + rigid rectangles with own velocities
        v = np.empty((c, c, 2), np.float32)
        v[:] = rng.uniform(-self.max_v, self.max_v, 2)
        for _ in range(self.n_objects):
            h = int(rng.integers(c // 8, c // 3))
            w = int(rng.integers(c // 8, c // 3))
            top = int(rng.integers(0, c - h))
            left = int(rng.integers(0, c - w))
            v[top:top + h, left:left + w] = rng.uniform(
                -self.max_v, self.max_v, 2)
        ys, xs = np.mgrid[0:c, 0:c].astype(np.float32)
        clip = np.empty((T, c, c, 3), np.float32)
        for t in range(T):
            sx = xs + m + t * v[..., 0]
            sy = ys + m + t * v[..., 1]
            for ch in range(3):
                clip[t, ..., ch] = ndimage.map_coordinates(
                    base[..., ch], [sy, sx], order=1, mode="nearest")
        return clip, v

    def _pool_items(self):
        if self._pool is None:
            self._pool = [self._make_clip() for _ in range(self.pool_size)]
        return self._pool

    def batches(self, batch_size: int, steps: int, **_):
        for clips, _ in self.batches_with_flow(batch_size, steps):
            yield clips

    def batches_with_flow(self, batch_size: int, steps: int):
        pool = self._pool_items()
        for _ in range(steps):
            idx = self.rng.integers(0, len(pool), batch_size)
            yield (np.stack([pool[i][0] for i in idx]),
                   np.stack([pool[i][1] for i in idx]))


class SyntheticClips:
    """Deterministic synthetic clips for harness smoke tests (no dataset)."""

    def __init__(self, crop: int = 64, frames: int = 3, seed: int = 0):
        self.crop, self.frames = crop, frames
        self.rng = np.random.default_rng(seed)

    def batches(self, batch_size: int, steps: int, **_):
        c, T = self.crop, self.frames
        for _ in range(steps):
            base = self.rng.random((batch_size, 1, c // 8 + 2, c // 8 + 2, 3))
            big = np.repeat(np.repeat(base, 8, axis=2), 8, axis=3)
            clip = np.concatenate(
                [big[:, :, s:s + c, s:s + c] for s in range(T)], axis=1)
            clip += self.rng.normal(0, 0.02, clip.shape)
            yield np.clip(clip, 0, 1).astype(np.float32)
