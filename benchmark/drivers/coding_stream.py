"""Closed-loop coding of a seeded stream: each frame (or image) is encoded
with real rANS into a container, then decoded, one after another, for the
window's seconds; the decoder's DPB feeds the next P-frame, in the video
runner's write-stream order. An I-frame opens every ``gop`` frames
(``gop`` 1: an image codec).

The configuration's ``container`` names the stream container and with
it the rate parameter: ``video_q_index`` (``pack_i`` / ``pack_p`` at
``q_index``) or ``image_q_scale`` (``pack_i_ushort_q`` at ``q_scale``).

Traffic parameters (``traffic/<name>.json``): ``height``, ``width``,
``pad`` (the frame is edge-padded to a multiple of it), ``step`` and
``period`` of the pan, ``gop``, ``check`` (how many frames after the
first two are compared with the reference, drawn from the seed below
``check_below``, outside the profiled stretch) and ``trace`` (the first
frame, after frame 1, and the count of the profiled stretch). Set-up codes one frame of each kind (I; the first P
after it; a later P) before the window.

Correctness: after the window the program decodes each sampled frame
and frames 0 and 1 once more from the bytes the window coded, with a tap
on its entropy decoder that keeps every symbol plane it decodes. The
reference then recomputes, from the same input frame and weights, the
reconstruction and the DPB of those frames: frame 0 from its input alone,
frame 1 from the reference's own frame 0, every later P-frame from the
DPB the program's decoder held before it. It follows the program's
symbols (``reference/symbols.py``): each coded latent's symbols are the
decoder's, and each is judged against the reference's own rounding.
``symbol_faults`` counts those that differ other than by a rounding tie
within the limits file's ``tie_delta`` (``tie_symbols``, reported, not
bound); ``recon_gap`` is the largest absolute gap of a decoded
reconstruction, ``feature_gap`` the largest gap of the other DPB tensors
relative to the reference's largest magnitude.
"""

from __future__ import annotations

import contextlib
import itertools
import random
import time

import numpy as np
import torch

from .. import harness
from ..inputs import Frames, make_weights
from ..reference import build as build_reference
from ..reference.counts import conv_flops, k1_bytes
from ..reference.layers import accumulate_f64
from ..reference.symbols import Symbols

CONTAINERS = ("video_q_index", "image_q_scale")
DPB_KEYS = ("ref_frame", "ref_feature", "ref_mv_feature", "ref_y",
            "ref_mv_y")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _moved(dpb, device):
    """``dpb`` (a dict of tensors or None) on ``device``."""
    if dpb is None:
        return None
    return {k: None if v is None else v.to(device) for k, v in dpb.items()}


def _i_dpb(x_hat):
    return {"ref_frame": x_hat, "ref_feature": None, "ref_mv_feature": None,
            "ref_y": None, "ref_mv_y": None}


def weights(cfg: dict, seed: int, device) -> dict:
    """Seeded weights of each model the configuration names, keyed by
    registry name (one generator seed per model)."""
    out = {}
    for k, name in enumerate(cfg["models"].values()):
        with torch.device("meta"):
            layout = build_reference(name, cfg)
        out[name] = make_weights(layout, seed * 8 + k, device)
    return out


class ProgramCodec:
    """The program under test: its runtimes' ``compress``, the stream
    container, ``decompress``."""

    def __init__(self, cfg: dict, w: dict, device):
        from dcvc_tpu_torch.models.registry import build
        from dcvc_tpu_torch.utils import stream

        self.stream = stream
        self.cfg = cfg
        self.i_name = cfg["models"]["i"]
        self.p_name = cfg["models"].get("p")
        widths = cfg.get("widths", {})
        _, self.irt = build(self.i_name, device=device,
                            state_dict=w[self.i_name],
                            **widths.get(self.i_name, {}))
        self.irt.update()
        self.prt = None
        if self.p_name:
            warps = cfg["warps"]
            _, self.prt = build(self.p_name, device=device,
                                state_dict=w[self.p_name],
                                od_warp_mode=warps["od"],
                                mc_warp_mode=warps["mc"],
                                me_warp_mode=warps["me"])
            self.prt.update()
        self.q_index = cfg.get("q_index", 0)
        self.image = _image_container(cfg)
        if self.image:
            self.q, self.q_code = stream.get_rounded_q(cfg["q_scale"])

    def runtimes(self):
        return [rt for rt in (self.irt, self.prt) if rt is not None]

    def modules(self, kind: str):
        return self.irt.module if kind == "I" else self.prt.module

    def encode_i(self, x):
        h, w = x.shape[2], x.shape[3]
        if self.image:
            comp = self.irt.compress(x, self.q)
            return self.stream.pack_i_ushort_q(h, w, self.q_code,
                                               comp["bit_stream"])
        comp = self.irt.compress(x, False, self.q_index)
        return self.stream.pack_i(h, w, False, self.q_index,
                                  comp["bit_stream"])

    def decode_i(self, data):
        if self.image:
            h, w, q_code, s = self.stream.unpack_i_ushort_q(data)
            return self.irt.decompress(s, h, w, q_code / 100)["x_hat"]
        h, w, qc, qi, s = self.stream.unpack_i(data)
        return self.irt.decompress(s, h, w, qc, qi)["x_hat"]

    def encode_p(self, x, dpb, i):
        comp = self.prt.compress(x, dpb, False, self.q_index, i)
        return self.stream.pack_p(comp["bit_stream"], False, self.q_index,
                                  i % 4)

    def decode_p(self, data, dpb, shape):
        qc, qi, fi, s = self.stream.unpack_p(data)
        return self.prt.decompress(dpb, s, shape[0], shape[1], qc, qi, fi)[
            "dpb"]

    def decoded_symbols(self, kind, data, dpb, shape) -> list:
        """The symbol planes the decoder produces from ``data``, flat, in
        stream order: the frame decoded once more, with a tap on the
        runtime's entropy decoder."""
        coder = (self.irt if kind == "I" else self.prt).entropy_coder
        planes = []
        inner = coder.decode_stream
        had = "decode_stream" in coder.__dict__

        def tapped(*a, **k):
            out = inner(*a, **k)
            planes.append(torch.from_numpy(np.array(out, copy=True)))
            return out

        coder.decode_stream = tapped
        try:
            if kind == "I":
                self.decode_i(data)
            else:
                self.decode_p(data, dpb, shape)
        finally:
            if had:
                coder.decode_stream = inner
            else:
                del coder.decode_stream
        return planes

    def close(self):
        self.irt = self.prt = None


class ReferenceCodec:
    """The reference in the program's place (a control): its
    reconstruction and DPB are what it "decodes", its own rounding the
    symbols it decodes. ``precision``: ``tf32``, TF32 (the precision below
    the configuration's); ``f64``, every dense convolution accumulated in
    float64 and rounded to float32 (``accumulate_f64``: another exact
    order)."""

    def __init__(self, cfg: dict, w: dict, device, precision: str):
        if precision not in ("tf32", "f64"):
            raise ValueError(f"no control precision {precision!r}")
        self.refs = reference_modules(cfg, w, device)
        if precision == "f64":
            for m in self.refs.values():
                accumulate_f64(m)
        self.cfg = cfg
        self.tf32 = precision == "tf32"
        self.i_name = cfg["models"]["i"]
        self.p_name = cfg["models"].get("p")

    def _coded(self, module, fn) -> dict:
        sym = Symbols(module.STREAM)
        with _tf32(self.tf32):
            out = fn(sym)
        return {"out": out, "symbols": sym.stream(),
                "residuals": sym.residuals()}

    def encode_i(self, x):
        m = self.refs[self.i_name]
        return self._coded(m, lambda sym: reference_i(m, self.cfg, x, sym))

    def decode_i(self, data):
        return data.pop("out")

    def encode_p(self, x, dpb, i):
        m = self.refs[self.p_name]
        return self._coded(m, lambda sym: reference_p(m, self.cfg, x, dpb,
                                                      i, sym))

    def decode_p(self, data, dpb, shape):
        return data.pop("out")

    def decoded_symbols(self, kind, data, dpb, shape) -> list:
        return data["symbols"]

    def close(self):
        self.refs = {}


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 on or off for the block, without gradients."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def reference_modules(cfg: dict, w: dict, device) -> dict:
    """The reference module of each model, with the weights ``w``."""
    refs = {}
    for name, sd in w.items():
        m = build_reference(name, cfg).to(device).eval()
        m.load_state_dict(sd, strict=True)
        refs[name] = m
    return refs


def _image_container(cfg: dict) -> bool:
    if cfg["container"] not in CONTAINERS:
        raise ValueError(f"no stream container {cfg['container']!r}")
    return cfg["container"] == "image_q_scale"


def reference_i(module, cfg, x, sym=None):
    if _image_container(cfg):
        return module.code(x, cfg["q_scale"], sym)
    return module.code(x, cfg.get("q_index", 0), sym)


def reference_p(module, cfg, x, dpb, i, sym=None):
    qs = module.q_scales(cfg.get("q_index", 0), x.device)
    return module(x, dpb, qs, i, sym=sym)[0]


def _kind(i: int, gop: int) -> str:
    return "I" if i % gop == 0 else ("P1" if i % gop == 1 else "P")


def code_frames(codec, frames, gop: int, stop, keep=(), spans=None,
                on_frame=None, dev=None):
    """Codes frames 0, 1, ... until ``stop(n_done, elapsed_s)``. Returns
    the records ``(kind, encode_s, decode_s, bytes)`` and, for frames in
    ``keep``, ``(DPB before, decoded DPB, coded data)``, the DPBs copied
    to the host, so that the check's sample holds no device memory in the
    window (the data is held, not copied); the copies' seconds are left
    out of the elapsed time. ``on_frame(i, phase)`` runs
    before (``"start"``) and after (``"end"``) each frame, outside its
    times; it returns seconds to leave out of the elapsed time too."""
    spans = spans or harness.Spans()
    records, held = [], {}
    dpb = None
    t_start = None
    excluded = 0.0
    for i in itertools.count():
        x = frames(i)
        if on_frame is not None:
            excluded += on_frame(i, "start")
        kind = _kind(i, gop)
        _sync(dev)
        t0 = time.perf_counter()
        if t_start is None:
            t_start = t0
        with spans.span("encode"):
            data = (codec.encode_i(x) if kind == "I"
                    else codec.encode_p(x, dpb, i))
            _sync(dev)
        t1 = time.perf_counter()
        with spans.span("decode"):
            if kind == "I":
                out = _i_dpb(torch.clamp(codec.decode_i(data), 0.0, 1.0))
            else:
                out = dict(codec.decode_p(data, dpb, x.shape[2:]))
                out["ref_frame"] = torch.clamp(out["ref_frame"], 0.0, 1.0)
            _sync(dev)
        t2 = time.perf_counter()
        if i in keep:
            t = time.perf_counter()
            held[i] = (_moved(dpb, "cpu"), _moved(out, "cpu"), data)
            excluded += time.perf_counter() - t
        dpb = out
        records.append((kind, t1 - t0, t2 - t1,
                        len(data) if isinstance(data, (bytes, bytearray))
                        else 0))
        if on_frame is not None:
            excluded += on_frame(i, "end")
        if stop(i + 1, time.perf_counter() - t_start - excluded):
            break
    return records, held, t_start, excluded


def sample(mix: dict, seed: int) -> set:
    """Frames 0 and 1 and ``check`` more drawn from the seed below
    ``check_below``, outside the profiled stretch (so that no copy of the
    sample falls into the trace)."""
    rng = random.Random(seed)
    t_first, count = mix["trace"]
    pool = [i for i in range(2, mix["check_below"])
            if not t_first <= i < t_first + count]
    return {0, 1} | set(rng.sample(pool, min(mix["check"], len(pool))))


def _gap(a, b) -> float:
    """Largest absolute gap; a missing or misshapen tensor, infinite."""
    if a is None or a.shape != b.shape:
        return float("inf")
    return float((a.double() - b.double()).abs().max().item())


def decoded(codec, frames, gop: int, held: dict, device) -> dict:
    """Frame -> the symbol planes the codec's decoder produces for each
    held frame (``decoded_symbols``), decoded after the window."""
    out = {}
    for i in sorted(held):
        dpb_in, _, data = held[i]
        shape = frames(i).shape[2:]
        out[i] = codec.decoded_symbols(_kind(i, gop)[0], data,
                                       _moved(dpb_in, device), shape)
    return out


def readings(cfg: dict, w: dict, frames, gop: int, held: dict, device,
             planes: dict | None, delta: float,
             residuals: dict | None = None) -> dict:
    """The reference's readings of the held frames (see the module's
    docstring), following the decoder's symbol ``planes`` (frame -> list
    in stream order); None: its own rounding, as the check did before it
    followed the symbols. ``residuals`` (frame -> a control's residual
    planes) adds how far the reference's residuals lie from them."""
    refs = reference_modules(cfg, w, device)
    recon_gap, feature_gap = 0.0, None
    ties = faults = 0
    gaps, distances = [], []
    own = {}
    for i in sorted(held):
        dpb_in, out, _ = held[i]
        dpb_in, out = _moved(dpb_in, device), _moved(out, device)
        x = frames(i)
        name = cfg["models"]["i" if i % gop == 0 else "p"]
        sym = Symbols(refs[name].STREAM,
                      None if planes is None else planes.get(i, []), delta,
                      None if residuals is None else residuals[i])
        with _tf32(False):
            if i % gop == 0:
                expect = _i_dpb(reference_i(refs[name], cfg, x, sym))
            else:
                if i % gop == 1 and (i - 1) in own:
                    dpb_in = own[i - 1]
                expect = reference_p(refs[name], cfg, x, dpb_in, i, sym)
        own[i] = expect
        ties += sym.ties
        faults += sym.faults
        gaps += sym.gaps
        distances += sym.distances
        recon_gap = max(recon_gap, _gap(out["ref_frame"], expect["ref_frame"]))
        for k in DPB_KEYS[1:]:
            if expect.get(k) is None:
                continue
            scale = float(expect[k].abs().max().item()) or 1.0
            g = _gap(out[k], expect[k]) / scale
            feature_gap = g if feature_gap is None else max(feature_gap, g)
    refs.clear()
    out = {"recon_gap": recon_gap, "symbol_faults": faults,
           "tie_symbols": ties, "flip_distances": sorted(distances)}
    if feature_gap is not None:
        out["feature_gap"] = feature_gap
    if gaps:
        g = torch.cat(gaps)
        out["residual_gap_max"] = float(g.max().item())
        out["residual_gap_median"] = float(g.median().item())
    return out


def flops_by_kind(codec, frames, gop: int, dev) -> dict:
    """Convolution FLOPs of one encode + decode of each kind of frame
    (``I``; ``P1``, the first after an I-frame; ``P``), counted on the
    program's modules while the set-up codes the warm-up frames."""
    counted = {}
    dpb = None
    for i in range(min(gop, 3)):
        x = frames(i)
        kind = _kind(i, gop)
        box = {}

        def round_trip():
            if kind == "I":
                box["out"] = _i_dpb(torch.clamp(
                    codec.decode_i(codec.encode_i(x)), 0.0, 1.0))
            else:
                out = dict(codec.decode_p(codec.encode_p(x, dpb, i), dpb,
                                          x.shape[2:]))
                out["ref_frame"] = torch.clamp(out["ref_frame"], 0.0, 1.0)
                box["out"] = out

        counted[kind] = conv_flops(codec.modules("I" if kind == "I" else "P"),
                                   round_trip)
        dpb = box["out"]
    _sync(dev)
    return counted


class _K1Capture:
    """Shapes of the block-warp launches the program makes while on."""

    def __init__(self):
        from dcvc_tpu_torch.ops import block_warp as bw

        self.bytes = []
        self.on = False
        launch = bw._launch

        def counted(im, flow, *a, **k):
            if self.on:
                M, C, H, W = im.shape
                item = 2 if im.dtype == torch.bfloat16 else 4
                self.bytes.append(k1_bytes(M, C, H, W, item))
            return launch(im, flow, *a, **k)

        bw._launch = counted


def run(ctx: dict) -> dict:
    cfg, mix, dev = ctx["config"], ctx["traffic"], ctx["device"]
    seed, trace = ctx["seed"], ctx["trace"]
    phases = ctx["phases"]
    frames = Frames(seed, mix["height"], mix["width"], mix["pad"],
                    mix["step"], mix["period"], dev)
    w = weights(cfg, seed, dev)
    _sync(dev)
    phases.mark("inputs")
    codec = ProgramCodec(cfg, w, dev)
    phases.mark("program")
    gop = mix["gop"]
    spans = harness.Spans(trace)
    k1 = _K1Capture() if trace else None

    # set-up: warm every kind of frame the window codes (and count its
    # convolution FLOPs); the kinds share every kernel shape with the
    # frames the window codes
    flops = flops_by_kind(codec, frames, gop, dev)
    phases.mark("warmup")
    if trace:
        for rt in codec.runtimes():
            spans.wrap(rt.entropy_coder, ("encode_with_indexes", "flush",
                                          "get_encoded_stream", "set_stream",
                                          "decode_stream"), "entropy")
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    keep = sample(mix, seed)
    t_first, count = mix["trace"]
    prof_box = {}

    def on_frame(i, phase):
        if not trace:
            return 0.0
        if phase == "start" and i == t_first:
            from torch.profiler import ProfilerActivity, profile

            t = time.perf_counter()
            prof_box["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA])
            prof_box["prof"].__enter__()
            prof_box["rf"] = torch.profiler.record_function("stretch")
            prof_box["rf"].__enter__()
            k1.on = True
            return time.perf_counter() - t
        if phase == "end" and i == t_first + count - 1:
            t = time.perf_counter()
            _sync(dev)
            k1.on = False
            prof_box["rf"].__exit__(None, None, None)
            prof_box["prof"].__exit__(None, None, None)
            return time.perf_counter() - t
        return 0.0

    # the window holds the first P-frame at least (frame 1 is always
    # checked) and, traced, the profiled stretch
    least = max(2 if gop > 1 else 1, t_first + count if trace else 0)

    def stop(n, elapsed):
        return n >= least and elapsed >= ctx["seconds"]

    records, held, t_start, excluded = code_frames(
        codec, frames, gop, stop, keep, spans, on_frame, dev)
    window_s = time.perf_counter() - t_start - excluded
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    rec = {
        "setup_s": ctx["t_window"](t_start),
        "setup_phases": phases.done,
        "kind": "video" if gop > 1 else "image",
        "window_s": window_s,
        "attempted": len(records), "failed": 0,
        "frames": [{"kind": k, "encode_s": e, "decode_s": d, "bytes": b}
                   for k, e, d, b in records],
        "flops_by_kind": flops,
        "spans": dict(spans.total),
        "window_peak_bytes": window_peak,
        "memory_peak_bytes": max(setup_peak, window_peak),
    }
    if trace:
        rec["profile"] = harness.reduce_profile(
            prof_box["prof"], ("encode", "decode", "entropy"))
        rec["k1_bytes"] = list(k1.bytes)
        prof_box.clear()
    t_check = time.perf_counter()
    planes = decoded(codec, frames, gop, held, dev)
    t_decoded = time.perf_counter()
    codec.close()
    del codec
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    r = readings(cfg, w, frames, gop, held, dev, planes,
                 ctx["limits"].get("tie_delta", 0.0))
    rec["readings"] = r
    rec["checked"] = sorted(held)
    rec["detail"] = {"tie_symbols": r["tie_symbols"],
                     "check_decode_s": t_decoded - t_check,
                     "check_s": time.perf_counter() - t_check}
    return rec


def calibrate(ctx: dict, mode: str) -> dict:
    """Readings of one seed with the program (``program``) or a control
    in its place (``control``: the reference in TF32; ``twin``: in
    float64-accumulated convolutions) coding the frames a run of that seed
    checks, beside those of the rule before the reference followed the
    decoder's symbols (``old_recon_gap``, ``old_feature_gap``)."""
    cfg, mix, dev, seed = (ctx["config"], ctx["traffic"], ctx["device"],
                           ctx["seed"])
    frames = Frames(seed, mix["height"], mix["width"], mix["pad"],
                    mix["step"], mix["period"], dev)
    w = weights(cfg, seed, dev)
    gop = mix["gop"]
    controls = {"control": "tf32", "twin": "f64"}
    codec = (ReferenceCodec(cfg, w, dev, controls[mode]) if mode in controls
             else ProgramCodec(cfg, w, dev))
    keep = sample(mix, seed)
    last = max(keep) + 1
    _, held, _, _ = code_frames(codec, frames, gop,
                                lambda n, _t: n >= last, keep, dev=dev)
    planes = decoded(codec, frames, gop, held, dev)
    codec.close()
    del codec
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    residuals = None
    if mode in controls:
        residuals = {i: held[i][2]["residuals"] for i in held}
    out = readings(cfg, w, frames, gop, held, dev, planes,
                   ctx["limits"].get("tie_delta", 0.0), residuals)
    old = readings(cfg, w, frames, gop, held, dev, None, 0.0)
    out["old_recon_gap"] = old["recon_gap"]
    if "feature_gap" in old:
        out["old_feature_gap"] = old["feature_gap"]
    return {**out, "checked": sorted(held)}
