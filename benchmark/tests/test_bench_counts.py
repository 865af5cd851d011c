"""The yardstick's arithmetic against hand-worked small cases."""

import statistics

import pytest
import torch
import torch.nn as nn

from benchmark import harness
from benchmark.reference.counts import conv_flops, k1_bytes


def test_percentile_takes_every_sample():
    vals = [float(v) for v in range(1, 11)]          # 1..10
    # rank 0.9 * 9 = 8.1: 9 + 0.1 * (10 - 9)
    assert harness.percentile(vals, 90) == pytest.approx(9.1)
    assert harness.percentile(list(reversed(vals)), 90) == pytest.approx(9.1)
    assert harness.percentile([5.0], 90) == 5.0
    assert harness.percentile(vals, 50) == statistics.median(vals)
    with pytest.raises(ValueError):
        harness.percentile([], 90)


def test_conv_flops_by_hand():
    conv = nn.Conv2d(4, 6, 3, stride=2, padding=1)            # out 6x4x4
    dw = nn.Conv2d(6, 6, 3, padding=1, groups=6)               # out 6x4x4
    up = nn.ConvTranspose2d(6, 2, 2, stride=2)                 # in 6x4x4
    net = nn.Sequential(conv, dw, up)
    x = torch.zeros(1, 4, 8, 8)
    flops = conv_flops(net, lambda: net(x))
    expect = (2 * (6 * 4 * 4) * 4 * 9          # conv
              + 2 * (6 * 4 * 4) * 1 * 9        # depthwise: in/groups = 1
              + 2 * (6 * 4 * 4) * 2 * 4)       # transposed: input x out x k
    assert flops == expect
    # hooks are removed afterwards
    assert conv_flops(net, lambda: None) == 0.0


def test_k1_bytes_of_the_offset_diversity_site():
    # 32 maps of 3 channels at 1088 x 1920, f32: PERF.md's 802 + 535 + 802 MB
    b = k1_bytes(32, 3, 1088, 1920, 4)
    assert b == 2 * 32 * 3 * 1088 * 1920 * 4 + 32 * 2 * 1088 * 1920 * 4
    assert round(b / 1e6) == 2139
    assert k1_bytes(1, 1, 2, 2, 2) == 2 * 4 * 2 + 2 * 4 * 4


class _Ev:
    def __init__(self, start, end, name, device_type, annotation=False):
        self.time_range = type("R", (), {"start": start, "end": end})()
        self.name = name
        self.device_type = device_type
        self.is_user_annotation = annotation


class _Prof:
    def __init__(self, events):
        self._e = events

    def events(self):
        return self._e


def test_reduce_profile_busy_idle_and_labels():
    cuda, cpu = "DeviceType.CUDA", "DeviceType.CPU"
    prof = _Prof([
        _Ev(0, 100, "stretch", cpu),
        _Ev(0, 60, "encode", cpu), _Ev(20, 40, "entropy", cpu),
        _Ev(60, 100, "decode", cpu),
        _Ev(5, 15, "conv", cuda), _Ev(10, 20, "conv", cuda),   # overlap
        _Ev(50, 70, "warp", cuda),
        _Ev(0, 100, "annotation", cuda, annotation=True),      # not counted
        _Ev(95, 110, "tail", cuda),                            # clipped
    ])
    p = harness.reduce_profile(prof, ("encode", "decode", "entropy"))
    assert p["window_s"] == pytest.approx(100e-6)
    assert p["busy_s"] == pytest.approx((15 + 20 + 5) * 1e-6)
    assert p["device_s_by_name"]["conv"] == pytest.approx(20e-6)
    assert p["device_s_by_name"]["tail"] == pytest.approx(5e-6)
    gaps = dict((round(s * 1e6), n) for n, s in p["gaps"])
    # 0-5 encode, 20-50 entropy (middle 35 inside 20-40), 70-95 decode
    assert gaps == {5: "encode", 30: "entropy", 25: "decode"}
    assert [round(s * 1e6) for _, s in p["gaps"]] == [30, 25, 5]
    bd = harness.breakdown(p)
    assert bd["device_ops"][0][0] == "conv" and len(bd["idle_gaps"]) == 3
