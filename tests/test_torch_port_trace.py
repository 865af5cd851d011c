"""The port's span and counter recorder (``dcvc_tpu_torch/utils/trace.py``)
and what the runtimes, the entropy coder and the trainer record in it, on
the CPU.

* Off by default: nothing is recorded and ``span`` hands out one shared
  no-op context.
* Spans keep their parent and their thread; a parent's self time is what
  its children leave of it; counters sum.
* A ``rans`` span opened on ``AsyncEntropyCoder``'s worker carries the
  worker's thread.
* One IntraDcRuntime round trip at 64 x 64 records the spans its code
  makes, a fixed number of readbacks a call, and ``rans.symbols`` equal to
  the symbols its stream codes, once encoded and once decoded.
* Every runtime's ``compress`` and ``decompress`` is a span.
"""

import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from dcvc_tpu_torch.entropy.bit_estimator import (BitEstimator,
                                                  build_factorized_tables,
                                                  encode_factorized)
from dcvc_tpu_torch.entropy.coder import AsyncEntropyCoder
from dcvc_tpu_torch.models import runtime
from dcvc_tpu_torch.models.intra_dc import IntraNoAR
from dcvc_tpu_torch.training.trainer import PFrameTrainer
from dcvc_tpu_torch.utils import trace


@pytest.fixture
def recorder():
    """The recorder on, and off and empty again after the test."""
    trace.take()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.take()


def test_off_by_default_records_nothing():
    assert not trace.enabled()
    a, b = trace.span("runtime.compress"), trace.span("rans", op="flush")
    assert a is b
    with a:
        trace.count("rans.symbols", 5)
    assert trace.take() == {"spans": [], "counters": {}}


def test_parents_self_time_and_counters(recorder):
    with trace.span("outer", n=3):
        with trace.span("inner", k=1):
            time.sleep(0.002)
            with trace.span("leaf"):
                trace.count("c", 3)
        with trace.span("inner", k=2):
            trace.count("c")
    with trace.span("second"):
        pass
    got = trace.take()
    assert got["counters"] == {"c": 4}
    by = {(s["name"], s["attrs"].get("k")): s for s in got["spans"]}
    top = by[("outer", None)]
    assert top["attrs"] == {"n": 3} and top["parent"] is None
    i1, i2, leaf = by[("inner", 1)], by[("inner", 2)], by[("leaf", None)]
    assert i1["parent"] == i2["parent"] == top["id"]
    assert leaf["parent"] == i1["id"]
    assert {s["thread"] for s in got["spans"]} == {threading.get_ident()}
    second = by[("second", None)]
    assert second["parent"] is None and second["id"] != top["id"]
    for child, parent in ((i1, top), (i2, top), (leaf, i1)):
        assert parent["start_ns"] <= child["start_ns"] <= child["end_ns"] \
            <= parent["end_ns"]
    dur = {k: s["end_ns"] - s["start_ns"] for k, s in by.items()}
    self_ns = dur[("outer", None)] - dur[("inner", 1)] - dur[("inner", 2)]
    assert 0 <= self_ns < dur[("outer", None)]
    assert dur[("inner", 1)] >= 2_000_000
    assert trace.take() == {"spans": [], "counters": {}}


def test_rans_span_on_the_async_worker_carries_its_thread(recorder):
    table = build_factorized_tables(BitEstimator(4))
    z = np.random.default_rng(0).integers(-3, 3, (1, 2, 3, 4)).astype(
        np.float32)
    coder = AsyncEntropyCoder()
    try:
        coder.reset()
        encode_factorized(coder, z, table)
        coder.flush()
        coder.get_encoded_stream()
    finally:
        coder.close()
    assert not coder._worker.is_alive()
    got = trace.take()
    ops = {s["attrs"]["op"]: s["thread"] for s in got["spans"]
           if s["name"] == "rans"}
    main = threading.get_ident()
    assert ops["encode_with_indexes"] == ops["flush"] == coder._worker.ident
    assert ops["encode_with_indexes"] != main
    assert ops["get_encoded_stream"] == main
    assert got["counters"]["rans.symbols"] == z.size


def test_intra_dc_round_trip_spans_and_counts(recorder):
    torch.manual_seed(0)
    N = 8
    rt = runtime.IntraDcRuntime(IntraNoAR(N=N, ch_a=8, ch_b=8), device="cpu")
    rt.update()
    x = torch.rand(1, 3, 64, 64)
    trace.take()
    comp = rt.compress(x, False, 32)
    enc = trace.take()
    rt.decompress(comp["bit_stream"], 64, 64, False, 32)
    dec = trace.take()
    # z (N x 1 x 1) and the four y parts (N x 4 x 4 in all)
    symbols = N * 1 * 1 + N * 4 * 4

    def kinds(t):
        return Counter((s["name"], s["attrs"].get("op")) for s in t["spans"])

    assert kinds(enc) == Counter({
        ("runtime.compress", None): 1, ("runtime.readback", None): 9,
        ("runtime.upload", None): 2, ("rans", "encode_with_indexes"): 5,
        ("rans", "flush"): 1, ("rans", "get_encoded_stream"): 1})
    assert kinds(dec) == Counter({
        ("runtime.decompress", None): 1, ("runtime.readback", None): 4,
        ("runtime.upload", None): 7, ("rans", "set_stream"): 1,
        ("rans", "decode_stream"): 5})
    for t, name in ((enc, "runtime.compress"), (dec, "runtime.decompress")):
        top = [s for s in t["spans"] if s["parent"] is None]
        assert [s["name"] for s in top] == [name]
        assert t["counters"] == {"rans.symbols": symbols}


@pytest.mark.parametrize("method", ["compress", "decompress"])
def test_every_runtime_call_is_a_span(recorder, method):
    rts = [c for c in vars(runtime).values() if isinstance(c, type)
           and issubclass(c, runtime._RuntimeBase) and method in vars(c)]
    assert len(rts) == (8 if method == "compress" else 7)
    for c in rts:
        assert getattr(c, method).__wrapped__.__name__ == method
        assert getattr(c, method).__qualname__ == f"{c.__name__}.{method}"

    class Rt:
        @runtime._call_span
        def compress(self, *args, **kwargs):
            return args, kwargs

    assert Rt().compress(1, frame_idx=2) == ((1,), {"frame_idx": 2})
    assert [s["name"] for s in trace.take()["spans"]] == ["runtime.compress"]


def test_train_step_and_its_loss_readback(recorder):
    class Opt:
        def zero_grad(self):
            pass

        def step(self):
            pass

    class Stub:
        seed, updates = 0, 0

        def loss(self, clip, lambdas, stage, key):
            return (clip * lambdas).sum()

    w = torch.ones(3, requires_grad=True)
    loss = PFrameTrainer.train_step(Stub(), Opt(), None, w, torch.ones(3))
    assert loss == 3.0
    spans = {s["name"]: s for s in trace.take()["spans"]}
    assert set(spans) == {"train.step", "train.readback"}
    assert spans["train.readback"]["parent"] == spans["train.step"]["id"]
