"""Cells, configurations, traffic, limits and metrics are found by name,
and a cell is added by adding files and entries only."""

import json
import shutil

import pytest

from benchmark import harness

from . import _tiny


def test_every_entry_has_its_files():
    spec = harness.spec()
    for c in spec["configs"]:
        cfg = harness.config(c["name"])
        assert (harness.ROOT / c["file"]).is_file()
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        mix = harness.traffic(w["traffic"])
        assert harness.driver(mix["kind"]).run
        assert harness.limits(w["name"])
        assert any(c["name"] == w["config"] for c in spec["configs"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


def test_metrics_for_follows_the_workloads_keys():
    spec = harness.spec()
    names = {w["name"] for w in spec["workloads"]}
    for cell in names:
        e2e = {m["name"] for m in harness.metrics_for(spec, cell, False)}
        layer = harness.metrics_for(spec, cell, True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        # a per-layer metric's end-to-end metric is reported in its cells
        for m in layer:
            assert m["moves"] in e2e


def test_a_throwaway_cell_is_data_only(tmp_path, monkeypatch):
    """Copy the benchmark, add a configuration, a traffic mix, limits, a
    metric and a cell as new files and entries, and run the cell on the
    CPU: no file that was there is edited."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    (bench / "configs" / "evc_ss_tiny.json").write_text(json.dumps({
        "name": "evc_ss_tiny", "models": {"i": "evc_SS"},
        "reference": {"evc_SS": {"class": "models:EVCIntra",
                                 "variant": "SS"}},
        "container": "image_q_scale",
        "widths": {"evc_SS": {"N": 192}}, "q_scale": 0.5,
        "dtype": "float32", "tf32": False,
        "reduced": [], "source": "https://github.com/microsoft/DCVC"}))
    (bench / "traffic" / "images_tiny.json").write_text(json.dumps({
        "kind": "coding_stream", "height": 64, "width": 128, "pad": 64,
        "step": [3, 5], "period": 4, "gop": 1, "check": 1,
        "check_below": 4, "trace": [1, 1]}))
    (bench / "limits" / "evc_ss_tiny_stream.json").write_text(
        json.dumps({"recon_gap": 1e-4}))
    (bench / "metrics" / "bytes_per_frame.py").write_text(
        "def read(rec):\n"
        "    return sum(f['bytes'] for f in rec['frames']) "
        "/ len(rec['frames'])\n")
    spec["configs"].append({"name": "evc_ss_tiny", "source": "x",
                            "file": "benchmark/configs/evc_ss_tiny.json",
                            "reduced": [], "why": "throwaway"})
    spec["workloads"].append({"name": "evc_ss_tiny_stream",
                              "config": "evc_ss_tiny",
                              "traffic": "images_tiny", "chips": 1,
                              "why": "throwaway"})
    spec["end_to_end"].append({"name": "bytes_per_frame", "unit": "B",
                               "better": "lower", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["evc_ss_tiny_stream"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    monkeypatch.setattr(harness, "BENCH", bench)
    monkeypatch.setattr(harness, "ROOT", root)
    out = _tiny.run("evc_ss_tiny_stream", seconds=0.3)
    assert out["correct"] is True
    assert out["metrics"]["bytes_per_frame"]["value"] > 0
    # fps and the latency list their cells: the new cell reports setup_s
    # and its own metric
    assert set(out["metrics"]) == {"setup_s", "bytes_per_frame"}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.cell(harness.spec(), "no_such_cell")


def test_a_metric_of_a_kind_finds_its_quantitys_reader(tmp_path,
                                                       monkeypatch):
    """``<q>.<kind>`` is read by ``metrics/<q>.py`` unless a file of its
    own name is there; the reader takes the kind from the record."""
    assert harness.reader("encode_ms.video").__file__.endswith(
        "encode_ms.py")
    assert harness.reader("frame_latency_ms.p90").__file__.endswith(
        "frame_latency_ms.p90.py")
    rec = {"kind": "image", "spans": {"encode": 3.0},
           "frames": [{"kind": "I", "encode_s": 1.0, "decode_s": 0.5}] * 2}
    assert harness.reader("encode_ms.image").read(rec) == 1500.0
    step = {"kind": "train", "spans": {"step": 2.0}, "step_s": [1.0, 1.0],
            "batch": 4, "window_s": 2.0, "window_peak_bytes": 2 ** 31}
    assert harness.reader("train_clips_per_s").read(step) == 4.0
    assert harness.reader("peak_gib.train").read(step) == 2.0
    assert harness.reader("frame_latency_ms.p90").read(step) is None


def test_the_configuration_decides_what_a_cell_trains(monkeypatch):
    """The train driver builds the model and warps the configuration
    names, for the program and the reference alike."""
    import torch

    from benchmark.drivers import train_step
    from benchmark.reference import warp
    from dcvc_tpu_torch.training import trainer

    cfg = harness.config("dc_f32")
    mix = harness.traffic("clips_256_b4")
    built = []
    orig = trainer.build_train_module

    def spy(name, **kw):
        built.append((name, kw))
        return orig(name, **kw)

    monkeypatch.setattr(trainer, "build_train_module", spy)
    w = train_step.make_weights(train_step.layout(cfg), 1, "cpu")
    prog = train_step.ProgramTrainer(cfg, mix, w, torch.device("cpu"))
    name, kw = built[0]
    assert name == cfg["models"]["p"] and prog.stage.name == mix["stage"]
    assert {k: kw[f"{k}_warp_mode"] for k in ("od", "mc", "me")} == \
        cfg["training_warps"]
    assert cfg["training_warps"]["od"] == "exact"
    assert train_step.reference_module(cfg).align.warp is warp.flow_warp
    lam = train_step.lambdas_for(dict(mix, batch=6), 1, "cpu").tolist()
    assert lam == [mix["lambdas"][(b + 1) % 4] for b in range(6)]


def test_the_configuration_names_the_container():
    from benchmark.drivers import coding_stream
    from benchmark.reference import build

    cfg = harness.config("evc_ll_f32")
    assert coding_stream._image_container(cfg)
    assert not coding_stream._image_container(harness.config("dc_f32"))
    with pytest.raises(ValueError):
        coding_stream._image_container(dict(cfg, container="evc"))
    with pytest.raises(ValueError):
        build("dmc_dc", harness.config("dc_f32"),
              warps={"od": "exact", "mc": "block:4,4,64,128,median4",
                     "me": "exact"})
