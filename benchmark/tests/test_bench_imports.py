"""Nothing the command runs loads JAX or the JAX package: a whole tiny run
in a fresh process, its modules' top-level names compared whole."""

import json
import subprocess
import sys

from benchmark import harness

SCRIPT = r"""
import json, sys
from types import SimpleNamespace
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from benchmark import harness, run, calibrate
orig = harness.traffic
def small(name):
    t = dict(orig(name)); t.update(height=64, width=64, check=1,
                                   check_below=4, trace=[1, 1])
    return t
harness.traffic = small
for cell in ("dc_1080p_stream", "evc_ll_1080p_stream"):
    for trace in (0, 1):
        out = run.run(SimpleNamespace(workload=cell, seed=3, seconds=0.1,
                                      trace=trace), device="cpu")
        assert out["correct"], out
for m in harness.spec()["end_to_end"] + harness.spec()["per_layer"]:
    harness.reader(m["name"])
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def test_no_jax_module_loaded():
    res = subprocess.run([sys.executable, "-c",
                          SCRIPT.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    tops = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "dcvc_tpu_torch" in tops and "benchmark" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dcvc_tpu_torch_like", sys)
    assert harness.forbidden_modules() == [] or all(
        n.split(".")[0] in harness.FORBIDDEN
        for n in harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "dcvc_tpu.models", sys)
    assert "dcvc_tpu.models" in harness.forbidden_modules()
