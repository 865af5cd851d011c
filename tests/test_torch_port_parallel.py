"""The port's job fan-out (``dcvc_tpu_torch/parallel/jobs.py``) and the
video CLI's ``--worker_num`` process pool, against the JAX package, on the
CPU.

* ``shard_work`` and ``run_sharded`` give ``dcvc_tpu.parallel.jobs``'s
  outputs on the same items (the JAX package's single process is rank 0 of
  1, as the port's is without a process group).
* Two real processes join a gloo process group through
  ``maybe_init_distributed`` (``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
  ``WORLD_SIZE`` on a free local port), exchange their ranks with
  ``all_gather_object`` and merge a ``run_sharded`` over five items that
  both ranks wrote. A partial file is written whole and renamed into
  place: the JAX package's plain write let one rank's merge read the
  other's half-written file (a ``JSONDecodeError`` seen here).
* The video CLI with ``--device cpu --worker_num 2`` (``evc_SS
  --force_intra`` on two 64 x 96 sequences) writes the ``.bin`` files and
  the results of ``--worker_num 1``, times aside.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from dcvc_tpu.parallel import jobs as jjobs
from dcvc_tpu_torch.parallel import jobs
from dcvc_tpu_torch.tools import test_video as cli
from dcvc_tpu_torch.utils import color
from _waits import call_in_thread, communicate_all

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six pytest workers on one host: two torch threads each
    keeps torch's spinning OpenMP pool from starving the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_items,count", [(0, 1), (1, 1), (5, 2), (11, 3),
                                           (4, 7)])
def test_shard_work_equals_jax(n_items, count):
    items = [f"seq{i}/{i % 3}" for i in range(n_items)]
    for index in range(count):
        assert (jobs.shard_work(items, index, count)
                == jjobs.shard_work(items, index, count))
    shards = [jobs.shard_work(items, i, count) for i in range(count)]
    assert sorted(x for s in shards for x in s) == sorted(items)


def test_shard_work_defaults_without_a_process_group():
    items = [1, 2, 3]
    assert jobs.process_rank_and_count() == (0, 1)
    assert jobs.shard_work(items) == jjobs.shard_work(items) == items
    assert jobs.maybe_init_distributed() == (0, 1)


def _flaky():
    calls = {"n": 0}

    def worker(item):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient")
        return {"ok": True, "calls": calls["n"]}

    return worker


def _broken(item):
    raise RuntimeError(f"boom {item.seq_name}")


RUNS = {
    # (pre-existing partial files, items, worker factory, retries)
    "merge_partials": ({"results_7.json": {"other/rate_1": {"bpp": 0.5}}},
                       [("mine", 0)], lambda: lambda it: {"bpp": 0.1}, 1),
    "rerun_overwrites": ({"results_0.json": {"s/rate_0": {"v": 1}}},
                         [("s", 0)], lambda: lambda it: {"v": 2}, 1),
    "retry_flaky": ({}, [("s", 0), ("t", 1)], _flaky, 1),
    "failure_recorded": ({}, [("a", 0), ("b", 2)], lambda: _broken, 2),
    "no_retry": ({}, [("s", 0)], _flaky, 0),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_sharded_equals_jax(name, tmp_path):
    partials, items, factory, retries = RUNS[name]
    merged = {}
    for pkg, mod in (("jax", jjobs), ("port", jobs)):
        out = tmp_path / pkg
        out.mkdir()
        for fname, content in partials.items():
            (out / fname).write_text(json.dumps(content))
        work = [mod.WorkItem(s, r, {}) for s, r in items]
        merged[pkg] = mod.run_sharded(work, factory(), out_dir=str(out),
                                      retries=retries)
        merged[pkg + "_files"] = sorted(os.listdir(out))
    assert merged["port"] == merged["jax"]
    assert merged["port_files"] == merged["jax_files"]


def test_run_sharded_never_leaves_a_half_written_partial(tmp_path,
                                                         monkeypatch):
    """A rank that dies while writing its partial file leaves none under
    the merged name (the write goes to a temporary name, then is renamed),
    so another rank's merge never reads half a file."""
    out = tmp_path / "shards"
    out.mkdir()
    (out / "results_1.json").write_text(json.dumps({"b/rate_0": {"v": 1}}))
    real_dump = json.dump

    def dump_and_die(obj, f):
        f.write('{"a/rate_0": ')
        raise RuntimeError("killed mid-write")

    monkeypatch.setattr(json, "dump", dump_and_die)
    items = [jobs.WorkItem("a", 0, {})]
    with pytest.raises(RuntimeError, match="mid-write"):
        jobs.run_sharded(items, lambda it: {"v": 0}, out_dir=str(out))
    assert not (out / "results_0.json").exists()
    monkeypatch.setattr(json, "dump", real_dump)
    assert jobs.run_sharded(items, lambda it: {"v": 0}, out_dir=str(out)) == {
        "a/rate_0": {"v": 0}, "b/rate_0": {"v": 1}}


_RANK = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, {root!r})
    import torch.distributed as dist
    from dcvc_tpu_torch.parallel.jobs import (WorkItem, maybe_init_distributed,
                                              run_sharded)

    rank, world = maybe_init_distributed()
    assert world == 2, world
    ranks = [None, None]
    dist.all_gather_object(ranks, rank)
    assert sorted(ranks) == [0, 1], ranks
    items = [WorkItem(f"seq{{i}}", i % 2, {{}}) for i in range(5)]
    out = os.environ["OUT_DIR"]
    run_sharded(items, lambda it: {{"rank": rank, "name": it.seq_name}},
                out_dir=out)
    dist.barrier()                  # both shards written before the merge
    merged = run_sharded(items, lambda it: {{"rank": rank,
                                             "name": it.seq_name}},
                         out_dir=out)
    if rank == 0:
        with open(os.path.join(out, "merged.json"), "w") as f:
            json.dump(merged, f)
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_run_sharded(tmp_path):
    port = _free_port()
    out = tmp_path / "out"
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(rank), WORLD_SIZE="2", OUT_DIR=str(out),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK.format(root=str(ROOT))], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = communicate_all(procs, 120)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    merged = json.loads((out / "merged.json").read_text())
    assert sorted(merged) == sorted(f"seq{i}/rate_{i % 2}" for i in range(5))
    assert {v["rank"] for v in merged.values()} == {0, 1}
    assert all(merged[k]["rank"] == i % 2
               for i, k in enumerate(f"seq{i}/rate_{i % 2}" for i in range(5)))
    assert sorted(os.listdir(out)) == ["merged.json", "results_0.json",
                                       "results_1.json"]


# -- the video CLI's process pool --------------------------------------------

H, W, FRAMES = 64, 96, 2
SEQS = ("s1", "s2")


@pytest.fixture(scope="module")
def pool_config(tmp_path_factory):
    d = tmp_path_factory.mktemp("pool")
    rng = np.random.default_rng(8)
    for name in SEQS:
        base = rng.random((H // 8 + 2, W // 8 + 2, 3))
        with open(d / f"{name}.yuv", "wb") as f:
            for i in range(FRAMES):
                img = np.kron(np.roll(base, i, axis=1),
                              np.ones((8, 8, 1)))[:H, :W]
                y, uv = color.rgb_to_ycbcr420(img)
                for plane in (y, uv):
                    f.write(np.clip(np.rint(plane * 255), 0, 255)
                            .astype(np.uint8).tobytes())
    cfg = {"root_path": str(d), "test_classes": {"c": {
        "test": 1, "base_path": "", "src_type": "yuv420",
        "sequences": {n: {"width": W, "height": H, "frames": FRAMES,
                          "gop": 32} for n in SEQS}}}}
    (d / "cfg.json").write_text(json.dumps(cfg))
    return d


def _pool_args(d, tag, workers):
    return ["--device", "cpu", "--test_config", str(d / "cfg.json"),
            "--i_frame_model", "evc_SS", "--force_intra", "--write_stream", "1",
            "--rate_num", "1", "--q_indexes", "20", "--force_frame_num",
            str(FRAMES), "--worker_num", str(workers), "--verbose", "0",
            "--stream_path", str(d / tag), "--output_path",
            str(d / f"{tag}.json")]


def _untimed(results: dict) -> dict:
    return {seq: {rate: {k: v for k, v in s.items() if "time" not in k}
                  for rate, s in rates.items()}
            for seq, rates in results.items()}


def test_cli_pool_writes_the_single_process_streams(pool_config, monkeypatch):
    d = pool_config
    monkeypatch.setenv("OMP_NUM_THREADS", "2")     # the spawned workers'
    one = cli.main(_pool_args(d, "one", 1))
    two = call_in_thread(lambda: cli.main(_pool_args(d, "two", 2)), 300,
                         "the --worker_num 2 pool")
    assert sorted(two) == sorted(SEQS)
    assert _untimed(two) == _untimed(one)
    assert json.loads((d / "two.json").read_text()).keys() == one.keys()
    for name in SEQS:
        for i in range(FRAMES):
            a = (d / "one" / f"{name}_{i}.bin").read_bytes()
            assert (d / "two" / f"{name}_{i}.bin").read_bytes() == a


def test_cli_pool_raises_without_cuda(pool_config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _pool_args(pool_config, "nocard", 2)
    with pytest.raises(SystemExit, match="device='cpu'"):
        cli.main(args[2:])                 # without --device cpu
