"""Host-level job parallelism: (sequence x rate) work distribution.

Port of ``dcvc_tpu/parallel/jobs.py`` on ``torch.distributed``. The
reference fans out with a spawn ProcessPoolExecutor and round-robins GPUs
per process (DCVC-DC/test_video.py:276-338); across hosts each process
takes a static round-robin share of the work items by its rank, and the
results meet on a shared filesystem. The jobs exchange no tensors, so the
process group is gloo by default: it serves wherever two ranks share a card
(NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Sequence


@dataclass
class WorkItem:
    seq_name: str
    rate_idx: int
    payload: dict


def process_rank_and_count() -> tuple[int, int]:
    """(rank, world size) of the process group when one is up, else
    (0, 1), as ``jax.process_index()`` / ``process_count()`` give them."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_work(items: Sequence, process_index: int | None = None,
               process_count: int | None = None) -> list:
    """Static round-robin assignment of work items to this process."""
    if process_index is None:
        process_index, process_count = process_rank_and_count()
    return [it for i, it in enumerate(items)
            if i % process_count == process_index]


def run_sharded(items: Sequence[WorkItem], worker: Callable[[WorkItem], dict],
                out_dir: str = "out/shards", retries: int = 1) -> dict:
    """Runs this process's share, persists it, merges what exists.

    Each rank writes ``out_dir/results_{rank}.json`` (atomically: the JAX
    package's plain write lets a concurrent merge read a half-written file);
    the merge reads every partial file present (ranks that have not
    finished are skipped and picked up on a re-run: recovery without a
    coordinator). A worker
    exception is retried ``retries`` times, then recorded as an
    ``{"error": ...}`` entry instead of ending the rank's whole share."""
    rank, _ = process_rank_and_count()
    results = {}
    for item in shard_work(items):
        key = f"{item.seq_name}/rate_{item.rate_idx}"
        for attempt in range(retries + 1):
            try:
                results[key] = worker(item)
                break
            except Exception as e:  # noqa: BLE001
                if attempt == retries:
                    results[key] = {"error": repr(e), "attempts": attempt + 1}

    os.makedirs(out_dir, exist_ok=True)
    # written whole, then renamed into place: another rank's merge may read
    # the directory at any moment and must never see a half-written file
    path = os.path.join(out_dir, f"results_{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(results, f)
    os.replace(path + ".tmp", path)

    merged = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("results_") and name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                merged.update(json.load(f))
    return merged


def maybe_init_distributed() -> tuple[int, int]:
    """Joins a gloo process group when launched by a multi-process runner.

    ``torchrun`` (or a manual launch) sets ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK`` and ``WORLD_SIZE``; with them set, ``init_process_group`` is
    called with that rendezvous. Returns (rank, world size)."""
    import torch.distributed as dist

    if (not dist.is_initialized() and "MASTER_ADDR" in os.environ
            and "WORLD_SIZE" in os.environ):
        dist.init_process_group(backend="gloo", init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return process_rank_and_count()
