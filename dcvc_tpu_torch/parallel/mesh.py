"""Device meshes and the placements of sharded frames.

Counterpart of ``dcvc_tpu/parallel/mesh.py``: a (data, tile) mesh over the
ranks of the initialised process group, data / GOP parallelism over
``data`` and spatial tiles of the frame's H axis over ``tile``. PyTorch
has no GSPMD, so a tensor on a mesh is held as this rank's slab (a plain
tensor) beside its placements; ``shard`` cuts a whole tensor into that
slab with no communication and ``gather`` puts the slabs back together.
The halo exchanges that XLA inserted between H tiles are written out in
``parallel/tile.py``, which the codec networks consult under a mesh.

The device type is ``cuda`` (one NCCL rank per card) unless the caller
asks for ``cpu`` (gloo); neither falls back on the other.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

AXES = ("data", "tile")


def make_mesh(n_devices: int | None = None, tile: int | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """(data, tile) mesh. ``tile`` shards the image H axis across ranks;
    by default 2 when the rank count is even and above 1, else 1."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed's process "
                           "group: call init_process_group first")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device_type='cpu' "
                           "for a gloo mesh on the CPU")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device_type!r}")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh spans every rank of the process group: "
                         f"{n} devices asked for, {world} ranks")
    if tile is None:
        tile = 2 if n % 2 == 0 and n > 1 else 1
    data = n // tile
    if data * tile != n:
        raise AssertionError(
            f"{n} devices cannot form (data={data}, tile={tile})")
    return init_device_mesh(device_type, (data, tile), mesh_dim_names=AXES)


def frame_sharding(mesh: DeviceMesh) -> tuple:
    """NCHW frames: batch over 'data', H (spatial tiles) over 'tile'."""
    return Shard(0), Shard(2)


def tile_sharding(mesh: DeviceMesh) -> tuple:
    """B = 1 coding frames and DPBs: replicated over 'data', H over
    'tile' (the serving pattern of ``tests/test_sharding_coding.py``)."""
    return Replicate(), Shard(2)


def replicated(mesh: DeviceMesh) -> tuple:
    return Replicate(), Replicate()


def scalar_sharding(mesh: DeviceMesh) -> tuple:
    """Per-sample vectors: over 'data', replicated over 'tile'."""
    return Shard(0), Replicate()


def slab(x: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    """Part ``rank`` of ``x`` cut into ``n`` equal parts along ``dim`` (a
    view); the one slab layout of the package."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"axis {dim} of {tuple(x.shape)} does not divide "
                         f"over {n} ranks")
    return x.narrow(dim, rank * (size // n), size // n)


def all_gather_parts(x: torch.Tensor, group, n: int) -> list:
    """Every rank's ``x`` over ``group`` of ``n`` ranks, in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return parts


def unslab(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The whole tensor from every rank's slab ``x`` (the inverse of
    ``slab`` over ``group``)."""
    return x if n == 1 else torch.cat(all_gather_parts(x, group, n), dim=dim)


def shard(mesh: DeviceMesh, x: torch.Tensor, placements) -> torch.Tensor:
    """This rank's slab of the whole tensor ``x`` (the same on every
    rank) under ``placements``; no communication. A sharded axis must
    divide evenly."""
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            x = slab(x, p.dim, mesh.get_local_rank(i), mesh.size(i))
    return x.contiguous()


def gather(mesh: DeviceMesh, x: torch.Tensor, placements) -> torch.Tensor:
    """The whole tensor from this rank's slab ``x``: every rank's slab,
    gathered along each sharded axis (the inverse of ``shard``)."""
    for i in reversed(range(len(placements))):
        p = placements[i]
        if isinstance(p, Shard):
            x = unslab(x, p.dim, mesh.get_group(i), mesh.size(i))
    return x
