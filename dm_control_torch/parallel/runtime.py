"""Joining processes into one group, and env batches over it.

Counterpart of ``dm_control_tpu/parallel/runtime.py``: one process a
device, joined by ``torch.distributed.init_process_group`` at a TCP
address this code is given (``tcp://127.0.0.1:<port>`` on one host); NCCL
where the device is the card, gloo on the CPU.  A failed join raises.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from dm_control_torch.parallel.mesh import (
    Mesh, Sharding, make_mesh, map_tensors, replicated,  # noqa: F401
)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               *, backend: Optional[str] = None,
               timeout: Optional[float] = None) -> None:
    """Joins this process to the group of ``num_processes`` at
    ``coordinator_address`` (``host:port``, rank 0's), as rank
    ``process_id``.  A no-op where a group exists already, or for one
    process with no coordinator.  ``backend`` defaults to NCCL where the
    card is there, else gloo; with NCCL the process's device is the card
    ``local_device_ids[0]`` (by default its rank's).  ``timeout`` (seconds)
    bounds every collective."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a "
                             f"coordinator_address")
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    rank = int(process_id or 0)
    if backend == "nccl":
        ids = local_device_ids or [rank % torch.cuda.device_count()]
        torch.cuda.set_device(int(ids[0]))
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes or 1), rank=rank, **kwargs)


def pod_mesh(host_axis: str = "host", env_axis: str = "env",
             devices=None, *, device=None) -> Mesh:
    """The mesh over every process with the axes (host, env): one device
    a process, so the env batch splits over the processes."""
    mesh = make_mesh(devices=devices, device=device)
    return Mesh(rank=mesh.rank, world_size=mesh.world_size,
                device=mesh.device, axis_names=(host_axis, env_axis))


def env_batch_sharding(mesh: Mesh) -> Sharding:
    """The leading env axis split over every axis of the mesh."""
    return Sharding(mesh, tuple(mesh.axis_names))


def make_global_env_batch(mesh: Mesh, local_tree):
    """The env batch of which each process passes only its own rows: in
    PyTorch the rank's rows are its part of the global batch as they
    stand, so this puts them on the mesh's device and checks
    (``assert_partitioned``) that the ranks' rows add up to the global
    batch, ``world_size`` times the longest leading axis of the tree."""
    tree = map_tensors(lambda x: x.to(mesh.device), local_tree)
    sizes = []
    map_tensors(lambda x: sizes.append(x.shape[0]) if x.dim() else x, tree)
    assert_partitioned(tree, mesh, max(sizes, default=0) * mesh.world_size)
    return tree


def assert_partitioned(tree, mesh: Mesh, batch: int) -> None:
    """Raises if a tensor of ``tree`` on the env axis is held whole, or
    in uneven parts, on the ranks: the check that the env state is split.
    A tensor is on the env axis where some rank holds ``batch`` or
    ``batch // world_size`` rows of it (its leading axis); its rows on all
    ranks must then add up to ``batch``.  Given the same ``batch``, every
    rank reaches the same verdict."""
    if mesh.world_size == 1 or not mesh.distributed:
        return
    rows = []
    map_tensors(lambda x: rows.append(x.shape[0] if x.dim() else -1), tree)
    mine = torch.tensor(rows, dtype=torch.int64, device=mesh.device)
    parts = [torch.empty_like(mine) for _ in range(mesh.world_size)]
    dist.all_gather(parts, mine)
    every = torch.stack(parts).cpu()
    on_axis = ((every == batch) | (every == batch // mesh.world_size)).any(0)
    bad = (on_axis & (every.sum(0) != batch)).nonzero().flatten().tolist()
    if bad:
        raise AssertionError(
            f"env batch leaves not split over {mesh.world_size} ranks "
            f"(global batch {batch}): leaves {bad[:5]} hold rows "
            f"{every[:, bad[:5]].tolist()} by rank")
