"""The mesh and the batch's split over it.

Counterpart of ``dm_control_tpu/parallel/mesh.py``.  PyTorch has no
global array: a mesh is the process group with this process's rank and
device, and a batched tensor "sharded" over it is the rank's own block
of rows, ``rows(mesh, B)`` of the global batch B.  Learner inputs are
gathered from every rank (``all_gather_rows``), gradients averaged
(``all_reduce_mean``); with no process group (one process) both are the
identity.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One device a process, over the default process group (or this
    process alone where ``torch.distributed`` is not initialised): this
    process's rank and device, the world size and the names of the axes
    the env batch splits over."""

    rank: int
    world_size: int
    device: torch.device
    axis_names: Tuple[str, ...] = ("env",)

    @property
    def size(self) -> int:
        return self.world_size

    @property
    def distributed(self) -> bool:
        """Whether collectives go through a process group (also at world
        size 1, where a group was initialised)."""
        return dist.is_available() and dist.is_initialized()

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch``."""
        if batch % self.world_size:
            raise ValueError(f"a batch of {batch} does not split over "
                             f"{self.world_size} ranks")
        n = batch // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)


def _default_device(rank: int):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "mesh on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, axis: str = "env",
              devices=None, *, device=None) -> Mesh:
    """A 1-D mesh over the processes of the default group, or over this
    process alone where ``torch.distributed`` is not initialised.  ``device`` defaults to the card of this rank;
    ``devices`` (a sequence indexed by rank) picks another.
    ``n_devices``, where given, must be the world size."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over a world of "
                         f"{world} processes")
    if device is None:
        device = devices[rank] if devices is not None \
            else _default_device(rank)
    return Mesh(rank=rank, world_size=world,
                device=torch.device(device), axis_names=(axis,))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on the mesh: split along its leading axis over
    ``axis_names``, or replicated (``axis_names`` empty)."""

    mesh: Mesh
    axis_names: Tuple[str, ...] = ()

    @property
    def is_fully_replicated(self) -> bool:
        return not self.axis_names or self.mesh.world_size == 1


def env_sharding(mesh: Mesh, axis: str = "env") -> Sharding:
    """The leading (env) axis split over the mesh."""
    return Sharding(mesh, (axis,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def map_tensors(fn: Callable, tree):
    """``fn`` on every tensor of a tree of dataclasses, dicts, lists and
    tuples; other leaves (generators, numbers, None) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return type(tree)((k, map_tensors(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def shard_batch(mesh: Mesh, tree, axis: str = "env", batch=None):
    """This rank's rows of a batched tree, on the mesh's device: every
    tensor whose leading axis is the global batch (``batch``, by default
    the largest leading axis that splits over the mesh) keeps
    ``mesh.rows(batch)``; every other tensor is replicated as it is."""
    if batch is None:
        sizes = []
        map_tensors(lambda x: sizes.append(x.shape[0]) if x.dim() else x,
                    tree)
        sizes = [n for n in sizes if n % mesh.world_size == 0]
        batch = max(sizes, default=0)

    def place(x):
        x = x.to(mesh.device)
        if x.dim() and x.shape[0] == batch:
            return x[mesh.rows(batch)]
        return x

    return map_tensors(place, tree)


def shard_env_map(mesh: Mesh, fn, axis=None):
    """``fn`` (a batched env function: every argument and result a tree
    whose tensors carry the env batch first) run by each rank on its own
    rows only, with no collective inside: the property the JAX package's
    ``shard_env_map`` exists for (its batch-wide predicates, the solver's
    convergence test and the autoreset's ``any``, stay local to a rank).
    Each rank already holds only its rows, so this is ``fn`` itself,
    checked to be given a mesh."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"shard_env_map needs a Mesh, not {type(mesh)}")
    return fn


def all_gather_rows(mesh: Mesh, x: torch.Tensor, dim: int = 0):
    """Every rank's ``x`` concatenated along ``dim`` in rank order (each
    rank's block of the global batch); ``x`` itself without a process
    group."""
    if not mesh.distributed:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=dim)


def all_reduce_mean(mesh: Mesh, tensors):
    """Each tensor replaced in place by its mean over the ranks."""
    if not mesh.distributed:
        return tensors
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        t.div_(mesh.world_size)
    return tensors
