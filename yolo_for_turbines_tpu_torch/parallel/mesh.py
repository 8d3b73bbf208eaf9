"""Process meshes and batch placement for data parallelism (counterpart of
``yolo_for_turbines_tpu/parallel/mesh.py``).

The JAX package runs one controller over a ``jax.sharding.Mesh`` of local
devices and lets XLA insert the gradient all-reduce. Here every rank is a
process (``torchrun`` starts them, ``torch.distributed`` joins them) that
owns one device, and a :class:`Mesh` describes how the ranks of the world
are laid out: its axis names and shape, this rank's coordinates, its device,
and one process group per axis. Batches shard along their leading axis in
rank order; parameters are replicated, each rank holding its own copy.

A world of one rank needs no process group: ``create_mesh()`` in a process
where none is initialised gives a one-rank mesh whose collectives do
nothing. A one-rank world that was initialised (``torchrun
--nproc_per_node=1``) runs its collectives through the backend all the
same.

The collectives themselves live in ``comm.py``; the train step, the
predictor and the trainer take a mesh (``train/steps.py``,
``inference.py``, ``train/trainer.py``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DATA_AXIS = "data"
DCN_AXIS = "dcn"
SPACE_AXIS = "space"  # spatial partitioning's axis (``spatial.py``)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a mesh of ranks.

    ``shape`` gives the size of each axis of ``axis_names``; rank r of the
    world sits at ``np.unravel_index(r, shape)``. ``group`` spans every rank
    of the mesh (None: a one-rank mesh with no process group, whose
    collectives do nothing); ``axis_groups[name]`` spans the ranks that
    share every coordinate but ``name`` (None where that axis has size 1).
    A rank of the world beyond the mesh's size is idle: it has no
    coordinates and takes part in nothing."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    device: torch.device
    group: Optional[object] = None
    axis_groups: Dict[str, Optional[object]] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def active(self) -> bool:
        return self.rank < self.size

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)] if name in self.axis_names else 1

    def axis_index(self, name: str) -> int:
        if name not in self.axis_names:
            return 0
        return int(np.unravel_index(self.rank, self.shape)[self.axis_names.index(name)])


def init_from_env(device="cuda") -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...), once:
    NCCL for a CUDA device, gloo for the CPU. Returns whether a process
    group is initialised afterwards; outside ``torchrun`` nothing happens."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://")
    return True


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` as given, or ``cuda:<LOCAL_RANK>``
    (``LOCAL_RANK`` as ``torchrun`` sets it, 0 without one). A bare
    ``"cuda"`` gets the local rank's index; a CUDA device must exist."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return resolve_device(device, "this rank")


def _world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _group_of(ranks: Sequence[int], world: int):
    """The process group over ``ranks`` (every rank of the world must call
    this, in the same order): the world's own group when they are the
    whole world (one rank included), None for a single rank of a larger
    world or without a process group."""
    if not dist.is_initialized():
        return None
    if list(ranks) == list(range(world)):
        return dist.group.WORLD
    if len(ranks) == 1:
        return None
    return dist.new_group(list(ranks))


def _build(axis_names, shape, device, what: str) -> Mesh:
    world, rank = _world()
    n = math.prod(shape)
    if world < n:
        raise ValueError(f"{what} needs {n} ranks, the world has {world}")
    device = rank_device(device)
    grid = np.arange(n).reshape(shape)
    group = _group_of(range(n), world)
    axis_groups = {}
    for ax, name in enumerate(axis_names):
        mine = None
        # every line of ranks along this axis, in a fixed order on every rank
        lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
        for line in lines:
            g = _group_of(line.tolist(), world)
            if rank in line:
                mine = g
        axis_groups[name] = mine
    return Mesh(tuple(axis_names), tuple(shape), rank, device, group, axis_groups)


def create_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """1-D ``("data",)`` mesh over the world's ranks.

    Reads the process group that ``torchrun`` set up (``init_from_env``),
    or a world of one rank when none is initialised. ``n_devices``, when
    given, must be the world's size: a rank left out of a ``torchrun`` job
    cannot idle through it. ``device`` is this rank's device
    (``rank_device``: ``cuda:<LOCAL_RANK>`` unless the caller asks for the
    CPU)."""
    world, _ = _world()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"create_mesh({n_devices}): the world has {world} ranks; a mesh "
                         f"of data parallelism spans all of them")
    return _build((DATA_AXIS,), (n,), device, "create_mesh")


def create_multislice_mesh(n_slices: int, chips_per_slice: int, device=None) -> Mesh:
    """2-D ``("dcn", "data")`` mesh: rank r is chip ``r % chips_per_slice``
    of slice ``r // chips_per_slice``.

    Batches shard over both axes, in rank order (``batch_sharding``). The
    gradient all-reduce runs over the whole mesh: how a hierarchical
    reduction is ordered is the transport's business (NCCL's rings and
    trees), and the sum is the same."""
    return _build((DCN_AXIS, DATA_AXIS), (n_slices, chips_per_slice), device,
                  "create_multislice_mesh")


def batch_group(mesh: Mesh):
    """The ranks that hold different rows of the batch and the same rows of
    an image: the whole mesh, or the ``"data"`` axis of a spatial mesh."""
    if SPACE_AXIS in mesh.axis_names:
        return mesh.axis_groups.get(DATA_AXIS)
    return mesh.group


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which block of a host array this rank holds: ``dims`` maps an axis
    to (this rank's index, the number of equal blocks); axes not named are
    whole. ``place`` takes the block and puts it on ``device``."""

    dims: Dict[int, Tuple[int, int]]
    device: torch.device

    def take(self, array):
        """This rank's block of ``array`` (numpy or tensor), as a view."""
        index = [slice(None)] * len(array.shape)
        for axis, (i, n) in self.dims.items():
            size = array.shape[axis]
            if size % n:
                raise ValueError(f"axis {axis} of size {size} does not divide into {n} "
                                 "shards (parallel.mesh.pad_batch_to_multiple pads a "
                                 "ragged batch)")
            step = size // n
            index[axis] = slice(i * step, (i + 1) * step)
        return array[tuple(index)]

    def place(self, array) -> torch.Tensor:
        block = self.take(array)
        if isinstance(block, np.ndarray):
            block = np.ascontiguousarray(block)
        return torch.as_tensor(block).to(self.device)


def batch_sharding(mesh: Mesh) -> Sharding:
    """The rank's rows of the leading (batch) axis: over every axis of a
    data-parallel mesh in rank order, over ``"data"`` of a spatial mesh."""
    if SPACE_AXIS in mesh.axis_names:
        return Sharding({0: (mesh.axis_index(DATA_AXIS), mesh.axis_size(DATA_AXIS))},
                        mesh.device)
    return Sharding({0: (mesh.rank, mesh.size)}, mesh.device)


def replicated_sharding(mesh: Mesh) -> Sharding:
    """The whole array on every rank (parameters, optimizer state)."""
    return Sharding({}, mesh.device)


def tree_map(fn, tree):
    """``fn`` over the leaves of nested tuples, lists and dicts."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: Mesh):
    """The rank's shard of a host batch (a tree of arrays) on its device."""
    sharding = batch_sharding(mesh)
    return tree_map(sharding.place, batch)


def pad_batch_to_multiple(batch, multiple: int):
    """Pad the leading axis of every array of ``batch`` with zeros to a
    multiple of ``multiple`` (the last batch of an epoch); returns
    (padded_batch, real_count). numpy copies."""
    leaves = []
    tree_map(leaves.append, batch)
    n = leaves[0].shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch, n

    def padded(x):
        x = np.asarray(x)
        return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])

    return tree_map(padded, batch), n
