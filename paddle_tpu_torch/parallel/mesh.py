"""Device mesh over the ranks of torch.distributed (counterpart of
paddle_tpu/parallel/mesh.py).

The JAX package names logical mesh axes ("dp", "mp", "pp", "sp", "ep")
over a `jax.sharding.Mesh` of devices and lets XLA lay its collectives
onto them. Here one process runs one rank: a mesh names the axes of a
`torch.distributed.device_mesh.DeviceMesh` over the world's ranks, with
one process group per axis, and the collective ops
(ops/collective.py) and the sequence-parallel ops
(parallel/ring_attention.py) run over the group of the axis they name,
NCCL on the card and gloo on the CPU.

A mesh of one rank needs no launcher: when no process group exists,
make_mesh sets up a 1-rank group itself (NCCL for a CUDAPlace, gloo for
CPUPlace(), through a FileStore in a temporary directory) and
Mesh.close() ends it. A larger mesh runs under a process group that the
caller started, one process per rank, and must cover the world.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from ..core.place import default_place
from ..errors import InvalidArgumentError

# Canonical axis names used across the framework.
DATA_AXIS = "dp"  # data parallel (batch sharding, grad allreduce)
MODEL_AXIS = "mp"  # tensor/model parallel (weight sharding)
PIPE_AXIS = "pp"  # pipeline stages
SEQ_AXIS = "sp"  # sequence/context parallel (ring attention)
EXPERT_AXIS = "ep"  # expert parallel (MoE all_to_all)

_current_mesh = None


class Mesh:
    """Named axes over the ranks of torch.distributed: `axis_names`,
    `shape` ({axis: size}, in order), `size`, the place its ranks run on,
    and per axis this rank's process group (`group`) and coordinate
    (`coordinate`). Built by make_mesh."""

    def __init__(self, device_mesh, place, owned_store=None):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.size = math.prod(self.shape.values())
        self.place = place
        # the temporary store directory of a 1-rank group make_mesh started
        self._owned_store = owned_store

    def group(self, axis):
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis):
        """This rank's index along `axis`."""
        return self.device_mesh.get_local_rank(axis)

    def global_rank(self, axis, index):
        """The world rank of the member `index` of this rank's `axis`
        group."""
        return dist.get_global_rank(self.group(axis), index)

    def close(self):
        """End the 1-rank process group make_mesh started (no-op for a
        group the caller started)."""
        if self._owned_store is not None and dist.is_initialized():
            dist.destroy_process_group()
            shutil.rmtree(self._owned_store, ignore_errors=True)
            self._owned_store = None

    def __repr__(self):
        return f"Mesh({self.shape}, {self.place!r})"


def _start_one_rank_group(place):
    """A 1-rank default process group for `place`; returns its store's
    temporary directory."""
    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_mesh_")
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    if place.device_type == "cuda":
        device = place.torch_device()  # raises without a card
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=device)
    else:
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    return tmp


def make_mesh(axes, place=None):
    """A Mesh of {axis_name: size} over the ranks of torch.distributed;
    the sizes multiply to the world size. With no process group started,
    a mesh of size 1 starts its own 1-rank group (NCCL on a CUDAPlace, the
    default place; gloo on CPUPlace()); a larger one raises."""
    from torch.distributed.device_mesh import init_device_mesh

    place = place if place is not None else default_place()
    owned = None
    world = dist.get_world_size() if dist.is_initialized() else 1
    names, sizes = list(axes), [int(s) for s in axes.values()]
    total = math.prod(sizes)
    if total != world:
        raise InvalidArgumentError(
            f"mesh {dict(zip(names, sizes))} needs {total} ranks, the world "
            f"has {world}"
            + ("" if dist.is_initialized() else
               " (no process group is started: start one rank per process "
               "with torch.distributed.init_process_group first)"))
    if not dist.is_initialized():
        owned = _start_one_rank_group(place)
    device_type = "cuda" if place.device_type == "cuda" else "cpu"
    dm = init_device_mesh(device_type, tuple(sizes),
                          mesh_dim_names=tuple(names))
    return Mesh(dm, place, owned_store=owned)


def current_mesh():
    return _current_mesh


@contextlib.contextmanager
def mesh_guard(mesh):
    global _current_mesh
    old = _current_mesh
    _current_mesh = mesh
    try:
        yield mesh
    finally:
        _current_mesh = old


def set_global_mesh(mesh):
    global _current_mesh
    _current_mesh = mesh


def spec(*axes):
    """A sharding spec: the mesh axis (or None) of each leading dim;
    spec("dp") shards dim 0 over "dp", spec() is replicated (the JAX
    package's PartitionSpec shorthand, as a tuple)."""
    return tuple(axes)
