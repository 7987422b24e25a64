"""Eager data parallelism (counterpart of paddle_tpu/dygraph/parallel.py;
reference dygraph/parallel.py: DataParallel :225, scale_loss :292,
apply_collective_grads :384; imperative/all_reduce.cc).

The fluid contract is per process: scale the loss by 1/nranks, and sum
the gradients over the ranks after backward. One process runs one rank
of torch.distributed (parallel/mesh.py: NCCL on the card, gloo on the
CPU), and the sum is one all_reduce per gradient dtype over a coalesced
buffer, in place of the JAX package's psum over a one-axis mesh. The
ranks are those of the current mesh's "dp" axis (parallel.mesh_guard),
else the whole world. Without a process
group the job has one rank and the sum is the identity, as the
reference's with nranks == 1; a 1-rank group runs the all_reduce."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..errors import PreconditionNotMetError
from ..parallel.mesh import DATA_AXIS, current_mesh
from .layers import Layer


class ParallelEnv:
    """Rank information (reference dygraph/parallel.py Env): the started
    process group's world size and rank, else the PADDLE_* env vars."""

    def __init__(self):
        started = dist.is_initialized()
        self.nranks = (dist.get_world_size() if started
                       else int(os.environ.get("PADDLE_TRAINERS_NUM", 1)))
        self.local_rank = (dist.get_rank() if started
                           else int(os.environ.get("PADDLE_TRAINER_ID", 0)))
        self.dev_id = 0
        self.current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        self.trainer_endpoints = [
            e
            for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
            if e
        ]


def prepare_context(strategy=None):
    """The job's ParallelEnv. A job of several ranks needs its process
    group started first (torch.distributed.init_process_group, one
    process per rank)."""
    env = strategy or ParallelEnv()
    if env.nranks > 1 and not dist.is_initialized():
        raise PreconditionNotMetError(
            f"{env.nranks} ranks but no process group is started: call "
            "torch.distributed.init_process_group in each rank's process "
            "first")
    return env


class DataParallel(Layer):
    def __init__(self, layers, strategy=None):
        super().__init__()
        self._layers = layers
        self._strategy = strategy or ParallelEnv()
        self.add_sublayer("_layers", layers)

    def _reduce_group(self):
        mesh = current_mesh()
        if mesh is not None and DATA_AXIS in mesh.axis_names:
            return mesh.group(DATA_AXIS)
        return None  # the default group: every rank

    @property
    def nranks(self):
        if dist.is_initialized():
            return dist.get_world_size(self._reduce_group())
        return max(1, getattr(self._strategy, "nranks", 1))

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def scale_loss(self, loss):
        if self.nranks <= 1:
            return loss
        return loss * (1.0 / self.nranks)

    def apply_collective_grads(self):
        """Sum every trainable parameter's gradient over the ranks, in
        place: one all_reduce per dtype over the gradients flattened into
        one buffer (the reference's coalesced buckets, :384). The identity
        when no process group is started."""
        if not dist.is_initialized():
            return
        group = self._reduce_group()
        grads = [p.value.grad for p in self.parameters()
                 if p.trainable and p.value.grad is not None]
        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for dtype in sorted(by_dtype, key=str):
            bucket = by_dtype[dtype]
            flat = _flatten_dense_tensors(bucket)
            dist.all_reduce(flat, group=group)
            with torch.no_grad():
                for g, s in zip(bucket, _unflatten_dense_tensors(flat,
                                                                 bucket)):
                    g.copy_(s)

    def state_dict(self, prefix=""):
        return self._layers.state_dict(prefix=prefix)

    def set_dict(self, state, use_structured_name=True):
        self._layers.set_dict(state)

    load_dict = set_dict
