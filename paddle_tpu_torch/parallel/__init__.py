"""Parallel execution (counterpart of paddle_tpu/parallel): the mesh over
torch.distributed's ranks, SPMD program annotation, gradient allreduce
insertion, and sequence parallelism (ring and Ulysses attention)."""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    Mesh,
    current_mesh,
    make_mesh,
    mesh_guard,
    set_global_mesh,
    spec,
)
from .spmd import shard_program, spec_for  # noqa: F401
from .transpiler import insert_grad_allreduce  # noqa: F401
from . import ring_attention  # noqa: F401  (registers the SP ops)
