"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The same Program/Block/Op IR and fluid-style layers API, with each op's
emitter written over torch tensors and the JAX package's Pallas kernels
replaced by hand-written Hopper kernels (kernels/). This package imports
torch and never jax, and nothing of paddle_tpu.

Entry points run on the card (`CUDAPlace(0)`) unless the caller passes
`CPUPlace()`.
"""

from . import ops  # noqa: F401  (registers every op emitter)
from . import contrib, initializer, layers, optimizer, parallel  # noqa: F401
from . import clip, dygraph, inference, io, metrics, regularizer  # noqa: F401
from .core import CPUPlace, CUDAPlace, default_place  # noqa: F401
from .framework import (  # noqa: F401
    Executor,
    append_backward,
    gradients,
    in_dygraph_mode,
    Program,
    Scope,
    default_main_program,
    default_startup_program,
    global_scope,
    program_guard,
    scope_guard,
    unique_name,
)
from .flags import get_flags, set_flags  # noqa: F401
from .layers import data  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401
