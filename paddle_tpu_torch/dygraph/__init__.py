"""Eager ("dygraph") mode (counterpart of paddle_tpu/dygraph/; reference
python/paddle/fluid/dygraph/ + paddle/fluid/imperative/):

* one op set: eager calls the same torch emitters as the static Executor;
* torch autograd is the tape (tracer.py), where the JAX package records
  jax.vjp closures; the fused kernels' ops run their dedicated grad ops
  as autograd Functions, so their backward kernels run;
* eager optimizers (optimizer.py's `minimize` on a VarBase loss), LR
  schedules, save_dygraph/load_dygraph in the JAX package's format and
  DataParallel over torch.distributed.

The dygraph->static half (TracedLayer, declarative / to_static,
ProgramTranslator) is not in the port yet: its names raise
UnimplementedError.
"""

from ..errors import UnimplementedError
from .base import enabled, guard, no_grad, to_variable  # noqa: F401
from .checkpoint import load_dygraph, save_dygraph  # noqa: F401
from .layers import Layer, LayerList, ParameterList, Sequential  # noqa: F401
from .nn import (  # noqa: F401
    BatchNorm,
    Conv2D,
    Dropout,
    Embedding,
    GRUUnit,
    LayerNorm,
    Linear,
    Pool2D,
)
from .parallel import DataParallel, ParallelEnv, prepare_context  # noqa: F401
from .tracer import Tracer  # noqa: F401
from .varbase import ParamBase, VarBase  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    CosineDecay,
    ExponentialDecay,
    InverseTimeDecay,
    LearningRateDecay,
    LinearLrWarmup,
    NaturalExpDecay,
    NoamDecay,
    PiecewiseDecay,
    PolynomialDecay,
    ReduceLROnPlateau,
)

_TO_STATIC = ("is not in the port yet (ROADMAP Queue 1, item 9b — "
              "dygraph→static: jit.py, dygraph_to_static.py and "
              "ast_transform.py)")


def _unported(name):
    def refuse(*args, **kwargs):
        raise UnimplementedError(f"dygraph.{name} {_TO_STATIC}")

    refuse.__name__ = refuse.__qualname__ = name
    return refuse


class TracedLayer:
    """dygraph→static capture (reference dygraph/jit.py:204): not ported."""

    def __init__(self, *args, **kwargs):
        raise UnimplementedError(f"dygraph.TracedLayer {_TO_STATIC}")

    @staticmethod
    def trace(layer, inputs):
        raise UnimplementedError(f"dygraph.TracedLayer.trace {_TO_STATIC}")


class ProgramTranslator:
    """reference program_translator.py:252: not ported."""

    def __init__(self, *args, **kwargs):
        raise UnimplementedError(f"dygraph.ProgramTranslator {_TO_STATIC}")

    @classmethod
    def get_instance(cls):
        return cls()


declarative = _unported("declarative")
to_static = _unported("to_static")
