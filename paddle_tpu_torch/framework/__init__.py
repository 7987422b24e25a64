from . import unique_name  # noqa: F401
from .backward import append_backward, gradients  # noqa: F401
from .executor import Executor  # noqa: F401
from .program import (  # noqa: F401
    Block,
    Operator,
    Parameter,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    grad_var_name,
    in_dygraph_mode,
    program_guard,
)
from .scope import Scope, global_scope, scope_guard  # noqa: F401
