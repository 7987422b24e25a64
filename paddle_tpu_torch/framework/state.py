"""Persistable state vars registered in both the main and the startup
program (counterpart of paddle_tpu/framework/state.py): the LR
schedule's step counter and anything else that lives in the scope and is
initialised by the startup program."""

from __future__ import annotations

from . import unique_name
from .program import default_main_program, default_startup_program


def create_persistable_var(name_hint, shape, dtype, init=0.0, unique=True,
                           main=None, startup=None):
    """A non-trainable persistable var in main and startup (the default
    programs unless given), with a fill_constant init op in startup.
    Returns the main-program Variable."""
    blk = (main or default_main_program()).global_block
    startup = (startup or default_startup_program()).global_block
    name = unique_name.generate(name_hint) if unique else name_hint
    v = blk.create_parameter(name, list(shape), dtype, trainable=False)
    v.stop_gradient = True
    startup.create_parameter(name, list(shape), dtype, trainable=False)
    startup.append_op(
        "fill_constant",
        {},
        {"Out": [name]},
        {"shape": list(shape), "dtype": dtype, "value": float(init)},
    )
    return v


def create_step_counter(name_hint, init=0.0, unique=True):
    """int32 [1] counter plus an in-graph `increment` op (int32 because a
    float32 counter saturates at 2^24 steps, as in the JAX package)."""
    v = create_persistable_var(name_hint, [1], "int32", init, unique=unique)
    default_main_program().global_block.append_op(
        "increment", {"X": [v.name]}, {"Out": [v.name]}, {"step": 1.0}
    )
    return v
