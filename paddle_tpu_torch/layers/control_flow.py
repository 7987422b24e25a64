"""Control-flow layers of the training slice (counterpart of
paddle_tpu/layers/control_flow.py; reference python/paddle/fluid/layers/
control_flow.py increment :1497)."""

from __future__ import annotations

from ..framework import unique_name
from ..framework.program import default_main_program


def increment(x, value=1.0, in_place=True):
    """x + value, appended to the current block; in place (the default)
    the output is x itself, so the executor writes a persistable x back."""
    blk = default_main_program().current_block()
    out = x
    if not in_place:
        out = blk.create_var(name=unique_name.generate("increment"),
                             shape=x.shape, dtype=x.dtype)
    blk.append_op(
        "increment", {"X": [x.name]}, {"Out": [out.name]}, {"step": value}
    )
    return out
