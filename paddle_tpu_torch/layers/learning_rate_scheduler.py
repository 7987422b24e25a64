"""Learning-rate schedules built in-graph from existing ops (counterpart of
paddle_tpu/layers/learning_rate_scheduler.py; reference
python/paddle/fluid/layers/learning_rate_scheduler.py polynomial_decay
:272, linear_lr_warmup :447).

The schedule is a handful of [1]-shaped ops appended to the main program
and run with the step. The global step counter `@LR_DECAY_COUNTER@` is an
int32 [1] persistable bumped by an `increment` op, as in the JAX package,
so checkpoints and convert.py carry the same state on both sides.
"""

from __future__ import annotations

from ..errors import UnimplementedError
from ..framework.program import Variable, default_main_program
from ..framework.state import create_step_counter
from . import tensor

LR_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _decay_step_counter(begin=0):
    """The global step as float32. The increment op runs before the decay
    math, so the counter starts at begin - 1 and the first run sees
    `begin`. One counter per program, shared by composed schedules; a
    schedule whose `begin` differs from the counter's gets a constant
    offset."""
    prog = default_main_program()
    main = prog.global_block
    if not main.has_var(LR_COUNTER_NAME):
        create_step_counter(LR_COUNTER_NAME, init=float(begin) - 1.0,
                            unique=False)
        prog._lr_counter_begin = int(begin)
    step = tensor.cast(main.var(LR_COUNTER_NAME), "float32")
    delta = int(begin) - getattr(prog, "_lr_counter_begin", int(begin))
    if delta:
        step = step + float(delta)
    return step


def _f(value):
    return tensor.fill_constant([1], "float32", float(value))


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(lr - end) * (1 - min(step, decay_steps) / decay_steps)^power + end.
    Only the cycle=False form is in this slice."""
    if cycle:
        raise UnimplementedError(
            "polynomial_decay(cycle=True) is not in this slice of the port"
        )
    step = _decay_step_counter()
    steps = _f(decay_steps)
    step = tensor.elementwise_min(step, steps)
    frac = tensor.pow(1.0 - step / steps, factor=float(power))
    return (float(learning_rate) - float(end_learning_rate)) * frac + float(
        end_learning_rate
    )


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """Linear ramp start_lr -> end_lr for warmup_steps, then
    `learning_rate` (a float or another schedule's Variable)."""
    step = _decay_step_counter()
    if not isinstance(learning_rate, Variable):
        learning_rate = _f(learning_rate)
    ramp = float(start_lr) + (float(end_lr) - float(start_lr)) * (
        step / float(warmup_steps)
    )
    m = tensor.cast(tensor.less_than(step, _f(warmup_steps)), "float32")
    return m * ramp + (1.0 - m) * learning_rate
