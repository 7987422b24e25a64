"""Learning-rate schedules built in-graph from existing ops (counterpart of
paddle_tpu/layers/learning_rate_scheduler.py; reference
python/paddle/fluid/layers/learning_rate_scheduler.py: noam_decay :58,
exponential_decay :114, natural_exp_decay :167, inverse_time_decay :218,
polynomial_decay :272, piecewise_decay :339, cosine_decay :407,
linear_lr_warmup :447).

The schedule is a handful of [1]-shaped ops appended to the main program
and run with the step. The global step counter `@LR_DECAY_COUNTER@` is an
int32 [1] persistable bumped by an `increment` op, as in the JAX package,
so checkpoints and convert.py carry the same state on both sides.
"""

from __future__ import annotations

import math

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


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """lr * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5), from
    step 1."""
    step = _decay_step_counter(begin=1)
    a = tensor.pow(step, factor=-0.5)
    b = step * float(warmup_steps) ** -1.5
    return (tensor.elementwise_min(a, b)
            * (float(learning_rate) * float(d_model) ** -0.5))


def _decay_ratio(decay_steps, staircase):
    step = _decay_step_counter()
    div = step / float(decay_steps)
    return tensor.floor(div) if staircase else div


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * decay_rate^(step / decay_steps), the exponent floored with
    staircase."""
    div = _decay_ratio(decay_steps, staircase)
    return float(learning_rate) * tensor.elementwise_pow(_f(decay_rate), div)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * exp(-decay_rate * step / decay_steps)."""
    div = _decay_ratio(decay_steps, staircase)
    return float(learning_rate) * tensor.exp(div * -float(decay_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * step / decay_steps)."""
    div = _decay_ratio(decay_steps, staircase)
    denom = div * float(decay_rate) + 1.0
    return _f(learning_rate) / denom


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(lr - end) * (1 - step / steps)^power + end, where steps is
    decay_steps and the step is held there, or with cycle decay_steps
    times ceil(step / decay_steps) (1 at step 0)."""
    step = _decay_step_counter()
    if cycle:
        ratio = tensor.ceil(step / float(decay_steps))
        zero = tensor.cast(tensor.equal(step, _f(0.0)), "float32")
        steps = (ratio + zero) * float(decay_steps)
    else:
        steps = _f(decay_steps)
        step = tensor.elementwise_min(step, steps)
    frac = tensor.pow(1.0 - step / steps, factor=float(power))
    return (float(learning_rate) - float(end_learning_rate)) * frac + float(
        end_learning_rate
    )


def piecewise_decay(boundaries, values):
    """values[i] while step < boundaries[i]; values[-1] after the last:
    a chain of selects folded from the right."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    step = _decay_step_counter()
    lr = _f(values[-1])
    for b, v in reversed(list(zip(boundaries, values[:-1]))):
        m = tensor.cast(tensor.less_than(step, _f(b)), "float32")
        lr = m * float(v) + (1.0 - m) * lr
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """lr / 2 * (cos(epoch * pi / epochs) + 1), epoch = floor(step /
    step_each_epoch)."""
    step = _decay_step_counter()
    epoch = tensor.floor(step / float(step_each_epoch))
    return 0.5 * float(learning_rate) * (
        tensor.cos(epoch * (math.pi / float(epochs))) + 1.0)


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
