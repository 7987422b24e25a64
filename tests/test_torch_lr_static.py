"""Port parity for the static learning-rate schedules
(paddle_tpu_torch/layers/learning_rate_scheduler.py): noam_decay,
exponential_decay, natural_exp_decay, inverse_time_decay (each with and
without staircase), polynomial_decay (with and without cycle),
piecewise_decay, cosine_decay and linear_lr_warmup over another
schedule, every case of tests/test_lr_meta.py, each built in both
packages (the same ops, slots and attrs) and run for 20 steps on the
CPU: the learning rate a step and the int32 step counter against the
JAX package's. A schedule also drives SGD, the parameters held against
the JAX package's after four steps.

Tolerance: the learning rate rtol 1e-6, atol 1e-12 (a few fp32 ops on
[1] tensors, pow and cos by other libraries); the counter exactly;
SGD's parameters atol 1e-6 + rtol 1e-5.
"""

import numpy as np
import pytest

from torch_fit_a_line import (assert_states_close, fit_a_line, line_feeds,
                              run_both)

STEPS = 20
COUNTER = "@LR_DECAY_COUNTER@"

SCHEDULES = {
    "noam": lambda L: [L.noam_decay(d_model=64, warmup_steps=4,
                                    learning_rate=2.0)],
    "exponential": lambda L: [L.exponential_decay(0.1, 3, 0.5)],
    "exponential_staircase": lambda L: [L.exponential_decay(
        0.1, decay_steps=3, decay_rate=0.5, staircase=True)],
    "natural_exp": lambda L: [L.natural_exp_decay(0.1, 5, 0.7)],
    "natural_exp_staircase": lambda L: [L.natural_exp_decay(
        0.1, 5, 0.7, staircase=True)],
    "inverse_time": lambda L: [L.inverse_time_decay(0.1, 5, 0.5)],
    "inverse_time_staircase": lambda L: [L.inverse_time_decay(
        0.1, 5, 0.5, staircase=True)],
    "polynomial": lambda L: [L.polynomial_decay(1.0, 8, 0.1, power=2.0)],
    "polynomial_cycle": lambda L: [L.polynomial_decay(
        1.0, decay_steps=4, end_learning_rate=0.1, power=2.0, cycle=True)],
    "piecewise": lambda L: [L.piecewise_decay([2, 5], [1.0, 0.5, 0.1])],
    "cosine": lambda L: [L.cosine_decay(0.5, step_each_epoch=2, epochs=4)],
    "warmup_over_exponential": lambda L: [L.linear_lr_warmup(
        L.exponential_decay(0.1, 10, 0.5), warmup_steps=3, start_lr=0.0,
        end_lr=0.1)],
    "warmup_over_polynomial_cycle": lambda L: [L.linear_lr_warmup(
        L.polynomial_decay(0.1, 5, 0.01, cycle=True), 4, 0.0, 0.1)],
    # a schedule from step 1 after one from step 0 shares the counter,
    # offset by the difference of their beginnings
    "exponential_then_noam": lambda L: [L.exponential_decay(0.1, 3, 0.5),
                                        L.noam_decay(64, 4)],
}


def _schedule(case):
    def body(fluid):
        return SCHEDULES[case](fluid.layers)

    return body


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedule_matches_the_jax_package_over_20_steps(case):
    r = run_both(_schedule(case), [{}] * STEPS, fetch=lambda out: out)
    for step, (got, want) in enumerate(zip(r["port"], r["jax"])):
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == (1,)
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12,
                                       err_msg=f"step {step}")
    counter = r["port_end"][COUNTER]
    assert counter.dtype == np.int32
    np.testing.assert_array_equal(counter, r["jax_end"][COUNTER])
    # the counter starts at begin - 1 and the first run sees begin
    begin = 1 if case == "noam" else 0
    assert int(counter[0]) == begin + STEPS - 1
    lrs = [float(g[0][0]) for g in r["port"]]
    assert len(set(lrs)) > 1, lrs  # the schedule moves


def test_a_schedule_drives_sgd_as_in_the_jax_package():
    """test_lr_meta.py's scheduler_drives_optimizer: lr 0.5 for two
    steps, then 0; the parameters follow it."""
    def make(f):
        return f.optimizer.SGD(f.layers.piecewise_decay([2], [0.5, 0.0]))

    r = run_both(fit_a_line(make), line_feeds(4))
    assert_states_close(r["port_end"], r["jax_end"], rtol=1e-5, atol=1e-6)
    assert not np.array_equal(r["port_end"]["fc_w_0"], r["start"]["fc_w_0"])
