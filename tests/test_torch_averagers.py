"""Port parity for the averagers and Lookahead
(paddle_tpu_torch/optimizer.py): ExponentialMovingAverage (a constant
decay, a numeric thres_steps and the caller's step Variable),
ModelAverage (a window that keeps accumulating, and one that shifts its
tiers) and LookaheadOptimizer (over SGD and over Adam), each on
tests/test_optimizers_sweep.py's fit-a-line for five steps in both
packages (tests/torch_fit_a_line.py), then through apply() (the averaged
parameters swapped into the scope) and restore() (the trained ones
back), as tests/test_lr_meta.py drives the JAX package's.

Tolerances, fp32 both sides: every persistable (shadows, sums, decay
products) atol 1e-6 + rtol 1e-5, the int32 counters exactly; the applied
averages rtol 1e-5, atol 1e-6; restore() gives the trained values
bit for bit.
"""

import numpy as np
import pytest

from paddle_tpu.framework.scope import scope_guard as jscope_guard

import paddle_tpu_torch as tf

from torch_fit_a_line import assert_states_close, fit_a_line, line_feeds, \
    run_both
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

STEPS = 5
PARAMS = ("fc_w_0", "fc_b_0")


def _sgd(f):
    return f.optimizer.SGD(0.05)


AVERAGERS = {
    "ema": lambda f: f.optimizer.ExponentialMovingAverage(0.9),
    "ema_thres_number": lambda f: f.optimizer.ExponentialMovingAverage(
        0.99, thres_steps=3),
    "ema_thres_variable": lambda f: f.optimizer.ExponentialMovingAverage(
        0.99, thres_steps=f.default_main_program().global_block.var(
            "@LR_DECAY_COUNTER@")),
    "model_average": lambda f: f.optimizer.ModelAverage(
        0.15, max_average_window=100),
    "model_average_shift": lambda f: f.optimizer.ModelAverage(
        0.15, min_average_window=2, max_average_window=3),
}


def _averaged(case):
    def body(fluid):
        make = _sgd
        if case == "ema_thres_variable":  # a schedule's step counter
            def make(f):
                return f.optimizer.SGD(f.layers.piecewise_decay(
                    [3], [0.05, 0.02]))
        loss, _, _ = fit_a_line(make)(fluid)
        avg = AVERAGERS[case](fluid)
        if case.startswith("ema"):
            avg.update()
        return loss, avg

    return body


def _applied(avg, scope, guard):
    with guard(scope):
        with avg.apply(need_restore=False):
            inside = {p: np.asarray(scope.find_var(p)) for p in PARAMS}
        avg.restore()
        after = {p: np.asarray(scope.find_var(p)) for p in PARAMS}
    return inside, after


@pytest.mark.parametrize("case", list(AVERAGERS))
def test_averager_matches_the_jax_package_through_apply_and_restore(case):
    r = run_both(_averaged(case), line_feeds(STEPS))
    assert_states_close(r["port_end"], r["jax_end"], rtol=1e-5, atol=1e-6)
    jin, jafter = _applied(r["jax_out"][1], r["jax_scope"], jscope_guard)
    tin, tafter = _applied(r["port_out"][1], r["port_scope"],
                           tf.scope_guard)
    for p in PARAMS:
        np.testing.assert_allclose(tin[p], jin[p], rtol=1e-5, atol=1e-6,
                                   err_msg=p)
        assert tin[p].dtype == np.float32 and tin[p].shape == tafter[p].shape
        assert not np.array_equal(tin[p], tafter[p])  # an average
        np.testing.assert_array_equal(tafter[p], r["port_end"][p])


@pytest.mark.parametrize("inner", ["SGD", "Adam"])
def test_lookahead_matches_the_jax_package(inner):
    """k=2, alpha=0.5: the slow weights sync at steps 2 and 4; the fast
    weights after five steps and every slow weight."""
    def make(f):
        opt = getattr(f.optimizer, inner)(0.05)
        return f.optimizer.LookaheadOptimizer(opt, alpha=0.5, k=2)

    r = run_both(fit_a_line(make), line_feeds(STEPS))
    for got, want in zip(r["port"], r["jax"]):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert_states_close(r["port_end"], r["jax_end"], rtol=1e-5, atol=1e-6)
    slow = [n for n in r["port_end"] if n.endswith("_slow_0")]
    assert sorted(slow) == ["fc_b_0_slow_0", "fc_w_0_slow_0"]
    for n in slow:
        assert not np.array_equal(r["port_end"][n], r["start"][n])
    assert int(r["port_end"]["lookahead_step_0"][0]) == STEPS
