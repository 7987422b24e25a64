"""The ten eager LR schedules of the dygraph package
(paddle_tpu/dygraph/__init__.py:28-39) in the port against the JAX
package's: 20 calls of each give the same sequence of learning rates
(plain Python floats in both, rtol 1e-12), including LinearLrWarmup over
PolynomialDecay (bench_bert's schedule) and over a float, PolynomialDecay
with cycle, and ReduceLROnPlateau driven by a fixed metric sequence in
both modes. An eager optimizer calls its schedule once per minimize,
whatever the number of parameters; a static-graph Variable as the
learning rate is refused on the eager path."""

import math

import numpy as np
import pytest

from paddle_tpu import dygraph as jdg

import paddle_tpu_torch as tf
from paddle_tpu_torch import dygraph as tdg
from paddle_tpu_torch.errors import UnimplementedError

STEPS = 20
SCHEDULES = {
    "noam": lambda dg: dg.NoamDecay(64, 5),
    "piecewise": lambda dg: dg.PiecewiseDecay([3, 8, 15], [1.0, 0.5, 0.1,
                                                           0.01]),
    "natural_exp": lambda dg: dg.NaturalExpDecay(0.1, 4, 0.5),
    "natural_exp_staircase": lambda dg: dg.NaturalExpDecay(0.1, 4, 0.5,
                                                           staircase=True),
    "exponential": lambda dg: dg.ExponentialDecay(0.1, 3, 0.9),
    "inverse_time": lambda dg: dg.InverseTimeDecay(0.1, 5, 0.5,
                                                   staircase=True),
    "polynomial": lambda dg: dg.PolynomialDecay(0.1, 12, 0.001, power=2.0),
    "polynomial_cycle": lambda dg: dg.PolynomialDecay(0.1, 6, 0.001,
                                                      cycle=True),
    "cosine": lambda dg: dg.CosineDecay(0.1, 3, 7),
    "warmup_polynomial": lambda dg: dg.LinearLrWarmup(
        dg.PolynomialDecay(1e-4, 100, 1e-5), 6, 0.0, 1e-4),
    "warmup_float": lambda dg: dg.LinearLrWarmup(0.05, 4, 0.01, 0.05),
    "begin_step": lambda dg: dg.ExponentialDecay(0.1, 2, 0.5, begin=3,
                                                 step=2),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_the_jax_package(name):
    want, got = SCHEDULES[name](jdg), SCHEDULES[name](tdg)
    w = [want() for _ in range(STEPS)]
    g = [got() for _ in range(STEPS)]
    assert all(isinstance(v, float) for v in g)
    np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
    assert len(set(g)) > 1


@pytest.mark.parametrize("mode", ["min", "max"])
def test_reduce_lr_on_plateau_matches(mode):
    metrics = [1.0, 0.9, 0.95, 0.97, 0.96, 0.99, 0.98, 0.5, 0.6, 0.7, 0.8,
               0.65, 0.66, 0.67, 0.2, 0.3]
    if mode == "max":
        metrics = [-m for m in metrics]
    kw = dict(mode=mode, decay_rate=0.5, patience=2, cooldown=1,
              min_lr=0.01)
    want = jdg.ReduceLROnPlateau(0.1, **kw)
    got = tdg.ReduceLROnPlateau(0.1, **kw)
    seq = [(got.step(m), got()) for m in metrics]
    assert seq == [(want.step(m), want()) for m in metrics]
    assert seq[-1][0] < 0.1


def test_learning_rate_decay_base_and_exports():
    import paddle_tpu.dygraph as jmod

    names = ("CosineDecay", "ExponentialDecay", "InverseTimeDecay",
             "LearningRateDecay", "LinearLrWarmup", "NaturalExpDecay",
             "NoamDecay", "PiecewiseDecay", "PolynomialDecay",
             "ReduceLROnPlateau")
    for n in names:
        assert hasattr(jmod, n) and hasattr(tdg, n), n
    with pytest.raises(NotImplementedError):
        tdg.LearningRateDecay()()


def test_eager_optimizer_advances_its_schedule_once_a_minimize():
    x = np.random.RandomState(0).randn(3, 4).astype("float32")
    main = tf.Program()
    with tf.program_guard(main, tf.Program()):
        lr_var = tf.layers.fill_constant([1], "float32", 0.1)
    with tdg.guard(tf.CPUPlace()):
        net = tdg.Sequential(tdg.Linear(4, 5), tdg.Linear(5, 2))
        sched = tdg.PolynomialDecay(0.1, 10, 0.0)
        opt = tf.optimizer.SGD(sched, parameter_list=net.parameters())
        w0 = net[0].weight.numpy()
        for step in range(3):
            loss = tf.layers.reduce_mean(net(tdg.to_variable(x)))
            loss.backward()
            g = net[0].weight.gradient()
            updated = opt.minimize(loss)[0]
            assert len(updated) == 4 and sched.step_num == step + 1
            lr = 0.1 * (1 - step / 10)
            np.testing.assert_allclose(net[0].weight.numpy(), w0 - lr * g,
                                       rtol=1e-6, atol=1e-7)
            w0 = net[0].weight.numpy()
            net.clear_gradients()
        loss = tf.layers.reduce_mean(net(tdg.to_variable(x)))
        loss.backward()
        with pytest.raises(UnimplementedError):
            tf.optimizer.SGD(lr_var, parameter_list=net.parameters()
                             ).minimize(loss)
    assert math.isclose(sched(), 0.1 * (1 - 3 / 10))
