"""Port parity for the ResNet training slice: bench.py's bench_resnet
program (resnet_train_net, softmax-CE loss and top-1 accuracy, Momentum
with mu 0.9) at its CPU size, ResNet-18 on 3x32x32, B=4, 10 classes,
with the plain stem and with space_to_depth_stem, built and trained by
paddle_tpu_torch and by the JAX package on the CPU.

Both programs are built from a fresh unique_name state, so their variable
names match; the JAX package's startup state (weights, batch-norm moving
statistics, velocities, learning rate) is carried across with
convert.state_from_numpy. Feeds are bench_resnet's: uniform images and
int32 labels into the int64-declared [B, 1] label, from RandomState(0).
One JAX run per stem serves the file's tests (a module-scoped fixture).

The learning rate is 1e-3, not bench_resnet's 0.1: at B=4 one step of 0.1
takes the loss from 4.4 to 13.8, and the fp32 rounding differences of
the first step (gradients 1.5e-4 apart) grow to 7% of a gradient in the
second. Batch norm over 4 samples of a 1x1 map (stage 4) divides by
batch deviations near sqrt(eps), which amplifies them; at lr 1e-3 they
still grow to 1.4-3.5% of a gradient (measured, by torch's thread
count). So the second step is held tightly from the JAX package's state
after its first, and the port's own second step loosely.

Tolerances, fp32 on both sides, sums in other orders (measured, plain
stem / space-to-depth stem, in parentheses):
- the first step from one state: loss rtol 5e-5 (9.8e-6 / 1.7e-6),
  accuracy equal, every @GRAD relative L2 1e-3 (1.5e-4 / 1.0e-4);
- the second step from the JAX package's state after the first: loss
  rtol 5e-5, @GRAD relative L2 1e-3 (2.7e-4), and after it every
  velocity and parameter update (end - start) relative L2 1e-3, every
  moving mean and variance atol 1e-5 + rtol 1e-5 (a batch mean of
  values up to ~3 summed in another order: 1.4e-6);
- the port's own two steps: loss rtol 1e-4 (5.4e-5), accuracy equal,
  @GRAD, velocities and parameter updates relative L2 2^-3 (1.4e-2 to
  3.5e-2 / 1.1e-3), moving statistics atol 1e-4 + rtol 1e-4 (1.3e-5 of
  0.8).

The space-to-depth stem's steps are in test_torch_resnet_training_s2d.py,
so that parallel test workers run the two JAX runs side by side.
"""

import numpy as np
import pytest

import paddle_tpu as jf
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.resnet import resnet_train_net as jresnet_train_net
from paddle_tpu.optimizer import Momentum as JMomentum

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import resnet_train_net as tresnet_train_net
from paddle_tpu_torch.optimizer import Momentum as TMomentum

from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

B, HW, DEPTH, CLASSES = 4, 32, 18, 10
LR = 1e-3
JAX = (jf, jun, jresnet_train_net, JMomentum)
PORT = (tf, tf.unique_name, tresnet_train_net, TMomentum)
STEP_L2 = 1e-3
OWN_L2 = 2.0 ** -3


def build(pkg, s2d):
    fluid, unique_name, train_net, momentum = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with unique_name.guard(), fluid.program_guard(main, startup):
        image = fluid.data("image", [B, 3, HW, HW])
        label = fluid.data("label", [B, 1], "int64")
        loss, acc = train_net(image, label, depth=DEPTH, class_num=CLASSES,
                              space_to_depth_stem=s2d)
        _, pg = momentum(LR, 0.9).minimize(loss, startup)
    return main, startup, loss, acc, pg


def feeds():
    """bench_resnet's batches (uniform images, int32 labels)."""
    rng = np.random.RandomState(0)
    return [{"image": rng.rand(B, 3, HW, HW).astype("float32"),
             "label": rng.randint(0, CLASSES, (B, 1)).astype("int32")}
            for _ in range(2)]


def _state(scope):
    return {n: np.asarray(scope.find_var(n)) for n in scope.local_var_names()}


def _rel_l2(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def jax_two_steps(s2d):
    """The JAX package's program and its two steps: the states at the
    start, after the first and after the second step, and each step's
    loss, accuracy and gradients."""
    main, startup, loss, acc, pg = build(JAX, s2d)
    scope, exe = JScope(), jf.Executor(jf.CPUPlace())
    exe.run(startup, scope=scope)
    states, fetched = [_state(scope)], []
    fetch = [loss.name, acc.name] + [g.name for _, g in pg]
    for f in feeds():
        fetched.append([np.asarray(v) for v in exe.run(
            main, feed=f, fetch_list=fetch, scope=scope)])
        states.append(_state(scope))
    return dict(states=states, fetched=fetched, main=main,
                pg=[(p.name, g.name) for p, g in pg])


@pytest.fixture(scope="module")
def jax_run():
    return jax_two_steps(False)


def _attrs(op):
    # dunder attrs are bookkeeping (uid, build site); __vjp__'s copy of
    # its forward op's attrs holds them too
    return {k: v for k, v in op.attrs.items()
            if not k.startswith("__") and k != "fwd_attrs"}


def check_programs_match(run, s2d):
    jmain = run["main"]
    tmain, tstartup, _, _, tpg = build(PORT, s2d)
    jb, tb = jmain.global_block, tmain.global_block
    assert [op.type for op in tb.ops] == [op.type for op in jb.ops]
    types = {op.type for op in tb.ops}
    assert {"conv2d", "batch_norm", "pool2d", "relu", "top_k", "accuracy",
            "momentum", "reduce_mean"} <= types
    assert ("space_to_depth" in types) == ("pad2d" in types) == s2d
    for jop, top in zip(jb.ops, tb.ops):
        assert top.inputs == jop.inputs and top.outputs == jop.outputs, top
        assert _attrs(top) == _attrs(jop), top.type
    jvars = {v.name: v for v in jmain.list_vars()}
    tvars = {v.name: v for v in tmain.list_vars()}
    assert set(tvars) == set(jvars)
    for name, jv in jvars.items():
        assert tvars[name].shape == jv.shape, name
        # integers by kind: the JAX package runs without 64-bit mode
        assert tvars[name].dtype == jv.dtype or (
            "int" in tvars[name].dtype and "int" in jv.dtype), name
        assert tvars[name].persistable == jv.persistable, name
        assert tvars[name].stop_gradient == jv.stop_gradient, name
    assert [(p.name, g.name) for p, g in tpg] == run["pg"]
    # 20 convolutions, 20 batch norms of two weights each and the fc;
    # the moving statistics are not trained
    n_bn = sum(op.type == "batch_norm" for op in tb.ops)
    assert n_bn == 20 and len(tpg) == 20 + 2 * n_bn + 2
    assert all(not p.name.startswith("bn_") for p, _ in tpg)


def test_programs_match_in_ops_names_shapes_and_dtypes(jax_run):
    check_programs_match(jax_run, False)


def _port_steps(s2d, state, batches):
    main, _, loss, acc, pg = build(PORT, s2d)
    scope = tf.Scope()
    convert.state_from_numpy(state, scope, tf.CPUPlace(), program=main)
    exe = tf.Executor(tf.CPUPlace())
    fetch = [loss.name, acc.name] + [g.name for _, g in pg]
    out = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
           for f in batches]
    return out, convert.state_to_numpy(scope)


def _hold_state(start, got, want, params, l2, stat_tol):
    """Velocities and each parameter's update (end - start) by relative
    L2; moving statistics elementwise; the rest equal. Returns the worst
    relative L2 of the updates and velocities."""
    assert set(got) == set(want)
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        if name in params or name.endswith("_velocity_0"):
            if name in params:
                g, w = g - start[name], w - start[name]
            r = _rel_l2(g, w)
            worst = max(worst, r)
            assert r <= l2, (name, r)
        elif name.startswith(("bn_mean", "bn_variance")):
            np.testing.assert_allclose(g, w, rtol=stat_tol[1],
                                       atol=stat_tol[0], err_msg=name)
        else:  # the learning rate
            np.testing.assert_array_equal(g, w, err_msg=name)
    return worst


def check_two_momentum_steps(run, s2d):
    start, mid, end = run["states"]
    w0, w1 = run["fetched"]
    grads = [g for _, g in run["pg"]]
    params = {p for p, _ in run["pg"]}
    assert any(n.startswith("bn_variance") for n in start)
    assert sum(n.endswith("_velocity_0") for n in start) == len(params)
    batches = feeds()

    # the port's own two steps from the carried start state
    (g0, g1), own_end = _port_steps(s2d, start, batches)
    assert abs(g0[0] - w0[0]).max() <= 5e-5 * abs(w0[0]).max()
    np.testing.assert_array_equal(g0[1], w0[1])
    for name, gv, wv in zip(grads, g0[2:], w0[2:]):
        assert _rel_l2(gv, wv) <= STEP_L2, (name, _rel_l2(gv, wv))
    assert abs(g1[0] - w1[0]).max() <= 1e-4 * abs(w1[0]).max()
    np.testing.assert_array_equal(g1[1], w1[1])
    for name, gv, wv in zip(grads, g1[2:], w1[2:]):
        assert _rel_l2(gv, wv) <= OWN_L2, (name, _rel_l2(gv, wv))
    own = _hold_state(start, own_end, end, params, OWN_L2, (1e-4, 1e-4))

    # the second step again, from the JAX package's state after its first
    (h1,), step_end = _port_steps(s2d, mid, batches[1:])
    assert abs(h1[0] - w1[0]).max() <= 5e-5 * abs(w1[0]).max()
    np.testing.assert_array_equal(h1[1], w1[1])
    for name, gv, wv in zip(grads, h1[2:], w1[2:]):
        assert _rel_l2(gv, wv) <= STEP_L2, (name, _rel_l2(gv, wv))
    step = _hold_state(mid, step_end, end, params, STEP_L2, (1e-5, 1e-5))
    moved = sum(not np.array_equal(start[n], end[n]) for n in end)
    assert moved >= len(params) * 2  # parameters, velocities, statistics
    print(f"worst relative L2 of updates and velocities: own steps "
          f"{own:.2e}, second step from the JAX state {step:.2e}")


def test_two_momentum_steps_match_the_jax_package(jax_run):
    check_two_momentum_steps(jax_run, False)
