"""Port parity for the training slice's new op emitters: each op built by
paddle_tpu_torch and by the JAX package in a one-op program, run on the
CPU from the same numpy inputs, forward output and, for differentiable
ops, the gradients of sum(out * w) with respect to every floating input
through the generic `__vjp__` grad op (append_backward).

Inputs come from numpy with a fixed seed. Tolerance: fp32, rtol 1e-5 and
atol 1e-6 (single ops on values of magnitude ~1; the two packages may sum
in another order).
"""

import numpy as np
import pytest

import paddle_tpu as jf
from paddle_tpu import layers as jl
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.backward import gradients as jgradients
from paddle_tpu.framework.scope import Scope as JScope

import paddle_tpu_torch as tf
from paddle_tpu_torch import layers as tl

A, C, D = 3, 4, 5
JAX = (jf, jl, jun, jgradients, JScope)
PORT = (tf, tl, tf.unique_name, tf.gradients, tf.Scope)


def _inputs():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 7, (6, 1))
    labels[2, 0] = -100  # an ignored position
    return {
        "x": rng.randn(A, C, D).astype(np.float32),
        "y": rng.randn(A, C, D).astype(np.float32),
        "pos": (rng.rand(A, C, D) + 0.5).astype(np.float32),
        "b": rng.randn(C).astype(np.float32),
        "m": rng.randn(6, 7).astype(np.float32),
        "idx": np.array([4, 0, 2, 2, 5], np.int64),
        "lbl": labels.astype(np.int64),
        "cnt": np.array([3], np.int32),
    }


def _append(layers, op_type, ins, attrs=None, like=None):
    """One op appended straight to the block (ops without a layer)."""
    blk = ins[0].block
    out = blk.create_var(name=f"{op_type}_out", shape=like.shape,
                         dtype=like.dtype)
    blk.append_op(op_type, {"X": [v.name for v in ins]}, {"Out": [out.name]},
                  attrs or {})
    return out


CASES = {
    "elementwise_sub": lambda L, v: L.elementwise_sub(v["x"], v["y"]),
    "elementwise_mul": lambda L, v: L.elementwise_mul(v["x"], v["y"]),
    "elementwise_div": lambda L, v: L.elementwise_div(v["x"], v["pos"]),
    "elementwise_max": lambda L, v: L.elementwise_max(v["x"], v["y"]),
    "elementwise_min": lambda L, v: L.elementwise_min(v["x"], v["y"]),
    "elementwise_sub_axis": lambda L, v: L.elementwise_sub(v["x"], v["b"],
                                                           axis=1),
    "elementwise_div_axis": lambda L, v: L.elementwise_div(v["x"], v["b"],
                                                           axis=1),
    "pow": lambda L, v: L.pow(v["pos"], factor=1.5),
    "reduce_sum_all": lambda L, v: L.reduce_sum(v["x"]),
    "reduce_sum_dim": lambda L, v: L.reduce_sum(v["x"], dim=[1],
                                                keep_dim=True),
    "reduce_sum_dims": lambda L, v: L.reduce_sum(v["x"], dim=[0, 2]),
    "sum": lambda L, v: _append(L, "sum", [v["x"], v["y"], v["pos"]],
                                like=v["x"]),
    "assign": lambda L, v: _append(L, "assign", [v["x"]], like=v["x"]),
    "cast_int": lambda L, v: L.cast(v["pos"], "int32"),
    "cast_float": lambda L, v: L.cast(v["cnt"], "float32"),
    "gather": lambda L, v: L.gather(v["m"], v["idx"]),
    "softmax_with_cross_entropy": lambda L, v: L.softmax_with_cross_entropy(
        v["m"], v["lbl"], ignore_index=-100),
    "not_equal": lambda L, v: L.not_equal(v["x"], v["y"]),
    "less_than": lambda L, v: L.less_than(v["x"], v["y"]),
    "increment": lambda L, v: _append(L, "increment", [v["cnt"]],
                                      {"step": 2.0}, like=v["cnt"]),
}


def _run(pkg, case, feed):
    fluid, layers, unique_name, gradients, scope_cls = pkg
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        v = {}
        for name, a in feed.items():
            v[name] = fluid.data(name, list(a.shape), str(a.dtype))
            v[name].stop_gradient = a.dtype.kind != "f"
        out = CASES[case](layers, v)
        fetch, diff = [out], []
        if out.dtype == "float32":
            w = fluid.data("w", list(out.shape), "float32")
            loss = layers.reduce_sum(layers.elementwise_mul(out, w))
            diff = [n for n, a in feed.items() if a.dtype.kind == "f"]
            grads = gradients(loss, [v[n] for n in diff])
            fetch += [g for g in grads if g is not None]
    if diff:
        feed = dict(feed, w=np.random.RandomState(1).randn(
            *out.shape).astype(np.float32))
    exe = fluid.Executor(fluid.CPUPlace())
    return [np.asarray(r) for r in exe.run(main, feed=feed,
                                           fetch_list=fetch,
                                           scope=scope_cls())]


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_the_jax_package_forward_and_vjp(case):
    feed = _inputs()
    want = _run(JAX, case, feed)
    got = _run(PORT, case, feed)
    assert len(got) == len(want) and len(got) >= 1
    if case not in ("cast_int", "cast_float", "not_equal", "less_than",
                    "increment"):
        assert len(got) >= 2  # a gradient came through __vjp__
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w)


def test_dropout_vjp_replays_the_forward_mask():
    """The generic grad op replays dropout under the forward op's uid, so
    the gradient is w exactly where the forward kept x (downgrade_in_infer:
    kept values are not rescaled) and 0 where it dropped."""
    main, startup = tf.Program(), tf.Program()
    main.random_seed = 3
    with tf.unique_name.guard(), tf.program_guard(main, startup):
        x = tf.data("x", [64, 64], "float32")
        w = tf.data("w", [64, 64], "float32")
        x.stop_gradient = False
        out = tl.dropout(x, 0.5, is_test=False)
        gx, = tf.gradients(tl.reduce_sum(tl.elementwise_mul(out, w)), [x])
    rng = np.random.RandomState(2)
    xv = rng.rand(64, 64).astype(np.float32) + 1.0
    wv = rng.randn(64, 64).astype(np.float32)
    o, g = tf.Executor(tf.CPUPlace()).run(
        main, feed={"x": xv, "w": wv}, fetch_list=[out, gx], scope=tf.Scope())
    kept = o != 0
    assert 0.4 < kept.mean() < 0.6
    np.testing.assert_array_equal(g, np.where(kept, wv, 0.0))
    np.testing.assert_array_equal(o, np.where(kept, xv, 0.0))
