"""Port parity for gradient clipping (paddle_tpu_torch/clip.py), the
regularizers (regularizer.py), per-parameter settings (ParamAttr's
regularizer and learning_rate) and their ops (sqrt, reciprocal, sign,
clip_by_norm, and the schedules' exp, floor, ceil, cos, elementwise_pow,
where), against the JAX package on the CPU; and program files with
per-parameter regularizers across the packages (io.py; the JAX package
unpickles the port's `.pdmodel` itself).

Each clip and regularizer runs two steps of tests/test_optimizers_sweep.py's
fit-a-line (tests/torch_fit_a_line.py: one program built in both
packages, the JAX package's startup state carried across, the same
feeds); the global norm's clip both active (the scale below 1) and not
(exactly 1), fetched each step. Tolerances, fp32 both sides: losses and
clip scales rtol 1e-5; every parameter and accumulator atol 1e-6 + rtol
1e-5 (as tests/test_torch_optimizer_zoo.py); single ops rtol 1e-6,
atol 1e-7.
"""

import pickle

import numpy as np
import pytest

import paddle_tpu as jf
from paddle_tpu import io as jio
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard

import paddle_tpu_torch as tf
from paddle_tpu_torch import io as tio

from torch_fit_a_line import (JAX, PORT, assert_states_close, build,
                              fit_a_line, jax_state, line_feeds, run_both,
                              run_op)
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


def _opt(kind, lr, kw):
    """An optimizer maker: optimizer.<kind>(lr, **kw(fluid))."""
    return lambda f: getattr(f.optimizer, kind)(lr, **kw(f))


CASES = {
    "value": _opt("SGD", 0.05, lambda f: dict(
        grad_clip=f.clip.GradientClipByValue(0.5))),
    "value_min": _opt("SGD", 0.05, lambda f: dict(
        grad_clip=f.clip.GradientClipByValue(1.0, min=-0.2))),
    "error_clip": _opt("Momentum", 0.05, lambda f: dict(
        grad_clip=f.clip.ErrorClipByValue(0.3))),
    "norm": _opt("Adam", 0.05, lambda f: dict(
        grad_clip=f.clip.GradientClipByNorm(1.0))),
    "global_norm_active": _opt("Lamb", 0.05, lambda f: dict(
        grad_clip=f.clip.GradientClipByGlobalNorm(1.0))),
    "global_norm_inactive": _opt("SGD", 0.01, lambda f: dict(
        grad_clip=f.clip.GradientClipByGlobalNorm(1e4))),
    "l2": _opt("Momentum", 0.05, lambda f: dict(
        regularization=f.regularizer.L2Decay(0.1))),
    "l1": _opt("SGD", 0.05, lambda f: dict(
        regularization=f.regularizer.L1DecayRegularizer(0.1))),
    "clip_then_l2": _opt("AdamW", 0.05, lambda f: dict(
        grad_clip=f.clip.GradientClipByGlobalNorm(1.0),
        regularization=f.regularizer.L2DecayRegularizer(0.01))),
}


def _with_scale(body):
    """body, returning its loss and the global norm's clip scale."""
    def wrapped(fluid):
        loss, _, _ = body(fluid)
        return loss, fluid.default_main_program().global_block.var(
            "clip_scale_0")

    return wrapped


def _check(r):
    for got, want in zip(r["port"], r["jax"]):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5)
    assert_states_close(r["port_end"], r["jax_end"], rtol=1e-5, atol=1e-6)
    for p in ("fc_w_0", "fc_b_0"):
        assert not np.array_equal(r["port_end"][p], r["start"][p])


@pytest.mark.parametrize("name", list(CASES))
def test_each_clip_and_regularizer_matches_the_jax_package(name):
    body = fit_a_line(CASES[name])
    if name.startswith(("global_norm", "clip_then")):
        body = _with_scale(body)
        r = run_both(body, line_feeds(2), fetch=lambda out: list(out))
        scales = [float(s[1][0]) for s in r["port"]]
        if name == "global_norm_inactive":
            assert scales == [1.0, 1.0]
        else:
            assert all(0.0 < s < 1.0 for s in scales), scales
    else:
        r = run_both(body, line_feeds(2))
    _check(r)


def _param_attr(fluid, reg_kind, coeff, lr=1.0):
    reg = getattr(fluid.regularizer, reg_kind)(coeff)
    return fluid.ParamAttr(regularizer=reg, learning_rate=lr,
                           do_model_average=True)


@pytest.mark.parametrize("reg_kind", ["L2Decay", "L1Decay"])
def test_a_parameters_own_regularizer_wins(reg_kind):
    """ParamAttr(regularizer=...) on the weight; the optimizer's
    regularization reaches only the bias. The weight's learning_rate of
    0.5 is kept in optimize_attr and, as in the JAX package, no
    optimizer reads it."""
    def make(f):
        return f.optimizer.Momentum(
            0.05, regularization=f.regularizer.L2Decay(0.3))

    def body(fluid):
        return fit_a_line(make, param_attr=_param_attr(
            fluid, reg_kind, 0.2, lr=0.5))(fluid)

    r = run_both(body, line_feeds(2))
    _check(r)
    w = r["port_main"].global_block.var("fc_w_0")
    b = r["port_main"].global_block.var("fc_b_0")
    assert type(w.regularizer).__name__ == reg_kind
    assert w.regularizer.coeff == 0.2 and b.regularizer is None
    assert w.optimize_attr == {"learning_rate": 0.5}
    assert b.optimize_attr == {"learning_rate": 1.0}
    ops = [op.type for op in r["port_main"].global_block.ops]
    # the weight's regularizer and the bias's (the optimizer's L2)
    assert ops.count("sign") == (reg_kind == "L1Decay")
    assert ops.count("sum") == 2


def test_param_attr_keeps_the_jax_packages_fields():
    attr = tf.ParamAttr(name="w", learning_rate=0.1,
                        regularizer=tf.regularizer.L1Decay(0.5),
                        do_model_average=True)
    assert (attr.name, attr.learning_rate, attr.regularizer.coeff,
            attr.trainable, attr.do_model_average) == ("w", 0.1, 0.5, True,
                                                       True)
    default = tf.ParamAttr.to_attr(None)
    assert (default.learning_rate, default.regularizer,
            default.do_model_average) == (1.0, None, False)
    assert tf.regularizer.L2DecayRegularizer is tf.regularizer.L2Decay


UNARY = {
    "sqrt": lambda x: np.abs(x) + 0.1,
    "reciprocal": lambda x: x + np.sign(x) * 0.5,
    "sign": lambda x: np.where(np.abs(x) < 0.3, 0.0, x),
    "exp": lambda x: x,
    "floor": lambda x: 3 * x,
    "ceil": lambda x: 3 * x,
    "cos": lambda x: 3 * x,
}


@pytest.mark.parametrize("op_type", list(UNARY))
def test_unary_ops_match_the_jax_package(op_type):
    x = UNARY[op_type](np.random.RandomState(2).randn(5, 7)).astype(
        "float32")
    ins = {"X": [x]}
    want = run_op(JAX, op_type, ins, {"Out": 1}, {})["Out"][0]
    got = run_op(PORT, op_type, ins, {"Out": 1}, {})["Out"][0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("op_type,inputs,attrs", [
    ("clip_by_norm", {"X": [np.arange(-6, 6, dtype="float32").reshape(3, 4)]},
     {"max_norm": 2.0}),
    ("clip_by_norm", {"X": [np.full((3, 4), 0.01, "float32")]},
     {"max_norm": 2.0}),
    ("elementwise_pow", {"X": [np.full([1], 0.5, "float32")],
                         "Y": [np.array([2.5], "float32")]}, {}),
    ("where", {"Condition": [np.array([True, False, True])],
               "X": [np.arange(3, dtype="int32")],
               "Y": [np.full(3, 7, "int32")]}, {}),
    ("clip", {"X": [np.array([0.3, 5.0], "float32")]},
     {"min": 1.0, "max": 3.4e38}),
])
def test_clip_ops_match_the_jax_package(op_type, inputs, attrs):
    want = run_op(JAX, op_type, inputs, {"Out": 1}, attrs)["Out"][0]
    got = run_op(PORT, op_type, inputs, {"Out": 1}, attrs)["Out"][0]
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _regularized(fluid):
    return fit_a_line(
        lambda f: f.optimizer.SGD(0.05),
        param_attr=fluid.ParamAttr(regularizer=fluid.regularizer.L2Decay(
            0.2)),
        bias_attr=fluid.ParamAttr(regularizer=fluid.regularizer.L1Decay(
            0.1)))(fluid)


def _steps(fluid, exe, main, scope, loss_name, feeds):
    return [np.asarray(exe.run(main, feed=f, fetch_list=[loss_name],
                               scope=scope)[0]) for f in feeds]


def test_regularized_programs_cross_the_packages(tmp_path):
    """The JAX package's checkpoint of a program whose parameters carry
    L2Decay and L1Decay loads in the port (io.load_program, io.load)
    and trains to the JAX package's values; the port's checkpoint of it
    is read back by the JAX package, regularizers and all, and trains
    there to the port's values."""
    feeds = line_feeds(3, seed=1)
    jmain, jstartup, (jloss, _, _) = build(JAX, _regularized)
    jscope, jexe = JScope(), jf.Executor(jf.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    jpath = str(tmp_path / "jax")
    with jscope_guard(jscope):
        jio.save(jmain, jpath)
    want = _steps(jf, jexe, jmain, jscope, jloss.name, feeds[:2])

    prog = tio.load_program(jpath)
    regs = {p.name: p.regularizer for p in prog.all_parameters()
            if p.trainable}
    assert {n: (type(r), r.coeff) for n, r in regs.items()} == {
        "fc_w_0": (tf.regularizer.L2Decay, 0.2),
        "fc_b_0": (tf.regularizer.L1Decay, 0.1)}
    texe, tscope = tf.Executor(tf.CPUPlace()), tf.Scope()
    with tf.scope_guard(tscope):
        tio.load(prog, jpath, executor=texe)
    got = _steps(tf, texe, prog, tscope, jloss.name, feeds[:2])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_states_close(
        {n: tscope.find_var(n).numpy() for n in tscope.local_var_names()},
        jax_state(jscope), rtol=1e-5, atol=1e-6)

    tpath = str(tmp_path / "port")
    with tf.scope_guard(tscope):
        tio.save(prog, tpath)
    with open(tpath + ".pdmodel", "rb") as f:
        back = pickle.load(f)
    jregs = {p.name: p.regularizer for p in back.all_parameters()
             if p.trainable}
    assert {n: (type(r), r.coeff) for n, r in jregs.items()} == {
        "fc_w_0": (jf.regularizer.L2Decay, 0.2),
        "fc_b_0": (jf.regularizer.L1Decay, 0.1)}
    assert back.global_block.var("fc_w_0").optimize_attr == {
        "learning_rate": 1.0}
    bscope = JScope()
    with jscope_guard(bscope):
        jio.load(back, tpath)
    again = _steps(jf, jexe, back, bscope, jloss.name, feeds[2:])
    port_next = _steps(tf, texe, prog, tscope, jloss.name, feeds[2:])
    np.testing.assert_allclose(again, port_next, rtol=1e-5)
