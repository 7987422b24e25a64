"""The eager surface of the port's dygraph beyond tests/test_dygraph.py's
scenarios (tests/test_torch_dygraph.py), on the CPU, fp32: VarBase
operators, indexing and no_grad; the eager SGD and Momentum (Nesterov)
updates and GRUUnit against the JAX package's dygraph with the weights
carried across by name; `reduce_*` with `dim` None or an int; the
guard's default place; and the refusals of what is not ported.

Tolerances (fp32 both sides, sums in other orders): values and
gradients atol 1e-5 + rtol 1e-4; parameters after three SGD or Momentum
steps atol 1e-6 + rtol 1e-5; element-wise results exactly.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import dygraph as jdg
from paddle_tpu.dygraph.tracer import trace_op as jtrace
from paddle_tpu.dygraph.tracer import trace_op_multi as jtrace_multi
from paddle_tpu.optimizer import SGD as JSGD
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu.regularizer import L2Decay as JL2Decay

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch import dygraph as tdg
from paddle_tpu_torch.dygraph.tracer import trace_op as ttrace
from paddle_tpu_torch.dygraph.tracer import trace_op_multi as ttrace_multi
from paddle_tpu_torch.errors import InvalidArgumentError
from paddle_tpu_torch.errors import PreconditionNotMetError
from paddle_tpu_torch.errors import UnimplementedError
from paddle_tpu_torch.optimizer import SGD as TSGD
from paddle_tpu_torch.optimizer import Momentum as TMomentum

MEAN = {"dim": None, "keep_dim": False}
JAX = (jdg, jtrace, jtrace_multi, jdg.guard)
PORT = (tdg, ttrace, ttrace_multi, lambda: tdg.guard(tf.CPUPlace()))


def _close(got, want, atol=1e-5, rtol=1e-4, msg=""):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=msg)


def test_varbase_operators_and_no_grad():
    a_np = np.array([[1.5, -2.0], [3.0, 4.5]], "float32")
    with tdg.guard(tf.CPUPlace()):
        a = tdg.to_variable(a_np)
        a.stop_gradient = False
        checks = {
            "add": (a + 1.0, a_np + 1), "radd": (2.0 + a, a_np + 2),
            "sub": (a - 1.0, a_np - 1), "rsub": (1.0 - a, 1 - a_np),
            "mul": (a * 2.0, a_np * 2), "div": (a / 2.0, a_np / 2),
            "floordiv": (a // 2.0, a_np // 2), "mod": (a % 2.0, a_np % 2),
            "neg": (-a, -a_np), "matmul": (a @ a, a_np @ a_np),
            "getitem": (a[:, 1], a_np[:, 1]),
        }
        for name, (got, want) in checks.items():
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       err_msg=name)
        for got, want in ((a < 2.0, a_np < 2), (a <= 1.5, a_np <= 1.5),
                          (a > 3.0, a_np > 3), (a >= 3.0, a_np >= 3),
                          (a == 4.5, a_np == 4.5), (a != 4.5, a_np != 4.5)):
            np.testing.assert_array_equal(got.numpy(), want)
        assert (a == None) is False  # noqa: E711
        assert len(a) == 2 and a.shape == (2, 2) and a.dtype == "float32"
        assert a.astype("int32").dtype == "int32"
        assert bool(a[0, 0] > 1.0) and not bool(a[0, 1] > 0.0)
        with pytest.raises(ValueError):
            bool(a > 0.0)
        # gradient through __getitem__
        loss = ttrace("reduce_sum", {"X": [a[:, 1] * 3.0]}, MEAN)
        loss.backward()
        np.testing.assert_array_equal(a.gradient(), [[0, 3], [0, 3]])
        a.clear_gradient()
        assert a.gradient() is None
        with tdg.no_grad():
            out = a * 2.0
        assert out.stop_gradient and out.value.grad_fn is None

        @tdg.no_grad
        def double(v):
            return v * 2.0

        assert double(a).stop_gradient
        assert not (a * 2.0).stop_gradient
        d = (a * 2.0).detach()
        assert d.stop_gradient and d.value.grad_fn is None


def _optimizer_run(pkg, opt, state=None, steps=3):
    dg, trace, _, guard = pkg
    x_np = np.random.RandomState(1).randn(6, 4).astype("float32")
    with guard():
        lin = dg.Linear(4, 3)
        if state is not None:
            convert.layer_state_from_numpy(lin, state)
        start = lin.state_dict()
        o = opt(parameter_list=lin.parameters())
        for _ in range(steps):
            h = trace("tanh", {"X": [lin(dg.to_variable(x_np))]}, {})
            loss = trace("reduce_mean", {"X": [h * h]}, MEAN)
            loss.backward()
            o.minimize(loss)
            lin.clear_gradients()
        return start, lin.state_dict()


@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov"])
def test_eager_sgd_and_momentum_match_the_jax_package(kind):
    def make(sgd, momentum):
        if kind == "sgd":
            return lambda **kw: sgd(0.5, **kw)
        return lambda **kw: momentum(0.5, momentum=0.9,
                                     use_nesterov=kind == "nesterov", **kw)

    start, want = _optimizer_run(JAX, make(JSGD, JMomentum))
    _, got = _optimizer_run(PORT, make(TSGD, TMomentum), state=start)
    for name, w in want.items():
        assert not np.array_equal(w, start[name])
        _close(got[name], w, atol=1e-6, rtol=1e-5, msg=name)


def test_gru_unit_matches_the_jax_package():
    rng = np.random.RandomState(2)
    x_np = rng.randn(3, 12).astype("float32")
    h_np = rng.randn(3, 4).astype("float32")
    out = {}
    for pkg in (JAX, PORT):
        dg, trace, _, guard = pkg
        with guard():
            gru = dg.GRUUnit(12)
            if pkg is PORT:
                convert.layer_state_from_numpy(gru, out[JAX][0])
            x, h = dg.to_variable(x_np), dg.to_variable(h_np)
            x.stop_gradient = False
            new_h, _, _ = gru(x, h)
            trace("reduce_sum", {"X": [new_h]}, MEAN).backward()
            out[pkg] = (gru.state_dict(), new_h.numpy(), x.gradient(),
                        gru.weight.gradient())
    for g, w in zip(out[PORT][1:], out[JAX][1:]):
        _close(g, w)


def test_guard_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default place is usable")
    with pytest.raises(PreconditionNotMetError):
        with tdg.guard():
            pass
    assert not tdg.enabled()
    with tdg.guard(tf.CPUPlace()):
        assert tdg.enabled()
        assert tdg.to_variable(np.zeros(2)).value.device.type == "cpu"


def test_what_is_not_ported_raises_naming_its_item():
    for fn in (lambda: tdg.TracedLayer.trace(None, []),
               lambda: tdg.declarative(lambda x: x),
               lambda: tdg.to_static(lambda x: x),
               lambda: tdg.ProgramTranslator.get_instance()):
        with pytest.raises(UnimplementedError, match="item 9b"):
            fn()
    with tdg.guard(tf.CPUPlace()):
        with tf.program_guard(tf.Program(), tf.Program()), \
                pytest.raises(InvalidArgumentError, match="dygraph.nn"):
            tf.layers.fc(tdg.to_variable(np.ones((1, 2), "float32")), 2)
    # a parameter with a regularizer now takes its eager step as the JAX
    # package's does, which reads a `_coeff` field that L2Decay lacks:
    # the decay is not applied in eager mode
    def regularized(sgd, decay):
        def make(parameter_list):
            parameter_list[0].regularizer = decay(0.5)
            return sgd(0.5, parameter_list=parameter_list)
        return make

    start, want = _optimizer_run(JAX, regularized(JSGD, JL2Decay))
    _, got = _optimizer_run(PORT, regularized(TSGD, tf.regularizer.L2Decay),
                            state=start)
    _, plain = _optimizer_run(PORT, lambda **kw: TSGD(0.5, **kw),
                              state=start)
    for name, w in want.items():
        _close(got[name], w, atol=1e-6, rtol=1e-5, msg=name)
        np.testing.assert_array_equal(got[name], plain[name], err_msg=name)


@pytest.mark.parametrize("attrs", [
    {"dim": None, "keep_dim": False}, {"dim": 1, "keep_dim": True},
    {"dim": [0, -1], "keep_dim": False}, {"dim": [0], "reduce_all": True,
                                          "keep_dim": True}])
def test_reduce_ops_take_the_jax_packages_dim_forms(attrs):
    """reduce_sum / reduce_mean with `dim` None (every axis) or an int
    (one axis), as the JAX package's reduce_axes reads them: the port's
    emitter raised TypeError on both before the eager mode built them."""
    x_np = np.random.RandomState(5).randn(2, 3, 4).astype("float32")
    for op in ("reduce_sum", "reduce_mean"):
        with jdg.guard():
            want = jtrace(op, {"X": [jdg.to_variable(x_np)]},
                          dict(attrs)).numpy()
        with tdg.guard(tf.CPUPlace()):
            got = ttrace(op, {"X": [tdg.to_variable(x_np)]},
                         dict(attrs)).numpy()
        assert got.shape == want.shape, (op, attrs)
        _close(got, want, atol=1e-6, rtol=1e-6)


def test_the_dygraph_namespace_matches_the_jax_packages():
    import paddle_tpu.dygraph as jmod

    names = {n for n in dir(jmod) if not n.startswith("_")
             and n[0].isupper() or n in ("guard", "enabled", "no_grad",
                                         "to_variable", "save_dygraph",
                                         "load_dygraph", "prepare_context",
                                         "declarative", "to_static")}
    missing = sorted(n for n in names if not hasattr(tdg, n))
    assert missing == []


def test_hooks_and_containers():
    calls = []
    with tdg.guard(tf.CPUPlace()):
        lin = tdg.Linear(3, 3)
        lin.register_forward_pre_hook(
            lambda layer, args: calls.append("pre") or (args[0] * 2.0,))
        lin.register_forward_post_hook(
            lambda layer, args, out: calls.append("post") or out + 1.0)
        x = tdg.to_variable(np.ones((1, 3), "float32"))
        want = (np.ones((1, 3)) * 2) @ lin.weight.numpy() + \
            lin.bias.numpy() + 1
        _close(lin(x).numpy(), want, atol=1e-6, rtol=1e-6)
        assert calls == ["pre", "post"]
        ll = tdg.LayerList([tdg.Linear(3, 3)]).append(tdg.Linear(3, 2))
        assert len(ll) == 2 and ll[1].weight.shape == (3, 2)
        assert len(ll.parameters()) == 4
        pl = tdg.ParameterList([ll[0].weight]).append(ll[1].bias)
        assert len(pl) == 2 and list(pl)[1] is ll[1].bias
        seq = tdg.Sequential(("a", tdg.Linear(3, 3)), ("b", tdg.Linear(3, 1)))
        assert list(seq.state_dict()) == ["a.weight", "a.bias", "b.weight",
                                          "b.bias"]
        seq.eval()
        assert not seq.training and not seq[1].training
        seq.train()
        assert all(sl.training for sl in seq.sublayers(include_self=True))


def test_pool2d_and_dropout_match_the_jax_package():
    rng = np.random.RandomState(6)
    x_np = rng.randn(2, 3, 8, 8).astype("float32")
    out = {}
    for pkg in (JAX, PORT):
        dg, trace, _, guard = pkg
        with guard():
            x = dg.to_variable(x_np)
            x.stop_gradient = False
            pooled = [dg.Pool2D(2, "max", 2)(x),
                      dg.Pool2D(3, "avg", 1, pool_padding=1)(x),
                      dg.Pool2D(pool_type="avg", global_pooling=True)(x)]
            drop = dg.Dropout(0.25)
            drop.eval()
            y = drop(x)  # eval: the identity (upscale_in_train)
            loss = trace("reduce_sum", {"X": [pooled[0] * 3.0]}, MEAN)
            loss = loss + trace("reduce_sum", {"X": [pooled[1]]}, MEAN)
            loss.backward()
            out[pkg] = ([p.numpy() for p in pooled], y.numpy(),
                        x.gradient())
    (jp, jy, jg), (tp, ty, tg) = out[JAX], out[PORT]
    for g, w in zip(tp, jp):
        _close(g, w)
    np.testing.assert_array_equal(ty, x_np)
    np.testing.assert_array_equal(jy, x_np)
    _close(tg, jg)
    with tdg.guard(tf.CPUPlace()):
        drop = tdg.Dropout(0.25)
        kept = drop(tdg.to_variable(np.ones((64, 64), "float32"))).numpy()
    assert set(np.unique(kept)) <= {0.0, np.float32(1 / 0.75)}
    assert 0.7 < (kept > 0).mean() < 0.8
