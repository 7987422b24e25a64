"""The scenarios of tests/test_dygraph.py on the port's eager mode
(paddle_tpu_torch.dygraph), each held against the JAX package's
dygraph on the same numpy inputs with the weights carried across by
name (`convert.layer_state_from_numpy`), on the CPU, fp32: autograd
against numpy, a Linear-ReLU chain, the conv / BatchNorm / Linear
training with its running statistics, state_dict round trips, Embedding
and LayerNorm, DataParallel on one rank, eager against the port's own
static executor, distinct dropout streams per occurrence.
tests/test_torch_dygraph_eager.py holds the rest of the eager surface.

Tolerances (fp32 both sides, sums in other orders): values and
gradients atol 1e-5 + rtol 1e-4 (the conv net's after five Adam steps at
lr 1e-2: 1e-4 + 1e-3, as five steps compound the rounding); losses rtol
1e-5; running statistics atol 1e-6 + rtol 1e-5; plain element-wise
results exactly.
"""

import numpy as np

from paddle_tpu import dygraph as jdg
from paddle_tpu.dygraph.tracer import trace_op as jtrace
from paddle_tpu.dygraph.tracer import trace_op_multi as jtrace_multi
from paddle_tpu.optimizer import Adam as JAdam

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch import dygraph as tdg
from paddle_tpu_torch.dygraph.tracer import trace_op as ttrace
from paddle_tpu_torch.dygraph.tracer import trace_op_multi as ttrace_multi
from paddle_tpu_torch.optimizer import Adam as TAdam

MEAN = {"dim": None, "keep_dim": False}
JAX = (jdg, jtrace, jtrace_multi, jdg.guard)
PORT = (tdg, ttrace, ttrace_multi, lambda: tdg.guard(tf.CPUPlace()))


def _close(got, want, atol=1e-5, rtol=1e-4, msg=""):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=msg)


def test_basic_autograd_matches_numpy():
    x_np = np.array([[1.0, 2.0], [3.0, 4.0]], "float32")
    for dg, trace, _, guard in (JAX, PORT):
        with guard():
            x = dg.to_variable(x_np)
            x.stop_gradient = False
            y = x * x + 3.0 * x
            loss = trace("reduce_sum", {"X": [y]}, MEAN)
            loss.backward()
            np.testing.assert_allclose(x.gradient(), 2 * x_np + 3.0,
                                       rtol=1e-6)
            np.testing.assert_allclose(loss.numpy(), [60.0], rtol=1e-6)


def _linear_relu(pkg, state=None):
    dg, trace, _, guard = pkg
    x_np = np.random.RandomState(0).randn(2, 4).astype("float32")
    with guard():
        lin = dg.Linear(4, 3)
        if state is not None:
            convert.layer_state_from_numpy(lin, state)
        x = dg.to_variable(x_np)
        x.stop_gradient = False
        h = trace("relu", {"X": [lin(x)]}, {})
        loss = trace("reduce_mean", {"X": [h]}, MEAN)
        loss.backward()
        return (lin.state_dict(), loss.numpy(), x.gradient(),
                lin.weight.gradient(), lin.bias.gradient())


def test_linear_relu_chain_grads():
    want = _linear_relu(JAX)
    got = _linear_relu(PORT, state=want[0])
    assert got[3].shape == (4, 3) and got[4].shape == (3,)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)


class _ConvNet:
    """test_dygraph.py's mnist-style net for either package, its conv
    without a bias: batch norm subtracts a conv bias again, so its
    gradient is rounding noise, and Adam's step follows that noise's
    sign (lr either way), which the two packages' sums draw apart and
    the running mean would carry."""

    @staticmethod
    def build(dg, trace):
        class Net(dg.Layer):
            def __init__(self):
                super().__init__()
                self.conv = dg.Conv2D(1, 8, 3, padding=1, bias_attr=False)
                self.bn = dg.BatchNorm(8)
                self.fc = dg.Linear(8 * 8 * 8, 10)

            def forward(self, x):
                h = self.bn(self.conv(x))
                h = trace("relu", {"X": [h]}, {})
                h = trace("reshape2", {"X": [h]}, {"shape": [-1, 8 * 8 * 8]})
                return self.fc(h)

        return Net()


def _conv_training(pkg, adam, state=None, steps=5):
    dg, trace, trace_multi, guard = pkg
    rng = np.random.RandomState(0)
    xs = rng.randn(16, 1, 8, 8).astype("float32")
    ys = rng.randint(0, 10, (16, 1)).astype("int64")
    with guard():
        net = _ConvNet.build(dg, trace)
        if state is not None:
            assert len(convert.layer_state_from_numpy(net, state)) == 7
        start = net.state_dict()
        opt = adam(1e-2, parameter_list=net.parameters())
        losses = []
        for _ in range(steps):
            logits = net(dg.to_variable(xs))
            loss_full = trace_multi(
                "softmax_with_cross_entropy",
                {"Logits": [logits], "Label": [dg.to_variable(ys)]},
                {})["Loss"][0]
            loss = trace("reduce_mean", {"X": [loss_full]}, MEAN)
            loss.backward()
            opt.minimize(loss, parameter_list=net.parameters())
            net.clear_gradients()
            losses.append(float(loss.numpy().reshape(-1)[0]))
        net.eval()
        eval_logits = net(dg.to_variable(xs[:4])).numpy()
        return start, losses, net.state_dict(), eval_logits


def test_conv_batchnorm_training_matches_the_jax_package():
    start, jlosses, jend, jeval = _conv_training(JAX, JAdam)
    _, tlosses, tend, teval = _conv_training(PORT, TAdam, state=start)
    assert tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert set(tend) == set(jend) == set(start)
    for name in ("bn._mean_buf", "bn._var_buf"):
        assert not np.array_equal(tend[name], start[name]), name
        _close(tend[name], jend[name], atol=1e-6, rtol=1e-5, msg=name)
    for name, w in jend.items():
        _close(tend[name], w, atol=1e-4, rtol=1e-3, msg=name)
    # eval mode normalises with the running statistics
    _close(teval, jeval, atol=1e-4, rtol=1e-3)


def test_layer_state_dict_roundtrip():
    with tdg.guard(tf.CPUPlace()):
        net = tdg.Sequential(tdg.Linear(4, 8), tdg.Linear(8, 2))
        sd = net.state_dict()
        assert list(sd) == ["0.weight", "0.bias", "1.weight", "1.bias"]
        net2 = tdg.Sequential(tdg.Linear(4, 8), tdg.Linear(8, 2))
        assert not np.array_equal(net2.state_dict()["0.weight"],
                                  sd["0.weight"])
        leaf = net2[0].weight.value
        net2.set_dict(sd)
        assert net2[0].weight.value is leaf  # loaded in place
        for k, v in net2.state_dict().items():
            np.testing.assert_array_equal(v, sd[k])
        sd["0.weight"][:] = 0  # a copy, not a view of the parameter
        assert np.abs(net.state_dict()["0.weight"]).max() > 0
    with jdg.guard():
        jnet = jdg.Sequential(jdg.Linear(4, 8), jdg.Linear(8, 2))
        assert list(jnet.state_dict()) == list(sd)


def test_embedding_layernorm_match():
    ids_np = np.array([[1, 2, 3], [4, 0, 49]], "int64")
    with jdg.guard():
        emb, ln = jdg.Embedding([50, 16]), jdg.LayerNorm(16)
        want = ln(emb(jdg.to_variable(ids_np))).numpy()
        state = {**emb.state_dict(), **{"ln." + k: v for k, v in
                                        ln.state_dict().items()}}
    with tdg.guard(tf.CPUPlace()):
        emb, ln = tdg.Embedding([50, 16]), tdg.LayerNorm(16)
        convert.layer_state_from_numpy(emb, state)
        convert.layer_state_from_numpy(
            ln, {k[3:]: v for k, v in state.items() if k.startswith("ln.")})
        out = ln(emb(tdg.to_variable(ids_np)))
    assert out.shape == (2, 3, 16)
    _close(out.numpy(), want)


def test_data_parallel_single_process_identity():
    x_np = np.ones((2, 4), "float32")
    with tdg.guard(tf.CPUPlace()):
        lin = tdg.Linear(4, 2)
        dp = tdg.DataParallel(lin)
        assert dp.nranks == 1
        loss = ttrace("reduce_mean", {"X": [dp(tdg.to_variable(x_np))]},
                      MEAN)
        assert dp.scale_loss(loss) is loss
        loss.backward()
        before = lin.weight.gradient()
        dp.apply_collective_grads()  # no process group: the identity
        np.testing.assert_array_equal(lin.weight.gradient(), before)
        assert set(dp.state_dict()) == {"weight", "bias"}


def test_eager_matches_static_linear():
    """The port's eager Linear against the port's own executor, one set
    of weights and inputs."""
    rng = np.random.RandomState(3)
    w = rng.randn(4, 2).astype("float32")
    b = rng.randn(2).astype("float32")
    x_np = rng.randn(5, 4).astype("float32")
    main, startup = tf.Program(), tf.Program()
    with tf.unique_name.guard(), tf.program_guard(main, startup):
        xv = tf.data("x", [5, 4], "float32")
        out = tf.layers.fc(xv, 2, param_attr=tf.ParamAttr(name="w0"),
                           bias_attr=tf.ParamAttr(name="b0"))
        loss = tf.layers.reduce_mean(out)
    scope = tf.Scope()
    convert.state_from_numpy({"w0": w, "b0": b}, scope, tf.CPUPlace())
    static_loss, = tf.Executor(tf.CPUPlace()).run(
        main, feed={"x": x_np}, fetch_list=[loss], scope=scope)
    assert not tf.in_dygraph_mode()
    with tdg.guard(tf.CPUPlace()):
        assert tf.in_dygraph_mode()
        lin = tdg.Linear(4, 2)
        lin.weight.set_value(w)
        lin.bias.set_value(b)
        e_loss = tf.layers.reduce_mean(lin(tdg.to_variable(x_np)))
    assert not tf.in_dygraph_mode()
    np.testing.assert_allclose(static_loss.reshape(-1),
                               e_loss.numpy().reshape(-1), rtol=1e-6)


def test_explicit_seed_dropout_distinct_per_occurrence():
    """Two dropouts of one explicit seed in one step draw distinct masks
    (each traced op has its own uid), and a new guard draws them again."""

    def run_step():
        with tdg.guard(tf.CPUPlace()):
            x = tdg.to_variable(np.ones((64, 64), "float32"))
            attrs = {"dropout_prob": 0.5, "seed": 7,
                     "dropout_implementation": "upscale_in_train"}
            m1 = ttrace_multi("dropout", {"X": [x]}, dict(attrs))
            m2 = ttrace_multi("dropout", {"X": [x]}, dict(attrs))
            return m1["Mask"][0].numpy(), m2["Mask"][0].numpy()

    a1, a2 = run_step()
    assert not np.array_equal(a1, a2)
    assert 0.4 < a1.mean() < 0.6
    b1, b2 = run_step()
    np.testing.assert_array_equal(a1, b1)
    np.testing.assert_array_equal(a2, b2)


def test_fused_dropout_streams_differ_per_occurrence_and_step():
    """Training dropout in the fused residual op: two occurrences in one
    trace draw different masks, the same op sequence in a new guard the
    same ones."""
    rng = np.random.RandomState(0)
    x, y = rng.randn(2, 64, 32).astype("float32")
    attrs = {"dropout_prob": 0.5, "epsilon": 1e-5}

    def run():
        with tdg.guard(tf.CPUPlace()):
            a, b = tdg.to_variable(x), tdg.to_variable(y)
            return [ttrace("fused_dropout_add_ln", {"X": [a], "Y": [b]},
                           dict(attrs)).numpy() for _ in range(2)]

    first, second = run(), run()
    assert not np.array_equal(first[0], first[1])
    np.testing.assert_array_equal(first[0], second[0])
    np.testing.assert_array_equal(first[1], second[1])
