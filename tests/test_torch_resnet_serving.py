"""Port parity for the ResNet serving slice: bench_serving.py's
resnet_classify endpoint (`_build_classifier_endpoint("resnet")`:
resnet(img, class_num=10, depth=18, is_test=False) on [-1, 3, 32, 32],
softmax, an Adam(1e-3) minimize appended, frozen with
freeze_program(main, [prob], feed_names=("image",))), built and frozen by
paddle_tpu_torch and by the JAX package, run on the CPU from the JAX
package's startup state at batches of 1, 2 and 4, and served by the
port's serving.Server at buckets (1, 2, 4).

The frozen programs hold the same ops, every batch_norm in test mode
(clone(for_test=True) flips is_test), and no grad or update op.
Tolerances, fp32, 18 layers of convolutions summed in other orders:
probabilities atol 1e-5 (a probability is at most 1; measured 4.8e-7),
logits within 1e-5 of the largest logit's magnitude; the served answers
equal to the port's direct run of the same batch within 1e-6.
"""

import numpy as np
import pytest

import paddle_tpu as jf
from paddle_tpu import layers as jl
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.resnet import resnet as jresnet
from paddle_tpu.serving import freeze_program as jfreeze

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.serving import EndpointConfig, Server
from paddle_tpu_torch.serving import freeze_program as tfreeze

from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

JAX = (jf, jl, jun, jresnet, jfreeze, JScope)
PORT = (tf, tl, tf.unique_name, tresnet, tfreeze, tf.Scope)
BUCKETS = (1, 2, 4)
PROB_ATOL = 1e-5
LOGIT_RTOL = 1e-5


def build(pkg):
    """bench_serving's resnet classifier, frozen, and its startup."""
    fluid, layers, unique_name, resnet, freeze, _ = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.data("image", [-1, 3, 32, 32], "float32")
        logits = resnet(img, class_num=10, depth=18, is_test=False)
        prob = layers.softmax(logits)
        lab = fluid.data("lab", [-1, 1], "int64")
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, lab))
        fluid.optimizer.Adam(1e-3).minimize(loss, startup)
    return freeze(main, [prob], feed_names=("image",)), startup


def images(n, seed):
    """bench_serving's samples: standard normal images."""
    return np.random.RandomState(seed).randn(n, 3, 32, 32).astype(np.float32)


def fetches(frozen):
    """The served probabilities and the logits under them (the softmax's
    input: at random weights and initial moving statistics most rows are
    near one-hot, the logits are not)."""
    softmax, = [op for op in frozen.program.global_block.ops
                if op.type == "softmax"]
    return list(frozen.fetch_names) + softmax.inputs["X"]


@pytest.fixture(scope="module")
def jax_side():
    frozen, startup = build(JAX)
    scope, exe = JScope(), jf.Executor(jf.CPUPlace())
    exe.run(startup, scope=scope)
    state = {n: np.asarray(scope.find_var(n)) for n in scope.local_var_names()}
    outs = {b: [np.asarray(v) for v in exe.run(
        frozen.program, feed={"image": images(b, b)},
        fetch_list=fetches(frozen), scope=scope)] for b in BUCKETS}
    return frozen, state, outs


def test_frozen_programs_match_and_run_in_test_mode(jax_side):
    jfrozen = jax_side[0]
    tfrozen, _ = build(PORT)
    jops, tops = jfrozen.program.global_block.ops, \
        tfrozen.program.global_block.ops
    assert [op.type for op in tops] == [op.type for op in jops]
    for jop, top in zip(jops, tops):
        assert top.inputs == jop.inputs and top.outputs == jop.outputs, top
    bns = [op for op in tops if op.type == "batch_norm"]
    assert len(bns) == 20 and all(op.attr("is_test") is True for op in bns)
    types = {op.type for op in tops}
    assert not types & {"__vjp__", "adam", "softmax_with_cross_entropy"}
    assert tfrozen.program._is_inference
    assert tfrozen.feed_names == ("image",)
    assert tfrozen.fetch_names == jfrozen.fetch_names


def test_frozen_answers_match_the_jax_package_and_the_server(jax_side):
    _, state, want = jax_side
    frozen, _ = build(PORT)
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    convert.state_from_numpy(state, scope, tf.CPUPlace(),
                             program=frozen.program)
    direct = {}
    for b in BUCKETS:
        got, logits = exe.run(frozen.program, feed={"image": images(b, b)},
                              fetch_list=fetches(frozen), scope=scope)
        assert got.shape == (b, 10) and np.isfinite(got).all()
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
        np.testing.assert_allclose(got, want[b][0], rtol=0, atol=PROB_ATOL,
                                   err_msg=f"batch {b}")
        err = np.abs(logits - want[b][1]).max()
        assert err <= LOGIT_RTOL * np.abs(want[b][1]).max(), (b, err)
        direct[b] = got
    # the moving statistics are read, never written, in test mode
    for name in state:
        if name.startswith(("bn_mean", "bn_variance")):
            np.testing.assert_array_equal(
                scope.find_var(name).numpy(), state[name], err_msg=name)
    # the same images one request each through the server: batches of
    # 1, 2 and 4 (full and padded buckets)
    srv = Server()
    try:
        ep = srv.add_endpoint("resnet", frozen=frozen, executor=exe,
                              scope=scope,
                              config=EndpointConfig(buckets=BUCKETS,
                                                    max_wait_ms=50.0))
        srv.warmup()
        served = []
        for b in BUCKETS:
            futs = [srv.submit("resnet", {"image": x}) for x in
                    images(b, b)]
            served.append(np.stack([f.result(timeout=120)[0]
                                    for f in futs]))
    finally:
        assert srv.close(timeout=120)
    assert ep.batches and all(bk in BUCKETS for bk, _ in ep.batches)
    for b, got in zip(BUCKETS, served):
        # a padded or regrouped batch runs each image through the same
        # per-sample arithmetic (test-mode batch norm)
        np.testing.assert_allclose(got, direct[b], rtol=0, atol=1e-6,
                                   err_msg=f"served, batch {b}")
