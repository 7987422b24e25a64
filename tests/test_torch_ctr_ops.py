"""Port parity for the CTR slice's new op emitters, `sigmoid` and
`sigmoid_cross_entropy_with_logits` (with ignore_index and normalize):
each built by paddle_tpu_torch and by the JAX package in a one-op
program, run on the CPU from the same numpy inputs; the forward output
and the gradients of sum(out * w) with respect to every floating input
through the generic `__vjp__` grad op. Plus the observability switch the
embedding engine's telemetry obeys (PADDLE_TPU_MONITOR).

Inputs come from numpy with a fixed seed; the labels are 0/1 with some
positions at the ignore value. Tolerance: fp32, rtol 1e-5 and atol 1e-6
(single ops on values of magnitude ~1).
"""

import numpy as np
import pytest

import paddle_tpu as jf
from paddle_tpu import layers as jl
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.backward import gradients as jgradients

import paddle_tpu_torch as tf
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch import observability

JAX = (jf, jl, jun, jgradients)
PORT = (tf, tl, tf.unique_name, tf.gradients)

CASES = {
    "sigmoid": lambda L, v: L.sigmoid(v["x"]),
    "sigmoid_ce": lambda L, v: L.sigmoid_cross_entropy_with_logits(
        v["x"], v["label"]),
    "sigmoid_ce_ignore": lambda L, v: L.sigmoid_cross_entropy_with_logits(
        v["x"], v["label_ign"], ignore_index=-1),
    "sigmoid_ce_normalize": lambda L, v: L.sigmoid_cross_entropy_with_logits(
        v["x"], v["label_ign"], ignore_index=-1, normalize=True),
    "sigmoid_ce_normalize_all_ignored": lambda L, v:
        L.sigmoid_cross_entropy_with_logits(v["x"], v["none"],
                                            ignore_index=-1, normalize=True),
}


def _inputs():
    rng = np.random.RandomState(0)
    x = (3 * rng.randn(8, 5)).astype(np.float32)
    x[0, :2] = 0.0  # the kink of max(x, 0)
    label = (rng.rand(8, 5) < 0.4).astype(np.float32)
    ign = label.copy()
    ign[rng.rand(8, 5) < 0.3] = -1.0
    return {"x": x, "label": label, "label_ign": ign,
            "none": np.full((8, 5), -1.0, np.float32)}


def _run(pkg, case, feed):
    fluid, layers, unique_name, gradients = pkg
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        v = {}
        for name, a in feed.items():
            v[name] = fluid.data(name, list(a.shape), str(a.dtype))
            v[name].stop_gradient = False
        out = CASES[case](layers, v)
        w = fluid.data("w", list(out.shape), "float32")
        loss = layers.reduce_sum(layers.elementwise_mul(out, w))
        grads = [g for g in gradients(loss, list(v.values()))
                 if g is not None]
    feed = dict(feed, w=np.random.RandomState(1).randn(
        *out.shape).astype(np.float32))
    exe = fluid.Executor(fluid.CPUPlace())
    return [np.asarray(r) for r in exe.run(
        main, feed=feed, fetch_list=[out] + grads)], len(grads)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_the_jax_package_forward_and_vjp(case):
    feed = _inputs()
    want, n_want = _run(JAX, case, feed)
    got, n_got = _run(PORT, case, feed)
    assert n_got == n_want >= 1  # a gradient came through __vjp__
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    if case == "sigmoid_ce_ignore":
        ignored = feed["label_ign"] == -1
        assert ignored.any() and (got[0][ignored] == 0).all()


def test_monitor_switch_reads_the_environment(monkeypatch):
    """PADDLE_TPU_MONITOR=0 turns every counter, gauge, histogram and
    span into a no-op; set_enabled(None) reads the variable again."""
    observability.reset()
    monkeypatch.setenv("PADDLE_TPU_MONITOR", "0")
    observability.set_enabled(None)
    try:
        assert not observability.enabled()
        observability.add("c")
        observability.set_gauge("g", 1.0)
        observability.observe("h", 0.5)
        with observability.span("s"):
            pass
        assert not observability.get_counters()
        assert not observability.get_gauges()
        assert not observability.get_histograms()
        assert not observability.get_spans()
    finally:
        monkeypatch.delenv("PADDLE_TPU_MONITOR")
        observability.set_enabled(None)
    assert observability.enabled()
    observability.add("c", 2)
    observability.observe("h", 0.5, buckets=(0.25, 1.0))
    with observability.span("s", category="t", k=1):
        pass
    assert observability.get_counters() == {"c": 2}
    h = observability.get_histograms()["h"]
    assert h["count"] == 1 and h["buckets"] == [[0.25, 0], [1.0, 1],
                                                ["+Inf", 1]]
    (span,) = observability.get_spans()
    assert (span["name"], span["cat"], span["args"]) == ("s", "t", {"k": 1})
    observability.reset()
    assert not observability.get_spans() and not observability.get_counters()
