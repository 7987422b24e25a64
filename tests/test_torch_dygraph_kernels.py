"""Eager gradients through the ops that the hand-written kernels back:
fused_qkv_attention (#1/#3), fused_multihead_attention (#5/#6),
fused_dropout_add_ln (#2/#4) and layer_norm with
FLAGS_paddle_tpu_pallas_layer_norm on (#10/#11). Each is traced under
`dygraph.guard()` in the port (on the CPU, the kernels' plain versions)
and in the JAX package (its tape of `jax.vjp` closures), on the same
numpy inputs, every floating input differentiable; the loss is
sum(out * w) for a fixed random w. A kernel launch is invisible to
autograd: on the card the forward wrappers return tensors with no
`grad_fn`. The fixture `opaque_forwards` makes the plain versions
behave so here (each forward wrapper that ops/fused.py calls runs under
torch.no_grad), so a port whose tracer ran these ops as plain emitters,
autograd through the forward, would give no gradient at the inputs and
these tests would fail; the port's tracer runs their dedicated grad ops.

Tolerances, fp32 on both sides: outputs atol 1e-5, input gradients atol
1e-5 + rtol 1e-4 (sums over up to S = 32 rows in other orders).

With training dropout the port's backward must regenerate the forward's
mask: the eager gradients equal the plain backward called with the
op's own seed words (its uid in the tracer), within 1e-6.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import dygraph as jdg
from paddle_tpu import flags as jflags
from paddle_tpu.dygraph.tracer import trace_op_multi as jtrace

import paddle_tpu_torch as tf
from paddle_tpu_torch import dygraph as tdg
from paddle_tpu_torch.dygraph import tracer as ttracer
from paddle_tpu_torch.framework.registry import EmitContext
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_residual as fr

B, S, H, D = 2, 32, 4, 16
N = H * D
LN_FLAG = "FLAGS_paddle_tpu_pallas_layer_norm"


def _bias(rng):
    bias = np.zeros((B, S), np.float32)
    bias[1, S - 7:] = -1e4  # a padded tail of keys in one sample
    return bias + 0.1 * rng.randn(B, S).astype(np.float32)


def _case(name):
    rng = np.random.RandomState(7)
    f = lambda *shape: rng.randn(*shape).astype(np.float32)  # noqa: E731
    if name in ("qkv", "qkv_causal"):
        return ("fused_qkv_attention",
                {"QKV": f(B, S, 3 * N), "KeyBias": _bias(rng)},
                {"num_heads": H, "scale": D ** -0.5, "dropout_prob": 0.0,
                 "causal": name == "qkv_causal"}, (B, S, N))
    if name == "mha":
        return ("fused_multihead_attention",
                {"Q": f(B, H, S, D), "K": f(B, H, S, D), "V": f(B, H, S, D),
                 "KeyBias": _bias(rng)},
                {"scale": D ** -0.5, "dropout_prob": 0.0}, (B, H, S, D))
    if name == "residual":
        return ("fused_dropout_add_ln",
                {"X": f(B, S, N), "Y": f(B, S, N) * 2 + 0.5,
                 "Scale": 1 + 0.1 * f(N), "LnBias": 0.1 * f(N)},
                {"dropout_prob": 0.0, "epsilon": 1e-5}, (B, S, N))
    assert name == "layer_norm"
    return ("layer_norm",
            {"X": f(B, S, N) * 2 + 0.5, "Scale": 1 + 0.1 * f(N),
             "Bias": 0.1 * f(N)},
            {"begin_norm_axis": 2, "epsilon": 1e-5}, (B, S, N))


def _run(dg, trace, guard, op_type, inputs, attrs, out_shape):
    """(out, {slot: input gradient}) of sum(out * w) through one traced
    op, every input differentiable."""
    w = np.random.RandomState(11).randn(*out_shape).astype(np.float32)
    with guard():
        vbs = {}
        for slot, a in inputs.items():
            v = dg.to_variable(a)
            v.stop_gradient = False
            vbs[slot] = [v]
        out_slot = "Y" if op_type == "layer_norm" else "Out"
        out = trace(op_type, vbs, dict(attrs))[out_slot][0]
        loss = trace("reduce_sum", {"X": [out * dg.to_variable(w)]},
                     {"dim": None, "keep_dim": False})["Out"][0]
        loss.backward()
        return out.numpy(), {s: v[0].gradient() for s, v in vbs.items()}


@pytest.fixture
def opaque_forwards(monkeypatch):
    """The forward wrappers of ops/fused.py as opaque to autograd as a
    kernel launch is on the card."""
    from paddle_tpu_torch.ops import fused

    def opaque(fn):
        def run(*args, **kwargs):
            with torch.no_grad():
                return fn(*args, **kwargs)
        return run

    for name in ("fused_attention_qkv", "fused_attention",
                 "fused_dropout_add_ln_fwd"):
        monkeypatch.setattr(fused, name, opaque(getattr(fused, name)))


@pytest.fixture
def ln_flag_on():
    old_t = tf.get_flags([LN_FLAG])[LN_FLAG]
    old_j = jflags.get_flags([LN_FLAG])[LN_FLAG]
    tf.set_flags({LN_FLAG: True})
    jflags.set_flags({LN_FLAG: True})
    yield
    tf.set_flags({LN_FLAG: old_t})
    jflags.set_flags({LN_FLAG: old_j})


@pytest.mark.parametrize("name", ["qkv", "qkv_causal", "mha", "residual"])
def test_eager_input_gradients_match_the_jax_package(name, opaque_forwards):
    op_type, inputs, attrs, shape = _case(name)
    want_out, want = _run(jdg, jtrace, jdg.guard, op_type, inputs, attrs,
                          shape)
    got_out, got = _run(tdg, ttracer.trace_op_multi,
                        lambda: tdg.guard(tf.CPUPlace()), op_type, inputs,
                        attrs, shape)
    np.testing.assert_allclose(got_out, want_out, atol=1e-5, rtol=0)
    for slot, g in want.items():
        assert got[slot] is not None, f"no gradient reached {slot}"
        assert np.abs(got[slot]).max() > 0, slot
        np.testing.assert_allclose(got[slot], g, atol=1e-5, rtol=1e-4,
                                   err_msg=slot)


def test_layer_norm_flag_on_gradients_match(ln_flag_on):
    op_type, inputs, attrs, shape = _case("layer_norm")
    want_out, want = _run(jdg, jtrace, jdg.guard, op_type, inputs, attrs,
                          shape)
    got_out, got = _run(tdg, ttracer.trace_op_multi,
                        lambda: tdg.guard(tf.CPUPlace()), op_type, inputs,
                        attrs, shape)
    np.testing.assert_allclose(got_out, want_out, atol=1e-5, rtol=0)
    for slot, g in want.items():
        np.testing.assert_allclose(got[slot], g, atol=1e-5, rtol=1e-4,
                                   err_msg=slot)


def _seed_words(op_type):
    """The seed words of the op the current tracer traced last."""
    uid = ttracer._current()._op_seq
    return EmitContext("cpu", seed=uid).seed_words(uid, op_type)


def test_training_dropout_backward_regenerates_the_forward_mask(
        opaque_forwards):
    rng = np.random.RandomState(3)
    qkv = rng.randn(B, S, 3 * N).astype(np.float32)
    bias = _bias(rng)
    x, y = rng.randn(2, B * S, N).astype(np.float32)
    g, c = 1 + 0.1 * rng.randn(2, N).astype(np.float32)
    do_a = rng.randn(B, S, N).astype(np.float32)
    do_r = rng.randn(B * S, N).astype(np.float32)
    akw = dict(scale=D ** -0.5, dropout_rate=0.3, is_test=False)
    rkw = dict(rate=0.3, is_test=False, eps=1e-5)
    with tdg.guard(tf.CPUPlace()):
        vq, vb = tdg.to_variable(qkv), tdg.to_variable(bias)
        vq.stop_gradient = False
        out = tf.layers.fused_qkv_attention(vq, H, key_bias=vb,
                                            scale=D ** -0.5,
                                            dropout_prob=0.3)
        seed_a = _seed_words("fused_qkv_attention")
        (out * tdg.to_variable(do_a)).value.sum().backward()
        vx, vy, vg, vc = (tdg.to_variable(a) for a in (x, y, g, c))
        for v in (vx, vy, vg, vc):
            v.stop_gradient = False
        res = ttracer.trace_op(
            "fused_dropout_add_ln",
            {"X": [vx], "Y": [vy], "Scale": [vg], "LnBias": [vc]},
            {"dropout_prob": 0.3, "epsilon": 1e-5})
        seed_r = _seed_words("fused_dropout_add_ln")
        (res * tdg.to_variable(do_r)).value.sum().backward()
    t = {k: torch.from_numpy(v) for k, v in
         dict(qkv=qkv, bias=bias, do_a=do_a, x=x, y=y, g=g, do_r=do_r).items()}
    assert seed_a != seed_r
    want_out = fa.reference_qkv(t["qkv"], H, t["bias"], seed=seed_a, **akw)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), atol=1e-6)
    no_drop = fa.reference_qkv(t["qkv"], H, t["bias"], scale=D ** -0.5)
    assert np.abs(out.numpy() - no_drop.numpy()).max() > 1e-2  # a mask
    want_dqkv, _ = fa.reference_qkv_bwd(t["qkv"], H, t["bias"], t["do_a"],
                                        seed=seed_a, **akw)
    np.testing.assert_allclose(vq.gradient(), want_dqkv.numpy(), atol=1e-6)
    want = fr.reference_bwd(t["x"], t["y"], t["g"], t["do_r"], seed=seed_r,
                            **rkw)
    for v, w_ in zip((vx, vy, vg, vc), want):
        np.testing.assert_allclose(v.gradient(), w_.numpy(), atol=1e-5,
                                   rtol=1e-5)
