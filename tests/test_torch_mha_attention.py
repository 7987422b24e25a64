"""Port parity for the 4-D attention (#5, #6): the plain versions of
paddle_tpu_torch.kernels.flash_attention.fused_attention and
attention_grads against the JAX package's, both through its Pallas
kernels in interpret mode and through its jnp reference; the
fused_multihead_attention op and its grad op in a program against the JAX
package's; the port's training dropout (forward and backward draw one
Philox mask, the packed kernels' mask); and the AMP rewrite's declared
bf16 against the runtime dtype.

Inputs come from numpy with a fixed seed. Tolerance: fp32 rtol 2e-4,
atol 2e-5 (the JAX package's own kernel-vs-reference bound for
gradients; the two sum in other orders). The JAX package draws its
training masks from jax.random, so the cross-package cases run in test
mode or without dropout.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu import layers as jl
from paddle_tpu.contrib.mixed_precision import fp16_utils as jfp16
from paddle_tpu.contrib.mixed_precision.fp16_lists import (
    AutoMixedPrecisionLists as JLists,
)
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.kernels import flash_attention as jfa

import paddle_tpu_torch as tf
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.contrib.mixed_precision import fp16_utils as tfp16
from paddle_tpu_torch.contrib.mixed_precision.fp16_lists import (
    AutoMixedPrecisionLists as TLists,
)
from paddle_tpu_torch.framework.registry import EmitContext
from paddle_tpu_torch.kernels import flash_attention as tfa

B, H, S, D = 2, 3, 128, 32
RATE = 0.1
RTOL, ATOL = 2e-4, 2e-5
WORDS = (0x2024ABCD, 0x5EED0001)


def _qkv(seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(B, H, S, D) * 0.5).astype(dtype)
                 for _ in range(3))


def _bias():
    bias = np.zeros((B, S), np.float32)
    bias[1, 3 * S // 4:] = -1e4  # padded keys of the second sample
    return bias


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@functools.lru_cache(maxsize=None)
def _jax_fwd(causal, impl, interpret):
    """The JAX package's fused_attention in test mode, jitted (its
    interpret-mode kernel takes seconds per unjitted call)."""
    force = not interpret
    return jax.jit(lambda q, k, v, b: jfa.fused_attention(
        q, k, v, b, dropout_rate=RATE, is_test=True, causal=causal,
        dropout_implementation=impl, interpret=interpret,
        force_reference=force))


@functools.lru_cache(maxsize=None)
def _jax_bwd(causal, interpret):
    return jax.jit(lambda q, k, v, b, do: jfa.attention_grads(
        q, k, v, b, do, None, causal=causal, interpret=interpret,
        force_reference=not interpret))


@pytest.mark.parametrize("interpret", [True, False],
                         ids=["pallas_interpret", "reference"])
@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_the_jax_package(causal, impl, interpret):
    """#5's plain version against fused_attention, key bias on, test-mode
    dropout scaling (downgrade_in_infer scales by 1-p)."""
    q, k, v = _qkv()
    bias = _bias()
    port = tfa.fused_attention(*_t(q, k, v, bias), dropout_rate=RATE,
                               is_test=True, causal=causal,
                               dropout_implementation=impl).numpy()
    want = np.asarray(_jax_fwd(causal, impl, interpret)(*_j(q, k, v, bias)))
    assert port.shape == (B, H, S, D)
    np.testing.assert_allclose(port, want, rtol=RTOL, atol=ATOL)


def test_downgrade_in_infer_scales_by_keep_prob():
    q, k, v = _t(*_qkv(seed=1))
    kw = dict(dropout_rate=RATE, is_test=True)
    down = tfa.fused_attention(q, k, v, **kw)
    up = tfa.fused_attention(q, k, v,
                             dropout_implementation="upscale_in_train", **kw)
    np.testing.assert_allclose(down.numpy(), up.numpy() * (1 - RATE),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("interpret", [True, False],
                         ids=["pallas_interpret", "reference"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_the_jax_package(causal, interpret):
    """#6's plain version (dq, dk, dv, dbias) against attention_grads."""
    q, k, v = _qkv(seed=2)
    bias = _bias()
    do = np.random.RandomState(3).randn(B, H, S, D).astype(np.float32)
    port = tfa.attention_grads(*_t(q, k, v, bias, do), causal=causal)
    want = _jax_bwd(causal, interpret)(*_j(q, k, v, bias, do))
    for name, p, w in zip(("dq", "dk", "dv", "dbias"), port, want):
        np.testing.assert_allclose(p.numpy(), np.asarray(w).reshape(p.shape),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_no_bias_matches_the_reference():
    q, k, v = _qkv(seed=4)
    port = tfa.fused_attention(*_t(q, k, v)).numpy()
    want = np.asarray(jfa.fused_attention(*_j(q, k, v),
                                          force_reference=True))
    np.testing.assert_allclose(port, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("args,want", [
    ((128, 64, "float32"), True),
    ((512, 64, "bfloat16"), True),
    ((1024, 128, torch.float32), True),
    ((77, 32, torch.bfloat16), True),   # the kernels tile any S
    ((1025, 64, "float32"), False),     # the JAX package's whole-row cap
    ((128, 48, "float32"), False),      # no kernel instantiated for D=48
    ((128, 64, "float16"), False),
])
def test_supports(args, want):
    assert tfa.supports(*args) is want


def test_a_cpu_tensor_outside_supports_runs_the_plain_version():
    """Only a CUDA tensor is refused (it needs the card: the card tests);
    on the CPU the plain version takes any shape."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 1100, 48).astype(np.float32))
               for _ in range(3))
    assert not tfa.supports(1100, 48, q.dtype)
    out = tfa.fused_attention(q, k, v)
    ref = np.asarray(jfa.fused_attention(*_j(q.numpy(), k.numpy(),
                                             v.numpy()),
                                         force_reference=True))
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_training_dropout_is_the_packed_kernels_mask():
    """#5 on the heads of a packed projection equals #1 on the projection,
    dropout on: both key the Philox mask by (seed words, b, h, i, j); and
    #6 equals #3, dbias included, bit for bit in the plain versions."""
    rng = np.random.RandomState(6)
    qkv = torch.from_numpy(rng.randn(B, S, 3 * H * D).astype(np.float32))
    bias = torch.from_numpy(_bias())
    q, k, v = qkv.view(B, S, 3, H, D).permute(2, 0, 3, 1, 4)
    kw = dict(dropout_rate=0.25, is_test=False, seed=WORDS, causal=True)
    out = tfa.fused_attention(q, k, v, bias, **kw)
    packed = tfa.fused_attention_qkv(qkv, H, bias, **kw)
    assert torch.equal(out.transpose(1, 2).reshape(B, S, H * D), packed)
    do = torch.from_numpy(rng.randn(B, H, S, D).astype(np.float32))
    dq, dk, dv, db = tfa.attention_grads(q, k, v, bias, do, **kw)
    dqkv, db1 = tfa.fused_attention_qkv_bwd(
        qkv, H, bias, do.transpose(1, 2).reshape(B, S, H * D),
        want_dbias=True, **kw)
    grads = torch.cat([t.transpose(1, 2).reshape(B, S, H * D)
                       for t in (dq, dk, dv)], -1)
    assert torch.equal(grads, dqkv) and torch.equal(db, db1)
    # a dropped probability passes no gradient to v: dv = (keep . p)^T dO
    assert 0.6 < (out != 0).float().mean() <= 1.0


def test_autograd_and_torch_func_vjp_reach_the_backward():
    """Flash4D's gradients through autograd and through torch.func.vjp
    (the `__vjp__` replay's transform) equal attention_grads', dropout on."""
    q, k, v, bias = _t(*_qkv(seed=7), _bias())
    do = torch.from_numpy(
        np.random.RandomState(8).randn(B, H, S, D).astype(np.float32))
    kw = dict(dropout_rate=RATE, is_test=False, seed=WORDS)
    want = tfa.attention_grads(q, k, v, bias, do, **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = tfa.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    _, vjp = torch.func.vjp(
        lambda a, b, c, d: tfa.flash_attention(a, b, c, d, **kw),
        q, k, v, bias)
    for g1, g2, w in zip(got, vjp(do), want):
        assert torch.equal(g1, w) and torch.equal(g2, w)


def _op_program(pkg, dropout, is_test):
    fluid, layers, guard = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 5
    with guard(), fluid.program_guard(main, startup):
        q, k, v = (fluid.data(n, [B, H, S, D], "float32")
                   for n in ("q", "k", "v"))
        bias = fluid.data("bias", [B, S], "float32")
        w = fluid.data("w", [B, H, S, D], "float32")
        for x in (q, k, v, bias):
            x.stop_gradient = False
        out = layers.fused_multihead_attention(
            q, k, v, key_bias=bias, scale=0.2, dropout_prob=dropout,
            is_test=is_test)
        loss = layers.reduce_sum(layers.elementwise_mul(out, w))
        grads = fluid.gradients(loss, [q, k, v, bias])
    return main, out, grads


JAXPKG = (jf, jl, jun.guard)
PORT = (tf, tl, tf.unique_name.guard)


def _feed(seed):
    q, k, v = _qkv(seed)
    w = np.random.RandomState(seed + 1).randn(B, H, S, D).astype(np.float32)
    return {"q": q, "k": k, "v": v, "bias": _bias(), "w": w}


def test_op_and_grad_op_match_the_jax_package():
    """The fused_multihead_attention op and its dedicated grad op (no
    forward replay) in a program, against the JAX package's: the same
    ops and attrs, the same output and gradients of q, k, v and the key
    bias (training without dropout)."""
    jmain, jout, jgrads = _op_program(JAXPKG, 0.0, False)
    tmain, tout, tgrads = _op_program(PORT, 0.0, False)
    jops, tops = jmain.global_block.ops, tmain.global_block.ops
    assert [op.type for op in tops] == [op.type for op in jops]
    assert "fused_multihead_attention_grad" in [op.type for op in tops]
    for jop, top in zip(jops, tops):
        assert top.inputs == jop.inputs and top.outputs == jop.outputs
    feed = _feed(9)
    want = jf.Executor(jf.CPUPlace()).run(
        jmain, feed=feed, fetch_list=[jout] + jgrads, scope=JScope())
    got = tf.Executor(tf.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[tout] + tgrads, scope=tf.Scope())
    for name, g, w in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_test_mode_op_matches_the_jax_package():
    """is_test: the op scales by 1-p (downgrade_in_infer) in both."""
    jmain, jout, _ = _op_program(JAXPKG, RATE, True)
    tmain, tout, _ = _op_program(PORT, RATE, True)
    feed = _feed(10)
    want, = jf.Executor(jf.CPUPlace()).run(jmain, feed=feed,
                                           fetch_list=[jout], scope=JScope())
    got, = tf.Executor(tf.CPUPlace()).run(tmain, feed=feed, fetch_list=[tout],
                                          scope=tf.Scope())
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_grad_op_regenerates_the_forward_mask():
    """With dropout in training, the grad op's gradients equal Flash4D's
    under the forward op's seed words: one mask, forward and backward."""
    tmain, tout, tgrads = _op_program(PORT, 0.25, False)
    feed = _feed(11)
    got = tf.Executor(tf.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[tout] + tgrads, scope=tf.Scope())
    attn = next(op for op in tmain.global_block.ops
                if op.type == "fused_multihead_attention")
    words = EmitContext("cpu", seed=5, step=0).seed_words(attn.uid, attn.type)
    leaves = [torch.from_numpy(feed[n]).requires_grad_()
              for n in ("q", "k", "v", "bias")]
    out = tfa.flash_attention(*leaves, scale=0.2, dropout_rate=0.25,
                              is_test=False, seed=words)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(feed["w"]))
    np.testing.assert_array_equal(out.detach().numpy(), got[0])
    for g, w in zip(grads, got[1:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)


def test_amp_rewrite_declares_the_runtime_dtype():
    """Under the AMP rewrite (fused_multihead_attention is white-listed)
    the op reads bf16 q, k, v: the port casts them as the JAX package
    does, op for op, and the declared output dtype is the one the op
    gives at run time."""
    def build(pkg, lists, rewrite):
        fluid, layers, guard = pkg
        main, startup = fluid.Program(), fluid.Program()
        with guard(), fluid.program_guard(main, startup):
            q, k, v = (fluid.data(n, [B, H, S, D], "float32")
                       for n in ("q", "k", "v"))
            bias = fluid.data("bias", [B, S], "float32")
            out = layers.fused_multihead_attention(q, k, v, key_bias=bias,
                                                   dropout_prob=RATE)
        rewrite(main, lists(), dest_dtype="bfloat16")
        return main, out

    jmain, _ = build(JAXPKG, JLists, jfp16.rewrite_program)
    tmain, tout = build(PORT, TLists, tfp16.rewrite_program)
    jb, tb = jmain.global_block, tmain.global_block
    assert [op.type for op in tb.ops] == [op.type for op in jb.ops]
    for jop, top in zip(jb.ops, tb.ops):
        for n in top.input_names() + top.output_names():
            assert str(tb.var(n).dtype) == str(jb.var(n).dtype), n
    attn = next(op for op in tb.ops if op.type == "fused_multihead_attention")
    assert all(tb.var(attn.inputs[s][0]).dtype == "bfloat16"
               for s in ("Q", "K", "V"))
    feed = {k: v for k, v in _feed(12).items() if k != "w"}
    tmain.random_seed = 1
    got, = tf.Executor(tf.CPUPlace()).run(tmain, feed=feed, fetch_list=[tout],
                                          scope=tf.Scope(),
                                          return_numpy=False)
    assert str(got.dtype) == "torch." + tb.var(tout.name).dtype == \
        "torch.bfloat16"
