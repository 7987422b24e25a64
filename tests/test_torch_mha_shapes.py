"""Port parity for the attention shapes the kernels take only routed
(flash_attention.route): the 4-D fused_attention / attention_grads and
the packed fused_attention_qkv / fused_attention_qkv_bwd past the
whole-row cap (S=1152, 2048: #7-#9 on the card), at a head dim the
kernels take zero-padded (D=48: the next width, 64), and in fp16 (no
kernel: the plain version on every device), against the JAX package's
jnp reference on the same inputs, as the JAX package answers these
shapes on the CPU. The CPU runs the plain version of the routed kernels
(here the KV-tiled online softmax past S=1024). The
fused_multihead_attention op and its grad op at S=1152, D=48 in a
program against the JAX package's.

Inputs come from numpy with a fixed seed. Tolerances: fp32 atol 2e-5 +
rtol 2e-4 (test_torch_mha_attention.py's); fp16 outputs and gradients
atol 2e-3 + rtol 2e-3 (both sum in fp32 and round once to fp16, 11
mantissa bits, whose unit at magnitudes < 2 is <= 2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu import layers as jl
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.kernels import flash_attention as jfa

import paddle_tpu_torch as tf
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.kernels import flash_attention as tfa

TOL = {np.float32: (2e-4, 2e-5), np.float16: (2e-3, 2e-3)}


def _inputs(B, H, S, D, dtype, seed):
    rng = np.random.RandomState(seed)
    qkv = [(rng.randn(B, H, S, D) * 0.5).astype(dtype) for _ in range(4)]
    bias = np.zeros((B, S), np.float32)
    bias[-1, S - S // 7:] = -1e4
    return qkv, bias


def _close(got, want, dtype, what):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def test_route_reads_shape_and_dtype_only():
    assert tfa.route(1024, 64, torch.float32) == "whole"
    assert tfa.route(1152, 64, "bfloat16") == "tiled"
    assert tfa.route(2048, 48, torch.float32) == "tiled"
    assert tfa.route(128, 48, torch.float32) == "whole"
    assert tfa.route(128, 64, torch.float16) is None
    assert tfa.route(128, 36, torch.float32) is None   # D % 8 != 0
    assert tfa.route(128, 256, torch.float32) is None  # D > 128
    assert [tfa.kernel_width(d) for d in (8, 32, 40, 48, 64, 72, 128)] == [
        32, 32, 64, 64, 64, 128, 128]
    # the packed op saves its Lse only on the tiled path at a native width
    assert not tfa.uses_tiled_path(2048, 4, 48, torch.float32)
    assert tfa.uses_tiled_path(2048, 4, 64, torch.float32)


@pytest.mark.parametrize("B,H,S,D,dtype,causal", [
    (1, 2, 1152, 64, np.float32, True),
    (1, 2, 2048, 48, np.float32, False),
    (2, 3, 128, 48, np.float32, True),
    (2, 2, 160, 64, np.float16, True),
])
def test_4d_forward_and_gradients_match_the_jax_package(B, H, S, D, dtype,
                                                        causal):
    (q, k, v, do), bias = _inputs(B, H, S, D, dtype, seed=S + D)
    kw = dict(dropout_rate=0.1, is_test=True, causal=causal)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tb = torch.from_numpy(bias)
    out = tfa.fused_attention(tq, tk, tv, tb, **kw)
    assert out.dtype == tq.dtype and out.shape == (B, H, S, D)
    grads = tfa.attention_grads(tq, tk, tv, tb, tdo, **kw)
    jq, jk, jv, jdo, jb = (jnp.asarray(x) for x in (q, k, v, do, bias))
    want = jax.jit(lambda *a: jfa.fused_attention(*a, **kw))(jq, jk, jv, jb)
    jgrads = jax.jit(lambda *a: jfa.attention_grads(*a, None, **kw))(
        jq, jk, jv, jb, jdo)
    _close(out.numpy(), want, dtype, "out")
    for g, w, n in zip(grads, jgrads, ("dq", "dk", "dv", "dbias")):
        assert g.dtype == (torch.float32 if n == "dbias" else tq.dtype)
        _close(g.numpy(), w, dtype if n != "dbias" else np.float32, n)


@pytest.mark.parametrize("S,D,dtype", [(2048, 48, np.float32),
                                       (96, 48, np.float32),
                                       (128, 64, np.float16)])
def test_packed_forward_and_gradients_match_the_jax_package(S, D, dtype):
    B, H = 1, 2
    rng = np.random.RandomState(S)
    qkv = (rng.randn(B, S, 3 * H * D) * 0.5).astype(dtype)
    do = rng.randn(B, S, H * D).astype(dtype)
    bias = np.zeros((B, S), np.float32)
    kw = dict(is_test=True, causal=True)
    tq, tdo, tb = (torch.from_numpy(x) for x in (qkv, do, bias))
    out, lse = tfa.fused_attention_qkv(tq, H, tb, return_lse=True, **kw)
    assert lse is None  # saved only on the tiled path at a native width
    dqkv, dbias = tfa.fused_attention_qkv_bwd(tq, H, tb, tdo,
                                              want_dbias=True, **kw)
    jq, jdo, jb = (jnp.asarray(x) for x in (qkv, do, bias))
    want = jax.jit(lambda q_, b_: jfa.fused_attention_qkv(q_, H, b_, **kw))(
        jq, jb)
    jd, jdb = jax.jit(lambda q_, b_, d_: jfa.attention_grads_qkv(
        q_, H, b_, d_, None, **kw))(jq, jb, jdo)
    _close(out.numpy(), want, dtype, "out")
    _close(dqkv.numpy(), jd, dtype, "dqkv")
    _close(dbias.numpy(), jdb, np.float32, "dbias")


def _program(pkg, B, H, S, D):
    fluid, layers, guard = pkg
    with guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            names = ("q", "k", "v")
            qkv = [fluid.data(n, [B, H, S, D], "float32") for n in names]
            for x in qkv:
                x.stop_gradient = False
            bias = fluid.data("bias", [B, S], "float32")
            out = layers.fused_multihead_attention(*qkv, key_bias=bias,
                                                   causal=True)
            loss = layers.reduce_sum(layers.square(out))
            grads = fluid.gradients(loss, qkv)
    return main, [loss.name] + [g.name for g in grads]


def test_the_op_and_its_grad_op_match_the_jax_packages_past_the_cap():
    """fused_multihead_attention and fused_multihead_attention_grad at
    S=1152, D=48 (on the card: #7-#9 on zero-padded heads), forward loss
    and the gradients of q, k and v, against the JAX package's program."""
    B, H, S, D = 1, 2, 1152, 48
    (q, k, v, _), bias = _inputs(B, H, S, D, np.float32, seed=9)
    feed = {"q": q, "k": k, "v": v, "bias": bias}
    tmain, fetch = _program((tf, tl, tf.unique_name.guard), B, H, S, D)
    jmain, jfetch = _program((jf, jl, jun.guard), B, H, S, D)
    assert fetch == jfetch
    assert "fused_multihead_attention_grad" in [
        op.type for op in tmain.global_block.ops]
    got = tf.Executor(tf.CPUPlace()).run(tmain, feed=feed, fetch_list=fetch,
                                         scope=tf.Scope())
    want = jf.Executor(jf.CPUPlace()).run(jmain, feed=feed,
                                          fetch_list=jfetch, scope=JScope())
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5)
    for g, w, n in zip(got[1:], want[1:], fetch[1:]):
        _close(g, w, np.float32, n)
