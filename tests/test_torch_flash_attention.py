"""Port parity: paddle_tpu_torch.kernels.flash_attention (plain versions on
the CPU) against the JAX package's fused_attention_qkv and
attention_grads_qkv, both through the Pallas kernels in interpret mode
and through their jnp reference; and the port's training dropout, whose
forward and backward regenerate one Philox mask.

Inputs come from numpy with a fixed seed. Tolerance: fp32 atol 2e-5 (the
two JAX paths agree to ~6e-7; the port sums in another order); bf16 atol
1e-2 (one bf16 rounding of outputs of magnitude < 2); gradients atol
1e-4 (sums over S=128 rows of terms < 1).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu_torch as tf
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.errors import InvalidArgumentError
from paddle_tpu_torch.framework.registry import EmitContext
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import prng_mask

B, S = 2, 128
RATE = 0.1


def _inputs(H, D, seed=0):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, S, 3 * H * D).astype(np.float32)
    bias = np.zeros((B, S), np.float32)
    bias[1, 100:] = -1e4  # padded keys of the second sample
    return qkv, bias


def _port(qkv, bias, H, **kw):
    return tfa.fused_attention_qkv(
        torch.from_numpy(qkv), H, torch.from_numpy(bias), **kw
    ).numpy()


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,D", [(4, 32), (4, 64)])
def test_plain_matches_pallas_interpret_and_reference(H, D, causal, impl):
    qkv, bias = _inputs(H, D)
    kw = dict(dropout_rate=RATE, is_test=True, dropout_implementation=impl,
              causal=causal)
    port = _port(qkv, bias, H, **kw)
    interp = np.asarray(jfa.fused_attention_qkv(
        jnp.asarray(qkv), H, jnp.asarray(bias), interpret=True, **kw
    ))
    ref = np.asarray(jfa.fused_attention_qkv(
        jnp.asarray(qkv), H, jnp.asarray(bias), force_reference=True, **kw
    ))
    assert port.shape == (B, S, H * D)
    np.testing.assert_allclose(port, interp, rtol=0, atol=2e-5)
    np.testing.assert_allclose(port, ref, rtol=0, atol=2e-5)


def test_downgrade_in_infer_scales_by_keep_prob():
    """fluid test-mode dropout: downgrade_in_infer is exactly (1-p) times
    upscale_in_train — a port treating it as identity is off by 10%."""
    qkv, bias = _inputs(4, 32, seed=1)
    down = _port(qkv, bias, 4, dropout_rate=RATE, is_test=True,
                 dropout_implementation="downgrade_in_infer")
    up = _port(qkv, bias, 4, dropout_rate=RATE, is_test=True,
               dropout_implementation="upscale_in_train")
    np.testing.assert_allclose(down, up * (1 - RATE), rtol=0, atol=1e-6)


def test_no_bias_and_rate_zero_match_reference():
    qkv, _ = _inputs(4, 32, seed=2)
    port = tfa.fused_attention_qkv(torch.from_numpy(qkv), 4).numpy()
    ref = np.asarray(jfa.fused_attention_qkv(
        jnp.asarray(qkv), 4, force_reference=True
    ))
    np.testing.assert_allclose(port, ref, rtol=0, atol=2e-5)


def test_bf16_plain_matches_reference():
    qkv, bias = _inputs(4, 64, seed=3)
    q16 = torch.from_numpy(qkv).bfloat16()
    port = tfa.fused_attention_qkv(
        q16, 4, torch.from_numpy(bias), dropout_rate=RATE, is_test=True,
    )
    assert port.dtype == torch.bfloat16
    ref = jfa.fused_attention_qkv(
        jnp.asarray(qkv).astype(jnp.bfloat16), 4, jnp.asarray(bias),
        dropout_rate=RATE, is_test=True, force_reference=True,
    )
    np.testing.assert_allclose(
        port.float().numpy(), np.asarray(ref.astype(jnp.float32)),
        rtol=0, atol=1e-2,
    )


def test_meta_tensor_gives_output_shape():
    qkv = torch.empty(12289, 16, 3 * 4 * 32, device="meta")
    out = tfa.fused_attention_qkv(qkv, 4)
    assert out.device.type == "meta" and tuple(out.shape) == (12289, 16, 128)


def test_rejects_a_width_that_is_not_three_heads():
    with pytest.raises(InvalidArgumentError):
        tfa.fused_attention_qkv(torch.zeros(1, 8, 100), 4)


def test_training_dropout_raises_on_every_device():
    """Training dropout without the op's seed words raises on every device
    (a mask unrelated to the forward's would give wrong gradients); shape
    inference of a training program (meta tensors) still gets its output
    shape."""
    qkv, bias = _inputs(4, 32, seed=4)
    with pytest.raises(InvalidArgumentError):
        _port(qkv, bias, 4, dropout_rate=RATE, is_test=False)
    with pytest.raises(InvalidArgumentError):
        tfa.fused_attention_qkv_bwd(
            torch.from_numpy(qkv), 4, None, torch.zeros(B, S, 128),
            dropout_rate=RATE, is_test=False)
    meta = torch.empty(B, S, 3 * 4 * 32, device="meta")
    out = tfa.fused_attention_qkv(meta, 4, dropout_rate=RATE, is_test=False)
    assert tuple(out.shape) == (B, S, 128)


def _d_out(H, D, seed=5):
    return np.random.RandomState(seed).randn(B, S, H * D).astype(np.float32)


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_pallas_interpret_and_reference(causal, rate):
    """dqkv and dbias of the plain backward against the JAX package's
    backward kernel in interpret mode and its jnp reference, at rate 0
    and in test mode with rate 0.25."""
    H, D = 4, 32
    qkv, bias = _inputs(H, D, seed=6)
    do = _d_out(H, D)
    kw = dict(dropout_rate=rate, is_test=True, causal=causal)
    dqkv, dbias = tfa.fused_attention_qkv_bwd(
        torch.from_numpy(qkv), H, torch.from_numpy(bias),
        torch.from_numpy(do), want_dbias=True, **kw)
    statics = dict(scale=1 / np.sqrt(D), rate=rate, is_test=True,
                   upscale=False, causal=causal)
    jdqkv, jdbias = jfa._pallas_bwd_qkv(
        jnp.asarray(qkv), jnp.asarray(bias), jnp.zeros(2, jnp.uint32),
        jnp.asarray(do), H, D, statics, True)
    rdqkv, rdbias = jfa.attention_grads_qkv(
        jnp.asarray(qkv), H, jnp.asarray(bias), jnp.asarray(do), None,
        force_reference=True, **kw)
    for want_q, want_b in ((jdqkv, jdbias), (rdqkv, rdbias)):
        np.testing.assert_allclose(dqkv.numpy(), np.asarray(want_q), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(dbias.numpy(), np.asarray(want_b),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_training_backward_is_the_gradient_of_the_training_forward(impl):
    """With dropout in training, the plain backward equals autograd's
    gradient of the plain forward under the same seed words: both
    regenerate one mask. dv of a query row is zero exactly where the
    forward dropped that row's probabilities."""
    H, D, seed = 4, 32, (11, 22)
    qkv, bias = _inputs(H, D, seed=7)
    kw = dict(dropout_rate=0.25, is_test=False, dropout_implementation=impl,
              seed=seed)
    q = torch.from_numpy(qkv).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    do = torch.from_numpy(_d_out(H, D))
    out = tfa.fused_attention_qkv(q, H, bt, **kw)
    want_q, want_b = torch.autograd.grad(out, (q, bt), do)
    dqkv, dbias = tfa.fused_attention_qkv_bwd(
        q.detach(), H, bt.detach(), do, want_dbias=True, **kw)
    torch.testing.assert_close(dqkv, want_q, rtol=0, atol=1e-4)
    torch.testing.assert_close(dbias, want_b, rtol=0, atol=1e-4)

    # one query row of one head carries a gradient: dv = keep * p * dO
    row, head = 37, 2
    one = torch.zeros(B, S, H * D)
    one[:, row, head * D:(head + 1) * D] = 1.0
    dqkv1, _ = tfa.fused_attention_qkv_bwd(q.detach(), H, bt.detach(), one,
                                           **kw)
    dv = dqkv1[..., 2 * H * D + head * D:2 * H * D + (head + 1) * D]
    keep = prng_mask.keep_mask(seed, 0.25, S, S, lead=(B, H))[0, head, row]
    zero = (dv[0] == 0).all(-1)  # sample 0: no padded key (p > 0 for all)
    assert torch.equal(zero, ~keep) and 0 < keep.float().mean() < 1


def test_autograd_function_matches_the_grad_op():
    """FlashQKV's gradients equal the fused_qkv_attention_grad op's outputs
    in a training program with dropout, under the op's seed words."""
    H, D = 4, 32
    qkv, bias = _inputs(H, D, seed=8)
    w = _d_out(H, D, seed=9)
    main, startup = tf.Program(), tf.Program()
    main.random_seed = 5
    with tf.unique_name.guard(), tf.program_guard(main, startup):
        xq = tf.data("qkv", [B, S, 3 * H * D], "float32")
        xb = tf.data("bias", [B, S], "float32")
        xw = tf.data("w", [B, S, H * D], "float32")
        xq.stop_gradient = xb.stop_gradient = False
        out = tl.fused_qkv_attention(xq, H, key_bias=xb, dropout_prob=0.25)
        loss = tl.reduce_sum(tl.elementwise_mul(out, xw))
        gq, gb = tf.gradients(loss, [xq, xb])
    attn = next(op for op in main.global_block.ops
                if op.type == "fused_qkv_attention")
    assert any(op.type == "fused_qkv_attention_grad"
               for op in main.global_block.ops)
    got = tf.Executor(tf.CPUPlace()).run(
        main, feed={"qkv": qkv, "bias": bias, "w": w},
        fetch_list=[out, gq, gb], scope=tf.Scope())
    words = EmitContext("cpu", seed=5, step=0).seed_words(attn.uid, attn.type)
    q = torch.from_numpy(qkv).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    o = tfa.flash_qkv(q, H, bt, dropout_rate=0.25, is_test=False, seed=words)
    dq, db = torch.autograd.grad(o, (q, bt), torch.from_numpy(w))
    np.testing.assert_array_equal(o.detach().numpy(), got[0])
    np.testing.assert_allclose(dq.numpy(), got[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(db.numpy(), got[2], rtol=0, atol=1e-6)
