"""Port parity: paddle_tpu_torch.kernels.flash_tiled (plain versions on the
CPU) against the JAX package's KV-tiled Pallas kernels
(paddle_tpu/kernels/flash_tiled.py) in interpret mode, as
tests/test_flash_tiled.py runs them, and against its jnp reference; the
tiled plain versions against the port's whole-row ones with training
dropout (one Philox mask); and the build-time rule that hands the
forward's saved Out and Lse to the grad op.

Inputs come from numpy with a fixed seed; dropout is 0 against the JAX
package (its interpreter's PRNG is a stub). Tolerances, fp32: out atol
2e-5 (the JAX kernel and reference agree to ~1e-6; the port sums in
another order); lse atol 1e-5 (a logsumexp of S <= 384 terms of magnitude
< 10); dqkv and dbias atol 1e-4 (sums over up to 384 rows of terms < 1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu_torch as tf
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels import flash_tiled as jft
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.errors import InvalidArgumentError
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import flash_tiled as tft
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

H, D = 4, 32


def _inputs(B, S, seed=0):
    rng = np.random.RandomState(seed)
    qkv = (rng.randn(B, S, 3 * H * D) * 0.5).astype(np.float32)
    bias = (rng.randn(B, S) * 0.5).astype(np.float32)
    bias[-1, S - S // 5:] = -1e4  # padded keys in the last sample
    do = rng.randn(B, S, H * D).astype(np.float32)
    return qkv, bias, do


def _statics(causal, rate=0.0, is_test=True):
    return dict(scale=1 / np.sqrt(D), rate=rate, is_test=is_test,
                upscale=False, causal=causal)


def _lse_np(qkv, bias, causal):
    """Row logsumexp [B, H, S] of the scores, in float64."""
    B, S, _ = qkv.shape
    q = qkv[..., :H * D].reshape(B, S, H, D).transpose(0, 2, 1, 3)
    k = qkv[..., H * D:2 * H * D].reshape(B, S, H, D).transpose(0, 2, 1, 3)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / np.sqrt(D)
    s = s + bias[:, None, None, :]
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -1e30)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


# B in {1, 2} with each causal setting at S = 256; the S = 384 cases are
# in test_torch_flash_tiled_s384.py (the JAX package's interpreter takes
# seconds per case, and each file stays well under 20 s)
CASES = [(1, 256, False), (2, 256, True)]


@pytest.mark.parametrize("B,S,causal", CASES)
def test_plain_tiled_matches_pallas_interpret_and_reference(B, S, causal):
    check_against_the_jax_package(B, S, causal)


def check_against_the_jax_package(B, S, causal):
    qkv, bias, do = _inputs(B, S, seed=B + S)
    st = _statics(causal)
    out, lse = tft.flash_tiled_fwd(torch.from_numpy(qkv),
                                   torch.from_numpy(bias), None, H, D, **st)
    assert out.shape == (B, S, H * D) and lse.shape == (B, H, S)
    seed = jnp.zeros((2,), jnp.uint32)
    jq, jb, jdo = jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(do)
    # jitted: the JAX package's eager dispatch takes seconds per call here
    jout, jlse = jax.jit(lambda q, b: jft.flash_tiled_fwd(
        q, b, seed, H, D, st, interpret=True))(jq, jb)
    ref = jax.jit(lambda q, b: jfa._reference_qkv(
        q, b, jax.random.key(0), H, **st))(jq, jb)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=0)
    # the JAX package repeats each head's lse over its D lanes
    jl = np.asarray(jlse).reshape(B, S, H, D)[..., 0].transpose(0, 2, 1)
    np.testing.assert_allclose(lse.numpy(), jl, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _lse_np(qkv, bias, causal),
                               atol=1e-5, rtol=0)

    dqkv, dbias = tft.flash_tiled_bwd(
        torch.from_numpy(qkv), torch.from_numpy(bias), None,
        torch.from_numpy(do), out, lse, H, D, want_dbias=True, **st)
    jdqkv, jdbias = jax.jit(lambda q, b, d, o, l: jft.flash_tiled_bwd(
        q, b, seed, d, o, l, H, D, st, interpret=True))(jq, jb, jdo, jout,
                                                         jlse)
    rdqkv, rdbias = jax.jit(lambda q, b, d: jfa.attention_grads_qkv(
        q, H, b, d, None, scale=st["scale"], causal=causal,
        force_reference=True))(jq, jb, jdo)
    for want_q, want_b in ((jdqkv, jdbias), (rdqkv, rdbias)):
        np.testing.assert_allclose(dqkv.numpy(), np.asarray(want_q),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(dbias.numpy(), np.asarray(want_b),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("upscale", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_training_dropout_draws_the_whole_row_mask(causal, upscale):
    """Dropout 0.1 in training: the tiled plain versions and the whole-row
    ones (reference_qkv, reference_qkv_bwd) under the same seed words draw
    one mask, so out, dqkv and dbias agree (atol 1e-5 and 1e-4), and the
    tiled lse ignores the mask."""
    B, S, seed = 2, 300, (0xABC, 0x123)
    qkv, bias, do = (torch.from_numpy(a) for a in _inputs(B, S, seed=7))
    st = dict(_statics(causal, rate=0.1, is_test=False), upscale=upscale)
    out, lse = tft.flash_tiled_fwd(qkv, bias, seed, H, D, **st)
    kw = dict(scale=st["scale"], dropout_rate=0.1, is_test=False,
              upscale=upscale, causal=causal, seed=seed)
    torch.testing.assert_close(out, tfa.reference_qkv(qkv, H, bias, **kw),
                               atol=1e-5, rtol=0)
    _, lse0 = tft.flash_tiled_fwd(qkv, bias, None, H, D, **_statics(causal))
    torch.testing.assert_close(lse, lse0, atol=0, rtol=0)
    dqkv, dbias = tft.flash_tiled_bwd(qkv, bias, seed, do, out, lse, H, D,
                                      want_dbias=True, **st)
    want_q, want_b = tfa.reference_qkv_bwd(qkv, H, bias, do, **kw)
    torch.testing.assert_close(dqkv, want_q, atol=1e-4, rtol=0)
    torch.testing.assert_close(dbias, want_b, atol=1e-4, rtol=0)
    # the mask changes the result: dropout really ran
    assert (out - tfa.reference_qkv(qkv, H, bias, scale=st["scale"],
                                    causal=causal)).abs().max() > 1e-2


def test_dispatch_sends_long_sequences_to_the_tiled_kernels():
    """fused_attention_qkv takes the tiled path past MAX_SEQ = 1024, by
    shape and dtype alone, and returns the lse only there; the backward
    from the saved (out, lse) equals the one that re-runs the forward."""
    assert tfa.MAX_SEQ == 1024
    assert not tfa.uses_tiled_path(1024, 12, 64, torch.float32)
    assert tfa.uses_tiled_path(1025, 12, 64, "float32")
    assert tfa.uses_tiled_path(2048, 12, 64, torch.bfloat16)
    assert not tfa.uses_tiled_path(2048, 12, 48, torch.float32)
    assert tfa.supports_packed(512, 12, 64, torch.float32)
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy((rng.randn(1, 1100, 3 * 2 * 32) * 0.5)
                           .astype(np.float32))
    do = torch.from_numpy(rng.randn(1, 1100, 64).astype(np.float32))
    out, lse = tfa.fused_attention_qkv(qkv, 2, causal=True, return_lse=True)
    assert lse.shape == (1, 2, 1100)
    short, none = tfa.fused_attention_qkv(qkv[:, :1000], 2, return_lse=True)
    assert none is None and short.shape == (1, 1000, 64)
    torch.testing.assert_close(
        out, tfa.reference_qkv(qkv, 2, scale=32 ** -0.5, causal=True),
        atol=2e-5, rtol=0)
    saved, _ = tfa.fused_attention_qkv_bwd(qkv, 2, None, do, causal=True,
                                           saved_out=out, saved_lse=lse)
    rerun, _ = tfa.fused_attention_qkv_bwd(qkv, 2, None, do, causal=True)
    torch.testing.assert_close(saved, rerun, atol=0, rtol=0)
    want, _ = tfa.reference_qkv_bwd(qkv, 2, None, do, scale=32 ** -0.5,
                                    causal=True)
    torch.testing.assert_close(saved, want, atol=1e-4, rtol=0)
    meta = torch.empty(12289, 2048, 3 * 4 * 32, device="meta")
    mo, ml = tfa.fused_attention_qkv(meta, 4, return_lse=True)
    assert tuple(mo.shape) == (12289, 2048, 128)
    assert tuple(ml.shape) == (12289, 4, 2048) and ml.dtype == torch.float32


def test_tiled_wrappers_refuse_what_they_do_not_take():
    qkv = torch.zeros(1, 16, 3 * 2 * 32)
    with pytest.raises(InvalidArgumentError):  # D does not match qkv
        tft.flash_tiled_fwd(qkv, None, None, 2, 64)
    with pytest.raises(InvalidArgumentError):  # training without seed words
        tft.flash_tiled_fwd(qkv, None, None, 2, 32, rate=0.1, is_test=False)


def _program(S, dtype="float32"):
    main, startup = tf.Program(), tf.Program()
    with tf.unique_name.guard(), tf.program_guard(main, startup):
        x = tf.data("qkv", [2, S, 3 * 4 * 32], dtype)
        x.stop_gradient = False
        out = tl.fused_qkv_attention(x, 4, causal=True, dropout_prob=0.1)
        tf.gradients(tl.reduce_sum(out), [x])
    return main


@pytest.mark.parametrize("S,tiled", [(512, False), (2048, True)])
def test_grad_op_gets_saved_out_and_lse_only_on_the_tiled_path(S, tiled):
    ops = _program(S).global_block.ops
    fwd = next(op for op in ops if op.type == "fused_qkv_attention")
    grad = next(op for op in ops if op.type == "fused_qkv_attention_grad")
    assert bool(fwd.outputs.get("Lse")) == tiled
    if tiled:
        assert grad.inputs["Out"] == fwd.outputs["Out"]
        assert grad.inputs["Lse"] == fwd.outputs["Lse"]
        lse = _program(S).global_block.var(fwd.outputs["Lse"][0])
        assert lse.shape == (2, 4, S) and lse.dtype == "float32"
    else:
        assert "Out" not in grad.inputs and "Lse" not in grad.inputs
