"""Port parity: paddle_tpu_torch.kernels.fused_residual (plain versions on
the CPU) against the JAX package's fused_dropout_add_ln_fwd and
fused_dropout_add_ln_bwd in Pallas interpret mode and its jnp
reference_fwd, at R=16, N=128; and the port's training dropout, whose
forward and backward regenerate one Philox mask.

Inputs come from numpy with a fixed seed. Tolerance: fp32 atol 1e-5
(normalised outputs of magnitude < 10; the sums run in another order);
dg and dc, sums over 16 rows, atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu_torch as tf
from paddle_tpu.kernels import fused_residual as jfr
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.errors import InvalidArgumentError
from paddle_tpu_torch.framework.registry import EmitContext
from paddle_tpu_torch.kernels import fused_residual as tfr
from paddle_tpu_torch.kernels import prng_mask
from paddle_tpu_torch.kernels import sum_partials as tsp

R, N = 16, 128
EPS = 1e-5


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(R, N).astype(np.float32)
    y = rng.randn(R, N).astype(np.float32) * 2.0 + 0.5
    g = (1.0 + 0.1 * rng.randn(N)).astype(np.float32)
    c = (0.1 * rng.randn(N)).astype(np.float32)
    return x, y, g, c


@pytest.mark.parametrize("upscale", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_matches_pallas_interpret_and_reference(rate, upscale):
    x, y, g, c = _inputs()
    port = tfr.fused_dropout_add_ln_fwd(
        *(torch.from_numpy(a) for a in (x, y, g, c)),
        rate=rate, is_test=True, upscale=upscale, eps=EPS,
    ).numpy()
    jx, jy, jg, jc = (jnp.asarray(a) for a in (x, y, g, c))
    interp = np.asarray(jfr.fused_dropout_add_ln_fwd(
        jx, jy, jg, jc, jnp.zeros(2, jnp.uint32), rate, True, upscale, EPS,
        interpret=True,
    ))
    ref = np.asarray(jfr.reference_fwd(
        jx, jy, jg, jc, None, rate, True, upscale, EPS
    ))
    np.testing.assert_allclose(port, interp, rtol=0, atol=1e-5)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-5)


def test_downgrade_in_infer_scales_the_branch():
    """Test-mode downgrade_in_infer feeds LN with x + 0.9*y, not x + y."""
    x, y, g, c = _inputs(seed=1)
    t = [torch.from_numpy(a) for a in (x, y, g, c)]
    down = tfr.fused_dropout_add_ln_fwd(*t, rate=0.1, is_test=True)
    scaled = tfr.fused_dropout_add_ln_fwd(t[0], t[1] * 0.9, t[2], t[3])
    np.testing.assert_allclose(down.numpy(), scaled.numpy(), rtol=0, atol=1e-6)


def test_no_affine_matches_reference():
    x, y, _, _ = _inputs(seed=2)
    port = tfr.fused_dropout_add_ln_fwd(torch.from_numpy(x), torch.from_numpy(y))
    ref = jfr.reference_fwd(jnp.asarray(x), jnp.asarray(y), None, None, None,
                            0.0, True, False, EPS)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_meta_tensor_gives_output_shape():
    x = torch.empty(12289 * 16, N, device="meta")
    out = tfr.fused_dropout_add_ln_fwd(x, x)
    assert out.device.type == "meta" and tuple(out.shape) == (12289 * 16, N)


def test_training_dropout_raises_on_every_device():
    """Training dropout without the op's seed words raises on every device
    (a mask unrelated to the forward's would give wrong gradients); shape
    inference of a training program (meta tensors) still gets its output
    shape."""
    x, y, g, c = (torch.from_numpy(a) for a in _inputs(seed=3))
    with pytest.raises(InvalidArgumentError):
        tfr.fused_dropout_add_ln_fwd(x, y, g, c, rate=0.1, is_test=False)
    with pytest.raises(InvalidArgumentError):
        tfr.fused_dropout_add_ln_bwd(x, y, g, x, rate=0.1, is_test=False)
    meta = torch.empty(R, N, device="meta")
    out = tfr.fused_dropout_add_ln_fwd(meta, meta, rate=0.1, is_test=False)
    assert tuple(out.shape) == (R, N)


def _d_out(seed=4):
    return np.random.RandomState(seed).randn(R, N).astype(np.float32)


@pytest.mark.parametrize("upscale", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_backward_matches_pallas_interpret(rate, upscale):
    x, y, g, c = _inputs(seed=5)
    do = _d_out()
    got = tfr.fused_dropout_add_ln_bwd(
        *(torch.from_numpy(a) for a in (x, y, g, do)), rate=rate,
        is_test=True, upscale=upscale, eps=EPS)
    want = jfr.fused_dropout_add_ln_bwd(
        *(jnp.asarray(a) for a in (x, y, g)), jnp.zeros(2, jnp.uint32),
        jnp.asarray(do), rate, True, upscale, EPS, interpret=True)
    for name, a, b, atol in zip(("dx", "dy", "dg", "dc"), got, want,
                                (1e-5, 1e-5, 1e-4, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("upscale", [False, True])
def test_training_backward_is_the_gradient_of_the_training_forward(upscale):
    """With dropout in training, the plain backward equals autograd's
    gradient of the plain forward under the same seed words, and dy is
    zero exactly where the forward dropped y."""
    seed = (5, 6)
    x, y, g, c = (torch.from_numpy(a).requires_grad_()
                  for a in _inputs(seed=6))
    do = torch.from_numpy(_d_out())
    kw = dict(rate=0.3, is_test=False, upscale=upscale, eps=EPS, seed=seed)
    out = tfr.fused_dropout_add_ln_fwd(x, y, g, c, **kw)
    want = torch.autograd.grad(out, (x, y, g, c), do)
    got = tfr.fused_dropout_add_ln_bwd(x.detach(), y.detach(), g.detach(),
                                       do, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    keep = prng_mask.keep_mask(seed, 0.3, R, N)
    assert torch.equal(got[1] == 0, ~keep) and 0.5 < keep.float().mean() < 0.9
    # the forward ignores a dropped y entirely
    y2 = torch.where(keep, y.detach(), torch.full_like(y, 1e3))
    torch.testing.assert_close(
        tfr.fused_dropout_add_ln_fwd(x.detach(), y2, g.detach(), c.detach(),
                                     **kw), out.detach(), rtol=0, atol=0)


def test_autograd_function_matches_the_grad_op():
    """FusedDropoutAddLn's gradients equal the fused_dropout_add_ln_grad
    op's outputs in a training program with dropout, under the op's seed
    words."""
    x, y, _, _ = _inputs(seed=7)
    w = _d_out(seed=8)
    main, startup = tf.Program(), tf.Program()
    main.random_seed = startup.random_seed = 9
    with tf.unique_name.guard(), tf.program_guard(main, startup):
        vx = tf.data("x", [R, N], "float32")
        vy = tf.data("y", [R, N], "float32")
        vw = tf.data("w", [R, N], "float32")
        vx.stop_gradient = vy.stop_gradient = False
        out = tl.fused_dropout_add_ln(vx, vy, dropout_prob=0.3)
        loss = tl.reduce_sum(tl.elementwise_mul(out, vw))
        pg = tf.append_backward(
            loss, parameter_list=[vx, vy] + main.all_parameters())
    op = next(o for o in main.global_block.ops
              if o.type == "fused_dropout_add_ln")
    assert [p.name for p, _ in pg] == op.input_names()
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    exe.run(startup, scope=scope)
    gam, bet = (scope.find_var(n).clone() for n in op.input_names()[2:])
    fetch = [out] + [grad for _, grad in pg]
    got = exe.run(main, feed={"x": x, "y": y, "w": w}, fetch_list=fetch,
                  scope=scope)
    words = EmitContext("cpu", seed=9, step=0).seed_words(op.uid, op.type)
    tx, ty = (torch.from_numpy(a).requires_grad_() for a in (x, y))
    gam.requires_grad_()
    bet.requires_grad_()
    o = tfr.fused_dropout_add_ln(tx, ty, gam, bet, rate=0.3, is_test=False,
                                 seed=words)
    want = torch.autograd.grad(o, (tx, ty, gam, bet), torch.from_numpy(w))
    np.testing.assert_array_equal(o.detach().numpy(), got[0])
    for a, b in zip(want, got[1:]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)


def test_sum_partials_plain_version():
    part = torch.from_numpy(
        np.random.RandomState(0).randn(2, 7, 33).astype(np.float32))
    np.testing.assert_allclose(tsp.sum_partials(part).numpy(),
                               part.numpy().sum(1), rtol=0, atol=1e-6)


# the card tests' TOL["residual_bwd"] for fp32 (sums in another order)
BWD_ATOL = 5e-5


@pytest.mark.parametrize("R", [1, 15, 16, 17, 300, 1000, 8192, 16384,
                               16385, 100000])
def test_backward_row_groups_are_a_function_of_the_rows(R):
    """The backward kernel's row groups (one partial row each) depend on
    R alone: the same for every N and call, every row in exactly one
    group, at most BWD_GROUPS groups of at least BWD_MIN_ROWS rows (R
    permitting), the last one ragged."""
    groups, rows = tfr.bwd_groups(R)
    assert all(tfr.bwd_groups(R) == (groups, rows) for _ in range(3))
    assert (groups - 1) * rows < R <= groups * rows
    assert groups <= tsp.BWD_GROUPS and rows >= tsp.BWD_MIN_ROWS
    assert tfr.bwd_groups(16384) == (512, 32)


def _kernel_order_sums(do, zhat, R, warps=4):
    """dg = sum_rows do * zhat and dc = sum_rows do in fp32 in the card's
    fixed order: each group of bwd_groups(R) rows by its warps (warp w
    takes rows w, w + warps, ... of the group, each a chain of fused
    multiply-adds), the warps added in order into the group's partial;
    then sum_partials over the G groups: YS slices (the fewest powers of
    two up to 32 that leave at most 16 groups a slice) of ceil(G / YS)
    groups, each summed in order, the slices' sums added in order."""
    groups, rows = tfr.bwd_groups(R)
    N = do.shape[1]
    part = torch.zeros(2, groups, N)
    for gi in range(groups):
        r0, r1 = gi * rows, min(gi * rows + rows, R)
        for w in range(warps):
            dg, dc = torch.zeros(N), torch.zeros(N)
            for r in range(r0 + w, r1, warps):
                dg = torch.addcmul(dg, do[r], zhat[r])
                dc = dc + do[r]
            part[0, gi] += dg
            part[1, gi] += dc
    ys = 1
    while ys < 32 and ys * 16 < groups:
        ys *= 2
    width = -(-groups // ys)
    out = torch.zeros(2, N)
    for y in range(ys):
        acc = torch.zeros(2, N)
        for gi in range(y * width, min(y * width + width, groups)):
            acc = acc + part[:, gi]
        out = out + acc
    return out[0], out[1]


@pytest.mark.parametrize("R,N", [(1000, 768), (2100, 700)])
def test_backward_sums_over_the_kernels_groups_hold_its_tolerance(R, N):
    """dg and dc summed over the kernel's row groups in its fixed order
    (R not a multiple of a group's rows: 63 and 132 groups, in 4 and 16
    slices of sum_partials) against the plain backward's within the card
    tests' residual_bwd atol, with training dropout. (The sums reach ~100
    here, where 5e-5 is ~6 fp32 units in the last place; over 16384 rows
    they reach ~400, and the card holds them to residual_sums.)"""
    rng = np.random.RandomState(R)
    x, y, do = (torch.from_numpy(rng.randn(R, N).astype(np.float32))
                for _ in range(3))
    g = torch.from_numpy((1 + 0.1 * rng.randn(N)).astype(np.float32))
    kw = dict(rate=0.1, is_test=False, upscale=True, eps=EPS,
              seed=(0x2024ABCD, 0x5EED0001))
    z, _ = tfr._z(x, y, 0.1, False, True, kw["seed"])
    mean, rstd = tfr._stats(z, EPS)
    dg, dc = _kernel_order_sums(do, (z - mean) * rstd, R)
    _, _, want_g, want_c = tfr.reference_bwd(x, y, g, do, **kw)
    np.testing.assert_allclose(dg.numpy(), want_g.numpy(), rtol=0,
                               atol=BWD_ATOL)
    np.testing.assert_allclose(dc.numpy(), want_c.numpy(), rtol=0,
                               atol=BWD_ATOL)
