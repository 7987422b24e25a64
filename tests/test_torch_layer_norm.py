"""Port parity for the standalone LayerNorm (#10, #11): the plain versions
beside paddle_tpu_torch/kernels/csrc/layer_norm.cu against the JAX
package's Pallas kernels in interpret mode and its jnp reference; the
`supports` predicate; the layer_norm / layer_norm_grad ops with
FLAGS_paddle_tpu_pallas_layer_norm on; the decline to the generic
__vjp__ when a loss reads Mean or Variance; the flag itself.

Inputs come from numpy with a fixed seed; bf16 inputs are the same
rounded values on both sides. Tolerances:
- plain #10/#11 vs the JAX kernels and reference_fwd, fp32: y, mean, var
  atol + rtol 1e-5 (the JAX package's own test_layer_norm_kernel.py);
  dx, dscale, dbias atol + rtol 2e-4 (its vjp check: sums of 64 rows in
  another order). bf16: y and dx are fp32 results rounded once to bf16
  on both sides, which may land one unit apart (2^-7 of |want|), beside
  the fp32 term; the fp32 statistics and column sums as in fp32.
- the flag-on ops against the JAX package with the flag on: on the CPU
  the JAX package takes its jnp branch (its `_ln_use_pallas` asks for a
  TPU), whose variance is two-pass, while the port's plain #10/#11 use
  the kernels' one-pass E[x^2] - mean^2. Inputs of magnitude ~2 over 32
  columns: atol + rtol 1e-5 forward, 1e-4 for the gradients.
- the __vjp__ decline against layer_norm_fwd_diff's custom vjp (the
  JAX kernels in interpret mode): atol + rtol 2e-4, as above.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu import layers as jl
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.kernels import layer_norm as jlnk

import paddle_tpu_torch as tf
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.kernels import fused_residual as tfr
from paddle_tpu_torch.kernels import layer_norm as lnk
from paddle_tpu_torch.kernels import sum_partials as tsp

R, N = 64, 256
EPS = 1e-5
FLAG = "FLAGS_paddle_tpu_pallas_layer_norm"
BF16_UNIT = 2.0 ** -7


@pytest.fixture
def flag_on():
    jf.set_flags({FLAG: True})
    tf.set_flags({FLAG: True})
    try:
        yield
    finally:
        jf.set_flags({FLAG: False})
        tf.set_flags({FLAG: False})


def _data(seed, dtype, affine_dtype=np.float32):
    """(x, scale, bias, w) as numpy fp32 holding values exact in `dtype`
    (bf16 values rounded once by torch), and the torch dtypes."""
    rng = np.random.RandomState(seed)
    x = rng.randn(R, N).astype(np.float32) * 2 + 0.5
    scale = rng.rand(N).astype(np.float32) + 0.5
    bias = rng.randn(N).astype(np.float32)
    w = rng.randn(R, N).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    adt = torch.bfloat16 if affine_dtype == "bfloat16" else torch.float32
    x, w = (torch.from_numpy(a).to(tdt) for a in (x, w))
    scale, bias = (torch.from_numpy(a).to(adt) for a in (scale, bias))
    return x, scale, bias, w


def _jnp(t):
    """A torch tensor as a jnp array of the same dtype and values."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _close(got, want, atol, rtol, dtype):
    """|got - want| <= atol + rtol |want|, plus one bf16 unit for a bf16
    output."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    if dtype == torch.bfloat16:
        rtol = rtol + BF16_UNIT
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@jax.jit
def _jax_fwd(x, s, b):
    return jlnk.layer_norm_fwd(x, s, b, EPS, interpret=True)


@jax.jit
def _jax_bwd(x, s, dy):
    return jlnk.layer_norm_bwd(x, s, dy, EPS, interpret=True)


CASES = [("float32", "float32", True), ("bfloat16", "bfloat16", True),
         ("bfloat16", "float32", True), ("float32", None, False),
         ("bfloat16", None, False)]


@pytest.mark.parametrize("dtype,affine_dtype,affine", CASES)
def test_plain_forward_matches_the_jax_kernel_and_reference(dtype,
                                                            affine_dtype,
                                                            affine):
    x, s, b, _ = _data(0, dtype, affine_dtype or "float32")
    ts, tb = (s, b) if affine else (None, None)
    y, mean, var = lnk.layer_norm_fwd(x, ts, tb, EPS)
    assert y.dtype == x.dtype and mean.dtype == var.dtype == torch.float32
    assert mean.shape == var.shape == (R,)
    # the JAX kernel substitutes ones and zeros for an absent scale/bias
    js = _jnp(s) if affine else jnp.ones((N,), jnp.float32)
    jb = _jnp(b) if affine else jnp.zeros((N,), jnp.float32)
    for want in (_jax_fwd(_jnp(x), js, jb),
                 jlnk.reference_fwd(_jnp(x), _jnp(s) if affine else None,
                                    _jnp(b) if affine else None, EPS)):
        _close(y, want[0], 1e-5, 1e-5, x.dtype)
        _close(mean, want[1], 1e-5, 1e-5, torch.float32)
        _close(var, want[2], 1e-5, 1e-5, torch.float32)


@pytest.mark.parametrize("dtype,affine_dtype,affine", CASES)
def test_plain_backward_matches_the_jax_kernel_and_vjp_of_reference(
        dtype, affine_dtype, affine):
    x, s, b, w = _data(1, dtype, affine_dtype or "float32")
    ts = s if affine else None
    dx, ds, db = lnk.layer_norm_bwd(x, ts, w, EPS)
    assert dx.dtype == x.dtype and ds.dtype == db.dtype == torch.float32
    want_k = _jax_bwd(_jnp(x), _jnp(s) if affine else
                      jnp.ones((N,), jnp.float32), _jnp(w))

    def f(x_, s_, b_):
        y, _, _ = jlnk.reference_fwd(x_, s_, b_, EPS)
        return jnp.sum(y.astype(jnp.float32) * _jnp(w).astype(jnp.float32))

    # the reference in fp32 on the same values: its grads are the exact
    # function's, which the kernel's fp32 arithmetic reproduces
    gx, gs, gb = jax.grad(f, (0, 1, 2))(
        _jnp(x).astype(jnp.float32),
        _jnp(s).astype(jnp.float32) if affine else jnp.ones((N,)),
        _jnp(b).astype(jnp.float32))
    for want in (want_k, (gx, gs, gb)):
        _close(dx, want[0], 2e-4, 2e-4, x.dtype)
        _close(ds, want[1], 2e-4, 2e-4, torch.float32)
        _close(db, want[2], 2e-4, 2e-4, torch.float32)


def test_supports_matches_the_jax_predicate():
    for rows in (1, 7, 8, 12, 16, 64, 8192, 8200):
        for n in (32, 128, 200, 256, 768, 1024, 4096, 8192, 8320):
            for dt in ("float32", "bfloat16", "float16"):
                want = jlnk.supports(rows, n, jnp.dtype(dt))
                assert lnk.supports(rows, n, dt) == want, (rows, n, dt)
                assert lnk.supports(rows, n, getattr(torch, dt)) == want


@pytest.mark.parametrize("rows", [8, 1001, 8192, 16384, 65536])
def test_backward_row_groups_are_one_function_of_the_rows(rows):
    """#11 and #4 take their row groups (one block and one partial row
    each) from one function, sum_partials.bwd_groups, of R alone: every
    row in one group, the last one ragged, at most 512 groups of at least
    16 rows, the same answer on every call."""
    assert lnk.bwd_groups is tsp.bwd_groups is tfr.bwd_groups
    groups, per = tsp.bwd_groups(rows)
    assert all(tsp.bwd_groups(rows) == (groups, per) for _ in range(3))
    assert (groups - 1) * per < rows <= groups * per
    assert groups <= 512 and per >= 16


def _kernel_order_sums(dy, xhat):
    """dscale = sum_rows dy * xhat and dbias = sum_rows dy in fp32 in #11's
    fixed order: a row takes WPR warps (1 up to N = 1024, then 2, 4, 8), a
    block max(4, WPR) warps, so it holds SLOTS = max(4, WPR) / WPR rows in
    flight; slot s takes rows s, s + SLOTS, ... of each group of
    bwd_groups(R) rows (a chain of fused multiply-adds a column), the
    slots are added in order into the group's partial; then sum_partials
    over the groups: YS slices (the fewest powers of two up to 32 that
    leave at most 16 groups a slice) summed in order, then added in
    order."""
    R, N = dy.shape
    wpr = next(w for w in (1, 2, 4, 8) if N <= 1024 * w)
    slots = max(4, wpr) // wpr
    groups, per = tsp.bwd_groups(R)
    part = torch.zeros(2, groups, N)
    for gi in range(groups):
        r0, r1 = gi * per, min(gi * per + per, R)
        for slot in range(slots):
            ds, db = torch.zeros(N), torch.zeros(N)
            for r in range(r0 + slot, r1, slots):
                ds = torch.addcmul(ds, dy[r], xhat[r])
                db = db + dy[r]
            part[0, gi] += ds
            part[1, gi] += db
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


@pytest.mark.parametrize("rows,n", [(1001, 768), (300, 2048), (40, 8192)])
def test_backward_sums_in_the_kernels_order_hold_its_tolerance(rows, n):
    """dscale and dbias summed in #11's fixed order (one, two and eight
    warps a row; 63, 19 and 3 groups) against the plain backward's within
    the card's ln_sums tolerance (atol 1e-3, rtol 1e-5)."""
    rng = np.random.RandomState(rows)
    x = torch.from_numpy(rng.randn(rows, n).astype(np.float32) * 2 + 0.5)
    dy = torch.from_numpy(rng.randn(rows, n).astype(np.float32))
    mean = x.mean(1, keepdim=True)
    var = torch.clamp(x.square().mean(1, keepdim=True) - mean.square(),
                      min=0.0)
    ds, db = _kernel_order_sums(dy, (x - mean) * torch.rsqrt(var + EPS))
    _, want_s, want_b = lnk.reference_bwd(x, None, dy, EPS)
    np.testing.assert_allclose(ds.numpy(), want_s.numpy(), atol=1e-3,
                               rtol=1e-5)
    np.testing.assert_allclose(db.numpy(), want_b.numpy(), atol=1e-3,
                               rtol=1e-5)


def test_wrappers_on_meta_tensors_give_shapes_and_dtypes():
    x = torch.empty((16, 256), dtype=torch.bfloat16, device="meta")
    y, mean, var = lnk.layer_norm_fwd(x, None, None, EPS)
    assert (y.shape, y.dtype) == ((16, 256), torch.bfloat16)
    assert (mean.shape, mean.dtype) == ((16,), torch.float32)
    assert (var.shape, var.dtype) == ((16,), torch.float32)
    dx, ds, db = lnk.layer_norm_bwd(x, None, x, EPS)
    assert (dx.shape, dx.dtype) == ((16, 256), torch.bfloat16)
    assert (ds.shape, db.dtype) == ((256,), torch.float32)


def _ln_program(pkg, B, S, H, stats_loss=False):
    """x [B, S, H] -> layer_norm over the last axis (GPT's `_ln`) -> loss
    sum(y * w) (+ sum(Mean * wm) + sum(Variance * wv) with stats_loss);
    grads of x, scale and bias."""
    fluid, layers, unique_name = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [B, S, H], "float32")
        x.stop_gradient = False
        w = fluid.data("w", [B, S, H], "float32")
        y = layers.layer_norm(x, begin_norm_axis=2,
                              param_attr=fluid.ParamAttr(name="ln_s"),
                              bias_attr=fluid.ParamAttr(name="ln_b"))
        loss = layers.reduce_sum(layers.elementwise_mul(y, w))
        if stats_loss:
            op = main.global_block.ops[-3]
            assert op.type == "layer_norm"
            mean = main.global_block.var(op.outputs["Mean"][0])
            var = main.global_block.var(op.outputs["Variance"][0])
            wm = fluid.data("wm", [B, S], "float32")
            wv = fluid.data("wv", [B, S], "float32")
            loss = layers.elementwise_add(
                loss, layers.elementwise_add(
                    layers.reduce_sum(layers.elementwise_mul(mean, wm)),
                    layers.reduce_sum(layers.elementwise_mul(var, wv))))
        params = [main.global_block.var(n) for n in ("ln_s", "ln_b")]
        grads = fluid.gradients(loss, [x] + params)
    return main, startup, [y] + grads


def _feed(B, S, H, seed=5):
    rng = np.random.RandomState(seed)
    return {"x": (rng.randn(B, S, H) * 2 + 0.5).astype(np.float32),
            "w": rng.randn(B, S, H).astype(np.float32),
            "wm": rng.randn(B, S).astype(np.float32),
            "wv": rng.randn(B, S).astype(np.float32)}


def _run_both(B, S, H, stats_loss=False, scale_seed=6):
    """The program in both packages from one scale/bias; returns (JAX
    results, port results, JAX program, port program)."""
    jmain, jstart, jfetch = _ln_program((jf, jl, jun), B, S, H, stats_loss)
    tmain, _, tfetch = _ln_program((tf, tl, tf.unique_name), B, S, H,
                                   stats_loss)
    rng = np.random.RandomState(scale_seed)
    s = (rng.rand(H) + 0.5).astype(np.float32)
    b = rng.randn(H).astype(np.float32)
    feed = _feed(B, S, H)
    if not stats_loss:
        feed = {k: feed[k] for k in ("x", "w")}
    jscope = JScope()
    jscope.set_var("ln_s", jnp.asarray(s))
    jscope.set_var("ln_b", jnp.asarray(b))
    want = jf.Executor(jf.CPUPlace()).run(
        jmain, feed=feed, fetch_list=[v.name for v in jfetch], scope=jscope)
    tscope = tf.Scope()
    tscope.set_var("ln_s", torch.from_numpy(s))
    tscope.set_var("ln_b", torch.from_numpy(b))
    got = tf.Executor(tf.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[v.name for v in tfetch], scope=tscope)
    return [np.asarray(w) for w in want], got, jmain, tmain


class _Spy:
    """Counts calls of a plain version the wrappers take on the CPU."""

    def __init__(self, monkeypatch, name):
        self.calls = 0
        real = getattr(lnk, name)

        def spy(*a, **k):
            self.calls += 1
            return real(*a, **k)

        monkeypatch.setattr(lnk, name, spy)


def test_flag_on_layer_norm_and_its_grad_op_match_the_jax_package(
        flag_on, monkeypatch):
    fwd, bwd = (_Spy(monkeypatch, n) for n in ("reference_fwd",
                                                "reference_bwd"))
    want, got, jmain, tmain = _run_both(2, 8, 128)
    for main in (jmain, tmain):
        ops = main.global_block.ops
        assert "layer_norm_grad" in [op.type for op in ops]
        assert not [op for op in ops if op.type == "__vjp__"
                    and op.attr("fwd_type") == "layer_norm"]
    assert (fwd.calls, bwd.calls) == (1, 1)  # the plain #10 and #11
    _close(got[0], want[0], 1e-5, 1e-5, torch.float32)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, 1e-4, 1e-4, torch.float32)


def test_program_built_with_the_flag_and_run_without_it_matches(
        flag_on, monkeypatch):
    """The JAX package reads the flag twice: its grad maker as the program
    is built, its emitters as the step is traced. With the flag off at run
    time its layer_norm_grad op takes the jnp branch; the port's takes
    the same two-pass formulas, and no kernel or plain #10/#11."""
    jmain, jstart, jfetch = _ln_program((jf, jl, jun), 2, 8, 128)
    tmain, _, tfetch = _ln_program((tf, tl, tf.unique_name), 2, 8, 128)
    jf.set_flags({FLAG: False})
    tf.set_flags({FLAG: False})
    fwd, bwd = (_Spy(monkeypatch, n) for n in ("reference_fwd",
                                                "reference_bwd"))
    feed = {k: v for k, v in _feed(2, 8, 128).items() if k in ("x", "w")}
    s = np.linspace(0.5, 1.5, 128).astype(np.float32)
    b = np.linspace(-1, 1, 128).astype(np.float32)
    jscope, tscope = JScope(), tf.Scope()
    for n, v in (("ln_s", s), ("ln_b", b)):
        jscope.set_var(n, jnp.asarray(v))
        tscope.set_var(n, torch.from_numpy(v))
    want = jf.Executor(jf.CPUPlace()).run(
        jmain, feed=feed, fetch_list=[v.name for v in jfetch], scope=jscope)
    got = tf.Executor(tf.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[v.name for v in tfetch], scope=tscope)
    assert "layer_norm_grad" in [op.type for op in tmain.global_block.ops]
    assert (fwd.calls, bwd.calls) == (0, 0)
    for g, w in zip(got, want):
        _close(g, np.asarray(w), 1e-5, 1e-5, torch.float32)


def test_loss_on_mean_and_variance_declines_to_the_generic_vjp(flag_on):
    """A loss that reads Mean and Variance: the grad maker declines, and
    the generic __vjp__ replays layer_norm through LayerNormFn under
    torch.func.vjp, whose backward adds the statistics' cotangents as the
    JAX package's `_lnd_bwd` does. Checked against jax.vjp of
    layer_norm_fwd_diff (the JAX kernels in interpret mode) with the same
    cotangents: dy = w, dmean = wm, dvar = wv."""
    B, S, H = 2, 32, 256
    want_prog, got, _, tmain = _run_both(B, S, H, stats_loss=True)
    vjps = [op for op in tmain.global_block.ops if op.type == "__vjp__"
            and op.attr("fwd_type") == "layer_norm"]
    assert len(vjps) == 1
    assert "layer_norm_grad" not in [op.type for op in tmain.global_block.ops]
    feed = _feed(B, S, H)
    rng = np.random.RandomState(6)
    s = jnp.asarray((rng.rand(H) + 0.5).astype(np.float32))
    b = jnp.asarray(rng.randn(H).astype(np.float32))
    x2 = jnp.asarray(feed["x"].reshape(B * S, H))

    def f(x_, s_, b_):
        return jlnk.layer_norm_fwd_diff(x_, s_, b_, EPS, True)

    _, pull = jax.vjp(f, x2, s, b)
    gx, gs, gb = pull((jnp.asarray(feed["w"].reshape(B * S, H)),
                       jnp.asarray(feed["wm"].reshape(-1)),
                       jnp.asarray(feed["wv"].reshape(-1))))
    for g, w in zip(got[1:], (gx.reshape(B, S, H), gs, gb)):
        _close(g, np.asarray(w), 2e-4, 2e-4, torch.float32)
    # and the JAX package's own program, whose generic vjp differentiates
    # its jnp branch
    for g, w in zip(got, want_prog):
        _close(g, w, 1e-4, 1e-4, torch.float32)


def test_layer_norm_fn_under_torch_func_vjp_matches_its_backward():
    """LayerNormFn (the counterpart of layer_norm_fwd_diff) differentiated
    by torch.func.vjp, as the generic __vjp__ does, against torch.autograd
    through the plain forward (atol + rtol 2e-4)."""
    x, s, b, w = _data(2, "float32")
    rng = np.random.RandomState(7)
    dm = torch.from_numpy(rng.randn(R).astype(np.float32))
    dv = torch.from_numpy(rng.randn(R).astype(np.float32))
    _, pull = torch.func.vjp(
        lambda x_, s_, b_: lnk.layer_norm_fwd_diff(x_, s_, b_, EPS), x, s, b)
    got = pull((w, dm, dv))
    xs = [t.clone().requires_grad_() for t in (x, s, b)]
    y, mean, var = lnk.reference_fwd(*xs, EPS)
    loss = (y * w).sum() + (mean * dm).sum() + (var * dv).sum()
    want = torch.autograd.grad(loss, xs)
    for g, wv in zip(got, want):
        _close(g, wv.numpy(), 2e-4, 2e-4, torch.float32)


def test_flag_reads_its_environment_variable_and_set_get_flags(monkeypatch):
    assert tf.get_flags(FLAG) == {FLAG: False}
    assert tf.get_flags(["paddle_tpu_pallas_layer_norm"]) == {FLAG: False}
    assert "paddle_tpu_pallas_layer_norm" in tflags.flag_docs()
    tf.set_flags({FLAG: True})
    try:
        assert tflags.flag("paddle_tpu_pallas_layer_norm") is True
    finally:
        tf.set_flags({FLAG: False})
    with pytest.raises(ValueError):
        tf.set_flags({"FLAGS_no_such_flag": 1})
    with pytest.raises(ValueError):
        tf.get_flags("no_such_flag")
    # FLAGS_<name> overrides the default as the module is imported
    monkeypatch.setenv(FLAG, "On")
    try:
        importlib.reload(tflags)
        assert tf.get_flags(FLAG) == {FLAG: True}
    finally:
        monkeypatch.delenv(FLAG)
        importlib.reload(tflags)
    assert tf.get_flags(FLAG) == {FLAG: False}
