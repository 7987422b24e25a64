"""Port parity for the ResNet slice's op emitters: each op built by
paddle_tpu_torch and by the JAX package in a one-op program, run on the
CPU from the same numpy inputs; every output, and for a differentiable
op the gradients of sum(out * w) with respect to every floating input
through the generic `__vjp__` grad op (append_backward).

Covered: conv2d (stride 1 and 2, 2- and 4-element paddings, SAME and
VALID, dilation, groups, a bf16 case), pool2d (max and avg, exclusive and
not, padded, global, adaptive, adaptive 1x1), batch_norm (train and test
mode, fp32 and bf16 input, NCHW and NHWC, all five outputs), relu,
reduce_mean, top_k (ties too), accuracy, pad2d (constant, reflect,
edge), space_to_depth (its (bh, bw, c) channel order against a numpy
reference as well) and momentum with and without Nesterov.

Inputs come from numpy with a fixed seed. Tolerances:
- fp32: rtol 1e-5, atol 1e-5 (single ops on values of magnitude ~1; the
  packages sum in other orders; batch norm's input gradient is a
  difference of sums over the 100 pixels of a channel);
- bf16 cases: each output within 2^-7 of the largest magnitude of the
  JAX package's array (one bf16 unit, 2^-8, each side may round a sum at
  another place); each gradient by its relative L2 error, within 2^-4
  (test_torch_amp.py's bound): a per-channel gradient is a sum of bf16
  products, which the JAX package on the CPU accumulates in bf16 and
  torch in fp32 (batch norm's dscale: the port 0.8%, the JAX package
  3.3% from the fp32 case's, 2.7% apart).
Integer outputs are equal.
"""

import numpy as np
import pytest

import paddle_tpu as jf
from paddle_tpu import layers as jl
from paddle_tpu.framework import registry as jreg
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.backward import gradients as jgradients
from paddle_tpu.framework.scope import Scope as JScope

import paddle_tpu_torch as tf
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.framework import registry as treg

from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

JAX = (jf, jl, jun, jgradients, JScope)
PORT = (tf, tl, tf.unique_name, tf.gradients, tf.Scope)
BF16_TOL = 2.0 ** -7
BF16_GRAD_L2 = 2.0 ** -4


def _inputs():
    rng = np.random.RandomState(0)
    m = rng.randn(6, 7).astype(np.float32)
    m[4, 2] = m[4, 5] = m[4].max() + 1.0  # a tie at the top of row 4
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {
        "img": f32(2, 4, 9, 9),
        "img8": f32(2, 4, 8, 8),
        "filt": f32(6, 4, 3, 3),
        "filt1": f32(6, 4, 1, 1),
        "filt4": f32(6, 4, 4, 4),
        "filtg": f32(6, 2, 3, 3),
        # batch norm: channels with nonzero means and unequal spreads
        "bx": (f32(4, 3, 5, 5) * np.array([1.0, 2.0, 0.5], np.float32)
               [None, :, None, None] + 1.5).astype(np.float32),
        "bxh": (f32(4, 5, 5, 3) * 1.5 - 0.5).astype(np.float32),
        "scale": (f32(3) * 0.5 + 1.0).astype(np.float32),
        "bias": f32(3),
        "mean": f32(3),
        "var": (np.abs(f32(3)) + 0.5).astype(np.float32),
        "m": m,
        "lbl": np.array([[3], [1], [6], [0], [2], [5]], np.int64),
        "param": f32(5, 3),
        "grad": f32(5, 3),
        "vel": f32(5, 3),
        "lr": np.array([0.1], np.float32),
    }


def _conv(w="filt", strides=(1, 1), paddings=(0, 0), dilations=(1, 1),
          groups=1, algo="EXPLICIT", cast=None):
    """conv2d of img by an input filter (the layer would create its own)."""
    attrs = {"strides": list(strides), "paddings": list(paddings),
             "dilations": list(dilations), "groups": groups,
             "padding_algorithm": algo}

    def build(L, v):
        return _op(L, "conv2d", {"Input": v["img"], "Filter": v[w]},
                   ("Output",), attrs, cast=cast)[0]
    return build


def _op(L, op_type, ins, outs, attrs, cast=None):
    """One op appended straight to the block, its output slots `outs`
    given the shapes and dtypes of the package's shape inference. With
    `cast`, every fp32 input is cast to that dtype first."""
    if cast:
        ins = {s: (L.cast(x, cast) if x.dtype == "float32" else x)
               for s, x in ins.items()}
    reg = treg if L is tl else jreg
    blk = next(iter(ins.values())).block
    in_names = {s: [x.name] for s, x in ins.items()}
    specs = reg.infer_shapes(op_type, blk, in_names, attrs)
    out_vars, out_names = [], {}
    for slot in outs:
        shape, dtype = specs[slot][0]
        var = blk.create_var(name=f"{op_type}_{slot}", shape=shape,
                             dtype=dtype)
        out_vars.append(var)
        out_names[slot] = [var.name]
    blk.append_op(op_type, in_names, out_names, attrs)
    return out_vars


def _bn(x="bx", layout="NCHW", is_test=False, cast=None):
    def build(L, v):
        return _op(
            L, "batch_norm",
            {"X": v[x], "Scale": v["scale"], "Bias": v["bias"],
             "Mean": v["mean"], "Variance": v["var"]},
            ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"),
            {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
             "data_layout": layout, "use_global_stats": False},
            cast=cast)
    return build


def _momentum(nesterov):
    def build(L, v):
        return _op(
            L, "momentum",
            {"Param": v["param"], "Grad": v["grad"], "Velocity": v["vel"],
             "LearningRate": v["lr"]},
            ("ParamOut", "VelocityOut"),
            {"mu": 0.9, "use_nesterov": nesterov})
    return build


def _accuracy(k):
    def build(L, v):
        # the port's layer and the JAX package's: top_k then accuracy
        return [L.accuracy(v["m"], v["lbl"], k=k)]
    return build


CASES = {
    "conv2d_s1_p1": _conv(paddings=[1, 1]),
    "conv2d_s2_p1": _conv(strides=[2, 2], paddings=[1, 1]),
    "conv2d_s2_pad4": _conv(strides=[2, 2], paddings=[0, 2, 1, 0]),
    "conv2d_k4_pad4_stem": _conv(w="filt4", paddings=[1, 2, 1, 2]),
    "conv2d_same_s2": _conv(strides=[2, 2], algo="SAME"),
    "conv2d_same_k4": _conv(w="filt4", algo="SAME"),
    "conv2d_valid": _conv(paddings=[3, 3], algo="VALID"),
    "conv2d_dilation": _conv(dilations=[2, 2], paddings=[2, 2]),
    "conv2d_groups": _conv(w="filtg", groups=2, paddings=[1, 1]),
    "conv2d_1x1_s2": _conv(w="filt1", strides=[2, 2]),
    "conv2d_bf16": _conv(strides=[2, 2], paddings=[1, 1], cast="bfloat16"),
    "pool2d_max_k3_s2_p1": lambda L, v: L.pool2d(
        v["img"], pool_size=3, pool_stride=2, pool_padding=1),
    "pool2d_max_k2_p0": lambda L, v: L.pool2d(v["img8"], pool_size=2,
                                              pool_stride=2),
    "pool2d_avg_exclusive_p1": lambda L, v: L.pool2d(
        v["img"], pool_size=3, pool_type="avg", pool_stride=2,
        pool_padding=1),
    "pool2d_avg_inclusive_p1": lambda L, v: L.pool2d(
        v["img"], pool_size=3, pool_type="avg", pool_stride=2,
        pool_padding=1, exclusive=False),
    "pool2d_avg_p0": lambda L, v: L.pool2d(v["img"], pool_size=[3, 2],
                                           pool_type="avg",
                                           pool_stride=[2, 1]),
    "pool2d_global_avg": lambda L, v: L.pool2d(v["img"], pool_type="avg",
                                               global_pooling=True),
    "pool2d_global_max": lambda L, v: L.pool2d(v["img"],
                                               global_pooling=True),
    "pool2d_adaptive_avg": lambda L, v: L.adaptive_pool2d(v["img8"], 2,
                                                          pool_type="avg"),
    "pool2d_adaptive_max": lambda L, v: L.adaptive_pool2d(v["img8"],
                                                          [4, 2]),
    "pool2d_adaptive_1x1": lambda L, v: L.adaptive_pool2d(v["img"], 1,
                                                          pool_type="avg"),
    "batch_norm_train": _bn(),
    "batch_norm_test": _bn(is_test=True),
    "batch_norm_train_nhwc": _bn("bxh", "NHWC"),
    "batch_norm_test_nhwc": _bn("bxh", "NHWC", is_test=True),
    "batch_norm_train_bf16": _bn(cast="bfloat16"),
    "batch_norm_test_bf16": _bn(is_test=True, cast="bfloat16"),
    "batch_norm_train_nhwc_bf16": _bn("bxh", "NHWC", cast="bfloat16"),
    "relu": lambda L, v: L.relu(v["img"]),
    "reduce_mean_all": lambda L, v: L.reduce_mean(v["img"]),
    "reduce_mean_dims_keep": lambda L, v: L.reduce_mean(
        v["img"], dim=[2, 3], keep_dim=True),
    "reduce_mean_neg_dim": lambda L, v: L.reduce_mean(v["img"], dim=-1),
    "top_k_1": lambda L, v: _op(L, "top_k", {"X": v["m"]},
                                ("Out", "Indices"), {"k": 1}),
    "top_k_3": lambda L, v: _op(L, "top_k", {"X": v["m"]},
                                ("Out", "Indices"), {"k": 3}),
    "accuracy_top1": _accuracy(1),
    "accuracy_top3": _accuracy(3),
    "pad2d_constant": lambda L, v: L.pad2d(v["img"], [1, 2, 0, 3],
                                           pad_value=0.5),
    "pad2d_reflect": lambda L, v: L.pad2d(v["img"], [2, 1, 3, 0],
                                          mode="reflect"),
    "pad2d_edge": lambda L, v: L.pad2d(v["img"], [0, 2, 1, 1], mode="edge"),
    "space_to_depth": lambda L, v: L.space_to_depth(v["img8"], 2),
    "momentum": _momentum(False),
    "momentum_nesterov": _momentum(True),
}


def _run(pkg, case, feed):
    fluid, layers, unique_name, gradients, scope_cls = pkg
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        v = {}
        for name, a in feed.items():
            v[name] = fluid.data(name, list(a.shape), str(a.dtype))
            v[name].stop_gradient = a.dtype.kind != "f"
        outs = CASES[case](layers, v)
        outs = outs if isinstance(outs, list) else [outs]
        fetch, n_grads = list(outs), 0
        out = outs[0]
        if out.dtype in ("float32", "bfloat16"):
            w = fluid.data("w", list(out.shape), "float32")
            o32 = out if out.dtype == "float32" else layers.cast(out,
                                                                 "float32")
            loss = layers.reduce_sum(layers.elementwise_mul(o32, w))
            diff = [n for n, a in feed.items() if a.dtype.kind == "f"]
            grads = [g for g in gradients(loss, [v[n] for n in diff])
                     if g is not None]
            fetch += grads
            n_grads = len(grads)
            feed = dict(feed, w=np.random.RandomState(1).randn(
                *out.shape).astype(np.float32))
    exe = fluid.Executor(fluid.CPUPlace())
    vals = exe.run(main, feed=feed, fetch_list=fetch, scope=scope_cls())
    dtypes = [f.dtype for f in fetch]
    return [np.asarray(r).astype(np.float32) if d == "bfloat16"
            else np.asarray(r) for r, d in zip(vals, dtypes)], dtypes, n_grads


def _rel_l2(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_the_jax_package_forward_and_vjp(case):
    feed = _inputs()
    want, wdt, wn = _run(JAX, case, feed)
    got, gdt, gn = _run(PORT, case, feed)
    assert len(got) == len(want) and gn == wn
    if not case.startswith(("top_k", "accuracy", "momentum")):
        assert gn >= 1  # a gradient came through __vjp__
    low = "bf16" in case
    n_outs = len(got) - gn
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if w.dtype.kind == "f":
            assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
            if low and i >= n_outs:
                assert _rel_l2(g, w) <= BF16_GRAD_L2, (i, _rel_l2(g, w))
            elif low:
                err = np.abs(g - w).max()
                assert err <= BF16_TOL * max(np.abs(w).max(), 1.0), (i, err)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                           err_msg=f"output {i}")
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w)
    # the declared dtypes agree (integers by kind: the JAX package runs
    # without 64-bit mode)
    for g, w in zip(gdt, wdt):
        assert g == w or (g.startswith("int") and w.startswith("int"))


def test_space_to_depth_orders_channels_bh_bw_c():
    """out[:, (bh * bs + bw) * C + c, i, j] = x[:, c, i * bs + bh, j * bs +
    bw]: not F.pixel_unshuffle's (c, bh, bw)."""
    x = _inputs()["img8"]
    got, _, _ = _run(PORT, "space_to_depth", {"img8": x})
    n, c, h, w = x.shape
    want = np.empty((n, 4 * c, h // 2, w // 2), np.float32)
    for bh in range(2):
        for bw in range(2):
            for ch in range(c):
                want[:, (bh * 2 + bw) * c + ch] = x[:, ch, bh::2, bw::2]
    np.testing.assert_array_equal(got[0], want)


def test_batch_norm_running_statistics_use_the_biased_variance():
    """MeanOut = 0.9 mean + 0.1 E[x], VarianceOut = 0.9 var + 0.1 of the
    biased batch variance (F.batch_norm would take the unbiased one)."""
    feed = _inputs()
    got, _, _ = _run(PORT, "batch_norm_train", feed)
    x = feed["bx"].astype(np.float64)
    bm = x.mean(axis=(0, 2, 3))
    bv = x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(got[1], 0.9 * feed["mean"] + 0.1 * bm,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2], 0.9 * feed["var"] + 0.1 * bv,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[4], bv, rtol=1e-5, atol=1e-6)
