"""Port parity for the YOLOv3 slice's op emitters: each op built by
paddle_tpu_torch and by the JAX package in a one-op program, run on the
CPU from the same numpy inputs; every output, and for a differentiable
op the gradients of sum(out * w) with respect to every floating input
through the generic `__vjp__` grad op (append_backward).

Covered: leaky_relu (the default alpha 0.02 and a given one), concat
(axis 1 of three inputs, axis 0), nearest_interp (x2 by scale, a
non-integer scale, out_h/out_w down and up, out_h/out_w before scale),
yolo_box, multiclass_nms (tied scores, background_label 0 and -1,
keep_top_k above the candidates, nms_top_k 64 and 100) and yolov3_loss
(invalid boxes of width 0, two boxes in one cell with different scores,
gt_score, label smoothing off, scale_x_y 1.2, a bf16 X with an fp32
Loss): its Loss, ObjectnessMask, GTMatchMask and the gradients of X,
GTBox and GTScore.

Inputs come from numpy with a fixed seed. Tolerances:
- fp32: rtol 1e-5, atol 1e-5 (single ops on values of magnitude ~1 to
  ~100; the packages sum in other orders; the losses are sums over a few
  hundred cells);
- the bf16 yolov3_loss: both packages compute in fp32 from the same
  bf16-rounded X, so its outputs are held as fp32 (rtol 1e-5, atol
  1e-5) and X's gradient, which reaches the fed fp32 X through the
  cast's gradient, by its relative L2 error within 2^-8 (one bf16
  unit: the gradient is rounded to bf16 at the cast).
Integer outputs and masks are equal.
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
BF16_GRAD_L2 = 2.0 ** -8
ANCHORS = [10, 14, 23, 27, 37, 58, 81, 82]
ANCHOR_MASK = [1, 2]
N_GT = 6


def _gt_boxes(rng, n):
    """Normalised (cx, cy, w, h) boxes; image 0's last two are invalid
    (w = h = 0); image 1's boxes 0 and 1 share a cell and a shape, so
    both are positives of one cell (the later one's score wins)."""
    gt = rng.uniform(0.1, 0.9, (n, N_GT, 4)).astype(np.float32)
    gt[..., 2:] = rng.uniform(0.1, 0.4, (n, N_GT, 2))
    gt[0, 4:, 2:] = 0.0
    cell = np.floor(gt[1, 0, :2] * 8) / 8
    gt[1, 0, :2], gt[1, 1, :2] = cell + 0.02, cell + 0.07
    gt[1, :2, 2:] = 0.25
    return gt


def _nms_inputs(rng, b, n, c):
    """Clusters of overlapping boxes and scores rounded to 0.05, so that
    many tie, some at 0."""
    centres = rng.uniform(20, 80, (b, n // 4, 2))
    centres = np.repeat(centres, 4, axis=1) + rng.randn(b, n, 2) * 3
    half = rng.uniform(5, 15, (b, n, 2))
    boxes = np.concatenate([centres - half, centres + half], -1)
    scores = np.round(rng.rand(b, c, n) * 20) / 20
    return boxes.astype(np.float32), scores.astype(np.float32)


def _inputs():
    rng = np.random.RandomState(0)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    boxes, scores = _nms_inputs(rng, 2, 120, 3)
    return {
        "x": f32(2, 4, 9, 9),
        "a": f32(2, 3, 5, 5),
        "b": f32(2, 2, 5, 5),
        "head": (f32(2, 3 * 9, 4, 4) * 0.8).astype(np.float32),
        "img_size": np.array([[128, 96], [64, 64]], np.int32),
        "boxes": boxes,
        "scores": scores,
        "yx": (f32(2, 2 * 9, 8, 8) * 0.5).astype(np.float32),
        "gt": _gt_boxes(rng, 2),
        "lab": rng.randint(0, 4, (2, N_GT)).astype(np.int32),
        "score": rng.uniform(0.3, 1.0, (2, N_GT)).astype(np.float32),
    }


def _op(L, op_type, ins, outs, attrs, cast=None):
    """One op appended straight to the block, its output slots `outs`
    given the shapes and dtypes of the package's shape inference. With
    `cast`, the input of slot `cast[0]` is cast to dtype `cast[1]`
    first."""
    if cast:
        ins = dict(ins, **{cast[0]: L.cast(ins[cast[0]], cast[1])})
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


def _interp(**attrs):
    def build(L, v):
        return _op(L, "nearest_interp", {"X": v["x"]}, ("Out",), attrs)
    return build


def _nms(**attrs):
    def build(L, v):
        return list(L.multiclass_nms(v["boxes"], v["scores"], **attrs))
    return build


def _loss(cast=None, score=False, **attrs):
    def build(L, v):
        ins = {"X": v["yx"], "GTBox": v["gt"], "GTLabel": v["lab"]}
        if score:
            ins["GTScore"] = v["score"]
        attrs_ = dict(anchors=ANCHORS, anchor_mask=ANCHOR_MASK, class_num=4,
                      ignore_thresh=0.3, downsample_ratio=16)
        attrs_.update(attrs)
        return _op(L, "yolov3_loss", ins,
                   ("Loss", "ObjectnessMask", "GTMatchMask"), attrs_,
                   cast=cast)
    return build


CASES = {
    "leaky_relu": lambda L, v: L.leaky_relu(v["x"]),
    "leaky_relu_alpha": lambda L, v: L.leaky_relu(v["x"], alpha=0.1),
    "concat_axis1": lambda L, v: L.concat([v["a"], v["b"], v["a"]], axis=1),
    "concat_axis0": lambda L, v: L.concat([v["a"], v["a"]], axis=0),
    "nearest_interp_x2": lambda L, v: L.resize_nearest(v["x"], scale=2.0),
    "nearest_interp_scale_1_5": lambda L, v: L.resize_nearest(v["x"],
                                                              scale=1.5),
    "nearest_interp_out_down": _interp(out_h=5, out_w=7),
    "nearest_interp_out_up": _interp(out_h=13, out_w=18),
    "nearest_interp_out_over_scale": _interp(out_h=4, out_w=6, scale=2.0),
    "yolo_box": lambda L, v: list(L.yolo_box(
        v["head"], v["img_size"], anchors=[10, 13, 16, 30, 33, 23],
        class_num=4, conf_thresh=0.3, downsample_ratio=16)),
    "multiclass_nms_bg_none_k64": _nms(score_threshold=0.05, nms_top_k=64,
                                       keep_top_k=40, nms_threshold=0.3),
    "multiclass_nms_bg0_k64": _nms(score_threshold=0.05, nms_top_k=64,
                                   keep_top_k=40, nms_threshold=0.3,
                                   background_label=0),
    "multiclass_nms_k100": _nms(score_threshold=0.05, nms_top_k=100,
                                keep_top_k=60, nms_threshold=0.45),
    "multiclass_nms_k100_bg0_keep_all": _nms(
        score_threshold=0.1, nms_top_k=100, keep_top_k=1000,
        nms_threshold=0.3, background_label=0),
    "multiclass_nms_keep_above_candidates": _nms(
        score_threshold=0.0, nms_top_k=64, keep_top_k=500,
        nms_threshold=0.5),
    "yolov3_loss": _loss(),
    "yolov3_loss_gt_score": _loss(score=True),
    "yolov3_loss_no_label_smooth": _loss(use_label_smooth=False),
    "yolov3_loss_scale_xy": _loss(score=True, scale_x_y=1.2),
    "yolov3_loss_bf16": _loss(cast=("X", "bfloat16"), score=True),
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
        fetch, n_grads, names = list(outs), 0, []
        out = outs[0]
        w = fluid.data("w", list(out.shape), "float32")
        loss = layers.reduce_sum(layers.elementwise_mul(out, w))
        diff = [n for n, a in feed.items() if a.dtype.kind == "f"]
        for n, g in zip(diff, gradients(loss, [v[n] for n in diff])):
            if g is not None:
                fetch.append(g)
                names.append(n)
        n_grads = len(names)
        feed = dict(feed, w=np.random.RandomState(1).randn(
            *out.shape).astype(np.float32))
    exe = fluid.Executor(fluid.CPUPlace())
    vals = exe.run(main, feed=feed, fetch_list=fetch, scope=scope_cls())
    dtypes = [f.dtype for f in fetch]
    return ([np.asarray(r).astype(np.float32) if d == "bfloat16"
             else np.asarray(r) for r, d in zip(vals, dtypes)], dtypes,
            names)


def _rel_l2(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _feed(case):
    v = _inputs()
    keys = {
        "leaky": ("x",), "concat": ("a", "b"), "nearest": ("x",),
        "yolo_box": ("head", "img_size"), "multiclass": ("boxes", "scores"),
        "yolov3_loss": ("yx", "gt", "lab", "score"),
    }
    want = next(k for p, k in keys.items() if case.startswith(p))
    return {k: v[k] for k in want}


def check(case, run):
    """The port's run of `case` against the JAX package's `run` (both
    from _run): every output and gradient under the tolerances above."""
    want, wdt, wnames = run
    got, gdt, gnames = _run(PORT, case, _feed(case))
    assert len(got) == len(want) and gnames == wnames
    differentiable = not case.startswith(("yolo_box", "multiclass"))
    assert bool(gnames) == differentiable
    if case.startswith("yolov3_loss"):
        # X's gradient, and GTBox's; GTScore's where the op reads it
        assert gnames[:2] == ["yx", "gt"]
    n_outs = len(got) - len(gnames)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if w.dtype.kind == "f":
            assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
            if case.endswith("bf16") and i == n_outs:
                assert _rel_l2(g, w) <= BF16_GRAD_L2, (i, _rel_l2(g, w))
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                           err_msg=f"output {i}")
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w)
    for g, w in zip(gdt, wdt):
        assert g == w or (g.startswith("int") and w.startswith("int"))


# the multiclass_nms cases run in test_torch_yolov3_nms.py, so that
# parallel test workers compile the two files' JAX programs side by side
OP_CASES = sorted(c for c in CASES if not c.startswith("multiclass"))


@pytest.fixture(scope="module")
def jax_outputs():
    return {case: _run(JAX, case, _feed(case)) for case in OP_CASES}


@pytest.mark.parametrize("case", OP_CASES)
def test_op_matches_the_jax_package_forward_and_vjp(case, jax_outputs):
    check(case, jax_outputs[case])


def test_yolov3_loss_inputs_reach_every_branch(jax_outputs):
    """The shared inputs do what the cases claim: negatives ignored (-1),
    invalid boxes unmatched (-1), and image 1's first two boxes matched to
    one cell, whose objectness is the later box's score."""
    feed = _inputs()
    (loss, obj, match, *_), _, _ = jax_outputs["yolov3_loss_gt_score"]
    got, _, _ = _run(PORT, "yolov3_loss_gt_score", _feed(
        "yolov3_loss_gt_score"))
    np.testing.assert_array_equal(got[1], obj)
    assert (obj == -1).any() and (obj == 0).any()
    assert (match[0, 4:] == -1).all()
    assert match[1, 0] == match[1, 1] >= 0
    gt, m = feed["gt"][1], int(match[1, 0])
    gi, gj = (gt[:2, :2] * 8).astype(int).T
    assert gi[0] == gi[1] and gj[0] == gj[1]
    assert obj[1, m, gj[0], gi[0]] == feed["score"][1, 1]
    assert feed["score"][1, 0] != feed["score"][1, 1]


def test_bf16_x_gives_an_fp32_loss(jax_outputs):
    """yolov3_loss computes in fp32 whatever X's dtype: the bf16 case's
    Loss is declared and run as fp32 in both packages."""
    _, dtypes, _ = _run(PORT, "yolov3_loss_bf16", _feed("yolov3_loss_bf16"))
    _, jdtypes, _ = jax_outputs["yolov3_loss_bf16"]
    assert dtypes[:2] == jdtypes[:2] == ["float32", "float32"]


def test_nearest_interp_is_jax_image_resize_nearest():
    """A non-integer resize picks floor((o + 0.5) * in / out), the JAX
    package's jax.image.resize 'nearest' (F.interpolate's 'nearest-exact',
    not 'nearest')."""
    x = _inputs()["x"]
    got, _, _ = _run(PORT, "nearest_interp_out_up", {"x": x})
    rows = np.floor((np.arange(13) + 0.5) * 9 / 13).astype(int)
    cols = np.floor((np.arange(18) + 0.5) * 9 / 18).astype(int)
    np.testing.assert_array_equal(got[0], x[:, :, rows][:, :, :, cols])


def test_objectness_mask_carries_no_gradient_into_x():
    """A loss that also reads ObjectnessMask gives X the gradient of the
    Loss alone: the mask depends on X only through comparisons."""
    feed = _feed("yolov3_loss_gt_score")
    grads = []
    for with_mask in (False, True):
        main, startup = tf.Program(), tf.Program()
        with tf.unique_name.guard(), tf.program_guard(main, startup):
            v = {n: tf.data(n, list(a.shape), str(a.dtype))
                 for n, a in feed.items()}
            v["yx"].stop_gradient = False
            loss, mask, _ = _loss(score=True)(tl, v)
            total = tl.reduce_sum(loss)
            if with_mask:
                total = total + tl.reduce_sum(tl.elementwise_mul(mask, mask))
            g, = tf.gradients(total, [v["yx"]])
        grads.append(tf.Executor(tf.CPUPlace()).run(
            main, feed=feed, fetch_list=[g], scope=tf.Scope())[0])
    np.testing.assert_array_equal(grads[1], grads[0])
