"""Port parity for the Mask R-CNN slice's op emitters: each op built by
paddle_tpu_torch and by the JAX package in a one-op program, run on the
CPU from the same numpy inputs; every output, and for a differentiable
op the gradients of sum(out * w) with respect to the case's float inputs
through the generic `__vjp__` grad op (tf.gradients).

Covered: abs at 0 (gradient 1, jnp.abs's), log, clip with inputs on
both bounds (gradient 0.5, jnp.clip's), greater_equal, take_along_axis
with an index broadcast over three axes, conv2d_transpose (the mask
head's k2 s2, and k3 s2 p1 in 2 groups), assign_value, anchor_generator,
roi_align (rank 2 over two maps with RoisNum; batched [B, R, 4] with
dead rows; a bf16 map), generate_proposals (scores rounded to 0.05, so
many tie, over two images and one; bf16 scores and deltas),
distribute_fpn_proposals and collect_fpn_proposals in both forms (tied
scores, dead rows) and box_decoder_and_assign. Also the detection.*
counters and record_roi_stats.

Inputs come from numpy with a fixed seed. Tolerances: fp32 rtol 1e-5,
atol 1e-5 (single ops on values up to ~100, summed in other orders);
bf16 outputs are compared as the fp32 they widen to under the same
tolerance (both packages round the same fp32 results). Integer outputs,
masks and every box the ops select are compared exactly where integer,
and within the fp32 tolerance where float.
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


def _boxes(rng, n, span, min_wh, max_wh):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(min_wh, max_wh, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _anchors(H, W, A, stride):
    """Anchors [H, W, A, 4] of sizes 8-24 centred on the cells."""
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    ctr = np.stack([xs, ys], -1)[:, :, None, :] * stride + stride / 2
    half = np.array([[4, 4], [8, 5], [12, 9]], np.float32)[:A] - 0.5
    return np.concatenate([ctr - half, ctr + half], -1).astype(np.float32)


def _inputs():
    rng = np.random.RandomState(0)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    x0 = f32(2, 3, 4, 5)
    x0[0, 0, :2] = 0.0
    cl = rng.uniform(0, 1, (3, 8)).astype(np.float32)
    cl[0, :3] = 0.25
    cl[1, :3] = 0.75
    roi2 = _boxes(rng, 5, 16, 2.5, 9.5)
    roib = _boxes(rng, 8, 16, 2.5, 9.5).reshape(2, 4, 4)
    roib[1, 3] = 0.0
    dist = np.concatenate([_boxes(rng, 10, 400, 4, 300),
                           np.zeros((2, 4), np.float32)])
    lv_rois = [_boxes(rng, 10, 60, 4, 30).reshape(2, 5, 4) for _ in range(3)]
    lv_scores = [(np.round(rng.rand(2, 5, 1) * 8) / 8).astype(np.float32)
                 for _ in range(3)]
    return {
        "x": f32(2, 3, 4, 5), "y": f32(2, 3, 4, 5), "x0": x0,
        "pos": rng.uniform(0.1, 3.0, (3, 7)).astype(np.float32), "cl": cl,
        "tx": f32(2, 6, 3, 2, 2),
        "tidx": rng.randint(0, 6, (2, 4, 1, 1, 1)).astype(np.int32),
        "ct_x": f32(2, 4, 5, 5), "ct_w2": f32(4, 3, 2, 2),
        "ct_w3": f32(4, 3, 3, 3),
        "feat": f32(1, 8, 5, 6),
        "rx": f32(2, 3, 10, 12), "roi2": roi2,
        "rnum": np.array([2, 3], np.int32), "rxb": f32(2, 3, 10, 12),
        "roib": roib,
        "sc": (np.round(rng.rand(2, 3, 6, 6) * 20) / 20).astype(np.float32),
        "dl": (f32(2, 12, 6, 6) * 0.3).astype(np.float32),
        "info": np.array([[48, 44, 1.0], [40, 48, 1.0]], np.float32),
        "an": _anchors(6, 6, 3, 8),
        "var": np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32),
                       (6, 6, 3, 1)),
        "dist": dist, "distb": dist.reshape(2, 6, 4),
        **{f"lr{i}": r for i, r in enumerate(lv_rois)},
        **{f"ls{i}": s for i, s in enumerate(lv_scores)},
        "ln0": np.array([5, 3], np.int32), "ln1": np.array([2, 5], np.int32),
        "ln2": np.array([4, 0], np.int32),
        "prior": _boxes(rng, 6, 50, 5, 30),
        "pvar": np.array([0.1, 0.1, 0.2, 0.2], np.float32),
        "deltas": (f32(6, 16) * 0.5).astype(np.float32),
        "bscore": rng.rand(6, 4).astype(np.float32),
    }


def _op(L, op_type, ins, outs, attrs, cast=None):
    """One op appended straight to the block, each output slot's vars
    given the shapes and dtypes of the package's shape inference (every
    var of a multi-var slot). With `cast`, the inputs of the slots in
    cast[0] are cast to dtype cast[1] first."""
    if cast:
        ins = dict(ins, **{s: L.cast(ins[s], cast[1]) for s in cast[0]})
    reg = treg if L is tl else jreg
    blk = next(iter(ins.values()))
    blk = (blk[0] if isinstance(blk, list) else blk).block
    as_list = {s: x if isinstance(x, list) else [x] for s, x in ins.items()}
    in_names = {s: [x.name for x in xs] for s, xs in as_list.items()}
    specs = reg.infer_shapes(op_type, blk, in_names, attrs)
    out_vars, out_names = [], {}
    for slot in outs:
        names = []
        for i, (shape, dtype) in enumerate(specs[slot]):
            var = blk.create_var(name=f"{op_type}_{slot}_{i}", shape=shape,
                                 dtype=dtype)
            out_vars.append(var)
            names.append(var.name)
        out_names[slot] = names
    blk.append_op(op_type, in_names, out_names, attrs)
    return out_vars


def _gp(cast=None, one=False, **attrs):
    def build(L, v):
        ins = {"Scores": v["sc"], "BboxDeltas": v["dl"], "ImInfo": v["info"],
               "Anchors": v["an"], "Variances": v["var"]}
        if one:
            ins = {k: L.slice(x, axes=[0], starts=[1], ends=[2])
                   if k in ("Scores", "BboxDeltas", "ImInfo") else x
                   for k, x in ins.items()}
        a = dict(pre_nms_topN=40, post_nms_topN=12, nms_thresh=0.5,
                 min_size=0.0)
        a.update(attrs)
        return _op(L, "generate_proposals", ins,
                   ("RpnRois", "RpnRoiProbs", "RpnRoisNum"), a, cast=cast)
    return build


def _roi_align(rank2, cast=None):
    def build(L, v):
        a = dict(pooled_height=3, pooled_width=4, spatial_scale=0.5,
                 sampling_ratio=2)
        ins = ({"X": v["rx"], "ROIs": v["roi2"], "RoisNum": v["rnum"]}
               if rank2 else {"X": v["rxb"], "ROIs": v["roib"]})
        return _op(L, "roi_align", ins, ("Out",), a, cast=cast)
    return build


def _distribute(key):
    def build(L, v):
        multi, restore, nums = L.distribute_fpn_proposals(
            v[key], 2, 5, 4, 224)
        return list(multi) + [restore] + list(nums)
    return build


def _collect(batched):
    def build(L, v):
        if batched:
            rois = [v[f"lr{i}"] for i in range(3)]
            scores = [v[f"ls{i}"] for i in range(3)]
            nums = [v[f"ln{i}"] for i in range(3)]
        else:
            rois = [L.reshape(L.slice(v[f"lr{i}"], axes=[0], starts=[0],
                                      ends=[1]), [-1, 4]) for i in range(3)]
            scores = [L.reshape(L.slice(v[f"ls{i}"], axes=[0], starts=[0],
                                        ends=[1]), [-1, 1])
                      for i in range(3)]
            nums = [L.slice(v[f"ln{i}"], axes=[0], starts=[0], ends=[1])
                    for i in range(3)]
        return list(L.collect_fpn_proposals(rois, scores, 2, 4, 7,
                                            rois_nums=nums))
    return build


def _conv_t(w, stride, pad, groups):
    def build(L, v):
        return _op(L, "conv2d_transpose", {"Input": v["ct_x"], "Filter": v[w]},
                   ("Output",), {"strides": [stride, stride],
                                 "paddings": [pad, pad], "groups": groups})
    return build


# case -> (builder, feeds, feeds whose gradients are held)
CASES = {
    "abs_at_zero": (lambda L, v: L.abs(v["x0"]), ("x0",), ("x0",)),
    "log": (lambda L, v: L.log(v["pos"]), ("pos",), ("pos",)),
    "clip_on_both_bounds": (lambda L, v: L.clip(v["cl"], 0.25, 0.75),
                            ("cl",), ("cl",)),
    "greater_equal": (lambda L, v: L.greater_equal(v["x"], v["y"]),
                      ("x", "y"), ()),
    "take_along_axis_broadcast": (
        lambda L, v: L.take_along_axis(v["tx"], v["tidx"], axis=1),
        ("tx", "tidx"), ("tx",)),
    "conv2d_transpose_k2_s2": (_conv_t("ct_w2", 2, 0, 1), ("ct_x", "ct_w2"),
                               ("ct_x", "ct_w2")),
    "conv2d_transpose_k3_s2_p1_g2": (_conv_t("ct_w3", 2, 1, 2),
                                     ("ct_x", "ct_w3"), ("ct_x", "ct_w3")),
    "assign_value": (lambda L, v: L.assign_value([[0.1, 0.1], [0.2, 0.25]]),
                     ("x",), ()),
    "anchor_generator": (lambda L, v: list(L.anchor_generator(
        v["feat"], anchor_sizes=[32.0, 64.0], aspect_ratios=[0.5, 1.0, 2.0],
        stride=[16.0, 16.0])), ("feat",), ()),
    "roi_align_rank2_rois_num": (_roi_align(True), ("rx", "roi2", "rnum"),
                                 ("rx",)),
    "roi_align_batched": (_roi_align(False), ("rxb", "roib"), ("rxb",)),
    "roi_align_batched_bf16": (_roi_align(False, (("X",), "bfloat16")),
                               ("rxb", "roib"), ()),
    "generate_proposals_ties": (_gp(), ("sc", "dl", "info", "an", "var"), ()),
    "generate_proposals_one_image": (_gp(one=True, post_nms_topN=40),
                                     ("sc", "dl", "info", "an", "var"), ()),
    "generate_proposals_bf16": (
        _gp(cast=(("Scores", "BboxDeltas"), "bfloat16"), nms_thresh=0.7),
        ("sc", "dl", "info", "an", "var"), ()),
    "distribute_fpn_proposals": (_distribute("dist"), ("dist",), ()),
    "distribute_fpn_proposals_batched": (_distribute("distb"), ("distb",),
                                         ()),
    "collect_fpn_proposals": (_collect(False),
                              ("lr0", "lr1", "lr2", "ls0", "ls1", "ls2",
                               "ln0", "ln1", "ln2"), ()),
    "collect_fpn_proposals_batched": (_collect(True),
                                      ("lr0", "lr1", "lr2", "ls0", "ls1",
                                       "ls2", "ln0", "ln1", "ln2"), ()),
    "box_decoder_and_assign": (lambda L, v: list(L.box_decoder_and_assign(
        v["prior"], v["pvar"], v["deltas"], v["bscore"])),
        ("prior", "pvar", "deltas", "bscore"), ("prior", "deltas")),
}


def _run(pkg, case):
    fluid, layers, unique_name, gradients, scope_cls = pkg
    build, feeds, held = CASES[case]
    every = _inputs()
    feed = {k: every[k] for k in feeds}
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        v = {}
        for name, a in feed.items():
            v[name] = fluid.data(name, list(a.shape), str(a.dtype))
            v[name].stop_gradient = name not in held
        outs = build(layers, v)
        outs = outs if isinstance(outs, list) else [outs]
        fetch, names = list(outs), []
        if held:
            out = outs[0]
            w = fluid.data("w", list(out.shape), "float32")
            loss = layers.reduce_sum(layers.elementwise_mul(out, w))
            for n, g in zip(held, gradients(loss, [v[n] for n in held])):
                fetch.append(g)
                names.append(n)
            feed = dict(feed, w=np.random.RandomState(1).randn(
                *out.shape).astype(np.float32))
    exe = fluid.Executor(fluid.CPUPlace())
    vals = exe.run(main, feed=feed, fetch_list=fetch, scope=scope_cls())
    dtypes = [f.dtype for f in fetch]
    return ([np.asarray(r).astype(np.float32) if d == "bfloat16"
             else np.asarray(r) for r, d in zip(vals, dtypes)], dtypes,
            names)


@pytest.fixture(scope="module")
def jax_outputs():
    return {case: _run(JAX, case) for case in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_the_jax_package_forward_and_vjp(case, jax_outputs):
    want, wdt, wnames = jax_outputs[case]
    got, gdt, gnames = _run(PORT, case)
    assert gnames == wnames == list(CASES[case][2])
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if w.dtype.kind == "f":
            assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"output {i}")
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w,
                                          err_msg=f"output {i}")
    for g, w in zip(gdt, wdt):
        assert g == w or (g.startswith("int") and w.startswith("int")), \
            (g, w)


def test_kinks_take_the_jax_packages_gradients(jax_outputs):
    """abs at 0 has gradient 1 (w's value there), clip on either bound
    0.5, in both packages (torch.abs would give 0 and torch.clamp 1)."""
    w = np.random.RandomState(1).randn(*_inputs()["x0"].shape)
    got, _, _ = _run(PORT, "abs_at_zero")
    np.testing.assert_allclose(got[1][0, 0, :2], w[0, 0, :2], rtol=1e-6)
    got, _, _ = _run(PORT, "clip_on_both_bounds")
    w = np.random.RandomState(1).randn(3, 8)
    np.testing.assert_allclose(got[1][:2, :3], 0.5 * w[:2, :3], rtol=1e-6)


def test_the_cases_reach_their_branches(jax_outputs):
    """The inputs do what the cases claim: generate_proposals has tied
    scores among its kept rois and suppresses some boxes; distribute
    sends rois to more than one level and marks the dead ones -1;
    collect keeps its top n."""
    (rois, probs, num), _, _ = jax_outputs["generate_proposals_ties"]
    assert len(np.unique(probs[0, :num[0]])) < num[0]
    (_, _, num), _, _ = jax_outputs["generate_proposals_one_image"]
    assert num[0] < 40  # of the 40 best, some suppressed
    outs, _, _ = jax_outputs["distribute_fpn_proposals"]
    nums = [int(n[0]) for n in outs[5:]]
    assert sum(n > 0 for n in nums) >= 2 and sum(nums) == 10
    assert (outs[4][-2:] == -1).all()
    (_, num), _, _ = jax_outputs["collect_fpn_proposals_batched"]
    assert num.tolist() == [7, 7]
    (_, num), _, _ = jax_outputs["collect_fpn_proposals"]
    assert num.tolist() == [7]


def test_detection_counters_and_roi_stats():
    """An executor's first run of a program bumps detection.<op>
    .instantiations (and .batched_instantiations for the [B, ...] form)
    once; a second run of the cached program does not; record_roi_stats
    writes the padding-waste gauge, the rois-per-image histogram and its
    counter."""
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.ops.detection_stats import record_roi_stats

    every = _inputs()
    main, startup = tf.Program(), tf.Program()
    with tf.unique_name.guard(), tf.program_guard(main, startup):
        v = {n: tf.data(n, list(every[n].shape), str(every[n].dtype))
             for n in ("rxb", "roib")}
        (out,) = _roi_align(False)(tl, v)
    exe = tf.Executor(tf.CPUPlace())
    key = "detection.roi_align.batched_instantiations"
    before = observability.get_counters().get(key, 0)
    for _ in range(2):
        exe.run(main, feed={n: every[n] for n in v}, fetch_list=[out],
                scope=tf.Scope())
    c = observability.get_counters()
    assert c[key] == before + 1
    assert c["detection.roi_align.instantiations"] >= 1

    waste = record_roi_stats(np.array([4, 8]), cap=8)
    assert waste == pytest.approx(1.0 - 12 / 16)
    assert observability.get_gauges()["detection.padding_waste"] == \
        pytest.approx(waste)
    assert observability.get_histograms()[
        "detection.rois_per_image"]["count"] >= 2
    assert observability.get_counters()["detection.roi_batches_recorded"] \
        >= 1
