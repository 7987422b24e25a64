"""Port parity for the YOLOv3 detector's inference path: yolov3_infer
(the three heads decoded by yolo_box, merged by multiclass_nms: Out [B,
100, 6] rows (label, score, x0, y0, x1, y1) and NmsRoisNum [B]) at
YoloConfig.tiny(class_num=4) on [-1, 3, 64, 64] images with their [-1,
2] sizes, test mode (the clone io.save_inference_model writes), built by
paddle_tpu_torch and by the JAX package and run on the CPU from the JAX
package's startup state, calibrated: the moving statistics are set to
one training-mode batch's (`calibrate`), as trained ones would be (at
the initial mean 0 and variance 1 the 23 residual adds grow the
activations until exp(tw) overflows); then the port's
io.save_inference_model and inference.create_paddle_predictor at batch
buckets (1, 2, 4).

Answers are compared by `hold_detections`: counts and labels equal;
scores within SCORE_ATOL and boxes within BOX_ATOL pixels; rows whose
score lies within TIE_EPS of a neighbour's form a group that is compared
as a set (`paired_rows`), since sums in other orders may swap
two near-equal scores, and the invalid rows (label -1, score 0) are one
such group (their boxes are read through the top-k's indices among
zeros). Boxes are held relative to their row's extent (`box_error`):
with random heads exp(tw) spreads boxes over up to ~1e5 pixels.
Readings on images(2, 0) (measured, fp32 on both sides): scores 3.6e-5
apart (SCORE_ATOL 2e-4), boxes 8.5e-5 of their extent (BOX_RTOL 5e-4),
16 of the 200 valid rows in near-tie groups (TIE_EPS 2e-4, above twice
the score error, so that two rows that can swap fall in one group); the
predictor's answers within the same bounds of a direct run of its
program.
"""

import numpy as np
import pytest

import paddle_tpu as jf
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.yolov3 import YoloConfig as JYoloConfig
from paddle_tpu.models.yolov3 import yolov3_infer as jyolov3_infer

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert, inference, io
from paddle_tpu_torch.models import YoloConfig as TYoloConfig
from paddle_tpu_torch.models import yolov3_infer as tyolov3_infer

from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

HW, CLASSES = 64, 4
JAX = (jf, jun, jyolov3_infer, JYoloConfig, JScope)
PORT = (tf, tf.unique_name, tyolov3_infer, TYoloConfig, tf.Scope)
SCORE_ATOL = 2e-4
BOX_RTOL = 5e-4
TIE_EPS = 2e-4
BUCKETS = (1, 2, 4)


def build(pkg, for_test=True):
    """yolov3_infer's program (in test mode), its startup and fetches."""
    fluid, unique_name, infer, config, _ = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.data("img", [-1, 3, HW, HW])
        size = fluid.data("size", [-1, 2], "int32")
        out, num = infer(img, size, config.tiny(CLASSES))
    return (main.clone(for_test=True) if for_test else main), startup, \
        [out.name, num.name]


def images(n, seed):
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(n, 3, HW, HW).astype(np.float32),
            "size": np.tile(np.array([[HW, HW]], np.int32), (n, 1))}


def calibrate(state):
    """The state with every moving mean and variance set to the batch
    statistics of one training-mode forward pass of the port's program
    over images(4, 9)."""
    main, _, _ = build(PORT, for_test=False)
    scope = tf.Scope()
    convert.state_from_numpy(state, scope, tf.CPUPlace(), program=main)
    bns = [op for op in main.global_block.ops if op.type == "batch_norm"]
    fetch = [op.outputs[s][0] for op in bns
             for s in ("SavedMean", "SavedVariance")]
    stats = tf.Executor(tf.CPUPlace()).run(main, feed=images(4, 9),
                                           fetch_list=fetch, scope=scope)
    state = dict(state)
    for i, op in enumerate(bns):
        state[op.inputs["Mean"][0]] = stats[2 * i]
        state[op.inputs["Variance"][0]] = stats[2 * i + 1]
    return state


def box_error(got, want):
    """|got - want| of each coordinate over 1 + the largest coordinate of
    its row: a corner is the centre less half the box, so its error
    follows the box's extent, not its own size."""
    scale = 1.0 + np.abs(want[..., 2:]).max(axis=-1, keepdims=True)
    return np.abs(got[..., 2:] - want[..., 2:]) / scale


def paired_rows(got, want):
    """want's rows reordered to pair with got's: each row of got, in turn,
    takes the unpaired row of want with its label whose box is nearest
    (box_error); a row with no such partner keeps a row of another label,
    which the label check refuses."""
    left, order = list(range(len(want))), []
    for r in got:
        same = [j for j in left if want[j, 0] == r[0]] or left
        j = min(same, key=lambda j: box_error(r[None], want[j][None]).max())
        left.remove(j)
        order.append(j)
    return want[order]


def hold_detections(got, want, counts):
    """Out rows of each image against the reference's under the module's
    rule; returns the rows compared in near-tie groups (valid ones)."""
    assert got.shape == want.shape
    tied = 0
    for b in range(want.shape[0]):
        g, w, n = got[b].astype(np.float64), want[b].astype(np.float64), \
            int(counts[b])
        np.testing.assert_array_equal(g[:, 0] >= 0, np.arange(len(w)) < n)
        np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=0, atol=SCORE_ATOL)
        # groups of rows whose scores chain within TIE_EPS
        start = 0
        for i in range(1, len(w) + 1):
            if i < len(w) and abs(w[i, 1] - w[i - 1, 1]) <= TIE_EPS:
                continue
            grp_g, grp_w = g[start:i], w[start:i]
            if i - start > 1:
                grp_w = paired_rows(grp_g, grp_w)
                tied += sum(r < n for r in range(start, i))
            np.testing.assert_array_equal(grp_g[:, 0], grp_w[:, 0])
            err = box_error(grp_g, grp_w)
            assert err.max(initial=0) <= BOX_RTOL, (b, start, err.max())
            start = i
    return tied


@pytest.fixture(scope="module")
def jax_side():
    main, startup, fetch = build(JAX)
    scope, exe = JScope(), jf.Executor(jf.CPUPlace())
    exe.run(startup, scope=scope)
    state = calibrate({n: np.asarray(scope.find_var(n))
                       for n in scope.local_var_names()})
    for n, v in state.items():
        scope.set_var(n, v)
    out, num = (np.asarray(v) for v in exe.run(
        main, feed=images(2, 0), fetch_list=fetch, scope=scope))
    return dict(state=state, out=out, num=num, main=main)


def port_program(state):
    main, _, fetch = build(PORT)
    scope = tf.Scope()
    convert.state_from_numpy(state, scope, tf.CPUPlace(), program=main)
    return main, scope, fetch


def test_infer_programs_match(jax_side):
    tmain, _, _ = build(PORT)
    jops = jax_side["main"].global_block.ops
    tops = tmain.global_block.ops
    assert [op.type for op in tops] == [op.type for op in jops]
    for jop, top in zip(jops, tops):
        assert top.inputs == jop.inputs and top.outputs == jop.outputs
    types = {op.type for op in tops}
    assert {"yolo_box", "multiclass_nms", "transpose2", "concat",
            "nearest_interp", "leaky_relu"} <= types
    assert all(op.attr("is_test") for op in tops if op.type == "batch_norm")


def test_yolov3_infer_matches_the_jax_package(jax_side):
    main, scope, fetch = port_program(jax_side["state"])
    out, num = tf.Executor(tf.CPUPlace()).run(
        main, feed=images(2, 0), fetch_list=fetch, scope=scope)
    assert out.shape == (2, 100, 6) and out.dtype == np.float32
    np.testing.assert_array_equal(num.astype(np.int64), jax_side["num"])
    assert (num > 0).all()
    tied = hold_detections(out, jax_side["out"], num)
    want = jax_side["out"]
    print(f"counts {num}; score error "
          f"{np.abs(out[..., 1] - want[..., 1]).max():.1e}, box error "
          f"{box_error(out, want).max():.1e} (row for row); valid rows in "
          f"near-tie groups: {tied}")


def test_the_predictor_answers_as_a_direct_run(jax_side, tmp_path):
    """save_inference_model, then the predictor at buckets (1, 2, 4) on
    batches of 1, 2 and 3 (padded to 4): each answer equal to a direct run
    of the predictor's program on the same images, and image 0's at batch
    1 equal to the JAX package's."""
    main, scope, fetch = port_program(jax_side["state"])
    model = str(tmp_path / "yolov3")
    with tf.scope_guard(scope):
        io.save_inference_model(model, ["img", "size"],
                                [main.global_block.var(n) for n in fetch],
                                tf.Executor(tf.CPUPlace()), main)
    config = inference.AnalysisConfig(model, place=tf.CPUPlace())
    config.set_batch_buckets(list(BUCKETS))
    pred = inference.create_paddle_predictor(config)
    assert pred.get_input_names() == ["img", "size"]
    for n in (1, 2, 3):
        feed = images(n, 5)
        out, num = (t.as_ndarray() for t in pred.run(
            [feed["img"], feed["size"]]))
        assert out.shape == (n, 100, 6) and num.shape == (n,)
        d_out, d_num = pred.executor.run(
            pred.program, feed=feed, fetch_list=pred.get_output_names(),
            scope=pred.scope)
        np.testing.assert_array_equal(num, d_num)
        hold_detections(out, d_out, num)
    out, num = (t.as_ndarray() for t in pred.run(
        [images(2, 0)["img"][:1], images(2, 0)["size"][:1]]))
    np.testing.assert_array_equal(num, jax_side["num"][:1])
    hold_detections(out, jax_side["out"][:1], num)
