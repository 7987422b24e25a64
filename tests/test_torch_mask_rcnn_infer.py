"""mask_rcnn_infer through the port's predictor against the JAX package's
executor: the detector at MaskRCNNConfig.tiny() on [1, 3, 64, 64] (test
mode, the port's startup state from its seed), written by the port's
io.save_inference_model, served by inference.create_paddle_predictor on
the CPU, and loaded and run by the JAX package's
io.load_inference_model and Executor (A2: every op type of the saved
program is one the JAX package registers; its op sequence is the JAX
package's own mask_rcnn_infer's, test_torch_mask_rcnn_legacy.py).

Detections [1, K, 6] are held by chip_smoke.hold_detections (counts and
labels equal, rows whose scores chain within 2e-4 compared as a set),
with the readings held tighter here, both packages on the CPU: scores
within 1e-5, box corners within 1e-5 of their row's extent. The mask
logits [K, C, 14, 14] of the kept detections (the mask head runs on the
kept boxes) are compared row by row after pairing the rows as
hold_detections pairs them, atol 1e-4 (four convolutions and a
transposed one over roi_align's features, summed in other orders).
"""

import sys
from pathlib import Path

import numpy as np

import paddle_tpu as jf
from paddle_tpu import io as jio
from paddle_tpu.framework import registry as jreg
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard

import paddle_tpu_torch as tf
from paddle_tpu_torch import inference, io
from paddle_tpu_torch.models import MaskRCNNConfig, mask_rcnn_infer

from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

HW = 64
SCORE_ATOL = 1e-5
BOX_RTOL = 1e-5
MASK_ATOL = 1e-4


def _pairing(got, want):
    """For each valid row of got, the row of want with its label whose
    box is nearest."""
    left, order = list(range(len(want))), []
    for r in got:
        same = [j for j in left if want[j, 0] == r[0]]
        j = min(same, key=lambda j: np.abs(want[j, 2:] - r[2:]).max())
        left.remove(j)
        order.append(j)
    return order


def test_the_ports_predictor_answers_as_the_jax_package(tmp_path):
    main, startup = tf.Program(), tf.Program()
    main.random_seed = startup.random_seed = 1
    with tf.unique_name.guard(), tf.program_guard(main, startup):
        image = tf.data("image", [1, 3, HW, HW])
        im_info = tf.data("im_info", [1, 3])
        out, mlogits = mask_rcnn_infer(image, im_info, MaskRCNNConfig.tiny())
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    model = str(tmp_path / "mask_rcnn")
    with tf.scope_guard(scope):
        io.save_inference_model(model, ["image", "im_info"], [out, mlogits],
                                exe, main)
    rng = np.random.RandomState(0)
    feed = {"image": rng.rand(1, 3, HW, HW).astype(np.float32),
            "im_info": np.array([[HW, HW, 1.0]], np.float32)}
    pred = inference.create_paddle_predictor(
        inference.AnalysisConfig(model, place=tf.CPUPlace()))
    got, got_m = (t.as_ndarray() for t in pred.run(
        [feed["image"], feed["im_info"]]))
    types = {op.type for op in pred.program.global_block.ops}
    assert {"generate_proposals", "collect_fpn_proposals",
            "distribute_fpn_proposals", "roi_align", "box_decoder_and_assign",
            "multiclass_nms", "conv2d_transpose", "assign_value"} <= types
    assert all(jreg.get_op_def(t) is not None for t in types)

    jscope, jexe = JScope(), jf.Executor(jf.CPUPlace())
    with jscope_guard(jscope):
        jprog, jfeeds, jfetch = jio.load_inference_model(model, jexe)
        want, want_m = (np.asarray(v) for v in jexe.run(
            jprog, feed=feed, fetch_list=jfetch))
    assert jfeeds == ["image", "im_info"]
    n = int((want[0, :, 0] >= 0).sum())
    assert n > 0 and got.shape == want.shape == (1, 64, 6)
    tied, s_err, b_err = chip_smoke.hold_detections(got, want, [n],
                                                    "port vs JAX package")
    assert s_err <= SCORE_ATOL and b_err <= BOX_RTOL, (s_err, b_err)
    order = _pairing(got[0, :n], want[0, :n])
    assert got_m.shape == want_m.shape
    np.testing.assert_allclose(got_m[:n], want_m[order], rtol=0,
                               atol=MASK_ATOL)
    print(f"{n} detections, {tied} in near-tie groups; scores {s_err:.2e}, "
          f"boxes {b_err:.2e}")
