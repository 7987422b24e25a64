"""The JAX package reads the port's YOLOv3 inference model: the
detector of test_torch_yolov3_infer.py (yolov3_infer at
YoloConfig.tiny(class_num=4), [-1, 3, 64, 64], from the port's startup
state with calibrated moving statistics), written by the port's
io.save_inference_model, loads through paddle_tpu.io.load_inference_model
and answers as the port's program does (A2: every op type in it is one
the JAX package registers), under test_torch_yolov3_infer.py's
`hold_detections`.
"""

import numpy as np

import paddle_tpu as jf
from paddle_tpu import io as jio
from paddle_tpu.framework import registry as jreg
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert, io

from test_torch_yolov3_infer import (PORT, build, calibrate,
                                     hold_detections, images)
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


def test_the_jax_package_loads_and_runs_the_ports_yolov3_model(tmp_path):
    main, startup, fetch = build(PORT)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    state = calibrate(convert.state_to_numpy(scope))
    convert.state_from_numpy(state, scope, tf.CPUPlace(), program=main)
    model = str(tmp_path / "yolov3")
    with tf.scope_guard(scope):
        written = io.save_inference_model(
            model, ["img", "size"], [main.global_block.var(n) for n in fetch],
            exe, main)
    feed = images(2, 0)
    tscope = tf.Scope()
    with tf.scope_guard(tscope):
        tprog, _, tfetch = io.load_inference_model(model, exe)
        out, num = exe.run(tprog, feed=feed, fetch_list=tfetch, scope=tscope)
    types = {op.type for op in tprog.global_block.ops}
    assert {"yolo_box", "multiclass_nms", "nearest_interp", "concat",
            "leaky_relu"} <= types
    assert all(jreg.get_op_def(t) is not None for t in types)
    jscope, jexe = JScope(), jf.Executor(jf.CPUPlace())
    with jscope_guard(jscope):
        jprog, jfeeds, jfetch = jio.load_inference_model(model, jexe)
        want, wnum = (np.asarray(v) for v in jexe.run(
            jprog, feed=feed, fetch_list=jfetch))
    assert (jfeeds, jfetch) == (["img", "size"], written)
    assert [op.type for op in jprog.global_block.ops] == [
        op.type for op in tprog.global_block.ops]
    np.testing.assert_array_equal(num.astype(np.int64), wnum)
    tied = hold_detections(out, want, num)
    print(f"counts {num}; valid rows in near-tie groups: {tied}")
