"""Port parity for the YOLOv3 slice's multiclass_nms: the cases of
test_torch_yolov3_ops.py's table whose names start with multiclass_nms
(tied scores, background_label 0 and -1, keep_top_k above the C * k
candidates, nms_top_k 64 and 100 over 120 boxes of three classes in
clusters), built by paddle_tpu_torch and by the JAX package in a one-op
program and run on the CPU from the same numpy inputs. Out and
NmsRoisNum are held under test_torch_yolov3_ops.py's tolerances (fp32
rtol 1e-5, atol 1e-5; the counts equal); the rows read through the
top-k's indices even where invalid, so equal rows mean equal tie order.
Also: the detection emitters run on meta tensors (no host read of a
value), and the greedy suppression against a literal sequential loop.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.framework.registry import OpView, get_op_def
from paddle_tpu_torch.ops.detection import _greedy_nms

from test_torch_yolov3_ops import CASES, JAX, _feed, _inputs, _run, check
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

NMS_CASES = sorted(c for c in CASES if c.startswith("multiclass"))


@pytest.fixture(scope="module")
def jax_outputs():
    return {case: _run(JAX, case, _feed(case)) for case in NMS_CASES}


@pytest.mark.parametrize("case", NMS_CASES)
def test_multiclass_nms_matches_the_jax_package(case, jax_outputs):
    check(case, jax_outputs[case])


def test_multiclass_nms_cases_meet_their_conditions(jax_outputs):
    """Ties among the kept scores; with keep_top_k above the C * k
    candidates the output holds all C * k rows; background 0 keeps no
    row of class 0. (nms_top_k 100 runs the JAX package's blocked
    suppression, two blocks of 64.)"""
    out, num = jax_outputs["multiclass_nms_bg_none_k64"][0]
    kept = out[0, :num[0], 1]
    assert len(np.unique(kept)) < len(kept)  # tied scores
    out, _ = jax_outputs["multiclass_nms_keep_above_candidates"][0]
    assert out.shape == (2, 3 * 64, 6)
    for case in ("multiclass_nms_bg0_k64",
                 "multiclass_nms_k100_bg0_keep_all"):
        out, num = jax_outputs[case][0]
        assert (out[..., 0] != 0).all() and (num > 0).all()
    out, _ = jax_outputs["multiclass_nms_k100_bg0_keep_all"][0]
    assert out.shape == (2, 3 * 100, 6)


def test_greedy_suppression_is_the_sequential_loop():
    """_greedy_nms over [B, C, k] boxes at k = 100 against the reference's
    loop, box by box: a box survives iff it is kept by score and overlaps
    no earlier survivor by more than the threshold."""
    v = _inputs()
    boxes = torch.from_numpy(v["boxes"][:, :100])  # [2, 100, 4]
    keep = torch.from_numpy(v["scores"][:, :, :100] > 0.2)  # [2, 3, 100]
    bx = boxes[:, None].expand(2, 3, 100, 4)
    got = _greedy_nms(bx, keep, 0.3).numpy()

    def iou(a, b):
        lt, rb = np.maximum(a[:2], b[:2]), np.minimum(a[2:], b[2:])
        inter = np.prod(np.maximum(rb - lt, 0))
        area = lambda r: np.prod(np.maximum(r[2:] - r[:2], 0))  # noqa: E731
        return inter / max(area(a) + area(b) - inter, 1e-10)

    for b in range(2):
        for c in range(3):
            alive = []
            for i in range(100):
                box = v["boxes"][b, i].astype(np.float64)
                ok = keep[b, c, i].item() and not any(
                    iou(box, v["boxes"][b, j].astype(np.float64)) > 0.3
                    for j in alive)
                if ok:
                    alive.append(i)
            assert list(np.nonzero(got[b, c])[0]) == alive, (b, c)


def test_detection_emitters_read_no_value_on_the_host():
    """yolo_box, multiclass_nms and yolov3_loss run on meta tensors, which
    hold no values: a host read (.item(), a data-dependent shape) would
    raise."""
    meta = torch.device("meta")
    runs = {
        "yolo_box": {"X": [torch.empty(2, 27, 4, 4, device=meta)],
                     "ImgSize": [torch.empty(2, 2, dtype=torch.int32,
                                             device=meta)]},
        "multiclass_nms": {"BBoxes": [torch.empty(2, 120, 4, device=meta)],
                           "Scores": [torch.empty(2, 3, 120, device=meta)]},
        "yolov3_loss": {"X": [torch.empty(2, 18, 8, 8, device=meta)],
                        "GTBox": [torch.empty(2, 6, 4, device=meta)],
                        "GTLabel": [torch.empty(2, 6, dtype=torch.int32,
                                                device=meta)]},
    }
    attrs = {
        "yolo_box": dict(anchors=[10, 13, 16, 30, 33, 23], class_num=4),
        "multiclass_nms": dict(nms_top_k=100, keep_top_k=50),
        "yolov3_loss": dict(anchors=[10, 14, 23, 27, 37, 58, 81, 82],
                            anchor_mask=[1, 2], class_num=4),
    }
    shapes = {
        "yolo_box": {"Boxes": (2, 48, 4), "Scores": (2, 48, 4)},
        "multiclass_nms": {"Out": (2, 50, 6), "NmsRoisNum": (2,)},
        "yolov3_loss": {"Loss": (2,), "ObjectnessMask": (2, 2, 8, 8),
                        "GTMatchMask": (2, 6)},
    }
    for op_type, ins in runs.items():
        outs = get_op_def(op_type).emit(None, OpView(op_type, attrs[op_type]),
                                        ins)
        got = {k: tuple(v[0].shape) for k, v in outs.items()}
        assert got == shapes[op_type], op_type
