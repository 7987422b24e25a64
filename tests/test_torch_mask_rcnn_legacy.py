"""The Mask R-CNN slice's other programs: the legacy per-image training
graph (mask_rcnn_train, bench.py's leg under PADDLE_TPU_BATCHED_DETECTION
=0), the batched graph under bench.py's AMP, and mask_rcnn_infer.

- Port only: the batched program at B=1 gives the legacy program's six
  losses, sampled rois, labels and live count from one state and one
  jitter (the docstring of mask_rcnn: losses are normalised per image,
  so B=1 is the legacy graph; rtol 1e-6, the two programs reduce in
  other shapes), and its gradients within 1e-5 relative L2.
- Build only, both packages: the legacy program (two images unrolled),
  mask_rcnn_infer, and the batched program under mp.decorate as bench.py
  trains on an accelerator (bf16, dynamic loss scaling from 2^12) hold
  the same ops (types, inputs, outputs, attrs) and variables (names,
  shapes, dtypes) at MaskRCNNConfig.tiny(); the AMP program's casts are
  where the JAX package puts them.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.models import mask_rcnn as jm
from paddle_tpu.optimizer import Momentum as JMomentum

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.kernels.prng_mask import philox4x32_10
from paddle_tpu_torch.models import mask_rcnn as tm
from paddle_tpu_torch.ops import _helpers as th
from paddle_tpu_torch.optimizer import Momentum as TMomentum

from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

HW, N_GT = 64, 2
JAX = (jf, jun, jm, JMomentum, jmp)
PORT = (tf, tf.unique_name, tm, TMomentum, tmp)


def build_batched(pkg, b, amp=False):
    fluid, unique_name, m, momentum, mp = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with unique_name.guard(), fluid.program_guard(main, startup):
        losses, aux = m.mask_rcnn_train_batched(
            fluid.data("images", [b, 3, HW, HW]),
            fluid.data("gt_boxes", [b, N_GT, 4]),
            fluid.data("gt_classes", [b, N_GT], dtype="int32"),
            fluid.data("is_crowd", [b, N_GT], dtype="int32"),
            fluid.data("gt_segms", [b, N_GT, HW, HW]),
            fluid.data("im_info", [b, 3]), m.MaskRCNNConfig.tiny())
        opt = momentum(0.002, 0.9)
        if amp:
            opt = mp.decorate(
                opt, amp_lists=mp.AutoMixedPrecisionLists(
                    custom_white_list={"softmax", "layer_norm"}),
                use_dynamic_loss_scaling=True, init_loss_scaling=2.0 ** 12,
                dest_dtype="bfloat16")
        _, pg = opt.minimize(losses[0], startup)
    return main, startup, losses, pg


def build_legacy(pkg, n_img):
    fluid, unique_name, m, momentum, _ = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with unique_name.guard(), fluid.program_guard(main, startup):
        per = [m.mask_rcnn_train(
            fluid.data(f"image{i}", [1, 3, HW, HW]),
            fluid.data(f"gt_boxes{i}", [N_GT, 4]),
            fluid.data(f"gt_classes{i}", [N_GT], dtype="int32"),
            fluid.data(f"is_crowd{i}", [N_GT], dtype="int32"),
            fluid.data(f"gt_segms{i}", [N_GT, HW, HW]),
            fluid.data(f"im_info{i}", [1, 3]), m.MaskRCNNConfig.tiny())
            for i in range(n_img)]
        loss = per[0][0]
        for losses in per[1:]:
            loss = fluid.layers.elementwise_add(loss, losses[0])
        if n_img > 1:
            loss = fluid.layers.scale(loss, scale=1.0 / n_img)
        _, pg = momentum(0.002, 0.9).minimize(loss, startup)
    return main, startup, per[0], pg


def build_infer(pkg):
    fluid, unique_name, m, _, _ = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with unique_name.guard(), fluid.program_guard(main, startup):
        m.mask_rcnn_infer(fluid.data("image", [1, 3, HW, HW]),
                          fluid.data("im_info", [1, 3]),
                          m.MaskRCNNConfig.tiny())
    return main


def _attrs(op):
    return {k: v for k, v in op.attrs.items()
            if not k.startswith("__") and k != "fwd_attrs"}


def _same_program(jmain, tmain):
    jb, tb = jmain.global_block, tmain.global_block
    assert [op.type for op in tb.ops] == [op.type for op in jb.ops]
    for jop, top in zip(jb.ops, tb.ops):
        assert top.inputs == jop.inputs and top.outputs == jop.outputs, top
        assert _attrs(top) == _attrs(jop), top.type
    jvars = {v.name: v for v in jmain.list_vars()}
    tvars = {v.name: v for v in tmain.list_vars()}
    assert set(tvars) == set(jvars)
    for name, jv in jvars.items():
        tv = tvars[name]
        assert tuple(tv.shape or ()) == tuple(jv.shape or ()), name
        assert tv.dtype == jv.dtype or (
            "int" in tv.dtype and "int" in jv.dtype), (name, tv.dtype,
                                                        jv.dtype)
    return len(tb.ops)


def test_the_legacy_program_is_the_jax_packages():
    n = _same_program(build_legacy(JAX, 2)[0], build_legacy(PORT, 2)[0])
    assert n == 1940


def test_mask_rcnn_infer_is_the_jax_packages():
    assert _same_program(build_infer(JAX), build_infer(PORT)) == 190


def test_the_amp_program_is_the_jax_packages():
    jmain = build_batched(JAX, 2, amp=True)[0]
    tmain = build_batched(PORT, 2, amp=True)[0]
    n = _same_program(jmain, tmain)
    casts = sum(op.type == "cast" for op in tmain.global_block.ops)
    assert n == 1609 and casts == 264
    blk = tmain.global_block
    for op in blk.ops:
        if op.type == "roi_align":
            assert blk.var(op.inputs["X"][0]).dtype == "bfloat16"
            assert blk.var(op.outputs["Out"][0]).dtype == "bfloat16"


def _fixed_jitter(ctx, op, n, size, device):
    """A jitter that depends only on the op's type: both programs' ops
    of one type draw the same."""
    if ctx.abstract:
        return torch.zeros((n, size), dtype=torch.float32, device=device)
    i = torch.arange(size, dtype=torch.int64, device=device)
    b = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w0 = philox4x32_10(i, b, zero, zero, (len(op.type), 99))[0]
    return (w0.expand(n, size) >> 9).to(torch.float32) * 2.0 ** -23


def test_batched_at_one_image_is_the_legacy_program(monkeypatch):
    monkeypatch.setattr(th, "sampling_jitter", _fixed_jitter)
    rng = np.random.RandomState(0)
    boxes = rng.rand(1, N_GT, 4).astype("float32") * (HW / 2)
    boxes[..., 2:] = boxes[..., :2] + 8 + boxes[..., 2:] / 2
    feed = {"images": rng.rand(1, 3, HW, HW).astype("float32"),
            "gt_boxes": boxes,
            "gt_classes": rng.randint(1, 4, (1, N_GT)).astype("int32"),
            "is_crowd": np.zeros((1, N_GT), "int32"),
            "gt_segms": (rng.rand(1, N_GT, HW, HW) > 0.5).astype("float32"),
            "im_info": np.array([[HW, HW, 1.0]], "float32")}
    one = {"image0": feed["images"], "gt_boxes0": boxes[0],
           "gt_classes0": feed["gt_classes"][0], "is_crowd0":
           feed["is_crowd"][0], "gt_segms0": feed["gt_segms"][0],
           "im_info0": feed["im_info"]}
    exe = tf.Executor(tf.CPUPlace())
    runs = []
    for (main, startup, losses, pg), f in ((build_batched(PORT, 1), feed),
                                           (build_legacy(PORT, 1), one)):
        gpl = next(op for op in main.global_block.ops
                   if op.type == "generate_proposal_labels")
        scope = tf.Scope()
        if not runs:
            exe.run(startup, scope=scope)
            start = convert.state_to_numpy(scope)
        else:
            convert.state_from_numpy(start, scope, tf.CPUPlace(),
                                     program=main)
        fetch = ([v.name for v in losses]
                 + [gpl.outputs[s][0] for s in ("Rois", "LabelsInt32",
                                                "RoisNum")]
                 + [g.name for _, g in pg])
        runs.append(exe.run(main, feed=f, fetch_list=fetch, scope=scope))
    batched, legacy = runs
    assert len(batched) == len(legacy)
    for i in range(6):
        np.testing.assert_allclose(batched[i], legacy[i], rtol=1e-6,
                                   err_msg=f"loss {i}")
    np.testing.assert_array_equal(batched[6].reshape(-1, 4),
                                  legacy[6].reshape(-1, 4))
    np.testing.assert_array_equal(batched[7].reshape(-1),
                                  legacy[7].reshape(-1))
    assert batched[8].tolist() == legacy[8].tolist()
    assert (batched[7] > 0).any()
    for g, w in zip(batched[9:], legacy[9:]):
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 1e-5, err
