"""Port parity for the Mask R-CNN training slice: bench.py's mask_rcnn
program (mask_rcnn_train_batched: a ResNet-18 FPN backbone, the RPN, the
box and mask heads and the batched detection ops, Momentum(0.002, 0.9))
at its CPU config, MaskRCNNConfig.tiny() on 3x64x64, B=2, 2 boxes an
image, built and trained one step by paddle_tpu_torch and by the JAX
package on the CPU.

Both programs are built from a fresh unique_name state, so their variable
names match; the JAX package's startup state is carried across with
convert.state_from_numpy. The feed is bench_mask_rcnn's, from
RandomState(0). Sampling is pinned: the JAX program's rpn_target_assign
and generate_proposal_labels get a `seed` attr, so that each draws
jax.random.uniform under jax.random.split(jax.random.key(seed + uid), B)
(paddle_tpu/ops/_helpers.py:88 op_key), and the port's sampling_jitter is
replaced by a function giving those same draws. One JAX run serves the
file's tests (a module-scoped fixture).

Near-ties. At init the RPN head's weights are N(0, 0.01), so the anchors'
scores crowd within 1e-6 of each other, and convolutions summed in
another order can swap two of them at a top-k cut, in an NMS order or in
collect's order; a proposal's IoU can sit on fg_thresh, a roi on an FPN
level's edge, a mask grid point on a pixel's half. The step compares
only where chip_smoke.mask_rcnn_guard, run on the JAX package's values
against the port's, finds every such decision further from its threshold
than the two runs' values lie apart (scores: more than twice the largest
difference of the RPN scores; IoU, level and pixel decisions by 1e-5,
1e-5 and 1e-4). Of feed seeds 0-3, 0 and 3 hold (seed 0: the nearest
score decision 1.25e-6 from its threshold, the scores at most 4.5e-7
apart; seeds 1 and 2: a score decision 3.0e-7 from its threshold, under
twice their scores' difference).

Stages, with the worst readings over seeds 0 and 3 in parentheses: the
sampled indices (rpn_target_assign's ScoreIndex and LocationIndex), the
proposals collect keeps, the sampled rois, their labels and rois_num
equal, the rois within 1e-5 (4e-6 px); the six losses rtol 1e-5 (4e-6);
every gradient and velocity, and each parameter's update, by relative L2
1e-3 (4e-5: no relu input near 0 changes sign between the packages on
these seeds); an update's error less two fp32 spacings of its parameter
an element (a batch-norm scale near 1 moves by ~1e-6, a few spacings);
the moving statistics atol 1e-5 + rtol 1e-4.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax

import paddle_tpu as jf
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import mask_rcnn as jm
from paddle_tpu.optimizer import Momentum as JMomentum

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import mask_rcnn as tm
from paddle_tpu_torch.ops import _helpers as th
from paddle_tpu_torch.optimizer import Momentum as TMomentum

from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

B, HW, N_GT = 2, 64, 2
JAX = (jf, jun, jm, JMomentum)
PORT = (tf, tf.unique_name, tm, TMomentum)
SEEDS = {"rpn_target_assign": 11, "generate_proposal_labels": 12}
SAMPLED = (("rpn_target_assign", "ScoreIndex"),
           ("rpn_target_assign", "LocationIndex"),
           ("collect_fpn_proposals", "FpnRois"),
           ("generate_proposal_labels", "Rois"),
           ("generate_proposal_labels", "LabelsInt32"),
           ("generate_proposal_labels", "RoisNum"))
LOSS_RTOL = 1e-5
GRAD_L2 = 1e-3
ROI_ATOL = 1e-5
STAT_TOL = (1e-5, 1e-4)


def build(pkg, b=B):
    fluid, unique_name, m, momentum = pkg
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
        _, pg = momentum(0.002, 0.9).minimize(losses[0], startup)
    return main, startup, losses, pg


def feed(seed=0, b=B):
    return chip_smoke.mask_rcnn_batch(b, HW, N_GT, 4, seed)


def jax_draws(main, b=B):
    """{op type: [b, n] -> draws} of the JAX program's two sampling ops
    under their `seed` attrs, as op_key and the batched ops draw them."""
    uids = {op.type: op.uid for op in main.global_block.ops
            if op.type in SEEDS}

    def draw(op_type, n):
        keys = jax.random.split(
            jax.random.key(SEEDS[op_type] + uids[op_type]), b)
        return np.stack([np.asarray(jax.random.uniform(k, (n,)))
                         for k in keys])
    return draw


def pin_sampling(monkeypatch, draw):
    """The port's sampling_jitter gives the JAX program's draws."""
    import torch

    real = th.sampling_jitter

    def pinned(ctx, op, n, size, device):
        if ctx.abstract:
            return real(ctx, op, n, size, device)
        return torch.from_numpy(draw(op.type, size)).to(device)

    monkeypatch.setattr(th, "sampling_jitter", pinned)


def fetches(main, losses, pg):
    ops = main.global_block.ops
    sampled = [next(op for op in ops if op.type == t).outputs[s][0]
               for t, s in SAMPLED]
    guard_names, guard = chip_smoke.mask_rcnn_guard(main)
    names = ([v.name for v in losses] + sampled + [g.name for _, g in pg]
             + list(guard_names))
    return names, guard


def _state(scope):
    return {n: np.asarray(scope.find_var(n)) for n in scope.local_var_names()}


def _rel_l2(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def port_program():
    return build(PORT)


@pytest.fixture(scope="module")
def jax_run():
    main, startup, losses, pg = build(JAX)
    for op in main.global_block.ops:
        if op.type in SEEDS:
            op.attrs["seed"] = SEEDS[op.type]
    scope, exe = JScope(), jf.Executor(jf.CPUPlace())
    exe.run(startup, scope=scope)
    start = _state(scope)
    names, _ = fetches(main, losses, pg)
    fetched = [np.asarray(v) for v in exe.run(
        main, feed=feed(), fetch_list=names, scope=scope)]
    return dict(main=main, start=start, end=_state(scope),
                fetched=dict(zip(names, fetched)), draw=jax_draws(main),
                pg=[(p.name, g.name) for p, g in pg])


def _attrs(op):
    return {k: v for k, v in op.attrs.items()
            if not k.startswith("__") and k not in ("fwd_attrs", "seed")}


def test_programs_match_in_ops_names_shapes_and_dtypes(jax_run,
                                                       port_program):
    jmain = jax_run["main"]
    tmain, _, _, tpg = port_program
    jb, tb = jmain.global_block, tmain.global_block
    assert [op.type for op in tb.ops] == [op.type for op in jb.ops]
    assert len(tb.ops) == 992
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
            "int" in tv.dtype and "int" in jv.dtype), name
        assert tv.persistable == jv.persistable, name
        assert tv.stop_gradient == jv.stop_gradient, name
    assert [(p.name, g.name) for p, g in tpg] == jax_run["pg"]


def test_one_momentum_step_matches_the_jax_package(jax_run, port_program,
                                                   monkeypatch):
    pin_sampling(monkeypatch, jax_run["draw"])
    main, _, losses, pg = port_program
    names, guard = fetches(main, losses, pg)
    scope = tf.Scope()
    convert.state_from_numpy(jax_run["start"], scope, tf.CPUPlace(),
                             program=main)
    got = dict(zip(names, tf.Executor(tf.CPUPlace()).run(
        main, feed=feed(), fetch_list=names, scope=scope)))
    want = jax_run["fetched"]
    guard(want, got)
    ops = main.global_block.ops
    for t, s in SAMPLED:
        n = next(op for op in ops if op.type == t).outputs[s][0]
        if want[n].dtype.kind == "f":
            np.testing.assert_allclose(got[n], want[n], rtol=0,
                                       atol=ROI_ATOL, err_msg=n)
        else:
            np.testing.assert_array_equal(got[n].astype(want[n].dtype),
                                          want[n], err_msg=n)
    for v in losses:
        assert np.isfinite(got[v.name]).all()
        np.testing.assert_allclose(got[v.name], want[v.name],
                                   rtol=LOSS_RTOL, err_msg=v.name)
    for _, g in jax_run["pg"]:
        assert _rel_l2(got[g], want[g]) <= GRAD_L2, (g, _rel_l2(got[g],
                                                                want[g]))
    start, end = jax_run["start"], jax_run["end"]
    own = convert.state_to_numpy(scope)
    assert set(own) == set(end)
    params = {p for p, _ in jax_run["pg"]}
    for name, w in end.items():
        g = own[name]
        if name in params:
            # the error beyond two fp32 spacings of the parameter
            d = np.maximum(np.abs(g - w) - 2 * np.spacing(np.abs(w)), 0)
            assert np.linalg.norm(d) <= GRAD_L2 * np.linalg.norm(
                w - start[name]), name
        elif name.endswith("_velocity_0"):
            assert _rel_l2(g, w) <= GRAD_L2, name
        elif name.startswith(("bn_mean", "bn_variance")):
            np.testing.assert_allclose(g, w, atol=STAT_TOL[0],
                                       rtol=STAT_TOL[1], err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_the_step_samples_foreground_on_every_level_it_reads(jax_run):
    """What the step exercises: fg and bg anchors sampled in both images,
    a full RoI cap of sampled rois with fg among them, and gradients that
    reach the box head, the mask head and the RPN head of the first
    level."""
    main, f = jax_run["main"], jax_run["fetched"]
    ops = main.global_block.ops
    gpl = next(op for op in ops if op.type == "generate_proposal_labels")
    labels = f[gpl.outputs["LabelsInt32"][0]][..., 0]
    assert (labels > 0).any(axis=1).all() and (labels == 0).any()
    assert f[gpl.outputs["RoisNum"][0]].tolist() == [16, 16]
    rpn = next(op for op in ops if op.type == "rpn_target_assign")
    assert (f[rpn.outputs["LocationIndex"][0]] >= 0).any(axis=1).all()
    grads = dict(jax_run["pg"])
    for p in ("fc_w_0", "conv2d_transpose_w_0", "conv2d_w_29"):
        assert np.abs(f[grads[p]]).max() > 0, p
