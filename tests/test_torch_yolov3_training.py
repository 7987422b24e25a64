"""Port parity for the YOLOv3 training slice: bench.py's bench_yolov3
program (yolov3_train: DarkNet-53, the FPN neck and three yolov3_loss
heads, Momentum(0.01, 0.9)) at its CPU size, YoloConfig.tiny(class_num=4)
on 3x64x64, B=2, 10 boxes, built and trained by paddle_tpu_torch and by
the JAX package on the CPU.

Both programs are built from a fresh unique_name state, so their variable
names match (the model names its parameters and moving statistics, the
layers the rest); the JAX package's startup state (weights, moving
statistics, velocities, learning rate) is carried across with
convert.state_from_numpy. Feeds are bench_yolov3's: uniform images,
boxes rand * 0.5 with 0.2 added to w and h, int32 labels, from
RandomState(0). One JAX run serves the file's tests (a module-scoped
fixture).

The leaky_relu kink. The forward activations of the two packages drift
apart by ~1e-4 relative through 75 convolutions summed in other orders;
where a batch-norm output near 0 lands on the other side of 0, its
leaky_relu slope is 0.02 in one package and 1 in the other, and with
B=2 and 2x2 to 32x32 maps one such element moves a layer's gradient by
percents. On bench's batch 5 of the 226560 leaky_relu inputs change
sign, on other seeds 0-3 (measured): the gradients behind the first kink
then lie up to 14% apart (relative L2), while with no sign change the
worst is 7.3e-4. Hence two tests:
- bench_yolov3's batch: the loss rtol 1e-5 (3.5e-6); the heads'
  gradients (no kink behind them) relative L2 1e-3 (1.2e-4); every
  gradient, velocity and parameter update (end - start) relative L2 2^-2
  (13.9% over seeds 0-3); the moving statistics (forward only, means and
  variances of activations that drift ~1e-4 apart) atol 1e-4 + rtol
  1e-4 (7.1e-5 on variances up to 3.6); the learning rate equal.
- the same step on the batch of seed 2, whose leaky_relu inputs keep
  their signs in both packages (the test checks it): every gradient,
  velocity and update relative L2 2e-3 (7.3e-4).
"""

import numpy as np
import pytest

import paddle_tpu as jf
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.yolov3 import YoloConfig as JYoloConfig
from paddle_tpu.models.yolov3 import yolov3_train as jyolov3_train
from paddle_tpu.optimizer import Momentum as JMomentum

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import YoloConfig as TYoloConfig
from paddle_tpu_torch.models import yolov3_train as tyolov3_train
from paddle_tpu_torch.optimizer import Momentum as TMomentum

from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

B, HW, N_GT, CLASSES = 2, 64, 10, 4
LR = 0.01
JAX = (jf, jun, jyolov3_train, JYoloConfig, JMomentum)
PORT = (tf, tf.unique_name, tyolov3_train, TYoloConfig, TMomentum)
LOSS_RTOL = 1e-5
HEAD_L2 = 1e-3
KINK_L2 = 2.0 ** -2
SAME_SIDE_L2 = 2e-3
STAT_TOL = (1e-4, 1e-4)
SAME_SIDE_SEED = 2


def build(pkg):
    fluid, unique_name, train, config, momentum = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with unique_name.guard(), fluid.program_guard(main, startup):
        image = fluid.data("image", [B, 3, HW, HW])
        gt_box = fluid.data("gt_box", [B, N_GT, 4])
        gt_label = fluid.data("gt_label", [B, N_GT], "int32")
        loss = train(image, gt_box, gt_label, config.tiny(CLASSES))
        _, pg = momentum(LR, 0.9).minimize(loss, startup)
    return main, startup, loss, pg


def feed(seed=0):
    """bench_yolov3's batch (seed 0)."""
    rng = np.random.RandomState(seed)
    boxes = rng.rand(B, N_GT, 4).astype("float32") * 0.5
    boxes[..., 2:] += 0.2
    return {"image": rng.rand(B, 3, HW, HW).astype("float32"),
            "gt_box": boxes,
            "gt_label": rng.randint(0, CLASSES, (B, N_GT)).astype("int32")}


def _state(scope):
    return {n: np.asarray(scope.find_var(n)) for n in scope.local_var_names()}


def _rel_l2(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _attrs(op):
    # dunder attrs are bookkeeping (uid, build site); __vjp__'s copy of
    # its forward op's attrs holds them too
    return {k: v for k, v in op.attrs.items()
            if not k.startswith("__") and k != "fwd_attrs"}


def _leaky_inputs(main):
    return [op.inputs["X"][0] for op in main.global_block.ops
            if op.type == "leaky_relu"]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's program and one step on each batch from its
    startup state: the states before and after it, its loss, gradients
    and leaky_relu inputs."""
    main, startup, loss, pg = build(JAX)
    scope, exe = JScope(), jf.Executor(jf.CPUPlace())
    exe.run(startup, scope=scope)
    start = _state(scope)
    fetch = [loss.name] + [g.name for _, g in pg] + _leaky_inputs(main)
    runs = {}
    for seed in (0, SAME_SIDE_SEED):
        scope = JScope()
        for n, v in start.items():
            scope.set_var(n, v)
        fetched = [np.asarray(v) for v in exe.run(
            main, feed=feed(seed), fetch_list=fetch, scope=scope)]
        runs[seed] = dict(end=_state(scope), fetched=fetched)
    return dict(start=start, runs=runs, main=main,
                pg=[(p.name, g.name) for p, g in pg])


def test_programs_match_in_ops_names_shapes_and_dtypes(jax_run):
    jmain = jax_run["main"]
    tmain, _, _, tpg = build(PORT)
    jb, tb = jmain.global_block, tmain.global_block
    assert [op.type for op in tb.ops] == [op.type for op in jb.ops]
    types = {op.type for op in tb.ops}
    assert {"conv2d", "batch_norm", "leaky_relu", "nearest_interp", "concat",
            "yolov3_loss", "reduce_mean", "momentum"} <= types
    for jop, top in zip(jb.ops, tb.ops):
        assert top.inputs == jop.inputs and top.outputs == jop.outputs, top
        assert _attrs(top) == _attrs(jop), top.type
    jvars = {v.name: v for v in jmain.list_vars()}
    tvars = {v.name: v for v in tmain.list_vars()}
    assert set(tvars) == set(jvars)
    for name, jv in jvars.items():
        assert tvars[name].shape == jv.shape, name
        assert tvars[name].dtype == jv.dtype or (
            "int" in tvars[name].dtype and "int" in jv.dtype), name
        assert tvars[name].persistable == jv.persistable, name
        assert tvars[name].stop_gradient == jv.stop_gradient, name
    assert [(p.name, g.name) for p, g in tpg] == jax_run["pg"]
    # 72 conv-bn-leaky units (52 in DarkNet-53, 20 in the neck) and three
    # biased head convolutions; the moving statistics are not trained
    n_bn = sum(op.type == "batch_norm" for op in tb.ops)
    n_conv = sum(op.type == "conv2d" for op in tb.ops)
    assert n_bn == 72 and n_conv == 75
    assert sum(op.type == "leaky_relu" for op in tb.ops) == n_bn
    assert len(tpg) == n_conv + 2 * n_bn + 3
    assert all(not p.name.endswith(("_bn_m", "_bn_v")) for p, _ in tpg)


def check_step(run, seed, grad_l2):
    """The port's step on batch `seed` from the JAX package's start state
    against the JAX package's. Returns (worst relative L2 of the heads'
    gradients, of every gradient, of the updates and velocities; leaky_relu
    inputs whose sign differs)."""
    start, params = run["start"], {p for p, _ in run["pg"]}
    end, want = run["runs"][seed]["end"], run["runs"][seed]["fetched"]
    grads = [g for _, g in run["pg"]]
    main, _, loss, pg = build(PORT)
    scope = tf.Scope()
    convert.state_from_numpy(start, scope, tf.CPUPlace(), program=main)
    got = tf.Executor(tf.CPUPlace()).run(
        main, feed=feed(seed), fetch_list=[loss.name] + grads
        + _leaky_inputs(main), scope=scope)
    n = 1 + len(grads)
    flips = sum(int(((g >= 0) != (w >= 0)).sum())
                for g, w in zip(got[n:], want[n:]))
    rel = float(np.abs(got[0] - want[0]).max() / np.abs(want[0]).max())
    assert np.isfinite(got[0]).all() and rel <= LOSS_RTOL, (got[0], want[0])
    worst = {"head": 0.0, "grad": 0.0, "update": 0.0, "stats": 0.0}
    for name, g, w in zip(grads, got[1:n], want[1:n]):
        r = _rel_l2(g, w)
        worst["grad"] = max(worst["grad"], r)
        assert r <= grad_l2, (name, r)
        if name.startswith("yolo_head"):
            worst["head"] = max(worst["head"], r)
            assert r <= HEAD_L2, (name, r)
    own = convert.state_to_numpy(scope)
    assert set(own) == set(end)
    moved = 0
    for name, w in end.items():
        g = own[name]
        moved += not np.array_equal(w, start[name])
        if name in params or name.endswith("_velocity_0"):
            if name in params:
                g, w = g - start[name], w - start[name]
            r = _rel_l2(g, w)
            worst["update"] = max(worst["update"], r)
            assert r <= grad_l2, (name, r)
        elif name.endswith(("_bn_m", "_bn_v")):
            worst["stats"] = max(worst["stats"], float(np.abs(g - w).max()))
            np.testing.assert_allclose(g, w, rtol=STAT_TOL[1],
                                       atol=STAT_TOL[0], err_msg=name)
        else:  # the learning rate
            np.testing.assert_array_equal(g, w, err_msg=name)
    # parameters, velocities and moving statistics all move
    assert moved == 2 * len(params) + 2 * 72
    print(f"batch {seed}: loss {rel:.1e} relative; worst relative L2: "
          f"heads' gradients {worst['head']:.1e}, gradients "
          f"{worst['grad']:.1e}, updates and velocities "
          f"{worst['update']:.1e}; moving statistics max |got - want| "
          f"{worst['stats']:.1e}; leaky_relu inputs of another sign: "
          f"{flips}")
    return flips


def test_one_momentum_step_matches_the_jax_package(jax_run):
    start = jax_run["start"]
    assert sum(n.endswith("_velocity_0") for n in start) == len(jax_run["pg"])
    assert sum(n.endswith(("_bn_m", "_bn_v")) for n in start) == 2 * 72
    check_step(jax_run, 0, KINK_L2)


def test_the_step_is_tight_where_no_leaky_relu_input_changes_sign(jax_run):
    assert check_step(jax_run, SAME_SIDE_SEED, SAME_SIDE_L2) == 0
