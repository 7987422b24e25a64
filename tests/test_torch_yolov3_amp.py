"""Port parity for YOLOv3 under AMP: bench_yolov3's program
(YoloConfig.tiny(class_num=4) on 3x64x64, B=2, 10 boxes,
Momentum(0.01, 0.9)) decorated as bench.py's `_amp` decorates it on an
accelerator (bf16, static loss scale 1.0, softmax and layer_norm
white-listed), by paddle_tpu_torch and by the JAX package on the CPU.

- The rewrite: the same ops in the same order with the same inputs,
  outputs and attrs, so the same casts (conv2d reads bf16, the
  black-listed batch_norm and reduce_mean fp32, each head's bias add and
  yolov3_loss's X bf16, its boxes and labels untouched), and the same
  declared dtype of every variable (integers by kind: the JAX package
  runs without 64-bit mode).
- The bf16 loss: one AMP step on bench's batch and on the batch of seed
  1 from the port's startup state, carried into the JAX package, the
  loss within 2^-5 (8 bf16 units) of the JAX package's and of the port's
  fp32 program's on the same state, every op's runtime output dtype
  equal to its declaration, yolov3_loss reading a bf16 X and giving an
  fp32 Loss. The JAX package computes its loss with the rewritten
  program's forward ops alone (io.prune to the loss: the same ops on the
  same values; compiling its whole AMP step takes ~60 s on the CPU).
  Measured over seeds 0-4, in bf16 units (2^-8 relative): the port's
  bf16 loss 0.04-2.67 from the JAX package's, 0.11-2.17 from its own fp32
  loss, the JAX package's 0.21-1.98 from that fp32 loss: 75 convolutions
  with bf16 outputs, summed on the CPU in other orders and widths, leave
  each package a few units from fp32 and from the other.

Gradients are not held: the fp32 steps already lie up to 14% apart
behind the leaky_relu kink (test_torch_yolov3_training.py), and bf16's
rounding of the activations moves far more of them across it.
"""

import numpy as np

import paddle_tpu as jf
from paddle_tpu import io as jio
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.yolov3 import YoloConfig as JYoloConfig
from paddle_tpu.models.yolov3 import yolov3_train as jyolov3_train
from paddle_tpu.optimizer import Momentum as JMomentum

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.models import YoloConfig as TYoloConfig
from paddle_tpu_torch.models import yolov3_train as tyolov3_train
from paddle_tpu_torch.optimizer import Momentum as TMomentum

from test_torch_amp import DtypeWatch, _attrs, _int, bench_amp
from test_torch_yolov3_training import B, CLASSES, HW, LR, N_GT, build, feed
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

JAX = (jf, jun, jyolov3_train, JYoloConfig, JMomentum, jmp)
PORT = (tf, tf.unique_name, tyolov3_train, TYoloConfig, TMomentum, tmp)
PORT_FP32 = PORT[:5]
LOSS_RTOL = 2.0 ** -5


def build_amp(pkg):
    fluid, unique_name, train, config, momentum, mp = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with unique_name.guard(), fluid.program_guard(main, startup):
        image = fluid.data("image", [B, 3, HW, HW])
        gt_box = fluid.data("gt_box", [B, N_GT, 4])
        gt_label = fluid.data("gt_label", [B, N_GT], "int32")
        loss = train(image, gt_box, gt_label, config.tiny(CLASSES))
        opt = bench_amp(mp, momentum(LR, 0.9))
        opt.minimize(loss, startup)
    return main, startup, loss, opt


def test_rewrite_matches_the_jax_package():
    jmain, *_ = build_amp(JAX)
    tmain, *_ = build_amp(PORT)
    jops, tops = jmain.global_block.ops, tmain.global_block.ops
    assert [op.type for op in tops] == [op.type for op in jops]
    for jop, top in zip(jops, tops):
        assert top.inputs == jop.inputs and top.outputs == jop.outputs, top
        assert _attrs(top) == _attrs(jop), top.type
        if top.type == "__vjp__":
            assert top.attr("fwd_type") == jop.attr("fwd_type")
    jvars = {v.name: v.dtype for v in jmain.list_vars()}
    tvars = {v.name: v.dtype for v in tmain.list_vars()}
    assert set(tvars) == set(jvars)
    for name, jd in jvars.items():
        td = tvars[name]
        assert td == jd or (_int(td) and _int(jd)), (name, td, jd)
    blk = tmain.global_block

    def dtype(op, slot):
        return blk.var(op.inputs[slot][0]).dtype

    n_conv = sum(op.type == "conv2d" for op in tops)
    assert n_conv == 75
    for op in tops:
        if op.type == "conv2d":
            assert {dtype(op, s) for s in ("Input", "Filter")} == {
                "bfloat16"}
        elif op.type == "batch_norm":
            assert dtype(op, "X") == "float32"
            assert blk.var(op.outputs["Y"][0]).dtype == "float32"
        elif op.type == "yolov3_loss":
            assert dtype(op, "X") == "bfloat16"
            assert (dtype(op, "GTBox"), dtype(op, "GTLabel")) == (
                "float32", "int32")
            assert blk.var(op.outputs["Loss"][0]).dtype == "float32"
    for p in tmain.all_parameters():  # fp32 masters, the int32 counter
        assert p.dtype in ("float32", "int32"), (p.name, p.dtype)


def test_amp_loss_matches_the_jax_package(monkeypatch):
    jmain, _, jloss, _ = build_amp(JAX)
    jforward = jio.prune(jmain, [jloss])
    tmain, tstartup, tloss, topt = build_amp(PORT)
    fmain, _, floss, _ = build(PORT_FP32)
    texe, jexe = tf.Executor(tf.CPUPlace()), jf.Executor(jf.CPUPlace())
    scope = tf.Scope()
    texe.run(tstartup, scope=scope)
    start = convert.state_to_numpy(scope)
    fp32 = {}
    for seed in (0, 1):  # the port's fp32 program, before the watch
        fs = tf.Scope()
        convert.state_from_numpy(start, fs, tf.CPUPlace(), program=fmain)
        fp32[seed], = texe.run(fmain, feed=feed(seed),
                               fetch_list=[floss.name], scope=fs)
    watch = DtypeWatch(monkeypatch, tmain.global_block)
    for seed in (0, 1):
        # each batch as a first step from the start state
        js = JScope()
        for n, v in start.items():
            js.set_var(n, v)
        want, = jexe.run(jforward, feed=feed(seed),
                         fetch_list=[jloss.name], scope=js)
        ts = tf.Scope()
        convert.state_from_numpy(start, ts, tf.CPUPlace(), program=tmain)
        got, = texe.run(tmain, feed=feed(seed), fetch_list=[tloss.name],
                        scope=ts)
        f32 = fp32[seed]
        want = np.asarray(want)
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        rel32 = float(np.abs(got - f32).max() / np.abs(f32).max())
        print(f"batch {seed}: loss {got} vs {want}, {rel / 2 ** -8:.3g} "
              f"bf16 units; the port's fp32 loss {f32}, "
              f"{rel32 / 2 ** -8:.3g} units")
        assert np.isfinite(got).all() and rel <= LOSS_RTOL, (seed, got, want)
        assert rel32 <= LOSS_RTOL, (seed, got, f32)
        assert topt.state_dict(ts) == {"loss_scaling": 1.0, "good_steps": 1,
                                       "bad_steps": 0}
    assert watch.checked > 2 * len(tmain.global_block.ops)
    assert watch.inputs["conv2d"] == {"Input": {"bfloat16"},
                                      "Filter": {"bfloat16"}}
    assert watch.inputs["batch_norm"]["X"] == {"float32"}
    assert watch.inputs["yolov3_loss"]["X"] == {"bfloat16"}
