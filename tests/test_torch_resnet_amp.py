"""Port parity for ResNet under AMP: bench_resnet's program (ResNet-18 on
3x32x32, B=4, 10 classes, Momentum(1e-3, 0.9)) decorated as bench.py's
`_amp` decorates it on an accelerator (bf16, static loss scale 1.0,
softmax and layer_norm white-listed), by paddle_tpu_torch and by the JAX
package on the CPU.

- The rewrite: the same ops in the same order with the same inputs,
  outputs and attrs, so the same casts (conv2d and mul read bf16, the
  black-listed batch_norm and reduce_mean fp32), and the same declared
  dtype of every variable (integers by kind: the JAX package runs
  without 64-bit mode).
- The bf16 loss: one AMP step on each of bench_resnet's two batches from
  the JAX package's carried startup state, the loss within 2^-8 of the
  JAX package's (one bf16 unit; measured 1.3e-3 relative on the first
  batch, where both are 3% from the fp32 program's loss), and every op's
  runtime output dtype equal to its declaration.

Gradients are not held: at B=4 the batch norms over 4 samples of a 1x1
map turn bf16's rounding of the activations into gradients 75% (median
relative L2) from the fp32 program's, on both packages alike, so the two
packages' bf16 gradients, and every step after the first, differ by as
much (measured). test_torch_resnet_training.py holds the fp32 steps.
"""

import numpy as np

import paddle_tpu as jf
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.resnet import resnet_train_net as jresnet_train_net
from paddle_tpu.optimizer import Momentum as JMomentum

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.models import resnet_train_net as tresnet_train_net
from paddle_tpu_torch.optimizer import Momentum as TMomentum

from test_torch_amp import DtypeWatch, _attrs, _int, bench_amp
from test_torch_resnet_training import B, CLASSES, DEPTH, HW, LR, feeds
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

JAX = (jf, jun, jresnet_train_net, JMomentum, jmp)
PORT = (tf, tf.unique_name, tresnet_train_net, TMomentum, tmp)
LOSS_RTOL = 2.0 ** -8


def build_amp(pkg):
    fluid, unique_name, train_net, momentum, mp = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with unique_name.guard(), fluid.program_guard(main, startup):
        image = fluid.data("image", [B, 3, HW, HW])
        label = fluid.data("label", [B, 1], "int64")
        loss, acc = train_net(image, label, depth=DEPTH, class_num=CLASSES)
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
    casts = [op for op in tops if op.type == "cast"]
    # the forward's casts: into each conv (input and filter) and the fc,
    # out of each conv into its batch norm (and the batch norm's four
    # fp32 inputs, force-cast), into the loss's mean; the backward
    # replays each cast (__vjp__(cast))
    n_conv = sum(op.type == "conv2d" for op in tops)
    assert n_conv == 20 and len(casts) > 6 * n_conv
    for op in tops:
        if op.type == "conv2d":
            assert {blk.var(op.inputs[s][0]).dtype
                    for s in ("Input", "Filter")} == {"bfloat16"}
        elif op.type == "batch_norm":
            assert blk.var(op.inputs["X"][0]).dtype == "float32"
            assert blk.var(op.outputs["Y"][0]).dtype == "float32"
    for p in tmain.all_parameters():  # fp32 masters
        assert p.dtype in ("float32", "int32"), (p.name, p.dtype)


def test_amp_loss_matches_the_jax_package(monkeypatch):
    jmain, jstartup, jloss, _ = build_amp(JAX)
    tmain, _, tloss, topt = build_amp(PORT)
    jscope, jexe = JScope(), jf.Executor(jf.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    start = {n: np.asarray(jscope.find_var(n))
             for n in jscope.local_var_names()}
    watch = DtypeWatch(monkeypatch, tmain.global_block)
    texe = tf.Executor(tf.CPUPlace())
    for i, feed in enumerate(feeds()):
        # each batch as a first step from the start state
        js = JScope()
        for n, v in start.items():
            js.set_var(n, v)
        want, = jexe.run(jmain, feed=feed, fetch_list=[jloss.name], scope=js)
        ts = tf.Scope()
        convert.state_from_numpy(start, ts, tf.CPUPlace(), program=tmain)
        got, = texe.run(tmain, feed=feed, fetch_list=[tloss.name], scope=ts)
        want = np.asarray(want)
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        print(f"batch {i}: loss {got} vs {want}, {rel / 2 ** -8:.3g} bf16 "
              "units")
        assert np.isfinite(got).all() and rel <= LOSS_RTOL, (i, got, want)
        assert topt.state_dict(ts) == {"loss_scaling": 1.0, "good_steps": 1,
                                       "bad_steps": 0}
    assert watch.checked > 2 * len(tmain.global_block.ops)
    assert watch.inputs["conv2d"] == {"Input": {"bfloat16"},
                                      "Filter": {"bfloat16"}}
    assert watch.inputs["batch_norm"]["X"] == {"float32"}
