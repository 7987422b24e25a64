"""Port parity for bench.py's bench_bert program (BERT MLM pretraining
with the gathered head) under the training-breadth optimizers, as
tests/test_torch_bert_training.py holds it under Adam: at
BertConfig.tiny(), B=4, S=64, dropout 0, two steps on the CPU from the
JAX package's carried-over state, in three configurations:
- Lamb (lamb_weight_decay 0.01) with GradientClipByGlobalNorm active
  (the clip scale fetched, below 1 at both steps);
- AdamW (weight_decay 0.01) with GradientClipByNorm(1.0);
- Momentum(0.9) with regularization=L2Decay(1e-4) under piecewise_decay
  (tests/test_torch_bert_training_momentum.py, to keep each file's time
  short).
And the eager mode: AdamW's and Lamb's eager steps with a regularized
parameter against the JAX package's eager steps, which pins that the
decay is not applied there (the JAX package reads a `_coeff` field that
L2Decay lacks) and that eager Lamb is AdamW's update.

Tolerances, as test_torch_bert_training.py's (fp32 both sides, sums in
other orders): loss and the clip scale rtol 1e-5; every @GRAD atol 1e-5
+ rtol 1e-4; moments and velocities atol 1e-7 + rtol 1e-4; beta powers
and the lr rtol 1e-6; each parameter's update over the two steps within
1e-3 of (|update| + lr), elements whose two gradients differ by more than
1e-4 of the JAX package's at a step exempt and counted (under 2%). Lamb's
trust ratio divides two norms summed in other orders: a relative error
near 1e-7, inside the update bound. The eager steps: atol 1e-6 + rtol
1e-5, as test_torch_dygraph_eager.py's.
"""

import numpy as np
import pytest

from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer import Lamb as JLamb
from paddle_tpu.regularizer import L2Decay as JL2Decay

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert

from test_torch_bert_training import (JAX, PORT, B, P, S, _attrs,
                                      _check_updates, _feed, _jax_state)
from test_torch_dygraph_eager import JAX as DG_JAX
from test_torch_dygraph_eager import PORT as DG_PORT
from test_torch_dygraph_eager import _optimizer_run

LR = 1e-3
CONFIGS = {
    "lamb_global_norm": lambda f, L: f.optimizer.Lamb(
        LR, lamb_weight_decay=0.01,
        grad_clip=f.clip.GradientClipByGlobalNorm(0.5)),
    "adamw_norm": lambda f, L: f.optimizer.AdamW(
        LR, weight_decay=0.01, grad_clip=f.clip.GradientClipByNorm(1.0)),
    "momentum_l2_piecewise": lambda f, L: f.optimizer.Momentum(
        L.piecewise_decay([1], [LR, LR / 2]), momentum=0.9,
        regularization=f.regularizer.L2Decay(1e-4)),
}


def _bench_bert(pkg, config):
    fluid, layers, unique_name, cfg_cls, pretrain, _ = pkg
    cfg = cfg_cls.tiny()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("ids", [B, S], "int64")
        types = fluid.data("types", [B, S], "int64")
        mask = fluid.data("mask", [B, S], "float32")
        mask_pos = fluid.data("mask_pos", [P], "int64")
        labels = fluid.data("labels", [P], "int64")
        loss = pretrain(ids, types, mask, labels, cfg, mask_pos=mask_pos)
        _, pg = CONFIGS[config](fluid, layers).minimize(loss, startup)
        blk = main.global_block
        scale = blk.var("clip_scale_0") if blk.has_var("clip_scale_0") \
            else None
    return main, startup, loss, pg, cfg, scale


@pytest.mark.parametrize("config", ["lamb_global_norm", "adamw_norm"])
def test_two_steps_match_the_jax_package(config):
    check_two_steps(config)


def check_two_steps(config):
    """The program op for op; the losses (and the clip scale), every
    @GRAD, the accumulators and the parameters' updates after two steps
    of CONFIGS[config]."""
    jmain, jstartup, jloss, jpg, cfg, jscale = _bench_bert(JAX, config)
    tmain, _, tloss, tpg, _, tscale = _bench_bert(PORT, config)
    jb, tb = jmain.global_block, tmain.global_block
    assert [op.type for op in tb.ops] == [op.type for op in jb.ops]
    for jop, top in zip(jb.ops, tb.ops):
        assert top.inputs == jop.inputs and top.outputs == jop.outputs, top
        assert _attrs(top) == _attrs(jop), top.type
    jf, tf_ = JAX[0], PORT[0]
    jscope, jexe = JAX[0].framework.scope.Scope(), jf.Executor(jf.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    start = _jax_state(jscope)
    tscope, texe = tf_.Scope(), tf_.Executor(tf_.CPUPlace())
    convert.state_from_numpy(start, tscope, tf_.CPUPlace(), program=tmain)
    grads = [g.name for _, g in jpg]
    assert grads == [g.name for _, g in tpg]
    head = [jloss.name] + ([jscale.name] if jscale is not None else [])
    want, got = [], []
    for feed in (_feed(cfg, 1), _feed(cfg, 2)):
        want.append([np.asarray(v) for v in jexe.run(
            jmain, feed=feed, fetch_list=head + grads, scope=jscope)])
        got.append(texe.run(tmain, feed=feed, fetch_list=head + grads,
                            scope=tscope))
    n = len(head)
    for step, (w, g) in enumerate(zip(want, got)):
        for i in range(n):
            np.testing.assert_allclose(g[i], w[i], rtol=1e-5,
                                       err_msg=f"{head[i]}, step {step}")
        for name, gv, wv in zip(grads, g[n:], w[n:]):
            np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} {step}")
    if config == "lamb_global_norm":
        assert all(0.0 < float(g[1][0]) < 1.0 for g in got), "clip inactive"
    jend, tend = _jax_state(jscope), convert.state_to_numpy(tscope)
    assert set(tend) == set(jend)
    jgrads = {p.name: [(g[n + i], w[n + i]) for g, w in zip(got, want)]
              for i, (p, _) in enumerate(jpg)}
    exempt, total = _check_updates(start, tend, jend, jgrads, LR)
    print(f"updates: {exempt} of {total} elements exempt")
    assert exempt < 0.02 * total
    moved = 0
    for name, w in jend.items():
        g = tend[name]
        if name in jgrads:
            pass  # parameters: their updates, above
        elif name.endswith(("_moment1_0", "_moment2_0", "_velocity_0")):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7,
                                       err_msg=name)
        elif w.dtype.kind == "f":  # beta powers, the lr
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=name)
        moved += name in start and not np.array_equal(start[name], w)
    assert moved > 2 * len(grads)


@pytest.mark.parametrize("kind", ["AdamW", "Lamb"])
def test_eager_step_with_a_regularizer_matches_the_jax_package(kind):
    """Three eager steps of a Linear layer whose weight carries an
    L2Decay: the port's parameters equal the JAX package's, and equal the
    port's own steps without the regularizer (no decay in eager mode)."""
    def make(opt, decay):
        def build(parameter_list):
            if decay is not None:
                parameter_list[0].regularizer = decay(0.5)
            return opt(0.05, parameter_list=parameter_list)
        return build

    jopt = {"AdamW": JAdamW, "Lamb": JLamb}[kind]
    topt = getattr(tf.optimizer, kind)
    start, want = _optimizer_run(DG_JAX, make(jopt, JL2Decay))
    _, got = _optimizer_run(DG_PORT, make(topt, tf.regularizer.L2Decay),
                            state=start)
    _, plain = _optimizer_run(DG_PORT, make(topt, None), state=start)
    for name, w in want.items():
        assert not np.array_equal(w, start[name])
        np.testing.assert_allclose(got[name], w, atol=1e-6, rtol=1e-5,
                                   err_msg=name)
        np.testing.assert_array_equal(got[name], plain[name], err_msg=name)
