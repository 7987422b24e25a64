"""Port parity for the training slice: bench.py's bench_bert program (BERT
MLM pretraining with the gathered head, Adam, fluid's LR schedule) built
and trained by paddle_tpu_torch against the same program in the JAX
package, on the CPU at BertConfig.tiny(), B=4, S=64, P=int(0.15*B*S).

Both programs are built from a fresh unique_name state, so their variable
names match; the JAX package's whole persistable state (weights, Adam
moments and beta powers, learning rate, step counter) is carried across
with convert.state_from_numpy. Feeds come from numpy with a fixed seed.
Dropout is 0 in the parity runs: the two packages draw their masks from
different generators.

Tolerances, fp32 on both sides, sums in other orders:
- loss: rtol 1e-5;
- every @GRAD: atol 1e-5 + rtol 1e-4 (gradients of magnitude <= ~1);
- Adam moments: atol 1e-7 + rtol 1e-4 (m1 = 0.1 g, m2 = 0.001 g^2);
- beta powers and the lr: rtol 1e-6;
- each parameter's update over the two steps (end - start): within 1e-3
  of (|update| + lr) of the JAX package's (measured: 3.0e-5). A step
  moves a weight by about lr, so its error scales with lr even where the
  second step undoes the first. Exempt are the elements whose two
  gradients differ by more than 1e-4 of the JAX package's at a step:
  Adam's step follows that disagreement, and near a zero gradient (the
  key bias's, zero but for rounding; a first-step gradient of ~1e-8
  against Adam's epsilon of 1e-8) its size and sign. They are counted
  and must stay under 2% of the elements (measured: 0.5%).
"""

import numpy as np
import pytest

import paddle_tpu as jf
from paddle_tpu import layers as jl
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import bert_pretrain as jbert_pretrain
from paddle_tpu.optimizer import Adam as JAdam

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.bert import bert_pretrain as tbert_pretrain
from paddle_tpu_torch.optimizer import Adam as TAdam

B, S = 4, 64
P = int(0.15 * B * S)
LR = 1e-3
JAX = (jf, jl, jun, JBertConfig, jbert_pretrain, JAdam)
PORT = (tf, tl, tf.unique_name, TBertConfig, tbert_pretrain, TAdam)


def _schedule(layers, warmup=1000, decay_steps=100000):
    """bench_bert's schedule: linear warmup over polynomial decay."""
    return layers.linear_lr_warmup(
        layers.polynomial_decay(1e-4, decay_steps, 1e-5), warmup, 0.0, 1e-4
    )


def _bench_bert(pkg, lr=LR, dropout=0.0):
    fluid, layers, unique_name, cfg_cls, pretrain, adam = pkg
    cfg = cfg_cls.tiny()
    cfg.hidden_dropout = cfg.attention_dropout = dropout
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("ids", [B, S], "int64")
        types = fluid.data("types", [B, S], "int64")
        mask = fluid.data("mask", [B, S], "float32")
        mask_pos = fluid.data("mask_pos", [P], "int64")
        labels = fluid.data("labels", [P], "int64")
        loss = pretrain(ids, types, mask, labels, cfg, mask_pos=mask_pos)
        lr_v = _schedule(layers) if lr is None else lr
        _, pg = adam(lr_v).minimize(loss, startup)
    return main, startup, loss, pg, cfg


def _feed(cfg, seed, dtype="int32"):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, S), np.float32)
    mask[1, 40:] = 0.0  # a padded tail of keys in one sample
    return {
        "ids": rng.randint(0, cfg.vocab_size, (B, S)).astype(dtype),
        "types": rng.randint(0, cfg.type_vocab_size, (B, S)).astype(dtype),
        "mask": mask,
        "mask_pos": rng.choice(B * S, P, replace=False).astype(dtype),
        "labels": rng.randint(0, cfg.vocab_size, P).astype(dtype),
    }


def _jax_state(jscope):
    return {n: np.asarray(jscope.find_var(n))
            for n in jscope.local_var_names()}


def _attrs(op):
    # dunder attrs are bookkeeping (uid, build site); __vjp__'s copy of
    # its forward op's attrs holds them too
    return {k: v for k, v in op.attrs.items()
            if not k.startswith("__") and k != "fwd_attrs"}


def test_programs_match_in_ops_names_shapes_and_dtypes():
    jmain, jstartup, _, jpg, _ = _bench_bert(JAX, lr=None)
    tmain, tstartup, _, tpg, _ = _bench_bert(PORT, lr=None)
    jb, tb = jmain.global_block, tmain.global_block
    assert [op.type for op in tb.ops] == [op.type for op in jb.ops]
    assert len({op.type for op in tb.ops}) == 31
    for jop, top in zip(jb.ops, tb.ops):
        assert top.inputs == jop.inputs and top.outputs == jop.outputs, top
        assert _attrs(top) == _attrs(jop), top.type
    assert ([op.type for op in tstartup.global_block.ops]
            == [op.type for op in jstartup.global_block.ops])
    jvars = {v.name: v for v in jmain.list_vars()}
    tvars = {v.name: v for v in tmain.list_vars()}
    assert set(tvars) == set(jvars)
    for name, jv in jvars.items():
        assert tvars[name].shape == jv.shape, name
        assert tvars[name].persistable == jv.persistable, name
    assert [(p.name, g.name) for p, g in tpg] == \
        [(p.name, g.name) for p, g in jpg]


def _two_steps(pkg_main, exe, scope, feeds, fetch):
    out = []
    for feed in feeds:
        out.append(exe.run(pkg_main, feed=feed, fetch_list=fetch,
                           scope=scope))
    return out


def test_two_adam_steps_match_the_jax_package():
    """Loss, every @GRAD, and the moments and parameters after each of
    two Adam steps at a constant lr, from one carried-over state."""
    jmain, jstartup, jloss, jpg, cfg = _bench_bert(JAX)
    tmain, _, tloss, tpg, _ = _bench_bert(PORT)
    jscope, jexe = JScope(), jf.Executor(jf.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    start = _jax_state(jscope)
    tscope = tf.Scope()
    convert.state_from_numpy(start, tscope, tf.CPUPlace(), program=tmain)
    assert set(convert.state_to_numpy(tscope)) == set(start)

    feeds = [_feed(cfg, 1), _feed(cfg, 2)]
    grads = [g.name for _, g in jpg]
    assert grads == [g.name for _, g in tpg] and len(grads) == 31
    want = _two_steps(jmain, jexe, jscope, feeds, [jloss.name] + grads)
    got = _two_steps(tmain, tf.Executor(tf.CPUPlace()), tscope, feeds,
                     [tloss.name] + grads)
    for step, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g[0], np.asarray(w[0]), rtol=1e-5,
                                   err_msg=f"loss, step {step}")
        for name, gv, wv in zip(grads, g[1:], w[1:]):
            np.testing.assert_allclose(gv, np.asarray(wv), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} {step}")

    jend, tend = _jax_state(jscope), convert.state_to_numpy(tscope)
    assert set(tend) == set(jend)
    jgrads = {p.name: [(g[1 + i], np.asarray(w[1 + i]))
                       for g, w in zip(got, want)]
              for i, (p, _) in enumerate(jpg)}
    exempt, total = _check_updates(start, tend, jend, jgrads, LR)
    print(f"updates: {exempt} of {total} elements exempt")
    assert exempt < 0.02 * total
    moved = 0
    for name, w in jend.items():
        g = tend[name]
        if name in jgrads:
            pass  # parameters: their updates, above
        elif name.endswith(("_moment1_0", "_moment2_0")):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7,
                                       err_msg=name)
        elif w.dtype.kind == "f":  # beta powers, the lr
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=name)
        moved += name in start and not np.array_equal(start[name], w)
    assert moved > 3 * len(grads)  # params, moments and beta powers moved


def _check_updates(start, got, want, grads, lr, rtol=1e-3, agree=1e-4):
    """Each parameter's update, end - start, within rtol of (|want's| +
    lr), but for elements whose two gradients (got's, want's) differ by
    more than agree of want's at some step. Returns (exempt elements,
    elements)."""
    exempt = total = 0
    for name, steps in grads.items():
        du = got[name].astype(np.float64) - start[name]
        dw = want[name].astype(np.float64) - start[name]
        noisy = np.zeros(dw.shape, bool)
        for g, w in steps:
            w = w.astype(np.float64)
            noisy |= np.abs(g - w) > agree * np.abs(w)
        err = np.abs(du - dw) - rtol * (np.abs(dw) + lr)
        assert (err[~noisy] <= 0).all(), (
            f"{name}: {(err[~noisy] > 0).sum()} updates differ; worst "
            f"{np.abs(du - dw)[~noisy].max():.3e}")
        exempt += int(noisy.sum())
        total += noisy.size
    return exempt, total


def test_int64_and_int32_feeds_give_the_same_steps():
    """bench_bert feeds int32 arrays to its int64 data variables (the JAX
    package runs without 64-bit mode); the port takes both alike.
    Tolerance: rtol 1e-5, atol 1e-6."""
    tmain, tstartup, tloss, tpg, cfg = _bench_bert(PORT)
    fetch = [tloss.name] + [g.name for _, g in tpg]
    exe, first = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(tstartup, scope=first)
    start = convert.state_to_numpy(first)
    runs = []
    for dtype in ("int32", "int64"):
        scope = tf.Scope()
        convert.state_from_numpy(start, scope, tf.CPUPlace(), program=tmain)
        runs.append(_two_steps(tmain, exe, scope,
                               [_feed(cfg, 1, dtype), _feed(cfg, 2, dtype)],
                               fetch))
        runs[-1].append(convert.state_to_numpy(scope))
    # the CPU's scatter-adds (embedding and gather gradients) may sum in
    # another order from run to run: ~1e-7 apart
    for a, b in zip(runs[0][:2], runs[1][:2]):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)
    for name, x in runs[0][2].items():
        np.testing.assert_allclose(x, runs[1][2][name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("warmup,decay_steps,steps", [
    (1000, 100000, 3),  # bench_bert's own schedule
    (3, 5, 8),          # short: warmup, then decay, then held at the end
])
def test_scheduled_lr_and_counter_match_the_jax_package(warmup, decay_steps,
                                                        steps):
    def build(pkg):
        fluid, layers, unique_name = pkg[:3]
        main, startup = fluid.Program(), fluid.Program()
        with unique_name.guard(), fluid.program_guard(main, startup):
            lr = _schedule(layers, warmup, decay_steps)
        return main, startup, lr

    jmain, jstartup, jlr = build(JAX)
    tmain, tstartup, tlr = build(PORT)
    assert ([op.type for op in tmain.global_block.ops]
            == [op.type for op in jmain.global_block.ops])
    jscope, jexe = JScope(), jf.Executor(jf.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    tscope, texe = tf.Scope(), tf.Executor(tf.CPUPlace())
    texe.run(tstartup, scope=tscope)
    counter = "@LR_DECAY_COUNTER@"
    for _ in range(steps):
        w, = jexe.run(jmain, fetch_list=[jlr.name, ], scope=jscope)
        g, = texe.run(tmain, fetch_list=[tlr.name], scope=tscope)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-12)
        tc = convert.state_to_numpy(tscope)[counter]
        assert tc.dtype == np.int32
        np.testing.assert_array_equal(tc, np.asarray(jscope.find_var(counter)))
    assert int(tc[0]) == steps - 1


def test_a_step_with_dropout_trains():
    """BERT's dropout of 0.1 in training: the port's step runs, its loss
    is finite, and two runs of one step differ (a new mask each step)."""
    tmain, tstartup, tloss, _, cfg = _bench_bert(PORT, dropout=0.1)
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    exe.run(tstartup, scope=scope)
    feed = _feed(cfg, 3)
    losses = [exe.run(tmain, feed=feed, fetch_list=[tloss], scope=scope)[0]
              for _ in range(2)]
    assert all(np.isfinite(x).all() for x in losses)
    assert losses[0] != losses[1]
