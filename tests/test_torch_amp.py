"""Port parity for AMP (paddle_tpu_torch.contrib.mixed_precision and
ops/amp_ops.py) against the JAX package, on the CPU.

- The rewrite: bench.py's bench_bert program at BERT-tiny and its
  bench_gpt_longctx program at GPT-tiny, decorated as bench.py's `_amp`
  decorates them (bf16, static loss scale 1.0, layer_norm and softmax
  white-listed) and under the default lists, with
  FLAGS_paddle_tpu_pallas_layer_norm off and on: the same ops in the same
  order with the same inputs, outputs and attrs (so the same casts), and
  the same declared dtype of every variable. The one difference allowed
  is an integer's width: the JAX package runs without 64-bit mode, so
  the ids it derives (range, fill_constant) are int32 where the port
  declares int64.
- check_finite_and_unscale and update_loss_scaling against the JAX
  package's emitters on finite, inf and NaN gradients, over a sequence of
  steps that grows the scale, shrinks it, hits the grow guard (a grown
  scale that overflows keeps the old one) and the shrink floor (a scale
  below 1 never rises through the shrink branch): equal values (the same
  IEEE operations on the same inputs) and equal dtypes, a bf16 gradient
  lifted to fp32 as jnp lifts it.
- The decorator's state_dict, load_state_dict and note_step against the
  JAX package's on the same sequence.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu import layers as jl
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.framework import registry as jreg
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import bert_pretrain as jbert_pretrain
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import gpt_lm_loss as jgpt_lm_loss
from paddle_tpu.optimizer import Adam as JAdam

import paddle_tpu_torch as tf
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.bert import bert_pretrain as tbert_pretrain
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.models.gpt import gpt_lm_loss as tgpt_lm_loss
from paddle_tpu_torch.optimizer import Adam as TAdam

FLAG = "FLAGS_paddle_tpu_pallas_layer_norm"
JAX = dict(fluid=jf, layers=jl, unique_name=jun, mp=jmp, adam=JAdam,
           gpt=(JGPTConfig, jgpt_lm_loss), bert=(JBertConfig, jbert_pretrain))
PORT = dict(fluid=tf, layers=tl, unique_name=tf.unique_name, mp=tmp,
            adam=TAdam, gpt=(TGPTConfig, tgpt_lm_loss),
            bert=(TBertConfig, tbert_pretrain))
GPT_B, GPT_S = 2, 64
BERT_B, BERT_S = 4, 64
BERT_P = int(0.15 * BERT_B * BERT_S)


def bench_amp(mp, opt, lists="bench"):
    """bench.py's `_amp` (lists="bench"), or decorate's defaults with the
    same static scale (lists="default")."""
    amp_lists = (mp.AutoMixedPrecisionLists(
        custom_white_list={"softmax", "layer_norm"})
        if lists == "bench" else None)
    return mp.decorate(opt, amp_lists=amp_lists,
                       use_dynamic_loss_scaling=False, init_loss_scaling=1.0,
                       dest_dtype="bfloat16")


def build_bench(pkg, which, flag=False, lists="bench", lr=1e-3,
                dropout=0.0):
    """bench_gpt_longctx's (GPT-tiny, B=2, S=64) or bench_bert's (BERT-tiny,
    B=4, S=64) program under AMP (bench_amp's `lists`; None: no AMP),
    built from a fresh unique_name state with
    FLAGS_paddle_tpu_pallas_layer_norm set to `flag` (and left so: the
    emitters read it as they run). Returns (main, startup, loss,
    params_grads, cfg, optimizer)."""
    fluid, layers = pkg["fluid"], pkg["layers"]
    fluid.set_flags({FLAG: flag})
    cfg_cls, model = pkg[which]
    cfg = cfg_cls.tiny()
    cfg.hidden_dropout = cfg.attention_dropout = dropout
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with pkg["unique_name"].guard(), fluid.program_guard(main, startup):
        if which == "gpt":
            ids = fluid.data("ids", [GPT_B, GPT_S], "int64")
            loss = model(ids, cfg)
        else:
            B, S, P = BERT_B, BERT_S, BERT_P
            ids = fluid.data("ids", [B, S], "int64")
            types = fluid.data("types", [B, S], "int64")
            mask = fluid.data("mask", [B, S], "float32")
            mask_pos = fluid.data("mask_pos", [P], "int64")
            labels = fluid.data("labels", [P], "int64")
            loss = model(ids, types, mask, labels, cfg, mask_pos=mask_pos)
        opt = pkg["adam"](lr)
        if lists is not None:
            opt = bench_amp(pkg["mp"], opt, lists)
        _, pg = opt.minimize(loss, startup)
    return main, startup, loss, pg, cfg, opt


@pytest.fixture
def flags_restored():
    yield
    jf.set_flags({FLAG: False})
    tf.set_flags({FLAG: False})


def _attrs(op):
    # dunder attrs are bookkeeping (uid, build site); __vjp__'s copy of
    # its forward op's attrs holds them too
    return {k: v for k, v in op.attrs.items()
            if not k.startswith("__") and k != "fwd_attrs"}


def _int(dtype):
    return dtype.startswith(("int", "uint"))


@pytest.mark.parametrize("which,lists,flag", [
    ("gpt", "bench", False), ("gpt", "bench", True), ("gpt", "default", True),
    ("bert", "bench", False), ("bert", "default", False),
])
def test_rewrite_matches_the_jax_package(which, lists, flag, flags_restored):
    jmain, *_ = build_bench(JAX, which, flag, lists)
    tmain, *_ = build_bench(PORT, which, flag, lists)
    jops, tops = jmain.global_block.ops, tmain.global_block.ops
    assert [op.type for op in tops] == [op.type for op in jops]
    for jop, top in zip(jops, tops):
        assert top.inputs == jop.inputs and top.outputs == jop.outputs, top
        assert _attrs(top) == _attrs(jop), top.type
        if top.type == "__vjp__":
            assert top.attr("fwd_type") == jop.attr("fwd_type")
    casts = [op for op in tops if op.type == "cast"]
    assert casts and all(op.attr("out_dtype") in ("bfloat16", "float32")
                         for op in casts)
    ln_grads = sum(op.type == "layer_norm_grad" for op in tops)
    n_ln = sum(op.type == "layer_norm" for op in tops)
    assert ln_grads == (n_ln if flag else 0)
    jvars = {v.name: v.dtype for v in jmain.list_vars()}
    tvars = {v.name: v.dtype for v in tmain.list_vars()}
    assert set(tvars) == set(jvars)
    for name, jd in jvars.items():
        td = tvars[name]
        assert td == jd or (_int(td) and _int(jd)), (name, td, jd)
    bf16 = {n for n, d in tvars.items() if d == "bfloat16"}
    assert len(bf16) > 50  # the activation stream and its gradients
    for p in tmain.all_parameters():  # fp32 masters
        assert p.dtype in ("float32", "int32"), (p.name, p.dtype)


class _Op:
    def __init__(self, **attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _emit(pkg_reg, op_type, attrs, ins):
    return pkg_reg.get_op_def(op_type).emit(None, _Op(**attrs), ins)


def _grads(kind, dtype=np.float32):
    rng = np.random.RandomState({"finite": 1, "inf": 2, "nan": 3}[kind])
    xs = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    if kind == "inf":
        xs[1][2] = -np.inf
    elif kind == "nan":
        xs[0][1, 1] = np.nan
    return xs


def _both(xs, bf16=False):
    t = [torch.from_numpy(x) for x in xs]
    j = [jnp.asarray(x) for x in xs]
    if bf16:
        t = [x.to(torch.bfloat16) for x in t]
        j = [x.astype(jnp.bfloat16) for x in j]
    return t, j


def _same(got, want):
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), \
        (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("kind", ["finite", "inf", "nan"])
@pytest.mark.parametrize("bf16", [False, True])
def test_check_finite_and_unscale_matches_the_jax_op(kind, bf16):
    t, j = _both(_grads(kind), bf16)
    scale = np.asarray([8.0], np.float32)
    got = _emit(treg, "check_finite_and_unscale", {},
                {"X": t, "Scale": [torch.from_numpy(scale)]})
    want = _emit(jreg, "check_finite_and_unscale", {},
                 {"X": j, "Scale": [jnp.asarray(scale)]})
    _same(got["FoundInfinite"][0], want["FoundInfinite"][0])
    assert bool(got["FoundInfinite"][0].item()) == (kind != "finite")
    for g, w in zip(got["Out"], want["Out"]):
        _same(g, w)


def _update(reg, state, xs, attrs, found):
    to = (torch.from_numpy if reg is treg else jnp.asarray)
    out = _emit(reg, "update_loss_scaling", attrs, {
        "X": xs, "FoundInfinite": [to(np.asarray([found]))],
        "PrevLossScaling": [to(np.asarray([state[0]], np.float32))],
        "InGoodSteps": [to(np.asarray([state[1]], np.int32))],
        "InBadSteps": [to(np.asarray([state[2]], np.int32))],
    })
    return out


def _state(out):
    return tuple(np.asarray(v[0] if not isinstance(v[0], torch.Tensor)
                            else v[0].numpy()).reshape(-1)[0].item()
                 for v in (out["LossScaling"], out["OutGoodSteps"],
                           out["OutBadSteps"]))


def test_update_loss_scaling_matches_the_jax_op_over_a_sequence():
    """incr_every 2, decr_every 2, ratios 2 and 0.5, from a scale of 4:
    two good steps grow it to 8; inf, NaN shrink it to 4; then the grow
    guard (a scale near fp32's max that would overflow keeps itself) and
    the shrink floor (0.5 stays 0.5: max(0.25, min(0.5, 1)))."""
    attrs = dict(incr_every_n_steps=2, decr_every_n_nan_or_inf=2,
                 incr_ratio=2.0, decr_ratio=0.5)
    seq = ["finite", "finite", "inf", "nan", "finite", "inf", "finite",
           "finite", "finite"]
    want_scales = [4.0, 8.0, 8.0, 4.0, 4.0, 4.0, 4.0, 8.0, 8.0]
    tstate = jstate = (4.0, 0, 0)
    for step, kind in enumerate(seq):
        xs = _grads(kind)
        found = kind != "finite"
        t, j = _both(xs)
        got = _update(treg, tstate, t, attrs, found)
        want = _update(jreg, jstate, j, attrs, found)
        for g, w in zip(got["Out"], want["Out"]):
            _same(g, w)
            if found:
                assert not g.any()  # zeroed on overflow
        for slot in ("LossScaling", "OutGoodSteps", "OutBadSteps"):
            _same(got[slot][0], want[slot][0])
        tstate, jstate = _state(got), _state(want)
        assert tstate == jstate
        assert tstate[0] == want_scales[step], (step, tstate)

    guard = dict(attrs, incr_every_n_steps=1, incr_ratio=4.0)
    floor = dict(attrs, decr_every_n_nan_or_inf=1)
    for a, state, kind, expect in ((guard, (3e38, 0, 0), "finite", 3e38),
                                   (floor, (0.5, 3, 0), "nan", 0.5)):
        t, j = _both(_grads(kind))
        got = _update(treg, state, t, a, kind != "finite")
        want = _update(jreg, state, j, a, kind != "finite")
        assert _state(got) == _state(want)
        assert _state(got)[0] == np.float32(expect)
    t, j = _both(_grads("finite"), bf16=True)
    got = _update(treg, (2.0, 0, 0), t, attrs, False)
    want = _update(jreg, (2.0, 0, 0), j, attrs, False)
    for g, w in zip(got["Out"], want["Out"]):
        _same(g, w)  # bf16 / fp32 scale -> fp32, as jnp lifts it


def _dynamic(pkg):
    """A one-layer program under dynamic loss scaling (incr_every 2,
    decr_every 2): the decorator's loss-scale state in main and startup."""
    fluid, layers = pkg["fluid"], pkg["layers"]
    main, startup = fluid.Program(), fluid.Program()
    with pkg["unique_name"].guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [4, 8], "float32")
        loss = layers.mean(layers.fc(x, 8))
        opt = pkg["mp"].decorate(pkg["adam"](1e-3), init_loss_scaling=16.0,
                                 incr_every_n_steps=2,
                                 decr_every_n_nan_or_inf=2)
        assert opt.state_dict() == {} and opt.note_step(True) is None
        opt.minimize(loss, startup)
    return main, startup, opt


def test_state_dict_load_state_dict_and_note_step_match_the_jax_package():
    jmain, jstartup, jopt = _dynamic(JAX)
    tmain, tstartup, topt = _dynamic(PORT)
    jscope, tscope = JScope(), tf.Scope()
    jf.Executor(jf.CPUPlace()).run(jstartup, scope=jscope)
    tf.Executor(tf.CPUPlace()).run(tstartup, scope=tscope)
    names = [topt.get_loss_scaling().name, topt._good_steps.name,
             topt._bad_steps.name]
    assert names == [jopt.get_loss_scaling().name, jopt._good_steps.name,
                     jopt._bad_steps.name]
    assert topt.state_dict(tscope) == jopt.state_dict(jscope) == {
        "loss_scaling": 16.0, "good_steps": 0, "bad_steps": 0}
    for good in (True, True, False, True, False, False, True):
        assert topt.note_step(good, tscope) == jopt.note_step(good, jscope)
        assert topt.state_dict(tscope) == jopt.state_dict(jscope)
    assert topt.state_dict(tscope)["loss_scaling"] == 16.0
    state = {"loss_scaling": 2.0 ** 20, "good_steps": 7, "bad_steps": 1}
    topt.load_state_dict(state, tscope)
    jopt.load_state_dict(state, jscope)
    assert topt.state_dict(tscope) == jopt.state_dict(jscope) == state
    for name, dtype in zip(names, (torch.float32, torch.int32, torch.int32)):
        v = tscope.find_var(name)
        assert (v.dtype, tuple(v.shape), v.device.type) == (dtype, (1,),
                                                            "cpu")
    topt.load_state_dict({"good_steps": 3}, tscope)  # the rest: defaults
    assert topt.state_dict(tscope) == {"loss_scaling": 16.0,
                                       "good_steps": 3, "bad_steps": 0}
    topt.load_state_dict({}, tscope)  # a no-op
    assert topt.state_dict(tscope)["good_steps"] == 3


# -- two AMP Adam steps, port vs JAX package (test_torch_gpt_amp.py,
# test_torch_bert_amp.py) ------------------------------------------------

def _jax_state(jscope):
    return {n: np.asarray(jscope.find_var(n))
            for n in jscope.local_var_names()}


def _rel_l2(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


class DtypeWatch:
    """Wraps the executor's run_op: after each op, every floating or bool
    output's runtime dtype must equal its variable's declared dtype, and
    an integer output must be an integer (bench.py feeds its ids as int32
    arrays into int64 declarations, and ops that slice or reshape them
    keep the fed width). Records each op type's input dtypes by slot."""

    def __init__(self, monkeypatch, block):
        from paddle_tpu_torch.core.dtypes import convert_dtype
        from paddle_tpu_torch.framework import executor

        self.inputs, self.checked = {}, 0
        real = executor.run_op

        def run_op(ctx, op, env):
            outs = real(ctx, op, env)
            for n in op.output_names():
                v = block._find_var_recursive(n) if n else None
                if v is None or n not in env:
                    continue
                got = convert_dtype(env[n].dtype)
                assert got == v.dtype or (_int(got) and _int(v.dtype)), \
                    (op.type, n, got, v.dtype)
                self.checked += 1
            seen = self.inputs.setdefault(op.type, {})
            for slot, names in op.inputs.items():
                for n in names:
                    if n and n in env:
                        seen.setdefault(slot, set()).add(
                            convert_dtype(env[n].dtype))
            return outs

        monkeypatch.setattr(executor, "run_op", run_op)


def bert_feed(cfg, seed):
    rng = np.random.RandomState(seed)
    mask = np.ones((BERT_B, BERT_S), np.float32)
    mask[1, 40:] = 0.0  # a padded tail of keys in one sample
    return {
        "ids": rng.randint(0, cfg.vocab_size, (BERT_B, BERT_S)).astype(
            "int32"),
        "types": rng.randint(0, cfg.type_vocab_size, (BERT_B, BERT_S)).astype(
            "int32"),
        "mask": mask,
        "mask_pos": rng.choice(BERT_B * BERT_S, BERT_P,
                               replace=False).astype("int32"),
        "labels": rng.randint(0, cfg.vocab_size, BERT_P).astype("int32"),
    }


def feeds_for(which, cfg):
    if which == "gpt":  # bench_gpt_longctx's int32 batches
        rng = np.random.RandomState(0)
        return [{"ids": rng.randint(0, cfg.vocab_size,
                                    (GPT_B, GPT_S)).astype("int32")}
                for _ in range(2)]
    return [bert_feed(cfg, 1), bert_feed(cfg, 2)]


# bf16 tolerances (a bf16 unit is 2^-8 relative); see the docstrings of
# test_torch_gpt_amp.py and test_torch_bert_amp.py for what was measured
LR = 1e-3
LOSS_RTOL = 2.0 ** -12
GRAD_L2 = 2.0 ** -4
FP32_GRAD_L2 = 2.0 ** -5
MOMENT_L2 = 2.0 ** -3
UPDATE_RTOL = UPDATE_AGREE = 2.0 ** -4
UPDATE_EXEMPT = 0.2


def check_two_amp_steps(which, flag, monkeypatch):
    """Two Adam steps (lr 1e-3) of the AMP bench program at tiny size,
    dropout 0, port vs JAX package from one carried state; the port's
    first-step gradients also against the JAX package's fp32 program.
    Returns the port's DtypeWatch."""
    from paddle_tpu_torch import convert

    jmain, jstartup, jloss, jpg, cfg, _ = build_bench(JAX, which, flag,
                                                      lr=LR)
    tmain, _, tloss, tpg, _, topt = build_bench(PORT, which, flag, lr=LR)
    jscope, jexe = JScope(), jf.Executor(jf.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    start = _jax_state(jscope)
    tscope = tf.Scope()
    convert.state_from_numpy(start, tscope, tf.CPUPlace(), program=tmain)
    declared = {v.name: v.dtype for v in tmain.list_vars()}
    for name in start:  # the carried state keeps each declared dtype
        got = str(tscope.find_var(name).dtype).split(".")[-1]
        assert got == declared[name], (name, got, declared[name])

    feeds = feeds_for(which, cfg)
    grads = [g.name for _, g in jpg]
    assert grads == [g.name for _, g in tpg]
    want = [[np.asarray(v) for v in jexe.run(
        jmain, feed=f, fetch_list=[jloss.name] + grads, scope=jscope)]
        for f in feeds]
    watch = DtypeWatch(monkeypatch, tmain.global_block)
    texe = tf.Executor(tf.CPUPlace())
    got = [texe.run(tmain, feed=f, fetch_list=[tloss.name] + grads,
                    scope=tscope) for f in feeds]
    assert watch.checked > len(tmain.global_block.ops)
    worst = dict(loss=0.0, grad=0.0, fp32=0.0, jax_fp32=0.0, moment=0.0,
                 update=0.0)
    for step, (w, g) in enumerate(zip(want, got)):
        rel = float(np.abs(g[0] - w[0]).max() / np.abs(w[0]).max())
        worst["loss"] = max(worst["loss"], rel)
        assert rel <= LOSS_RTOL, (step, g[0], w[0])
        for name, gv, wv in zip(grads, g[1:], w[1:]):
            assert gv.dtype == np.float32, name  # fp32 masters' grads
            r = _rel_l2(gv, wv)
            worst["grad"] = max(worst["grad"], r)
            assert r <= GRAD_L2, (step, name, r)

    # the JAX package's fp32 program on the first feed, from the start
    jmain32, _, _, jpg32, _, _ = build_bench(JAX, which, lists=None, lr=LR)
    assert [g.name for _, g in jpg32] == grads
    jscope32 = JScope()
    names32 = {v.name for v in jmain32.list_vars()}
    for n, v in start.items():
        if n in names32:
            jscope32.set_var(n, jnp.asarray(v))
    ref = jexe.run(jmain32, feed=feeds[0], fetch_list=grads, scope=jscope32)
    for name, gv, wv, rv in zip(grads, got[0][1:], want[0][1:], ref):
        r = _rel_l2(gv, rv)
        worst["fp32"] = max(worst["fp32"], r)
        assert r <= FP32_GRAD_L2, (name, r)
        # the JAX package's own bf16 distance from its fp32 program, the
        # scale of the port-vs-JAX bound (printed, not held)
        worst["jax_fp32"] = max(worst["jax_fp32"], _rel_l2(wv, rv))

    jend, tend = _jax_state(jscope), convert.state_to_numpy(tscope)
    assert set(tend) == set(jend)
    params = [p.name for p, _ in jpg]
    exempt = total = 0
    for i, name in enumerate(params):
        du = tend[name].astype(np.float64) - start[name]
        dw = jend[name].astype(np.float64) - start[name]
        noisy = np.zeros(dw.shape, bool)
        for g, w in zip(got, want):
            noisy |= (np.abs(g[1 + i] - w[1 + i])
                      > UPDATE_AGREE * np.abs(w[1 + i]))
        rel = (np.abs(du - dw) / (np.abs(dw) + LR))[~noisy]
        if rel.size:
            worst["update"] = max(worst["update"], float(rel.max()))
        assert not (rel > UPDATE_RTOL).any(), (name, rel.max())
        exempt += int(noisy.sum())
        total += noisy.size
    print(f"updates: {exempt} of {total} elements exempt")
    assert exempt < UPDATE_EXEMPT * total
    for name, w in jend.items():
        g = tend[name]
        if name in params:
            continue
        elif name.endswith(("_moment1_0", "_moment2_0")):
            r = _rel_l2(g, w)
            worst["moment"] = max(worst["moment"], r)
            assert r <= MOMENT_L2, (name, r)
        elif w.dtype.kind == "f":  # beta powers, loss_scaling
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
        else:  # good_steps, bad_steps
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert topt.state_dict(tscope) == {"loss_scaling": 1.0, "good_steps": 2,
                                       "bad_steps": 0}
    print(which, flag, {k: f"{v / 2 ** -8:.3g} bf16 units"
                        for k, v in worst.items()})
    return watch
