"""Port parity for the CTR training slice: bench.py's deepfm program at
its CPU config (DeepFMConfig(1000, 6, 8, (16,), 4): 1000 ids over 6
sparse fields, 8 factors, a 16-wide tower, 4 dense features; B=64,
Adam(1e-3)), in bench's plain layout and bench deepfm_fused's per-slot
layout, unfused and fused by embedding.fuse_lookups, built and trained by
paddle_tpu_torch and by the JAX package on the CPU.

Both programs are built from a fresh unique_name state, so their
variable names match; the port starts from the JAX package's startup
state (convert.state_from_numpy). Feeds are bench's: uniform ids, uniform
dense features, labels 1 with probability 0.3, from RandomState(0).

Tolerances from readings, fp32 on both sides, the tower's products and
the segment sums in other orders (measured in parentheses, the worst of
the three layouts): each of 3 losses rtol 1e-6 (7.2e-8), every
parameter, Adam moment and beta power after the 3 steps atol 1e-6 + rtol
1e-5 (8.4e-8 absolute on values up to 0.3; the beta powers 1.2e-7
relative). The per-slot layouts' steps are in
test_torch_deepfm_training_slots.py, so that parallel test workers run
the JAX side's compiles side by side.
"""

import numpy as np

import paddle_tpu as jf
from paddle_tpu.embedding import fuse_lookups as jfuse
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.deepfm import DeepFMConfig as JConfig
from paddle_tpu.models.deepfm import deepfm as jdeepfm

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch.embedding import fuse_lookups as tfuse
from paddle_tpu_torch.models import DeepFMConfig as TConfig
from paddle_tpu_torch.models import deepfm as tdeepfm

from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

JAX = (jf, jun, JConfig, jdeepfm, jfuse, JScope, jf.CPUPlace())
PORT = (tf, tf.unique_name, TConfig, tdeepfm, tfuse, tf.Scope,
        tf.CPUPlace())
B, STEPS = 64, 3
LAYOUTS = {"plain": (False, False), "per_slot": (True, False),
           "fused": (True, True)}
LOSS_RTOL = 1e-6
STATE_TOL = dict(atol=1e-6, rtol=1e-5)


def build(pkg, layout):
    """bench.py's deepfm program at its CPU config, per_slot and fused
    as `layout` says. Returns (main, startup, loss, pred)."""
    fluid, unique_name, config, deepfm, fuse, _, _ = pkg
    per_slot, fused = LAYOUTS[layout]
    cfg = config(vocab_size=1000, num_fields=6, embed_dim=8,
                 mlp_sizes=(16,), dense_dim=4)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with unique_name.guard(), fluid.program_guard(main, startup):
        feat = fluid.data("feat", [B, cfg.num_fields], "int64")
        dense = fluid.data("dense", [B, cfg.dense_dim], "float32")
        label = fluid.data("label", [B, 1], "float32")
        loss, pred = deepfm(feat, label, cfg, dense_input=dense,
                            per_slot=per_slot)
        if fused:
            assert fuse(main) == 2
        fluid.optimizer.Adam(1e-3).minimize(loss, startup)
    return main, startup, loss, pred


def batches():
    """bench deepfm's batches at its CPU size."""
    rng = np.random.RandomState(0)
    return [{"feat": rng.randint(0, 1000, (B, 6)).astype("int64"),
             "dense": rng.rand(B, 4).astype("float32"),
             "label": (rng.rand(B, 1) < 0.3).astype("float32")}
            for _ in range(STEPS)]


def train(pkg, layout, state=None):
    """STEPS Adam steps from the package's own startup state, or from
    `state`. Returns (start state, [(loss, pred)], end state, main)."""
    fluid, _, _, _, _, scope_cls, place = pkg
    main, startup, loss, pred = build(pkg, layout)
    scope, exe = scope_cls(), fluid.Executor(place)
    if state is None:
        exe.run(startup, scope=scope)
    else:
        convert.state_from_numpy(state, scope, place, program=main)
    start = {n: np.asarray(scope.find_var(n)).copy()
             for n in scope.local_var_names()}
    outs = [[np.asarray(v) for v in exe.run(
        main, feed=f, fetch_list=[loss, pred], scope=scope)]
        for f in batches()]
    end = {n: np.asarray(scope.find_var(n)) for n in scope.local_var_names()}
    return start, outs, end, main


def check_three_adam_steps(layout):
    start, jouts, jend, _ = train(JAX, layout)
    _, touts, tend, tmain = train(PORT, layout, start)
    for step, ((jl, jp), (tl, tp)) in enumerate(zip(jouts, touts)):
        assert np.isfinite(tl).all() and tp.shape == (B, 1)
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL,
                                   err_msg=f"loss, step {step}")
    assert set(tend) == set(jend)
    moved = 0
    for name, want in jend.items():
        got = tend[name]
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, err_msg=name, **STATE_TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
        moved += not np.array_equal(start[name], want)
    params = [p for p in tmain.all_parameters() if p.trainable]
    # every parameter, its two moments and two beta powers
    assert moved == 5 * len(params)
    lookups = {op.type for op in tmain.global_block.ops} & {
        "distributed_lookup_table", "fused_lookup_table"}
    assert lookups == ({"fused_lookup_table"} if layout == "fused"
                       else {"distributed_lookup_table"})


def test_three_adam_steps_match_the_jax_package():
    check_three_adam_steps("plain")


def test_fused_and_unfused_forwards_are_bitwise_equal_in_the_port():
    """From one state, the three layouts give the same loss and the same
    predictions bit for bit on the first step (the gathers are exact, the
    tower is the same)."""
    start = train(PORT, "plain")[0]
    firsts = {layout: train(PORT, layout, start)[1][0]
              for layout in LAYOUTS}
    for layout in ("per_slot", "fused"):
        for got, want in zip(firsts[layout], firsts["plain"]):
            np.testing.assert_array_equal(got, want, err_msg=layout)


def _plain(attrs):
    # dunder attrs are bookkeeping (uid, build site); __vjp__'s copy of
    # its forward op's attrs holds them too
    return {k: v for k, v in (attrs or {}).items()
            if not k.startswith("__") and k != "fwd_attrs"}


def test_fuse_lookups_builds_the_jax_packages_program():
    """The per-slot program fused and minimized: the same op sequence
    (types, inputs, outputs, attrs) and variables in both packages."""
    jmain = build(JAX, "fused")[0]
    tmain = build(PORT, "fused")[0]
    jops, tops = jmain.global_block.ops, tmain.global_block.ops
    assert [op.type for op in tops] == [op.type for op in jops]
    assert sum(op.type == "fused_lookup_table" for op in tops) == 2
    for jop, top in zip(jops, tops):
        assert top.inputs == jop.inputs and top.outputs == jop.outputs, top
        assert _plain(top.attrs) == _plain(jop.attrs), top.type
        assert _plain(top.attr("fwd_attrs")) == \
            _plain(jop.attr("fwd_attrs")), top
    jvars = {v.name: v for v in jmain.list_vars()}
    tvars = {v.name: v for v in tmain.list_vars()}
    assert set(tvars) == set(jvars)
    for name, jv in jvars.items():
        assert tvars[name].shape == jv.shape, name
        assert tvars[name].persistable == jv.persistable, name

