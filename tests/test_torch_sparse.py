"""Port parity for the lookup ops (paddle_tpu_torch/ops/sparse.py):
``distributed_lookup_table`` and ``fused_lookup_table`` against the JAX
package's, on the CPU (their static-size unique against jnp.unique is in
test_torch_sparse_unique.py).

- The lookups' forwards are bitwise equal to the JAX package's (a gather
  is exact): dedup on and off, [B, 1] ids, and two tables of one width
  fused through slot_table_idx. Both packages start from the JAX
  package's startup state.
- The table gradients agree within rtol 1e-6, room for a repeated id's
  row gradients summed in another order (measured on the CPU: equal bit
  for bit).
- Shape inference runs the ops on meta tensors; a meshed lookup axis
  raises; the trace-time counters count once per first run.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu import layers as jl
from paddle_tpu.embedding import fuse_lookups as jfuse
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert, observability
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.embedding import fuse_lookups as tfuse
from paddle_tpu_torch.errors import UnimplementedError
from paddle_tpu_torch.framework.registry import (
    EmitContext,
    OpView,
    get_op_def,
    infer_shapes,
)

from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

JAX = (jf, jl, jun, jfuse, JScope, jf.CPUPlace())
PORT = (tf, tl, tf.unique_name, tfuse, tf.Scope, tf.CPUPlace())
GRAD_RTOL = 1e-6


def build(pkg, case, dedup):
    """A lookup program: `single` one sparse_embedding over [B, F] ids,
    `column` one over [B, 1] ids, `fused` F per-slot lookups over two
    tables of one width (slots alternate between them) fused into one
    op. The loss is sum(out^2 * c), c a fixed tensor, so every row's
    gradient depends on the occurrence. Returns (main, startup, outs,
    loss)."""
    fluid, layers, unique_name, fuse, _, _ = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    b, f, v, d = 12, 5, 37, 6
    with unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("ids", [b, 1 if case == "column" else f], "int64")
        if case == "fused":
            outs = [layers.sparse_embedding(
                layers.slice(ids, [1], [i], [i + 1]), [v, d],
                param_attr=fluid.ParamAttr(name=f"tab{i % 2}"),
                dedup=dedup) for i in range(f)]
            assert fuse(main) == 1
        else:
            outs = [layers.sparse_embedding(
                ids, [v, d], param_attr=fluid.ParamAttr(name="tab0"),
                dedup=dedup)]
        width = f * d if case == "single" else d
        c = fluid.data("c", [b, width], "float32")
        parts = [layers.reduce_sum(layers.elementwise_mul(
            layers.square(layers.reshape(o, [b, width])), c)) for o in outs]
        loss = parts[0]
        for p in parts[1:]:
            loss = loss + p
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, outs, loss


def feed(case):
    rng = np.random.RandomState(3)
    f = 1 if case == "column" else 5
    # ids over [0, 40): the padded vocab (40) is reached, repeats are many
    return {"ids": rng.randint(0, 40, (12, f)).astype(np.int64),
            "c": rng.rand(12, 30 if case == "single" else 6).astype(
                np.float32)}


def run(pkg, case, dedup, state=None):
    fluid, _, _, _, scope_cls, place = pkg
    main, startup, outs, loss = build(pkg, case, dedup)
    scope, exe = scope_cls(), fluid.Executor(place)
    if state is None:
        exe.run(startup, scope=scope)
        state = {n: np.asarray(scope.find_var(n))
                 for n in scope.local_var_names()}
    else:
        convert.state_from_numpy(state, scope, place, program=main)
    tables = sorted(n for n in state if n.startswith("tab"))
    fetch = [o.name for o in outs] + [f"{t}@GRAD" for t in tables]
    vals = [np.asarray(v) for v in exe.run(main, feed=feed(case),
                                           fetch_list=fetch, scope=scope)]
    return main, state, vals[:len(outs)], vals[len(outs):]


@pytest.mark.parametrize("dedup", [True, False], ids=["dedup", "no_dedup"])
@pytest.mark.parametrize("case", ["single", "column", "fused"])
def test_lookup_forward_bitwise_and_grads_match_the_jax_package(case,
                                                                dedup):
    jmain, state, jouts, jgrads = run(JAX, case, dedup)
    tmain, _, touts, tgrads = run(PORT, case, dedup, state)
    kind = "fused_lookup_table" if case == "fused" \
        else "distributed_lookup_table"
    jops = [op for op in jmain.global_block.ops if op.type == kind]
    tops = [op for op in tmain.global_block.ops if op.type == kind]
    assert len(tops) == len(jops) == 1
    keep = ("axis_name", "dedup", "slot_table_idx", "partition", "quant")
    assert {k: v for k, v in tops[0].attrs.items() if k in keep} \
        == {k: v for k, v in jops[0].attrs.items() if k in keep}
    if case == "fused":
        assert tops[0].attr("slot_table_idx") == [0, 1, 0, 1, 0]
        assert tops[0].inputs["W"] == ["tab0", "tab1"]
    for t, j in zip(touts, jouts):
        assert t.shape == j.shape
        np.testing.assert_array_equal(t, j)
    assert len(tgrads) == len(jgrads) == (2 if case == "fused" else 1)
    for t, j in zip(tgrads, jgrads):
        assert np.count_nonzero(j) > 0
        np.testing.assert_allclose(t, j, rtol=GRAD_RTOL, atol=0)


def test_infer_shapes_runs_the_lookups_on_meta_tensors():
    """A -1 batch passes through both ops' shape pass: [-1, F] ids give
    [-1, F, D], [-1, 1] ids [-1, D]; the pass counts nothing."""
    observability.reset()
    main = tf.Program()
    with tf.program_guard(main, tf.Program()), tf.unique_name.guard():
        ids = tf.data("ids", [-1, 4], "int64")
        col = tf.data("col", [-1, 1], "int64")
        out = tl.sparse_embedding(ids, [30, 3],
                                  param_attr=tf.ParamAttr(name="t"))
        one = tl.sparse_embedding(col, [30, 3],
                                  param_attr=tf.ParamAttr(name="t"))
        blk = main.global_block
        spec = infer_shapes("fused_lookup_table", blk,
                            {"Ids": ["ids", "col"], "W": ["t"]},
                            {"slot_table_idx": [0, 0]})
    assert out.shape == (-1, 4, 3) and one.shape == (-1, 3)
    assert blk.var("t").shape == (32, 3)  # vocab padded to 8
    assert spec == {"Out": [((-1, 4, 3), "float32"),
                            ((-1, 3), "float32")]}
    assert not observability.get_counters()


def test_a_meshed_lookup_axis_raises():
    """The sharded tables are not ported: a lookup whose axis is a mesh
    axis of the run raises, and does not fall back to a local gather."""
    mesh = SimpleNamespace(axis_names=("ps",), shape={"ps": 2})
    ctx = EmitContext("cpu", mesh=mesh)
    ins = {"Ids": [torch.zeros(4, 1, dtype=torch.long)],
           "W": [torch.zeros(8, 2)]}
    for kind in ("distributed_lookup_table", "fused_lookup_table"):
        with pytest.raises(UnimplementedError, match="ROADMAP"):
            get_op_def(kind).emit(ctx, OpView(kind, {}), ins)
    # another axis name runs meshless
    out = get_op_def("fused_lookup_table").emit(
        ctx, OpView("fused_lookup_table", {"axis_name": "mp"}), ins)
    assert out["Out"][0].shape == (4, 2)


def test_trace_counters_count_each_first_run_once():
    """embedding.fused_lookup_{sites,tables} count once per executor
    cache entry (program, version, feed signature, fetch set), where the
    JAX package counts once per trace; the __vjp__ replay and later runs
    count nothing. (The executor's other counters, analysis.* and
    perf.*, count each run and plan too: only embedding.* is read.)"""
    def counters():
        return {k: v for k, v in observability.get_counters().items()
                if k.startswith("embedding.")}

    main, startup, _, loss = build(PORT, "fused", True)
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    exe.run(startup, scope=scope)
    observability.reset()
    for _ in range(3):
        exe.run(main, feed=feed("fused"), fetch_list=[loss], scope=scope)
    want = {"embedding.fused_lookup_sites": 1,
            "embedding.fused_lookup_tables": 2}
    assert counters() == want
    # PADDLE_TPU_MONITOR=0's switch: a new executor's first run counts
    # nothing while it is off
    observability.set_enabled(False)
    try:
        tf.Executor(tf.CPUPlace()).run(main, feed=feed("fused"),
                                       fetch_list=[loss], scope=scope)
    finally:
        observability.set_enabled(None)
    assert counters() == want
    # another fetch set is another cache entry: a trace of its own
    exe.run(main, feed=feed("fused"), fetch_list=[], scope=scope)
    assert counters() == {k: 2 * v for k, v in want.items()}
