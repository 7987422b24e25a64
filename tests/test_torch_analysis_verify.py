"""Port parity for the static verifier (paddle_tpu_torch/analysis:
structural, shapes, collectives, memory, verify) against the JAX
package's (paddle_tpu/analysis) on the CPU, and the executor's wiring
and perf telemetry:

- the malformed programs of tests/test_program_analysis.py and
  tests/test_memory_analysis.py, built by one code path in both packages
  (use before def, a late producer, undeclared read and write, shape and
  dtype desync, an unknown op, a missing feed, a dead op, an unreachable
  var, an unknown mesh axis, a collective only one pipeline stage issues,
  a collective in one cond branch, use after donate, a clean program):
  the same findings (category, severity, op, names) from each package's
  verify_program. The port registers neither `pipeline_block` nor `cond`
  (ROADMAP items 7 and 10), so their cases compare the collective family
  alone; the mesh is a stand-in with the axes and sizes the analysis
  reads;
- PADDLE_TPU_VERIFY: strict makes the port's Executor.run raise
  ProgramVerifyError before any op runs, warn warns and runs, 0 runs
  silently; the verdict is cached per program version, feeds and
  fetches;
- perf telemetry: after a few CPU steps of a small program,
  perf.step_flops is the steps times Program.estimate().total_flops,
  perf.step_bytes likewise; perf.mfu, perf.step_seconds and
  perf.family_time.* appear from the second run of a plan on and are
  dropped when a new plan's first run comes; perf.cost_table and the
  plan's peak and resident bytes are published; a failed estimate is
  counted once and never tried again; Executor.flops names
  its ROADMAP item; a program file the port writes after a run carries
  no verdicts of the verifier (the JAX package reads it).
"""

import pickle
import types
import warnings

import numpy as np
import pytest

import paddle_tpu as jf
from paddle_tpu import analysis as jan
from paddle_tpu.framework import unique_name as jun

import paddle_tpu_torch as tf
from paddle_tpu_torch import analysis as tan
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.errors import (
    ProgramVerifyError,
    ProgramVerifyWarning,
    UnimplementedError,
)

JAX = (jf, jun, jan)
PORT = (tf, tf.unique_name, tan)


@pytest.fixture(autouse=True)
def modes_restored():
    yield
    tan.set_verify_mode(None)
    jan.set_verify_mode(None)


def _sub_block(main):
    """A sub-block of the global block (the bodies of the JAX package's
    control-flow and pipeline ops), made with the package's own Block."""
    blk = type(main.global_block)(main, len(main.blocks), 0)
    main.blocks.append(blk)
    return blk


def _mesh(**axes):
    """What the collective analysis reads of a mesh: its axis names and
    sizes."""
    return types.SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


def use_before_def(fluid, blk, main):
    fluid.data("x", [4, 4])
    blk.create_var(name="ghost", shape=[4, 4], dtype="float32")
    blk.create_var(name="out", shape=[4, 4], dtype="float32")
    blk.append_op("relu", {"X": ["ghost"]}, {"Out": ["out"]})
    return ("x",), ("out",), None


def late_producer(fluid, blk, main):
    fluid.data("x", [4, 4])
    blk.create_var(name="late", shape=[4, 4], dtype="float32")
    blk.create_var(name="out", shape=[4, 4], dtype="float32")
    blk.append_op("relu", {"X": ["late"]}, {"Out": ["out"]})
    blk.append_op("relu", {"X": ["x"]}, {"Out": ["late"]})
    return ("x",), ("out",), None


def undeclared(fluid, blk, main):
    fluid.data("x", [4, 4])
    blk.append_op("relu", {"X": ["x"]}, {"Out": ["nowhere_declared"]})
    blk.create_var(name="out", shape=[4, 4], dtype="float32")
    blk.append_op("relu", {"X": ["never_declared"]}, {"Out": ["out"]})
    return ("x",), ("out",), None


def shape_desync(fluid, blk, main):
    fluid.data("x", [4, 4])
    blk.create_var(name="out", shape=[9, 9], dtype="float32")
    blk.append_op("relu", {"X": ["x"]}, {"Out": ["out"]})
    return ("x",), ("out",), None


def dtype_desync(fluid, blk, main):
    fluid.data("x", [4, 4])
    blk.create_var(name="out", shape=[4, 4], dtype="int64")
    blk.append_op("relu", {"X": ["x"]}, {"Out": ["out"]})
    return ("x",), ("out",), None


def unknown_op(fluid, blk, main):
    fluid.data("x", [4, 4])
    blk.create_var(name="out", shape=[4, 4], dtype="float32")
    blk.append_op("definitely_not_an_op", {"X": ["x"]}, {"Out": ["out"]})
    return ("x",), ("out",), None


def missing_feed(fluid, blk, main):
    fluid.data("x", [4, 4])
    fluid.data("y", [4, 4])
    blk.create_var(name="out", shape=[4, 4], dtype="float32")
    blk.append_op("elementwise_add", {"X": ["x"], "Y": ["y"]},
                  {"Out": ["out"]})
    return ("x",), ("out",), None


def dead_and_unreachable(fluid, blk, main):
    x = fluid.data("x", [4, 4])
    live = fluid.layers.scale(x, scale=2.0)
    fluid.layers.scale(x, scale=3.0)  # never fetched, feeds nothing
    blk.create_var(name="orphan", shape=[2], dtype="float32")
    return ("x",), (live.name,), None


def unknown_mesh_axis(fluid, blk, main):
    fluid.data("x", [8, 4])
    blk.create_var(name="red", shape=[8, 4], dtype="float32")
    blk.append_op("c_allreduce_sum", {"X": ["x"]}, {"Out": ["red"]},
                  {"axis_name": "dpp"})  # typo'd axis
    main._mesh = _mesh(dp=8)
    return ("x",), ("red",), None


def divergent_pipeline(fluid, blk, main):
    """Two pipeline stages; only stage 0 issues an all-reduce over dp."""
    fluid.data("x", [8, 4])
    blk.create_var(name="h", shape=[8, 4], dtype="float32")
    stages = []
    for poison in (True, False):
        stage = _sub_block(main)
        stage.append_op("relu", {"X": ["x"]}, {"Out": ["h"]})
        if poison:
            stage.append_op("c_allreduce_sum", {"X": ["h"]}, {"Out": ["h"]},
                            {"axis_name": "dp"})
        stages.append(stage.idx)
    blk.append_op("pipeline_block", {"X": ["x"]}, {"Out": ["h"]},
                  {"stage_blocks": stages, "axis_name": "pp"})
    main._mesh = _mesh(dp=4, pp=2)
    return ("x",), ("h",), ("collectives",)


def divergent_cond(fluid, blk, main):
    fluid.data("x", [8, 4])
    fluid.data("c", [1], "bool")
    tb = _sub_block(main)
    tb.append_op("c_allreduce_sum", {"X": ["x"]}, {"Out": ["x"]},
                 {"axis_name": "dp"})
    fb = _sub_block(main)
    blk.create_var(name="out", shape=[8, 4], dtype="float32")
    blk.append_op(
        "cond", {"Cond": ["c"], "TrueIn": ["x"], "FalseIn": ["x"]},
        {"Out": ["out"]},
        {"true_block": tb.idx, "false_block": fb.idx,
         "true_out_names": ["x"], "false_out_names": ["x"]},
    )
    main._mesh = _mesh(dp=8)
    return ("x", "c"), ("out",), ("collectives",)


def use_after_donate(fluid, blk, main):
    fluid.data("rows", [1, 4, 8])
    fluid.data("pos", [1], dtype="int32")
    for n in ("cache", "cache_new"):
        blk.create_var(name=n, shape=[16, 4, 8], dtype="float32",
                       persistable=True)
    blk.append_op("kv_cache_write", {"Cache": ["cache"], "X": ["rows"],
                                     "Pos": ["pos"]}, {"Out": ["cache_new"]})
    blk.create_var(name="reader", shape=[16, 4, 8], dtype="float32")
    blk.append_op("scale", {"X": ["cache"]}, {"Out": ["reader"]},
                  {"scale": 2.0})
    return ("rows", "pos"), ("reader",), None


def clean(fluid, blk, main):
    x = fluid.data("x", [4, 4])
    loss = fluid.layers.mean(fluid.layers.fc(x, 3))
    fluid.optimizer.SGD(0.1).minimize(loss)
    return ("x",), (loss.name,), None


CASES = {f.__name__: f for f in (
    use_before_def, late_producer, undeclared, shape_desync, dtype_desync,
    unknown_op, missing_feed, dead_and_unreachable, unknown_mesh_axis,
    divergent_pipeline, divergent_cond, use_after_donate, clean)}
EXPECT = {  # the categories each case must find (beside what both agree)
    "use_before_def": {"use-before-def"},
    "late_producer": {"use-before-def"},
    "undeclared": {"undeclared-write", "undeclared-var"},
    "shape_desync": {"shape-desync"},
    "dtype_desync": {"dtype-desync"},
    "unknown_op": {"unknown-op"},
    "missing_feed": {"missing-feed"},
    "dead_and_unreachable": {"dead-op", "unreachable-var"},
    "unknown_mesh_axis": {"unknown-mesh-axis"},
    "divergent_pipeline": {"collective-divergence"},
    "divergent_cond": {"collective-branch-divergence"},
    "use_after_donate": {"use-after-donate"},
    "clean": set(),
}


def _verify(pkg, case):
    fluid, unique_name, analysis = pkg
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        feeds, fetches, families = CASES[case](fluid, main.global_block,
                                               main)
    kw = {} if families is None else dict(families=families)
    return analysis.verify_program(main, feeds, fetches, **kw)


def _findings(report):
    return sorted((f.category, f.severity.name, f.op_index, f.op_type,
                   tuple(f.names)) for f in report.findings)


@pytest.mark.parametrize("case", sorted(CASES))
def test_findings_match_the_jax_package(case):
    want = _verify(JAX, case)
    got = _verify(PORT, case)
    assert _findings(got) == _findings(want)
    cats = {f.category for f in got.findings}
    assert EXPECT[case] <= cats, cats
    assert got.ok == want.ok == (not got.errors)
    assert [f.category for f in got.strict_errors()] == [
        f.category for f in want.strict_errors()]


def _broken(case):
    main, startup = tf.Program(), tf.Program()
    with tf.unique_name.guard(), tf.program_guard(main, startup):
        feeds, fetches, _ = CASES[case](tf, main.global_block, main)
    feed = {n: np.ones(main.global_block.var(n).shape, "float32")
            for n in feeds}
    return main, feed, list(fetches)


@pytest.mark.parametrize("case,match", [("use_before_def", "use-before-def"),
                                        ("shape_desync", "shape-desync")])
def test_strict_mode_refuses_the_run_before_any_op(case, match,
                                                    monkeypatch):
    from paddle_tpu_torch.framework import executor

    main, feed, fetches = _broken(case)
    ran = []
    monkeypatch.setattr(executor, "run_op",
                        lambda *a: ran.append(a) or {})
    tan.set_verify_mode("strict")
    with pytest.raises(ProgramVerifyError, match=match) as ei:
        tf.Executor(tf.CPUPlace()).run(main, feed=feed, fetch_list=fetches,
                                       scope=tf.Scope())
    assert ei.value.findings and not ran


def test_warn_mode_warns_and_runs_and_off_is_silent():
    main, startup = tf.Program(), tf.Program()
    with tf.unique_name.guard(), tf.program_guard(main, startup):
        x = tf.data("x", [4, 4])
        out = tf.layers.scale(x, scale=2.0)
        main.global_block.append_op("relu", {"X": [out.name]},
                                    {"Out": ["undeclared_sink"]})
    feed = {"x": np.ones((4, 4), "float32")}
    tan.set_verify_mode("warn")
    with pytest.warns(ProgramVerifyWarning, match="undeclared-write"):
        (got,) = tf.Executor(tf.CPUPlace()).run(
            main, feed=feed, fetch_list=[out], scope=tf.Scope())
    np.testing.assert_allclose(got, 2.0 * np.ones((4, 4)))
    main._bump()  # a new version: verified again
    tan.set_verify_mode("off")
    with warnings.catch_warnings():
        warnings.simplefilter("error", ProgramVerifyWarning)
        tf.Executor(tf.CPUPlace()).run(main, feed=feed, fetch_list=[out],
                                       scope=tf.Scope())


def test_verify_mode_parses_the_env_as_the_jax_package(monkeypatch):
    for raw in ("strict", "warn", "0", "off", "", "garbage"):
        monkeypatch.setenv("PADDLE_TPU_VERIFY", raw)
        assert tan.verify_mode() == jan.verify_mode()
    monkeypatch.delenv("PADDLE_TPU_VERIFY")
    assert tan.verify_mode() == "warn"
    with pytest.raises(ValueError):
        tan.set_verify_mode("not-a-mode")


def _line(B=None):
    main, startup = tf.Program(), tf.Program()
    main.random_seed = startup.random_seed = 5
    with tf.unique_name.guard(), tf.program_guard(main, startup):
        x = tf.data("x", [-1 if B is None else B, 13])
        y = tf.data("y", [-1 if B is None else B, 1])
        pred = tf.layers.fc(x, 1)
        loss = tf.layers.mean(tf.layers.square_error_cost(pred, y))
        tf.optimizer.SGD(0.01).minimize(loss)
    return main, startup, loss


def _feed(B, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(B, 13).astype("float32"),
            "y": rng.randn(B, 1).astype("float32")}


def test_verify_runs_once_per_program_version_feeds_and_fetches():
    main, startup, loss = _line()
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    before = obs.get_counters().get("analysis.programs_verified", 0)
    for B in (4, 8, 4):  # two plans of one program version
        exe.run(main, feed=_feed(B), fetch_list=[loss], scope=scope)
    exe.run(main, feed=_feed(4), fetch_list=[], scope=scope)  # new fetches
    assert obs.get_counters()["analysis.programs_verified"] == before + 2


def test_perf_telemetry_counts_the_estimate_each_step():
    main, startup, loss = _line()
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    obs.reset()
    steps = 4
    for i in range(steps):
        exe.run(main, feed=_feed(16, i), fetch_list=[loss], scope=scope)
        gauges = obs.get_gauges()
        # no steady-state gauge from the run that built the plan
        assert ("perf.mfu" in gauges) == (i > 0)
    est = main.estimate(feed_shapes={"x": (16, 13), "y": (16, 1)})
    snap = obs.snapshot()
    assert snap["counters"]["perf.step_flops"] == steps * int(
        est.total_flops)
    assert snap["counters"]["perf.step_bytes"] == steps * int(
        est.total_bytes)
    g = snap["gauges"]
    assert g["perf.peak_bytes_est"] == est.peak_bytes
    assert g["perf.resident_bytes_est"] == est.resident_bytes
    assert g["perf.mfu"] == pytest.approx(
        est.total_flops / g["perf.step_seconds"] / est.peak_flops)
    fams = {k[len("perf.family_time."):] for k in g
            if k.startswith("perf.family_time.")}
    assert fams == set(est.by_family())
    assert snap["tables"]["perf.cost_table"]["total_flops"] == \
        est.total_flops
    # a new plan's first run drops the previous plan's steady gauges
    exe.run(main, feed=_feed(8), fetch_list=[loss], scope=scope)
    g = obs.get_gauges()
    assert not [k for k in g if k.startswith(("perf.mfu",
                                              "perf.step_seconds",
                                              "perf.family_time."))]
    assert "perf.estimate_failures" not in obs.get_counters()


def test_monitor_off_skips_the_estimate_and_flops_names_its_item():
    main, startup, loss = _line(B=4)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    obs.reset()
    obs.set_enabled(False)
    try:
        exe.run(main, feed=_feed(4), fetch_list=[loss], scope=scope)
    finally:
        obs.set_enabled(None)
    assert not obs.get_counters() and not obs.get_tables()
    with pytest.raises(UnimplementedError, match="item 8"):
        exe.flops(main, feed=_feed(4), fetch_list=[loss], scope=scope)


def test_saved_programs_carry_no_verdicts(tmp_path):
    from paddle_tpu_torch import io as tio

    main, startup, loss = _line(B=4)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(4), fetch_list=[loss], scope=scope)
    assert main.__dict__["_verify_cache"]
    path = str(tmp_path / "line")
    with tf.scope_guard(scope):
        tio.save(main, path)
    with open(path + ".pdmodel", "rb") as f:
        jprog = pickle.load(f)  # as the JAX package's Program
    assert type(jprog) is jf.Program
    assert "_verify_cache" not in jprog.__dict__


def test_a_failed_estimate_is_counted_once_and_never_retried(monkeypatch):
    main, startup, loss = _line(B=4)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    calls = []

    def broken(*args, **kwargs):
        calls.append(1)
        raise ValueError("no estimate")

    monkeypatch.setattr(type(main), "estimate", broken)
    obs.reset()
    for _ in range(3):
        exe.run(main, feed=_feed(4), fetch_list=[loss], scope=scope)
    assert len(calls) == 1
    assert obs.get_counters()["perf.estimate_failures"] == 1
    assert not [k for k in obs.get_counters() if k.startswith("perf.step")]
    assert not [k for k in obs.get_gauges() if k.startswith("perf.")]
