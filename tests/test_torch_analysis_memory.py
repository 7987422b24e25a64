"""Port parity for the static memory plan (paddle_tpu_torch/analysis/
memory.py: plan_memory, hbm_budget, the donation verifier) against the
JAX package's (paddle_tpu/analysis/memory.py) on the CPU: the programs
of tests/torch_analysis_programs.py (bench.py's gpt_s4096 and gpt_s8192
legs at GPT-small full width under `_amp`, bench_bert at
BertConfig.base(), B=32, S=512 under `_amp`, ResNet-18 and DeepFM at the
port's test sizes) give the same plan exactly: peak, resident, feed and
transient bytes, the watermark op and its live bytes, the findings and
assumptions (but for the build frame, `__loc__`, which the JAX package's
ops record and the port's do not). Graph walks only: no startup run and
no arrays.

Also: PADDLE_TPU_HBM_BYTES parses the same way in both packages (None
when unset); an over-budget plan gives the same oom-risk finding; the
memory family's findings on small programs (use-after-donate,
missed-donation) agree; and on the CPU the executor's
memory_analysis reports nothing, with its counter bumped.
"""

import numpy as np
import pytest

import paddle_tpu as jf
from paddle_tpu.analysis import memory as jmem

import paddle_tpu_torch as tf
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.analysis import memory as tmem

from torch_analysis_programs import PROGRAMS, pair


def _findings(findings):
    return sorted((f.category, int(f.severity), f.op_index, f.op_type,
                   tuple(f.names)) for f in findings)


def _plan(table):
    return dict(peak=table.peak_bytes, resident=table.resident_bytes,
                feeds=table.feed_bytes,
                transient=table.transient_peak_bytes,
                watermark={k: v for k, v in table.watermark.items()
                           if k != "loc"},
                residents=table.residents,
                stage_peaks=table.stage_peaks,
                assumptions=table.assumptions,
                findings=_findings(table.findings),
                timeline=[(t["op_index"], t["op_type"], t["live_bytes"],
                           t["n_live"]) for t in table.timeline])


@pytest.mark.parametrize("name", PROGRAMS)
def test_plan_matches_the_jax_package(name):
    jmain, tmain, feeds = pair(name)
    want = jmem.plan_memory(jmain, feed_shapes=feeds, budget=None)
    got = tmem.plan_memory(tmain, feed_shapes=feeds, budget=None)
    assert got.peak_bytes > got.resident_bytes > 0
    assert _plan(got) == _plan(want)
    # Program.estimate carries the same plan
    est = tmain.estimate(feed_shapes=feeds)
    assert (est.peak_bytes, est.resident_bytes) == (got.peak_bytes,
                                                    got.resident_bytes)


@pytest.mark.parametrize("raw", [None, "", "1073741824", "16G", "512m",
                                 "1.5k", "2t", "bad", "0", "-4G"])
def test_hbm_budget_parses_as_the_jax_package(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("PADDLE_TPU_HBM_BYTES", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_HBM_BYTES", raw)
    assert tmem.hbm_budget() == jmem.hbm_budget()
    if raw is None:
        assert tmem.hbm_budget() is None


def test_over_budget_plan_gives_the_same_oom_risk(monkeypatch):
    jmain, tmain, feeds = pair("resnet18")
    monkeypatch.setenv("PADDLE_TPU_HBM_BYTES", "64M")
    want = jmem.plan_memory(jmain, feed_shapes=feeds)
    got = tmem.plan_memory(tmain, feed_shapes=feeds)
    assert got.budget_bytes == 64 * 2 ** 20
    assert [f.category for f in got.findings] == ["oom-risk"]
    assert _findings(got.findings) == _findings(want.findings)
    assert got.findings[0].message == want.findings[0].message


def _donation(fluid, read_after):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        fluid.data("rows", [1, 4, 8])
        fluid.data("pos", [1], dtype="int32")
        blk = main.global_block
        for n in ("cache", "cache_new"):
            blk.create_var(name=n, shape=[16, 4, 8], dtype="float32",
                           persistable=True)
        blk.append_op("kv_cache_write", {"Cache": ["cache"], "X": ["rows"],
                                         "Pos": ["pos"]},
                      {"Out": ["cache_new"]})
        blk.create_var(name="reader", shape=[16, 4, 8], dtype="float32")
        blk.append_op("scale", {"X": ["cache" if read_after
                                      else "cache_new"]},
                      {"Out": ["reader"]}, {"scale": 2.0})
        blk.create_var(name="table", shape=[256, 256], dtype="float32",
                       persistable=True)
        blk.create_var(name="table_scaled", shape=[256, 256],
                       dtype="float32")
        blk.append_op("scale", {"X": ["table"]}, {"Out": ["table_scaled"]},
                      {"scale": 0.99})
    return main


@pytest.mark.parametrize("read_after", [True, False])
def test_donation_findings_match_the_jax_package(read_after):
    feeds, fetches = ("rows", "pos"), ("reader", "table_scaled")
    want = jmem.plan_memory(_donation(jf, read_after), feed_names=feeds,
                            fetch_names=fetches, budget=None)
    got = tmem.plan_memory(_donation(tf, read_after), feed_names=feeds,
                           fetch_names=fetches, budget=None)
    cats = sorted(f.category for f in got.findings)
    assert cats == (["missed-donation", "use-after-donate"] if read_after
                    else ["missed-donation"])
    assert _findings(got.findings) == _findings(want.findings)
    assert _plan(got) == _plan(want)


def test_memory_analysis_reports_nothing_on_the_cpu():
    main, startup = tf.Program(), tf.Program()
    with tf.unique_name.guard(), tf.program_guard(main, startup):
        x = tf.data("x", [4, 8])
        loss = tf.layers.mean(tf.layers.fc(x, 3))
        tf.optimizer.SGD(0.1).minimize(loss)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    before = obs.get_counters().get("perf.memory_analysis_unavailable", 0)
    feed = {"x": np.ones((4, 8), "float32")}
    assert exe.memory_analysis(main, feed=feed, fetch_list=[loss],
                               scope=scope) is None
    assert obs.get_counters()["perf.memory_analysis_unavailable"] \
        == before + 1
