"""Port parity for the IR cost model (paddle_tpu_torch/analysis/cost.py,
Program.estimate) against the JAX package's (paddle_tpu/analysis/cost.py)
on the CPU: the same programs, built from one code path in both packages
(tests/torch_analysis_programs.py: bench.py's gpt_s4096 and gpt_s8192
legs at GPT-small full width under `_amp`, bench_bert at BertConfig.base(),
B=32, S=512 under `_amp`, ResNet-18 and DeepFM at the port's test sizes),
give the same table exactly: total FLOPs and bytes, every op row (type,
family, FLOPs, bytes, count, position), the roofline at one given peak,
the assumptions and the static memory plan it carries (but for the build
frame, `__loc__`, which the JAX package's ops record and the port's do
not). Graph walks only:
no startup run and no arrays.

Also: the port's default peaks are the H100's (989.4 TFLOP/s dense bf16,
3.35 TB/s), with the JAX package's environment overrides; the cost
model's step FLOPs of the two legs lie within bench.py's 20% of its
retired closed form (bench.py:442); a program with unpinned -1 dims
records the same assumptions in both packages.
"""

import pytest

import paddle_tpu as jf
from paddle_tpu.analysis import cost as jcost
from paddle_tpu.framework import unique_name as jun

import paddle_tpu_torch as tf
from paddle_tpu_torch.analysis import cost as tcost

from torch_analysis_programs import LEGS, PROGRAMS, pair

H100 = dict(peak_tflops=989.4, peak_gbps=3350.0)


def _rows(table):
    return [(e.op_type, e.family, e.flops, e.bytes, e.latency, e.count,
             e.block_idx, e.op_index) for e in table.ops]


@pytest.mark.parametrize("name", PROGRAMS)
def test_estimate_matches_the_jax_package(name):
    jmain, tmain, feeds = pair(name)
    want = jmain.estimate(feed_shapes=feeds, **H100)
    got = tmain.estimate(feed_shapes=feeds, **H100)
    assert len(got.ops) == len(want.ops) > 0
    assert _rows(got) == _rows(want)
    assert got.total_flops == want.total_flops > 0
    assert got.total_bytes == want.total_bytes
    assert got.total_latency == want.total_latency
    assert got.by_family() == want.by_family()
    assert got.assumptions == want.assumptions
    assert (got.peak_bytes, got.resident_bytes) == (want.peak_bytes,
                                                    want.resident_bytes)
    assert _where(got.memory.watermark) == _where(want.memory.watermark)


def _where(watermark):
    """The watermark but its `loc`: the JAX package's ops record the user
    frame that built them (`__loc__`), the port's do not."""
    return {k: v for k, v in watermark.items() if k != "loc"}


@pytest.mark.parametrize("name", sorted(LEGS))
def test_leg_step_flops_stay_near_bench_pys_closed_form(name):
    """bench_gpt_longctx's retired closed form (bench.py:442; causal
    attention at s/2 key positions a token): bench.py warns past 20%."""
    _, tmain, feeds = pair(name)
    b, s = LEGS[name]
    h, L, V = 768, 12, 32000
    legacy = 3 * (L * (24 * h * h + 4 * (s // 2) * h) + 2 * h * V) * b * s
    est = tmain.estimate(feed_shapes=feeds).total_flops
    assert abs(est - legacy) / legacy < 0.20, (est, legacy)


def test_default_peaks_are_the_h100s_and_the_env_overrides_them(
        monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("PADDLE_TPU_PEAK_GBPS", raising=False)
    assert tcost.peak_flops() == 989.4e12
    assert tcost.peak_bandwidth() == 3350.0e9
    _, tmain, feeds = pair("deepfm")
    table = tmain.estimate(feed_shapes=feeds)
    assert (table.peak_flops, table.peak_bandwidth) == (989.4e12, 3350.0e9)
    # the JAX package's variables, read the same way; a value that is no
    # number falls back to the default
    for raw, tflops, gbps in (("500", 500e12, 500e9),
                              ("fast", 989.4e12, 3350.0e9)):
        monkeypatch.setenv("PADDLE_TPU_PEAK_TFLOPS", raw)
        monkeypatch.setenv("PADDLE_TPU_PEAK_GBPS", raw)
        assert (tcost.peak_flops(), tcost.peak_bandwidth()) == (tflops,
                                                                gbps)
        if raw == "500":
            assert (jcost.peak_flops(), jcost.peak_bandwidth()) == (tflops,
                                                                    gbps)


def _unpinned(fluid, unique_name):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 16])
        y = fluid.layers.fc(x, 8, act="relu")
        loss = fluid.layers.mean(y)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main


def test_unpinned_batch_dims_give_the_same_assumptions():
    want = _unpinned(jf, jun).estimate(**H100)
    got = _unpinned(tf, tf.unique_name).estimate(**H100)
    assert got.assumptions == want.assumptions
    assert any("batch hint 1" in a for a in got.assumptions)
    assert _rows(got) == _rows(want)
    pinned = _unpinned(tf, tf.unique_name).estimate(
        feed_shapes={"x": (32, 16)}, **H100)
    assert pinned.total_flops > got.total_flops
