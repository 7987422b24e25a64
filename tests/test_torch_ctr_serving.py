"""Port parity for the CTR serving slice: bench_serving.py's ctr_rank
ranker (DeepFMConfig(4096, 13, 16, (64, 32)), per_slot=True, fused into
one fused_lookup_table per table width, Adam(1e-3).minimize appended,
frozen with freeze_program(main, [prob], feed_names=("feat_ids",))),
built by paddle_tpu_torch and by the JAX package on the CPU, from the
JAX package's startup state, served by the port's serving.Server at
buckets (1, 2, 4, 8) with max_wait_ms 4.

Feeds are bench_serving's requests: 13 power-law ids (rng.power(0.35))
over the 4096-id vocab. Tolerances, fp32 on both sides, the tower's
products possibly in other orders: probabilities (at most 1) atol 1e-6
against the JAX package's frozen program and against the port's direct
run of the same batch, one row or the whole batch (measured on the CPU:
equal bit for bit in both).
"""

import numpy as np
import pytest

import paddle_tpu as jf
from paddle_tpu import io as jio
from paddle_tpu.embedding import fuse_lookups as jfuse
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard
from paddle_tpu.models.deepfm import DeepFMConfig as JConfig
from paddle_tpu.models.deepfm import deepfm as jdeepfm
from paddle_tpu.serving import freeze_program as jfreeze

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert, io
from paddle_tpu_torch.embedding import fuse_lookups as tfuse
from paddle_tpu_torch.models import DeepFMConfig as TConfig
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.serving import EndpointConfig, Server
from paddle_tpu_torch.serving import freeze_program as tfreeze

from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

JAX = (jf, jun, JConfig, jdeepfm, jfuse, jfreeze, JScope, jf.CPUPlace())
PORT = (tf, tf.unique_name, TConfig, tdeepfm, tfuse, tfreeze, tf.Scope,
        tf.CPUPlace())
BUCKETS = (1, 2, 4, 8)
FIELDS, VOCAB = 13, 4096
ATOL = 1e-6


def build(pkg):
    """bench_serving's ctr_rank ranker, frozen, and its startup."""
    fluid, unique_name, config, deepfm, fuse, freeze, _, _ = pkg
    cfg = config(vocab_size=VOCAB, num_fields=FIELDS, embed_dim=16,
                 mlp_sizes=(64, 32))
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 13
    with unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("feat_ids", [-1, cfg.num_fields], "int64")
        label = fluid.data("label", [-1, 1], "float32")
        loss, prob = deepfm(ids, label, cfg, per_slot=True)
        assert fuse(main) == 2
        fluid.optimizer.Adam(1e-3).minimize(loss, startup)
    frozen = freeze(main, [prob], feed_names=("feat_ids",))
    return frozen, startup, main, prob


def requests(n, seed):
    """bench_serving's ctr requests: power-law ids, one row each."""
    rng = np.random.RandomState(seed)
    return (VOCAB * rng.power(0.35, (n, FIELDS))).astype(np.int64)


@pytest.fixture(scope="module")
def jax_side():
    frozen, startup, _, _ = build(JAX)
    scope, exe = JScope(), jf.Executor(jf.CPUPlace())
    exe.run(startup, scope=scope)
    state = {n: np.asarray(scope.find_var(n))
             for n in scope.local_var_names()}
    outs = {b: np.asarray(exe.run(
        frozen.program, feed={"feat_ids": requests(b, b)},
        fetch_list=list(frozen.fetch_names), scope=scope)[0])
        for b in BUCKETS}
    return frozen, state, outs


def test_frozen_rankers_match_with_two_fused_sites(jax_side):
    jfrozen = jax_side[0]
    tfrozen = build(PORT)[0]
    jops = jfrozen.program.global_block.ops
    tops = tfrozen.program.global_block.ops
    assert [op.type for op in tops] == [op.type for op in jops]
    for jop, top in zip(jops, tops):
        assert top.inputs == jop.inputs and top.outputs == jop.outputs, top
    fused = [op for op in tops if op.type == "fused_lookup_table"]
    assert len(fused) == 2
    assert {len(op.outputs["Out"]) for op in fused} == {FIELDS}
    types = {op.type for op in tops}
    assert not types & {"__vjp__", "adam", "distributed_lookup_table",
                        "sigmoid_cross_entropy_with_logits"}
    assert tfrozen.program._is_inference
    assert tfrozen.feed_names == ("feat_ids",)
    assert tfrozen.fetch_names == jfrozen.fetch_names


def test_served_answers_match_the_jax_package(jax_side):
    _, state, want = jax_side
    frozen = build(PORT)[0]
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    convert.state_from_numpy(state, scope, tf.CPUPlace(),
                             program=frozen.program)
    direct = {}
    for b in BUCKETS:
        got, = exe.run(frozen.program, feed={"feat_ids": requests(b, b)},
                       fetch_list=list(frozen.fetch_names), scope=scope)
        assert got.shape == (b, 1) and ((got > 0) & (got < 1)).all()
        np.testing.assert_allclose(got, want[b], rtol=0, atol=ATOL,
                                   err_msg=f"batch {b}")
        direct[b] = got
    srv = Server()
    try:
        ep = srv.add_endpoint(
            "ctr_rank", None,
            EndpointConfig(buckets=BUCKETS, max_wait_ms=4.0,
                           max_queue=4096),
            frozen=frozen, executor=exe, scope=scope)
        srv.warmup()
        served = []
        for b in BUCKETS:
            futs = [srv.submit("ctr_rank", {"feat_ids": r})
                    for r in requests(b, b)]
            served.append(np.stack([f.result(timeout=120)[0]
                                    for f in futs]))
    finally:
        assert srv.close(timeout=120)
    assert ep.batches and all(bk in BUCKETS for bk, _ in ep.batches)
    for b, got in zip(BUCKETS, served):
        np.testing.assert_allclose(got, direct[b], rtol=0, atol=ATOL,
                                   err_msg=f"served, batch {b}")
    assert np.ptp(np.concatenate(served)) > 1e-4


def test_the_jax_package_reads_the_ports_ranker(jax_side, tmp_path):
    """A2: the port's save_inference_model of the ranker loads through
    paddle_tpu.io.load_inference_model and answers as the port does."""
    _, state, _ = jax_side
    _, _, main, prob = build(PORT)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    convert.state_from_numpy(state, scope, tf.CPUPlace(), program=main)
    model = str(tmp_path / "ctr_rank")
    with tf.scope_guard(scope):
        written = io.save_inference_model(model, ["feat_ids"], [prob], exe,
                                          main)
        tprog, _, tfetch = io.load_inference_model(model, exe)
        feed = {"feat_ids": requests(8, 99)}
        got, = exe.run(tprog, feed=feed, fetch_list=tfetch, scope=scope)
    assert sum(op.type == "fused_lookup_table"
               for op in tprog.global_block.ops) == 2
    jscope, jexe = JScope(), jf.Executor(jf.CPUPlace())
    with jscope_guard(jscope):
        jprog, jfeeds, jfetch = jio.load_inference_model(model, jexe)
        want, = jexe.run(jprog, feed=feed, fetch_list=jfetch)
    assert (jfeeds, jfetch) == (["feat_ids"], written)
    assert [op.type for op in jprog.global_block.ops] == [
        op.type for op in tprog.global_block.ops]
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
