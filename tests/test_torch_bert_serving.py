"""Port parity for the serving slice: the BERT-tiny classifier built, frozen
and served by paddle_tpu_torch against the same model in the JAX package.

Both programs are built from a fresh unique_name state, so their variable
names match; the JAX package's weights are carried across with
convert.state_from_numpy. Feeds come from numpy with a fixed seed.
Tolerance on probabilities: atol 1e-5 (fp32 on both sides; the sums run in
another order). Also checks the package's hygiene: importing it pulls in
neither jax nor paddle_tpu, and an entry point without a place raises on a
host without a card.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu import layers as jl
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import bert_encoder as jbert_encoder
from paddle_tpu.serving import freeze_program as jfreeze_program

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.errors import PreconditionNotMetError
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from paddle_tpu_torch.models.bert import bert_encoder as tbert_encoder
from paddle_tpu_torch.serving import EndpointConfig, Server
from paddle_tpu_torch.serving import freeze_program as tfreeze_program

S = 16
FEEDS = ("ids", "types", "mask")
REPO = Path(__file__).resolve().parent.parent


def _build(fluid, layers, cfg_cls, encoder, freeze, unique_name, is_test):
    """The classifier of bench_serving's bert_classify mix: [CLS] hidden
    state -> fc(4) -> softmax, frozen to its feeds. Built in training mode
    (is_test=False, as bench_serving builds it), freezing flips it."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with unique_name.guard(), fluid.program_guard(main, startup):
        cfg = cfg_cls.tiny()
        ids = fluid.data("ids", [-1, S], "int64")
        types = fluid.data("types", [-1, S], "int64")
        mask = fluid.data("mask", [-1, S], "float32")
        seq = encoder(ids, types, mask, cfg, is_test=is_test)
        pooled = layers.slice(seq, [1], [0], [1])
        prob = layers.softmax(layers.fc(pooled, 4))
    return startup, freeze(main, [prob], feed_names=FEEDS), cfg


def _jax_model(is_test=True):
    return _build(jf, jl, JBertConfig, jbert_encoder, jfreeze_program, jun,
                  is_test)


def _port_model(is_test=True):
    return _build(tf, tl, TBertConfig, tbert_encoder, tfreeze_program,
                  tf.unique_name, is_test)


def _feed(cfg, batch, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((batch, S), np.float32)
    for b in range(batch):
        mask[b, rng.randint(4, S + 1):] = 0.0  # a padded tail per sample
    return {
        "ids": rng.randint(0, cfg.vocab_size, (batch, S)).astype(np.int64),
        "types": (rng.rand(batch, S) < 0.3).astype(np.int64),
        "mask": mask,
    }


def _canon(dtype):
    # the JAX package runs without 64-bit mode: its int64 is int32
    return "int" if dtype in ("int32", "int64") else dtype


def _attrs(op):
    # dunder attrs are bookkeeping (op uid, build site), not semantics
    return {k: v for k, v in op.attrs.items() if not k.startswith("__")}


@pytest.mark.parametrize("is_test", [True, False])
def test_frozen_programs_match_in_ops_names_shapes_and_dtypes(is_test):
    jstartup, jfrozen, _ = _jax_model(is_test)
    tstartup, tfrozen, _ = _port_model(is_test)
    jb, tb = jfrozen.program.global_block, tfrozen.program.global_block
    assert [op.type for op in tb.ops] == [op.type for op in jb.ops]
    for jop, top in zip(jb.ops, tb.ops):
        assert top.inputs == jop.inputs and top.outputs == jop.outputs
        assert _attrs(top) == _attrs(jop), top.type
    assert ([op.type for op in tstartup.global_block.ops]
            == [op.type for op in jstartup.global_block.ops])
    jvars = {v.name: v for v in jfrozen.program.list_vars()}
    tvars = {v.name: v for v in tfrozen.program.list_vars()}
    assert set(tvars) == set(jvars)
    for name, jv in jvars.items():
        tv = tvars[name]
        assert tv.shape == jv.shape, name
        assert _canon(tv.dtype) == _canon(jv.dtype), name
        assert tv.persistable == jv.persistable, name
    assert tfrozen.feed_names == jfrozen.feed_names
    assert tfrozen.fetch_names == jfrozen.fetch_names
    assert tfrozen.program._is_inference
    assert all(op.attrs["is_test"] for op in tb.ops if "is_test" in op.attrs)


@pytest.mark.parametrize("is_test", [True, False])
def test_carried_weights_give_the_same_probabilities(is_test):
    jstartup, jfrozen, cfg = _jax_model(is_test)
    jscope, jexe = JScope(), jf.Executor(jf.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n in jscope.local_var_names()}
    _, tfrozen, _ = _port_model(is_test)
    tscope = tf.Scope()
    convert.state_from_numpy(arrays, tscope, tf.CPUPlace())
    back = convert.state_to_numpy(tscope)
    assert set(back) == set(arrays)
    for n, a in arrays.items():
        np.testing.assert_array_equal(back[n], a)

    feed = _feed(cfg, 3)
    want, = jexe.run(jfrozen.program, feed=feed,
                     fetch_list=list(jfrozen.fetch_names), scope=jscope)
    got, = tf.Executor(tf.CPUPlace()).run(
        tfrozen.program, feed=feed, fetch_list=list(tfrozen.fetch_names),
        scope=tscope)
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_server_answers_like_a_direct_run():
    startup, frozen, cfg = _port_model()
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    feed = _feed(cfg, 5, seed=1)
    direct, = exe.run(frozen.program, feed=feed,
                      fetch_list=list(frozen.fetch_names), scope=scope)
    assert np.isfinite(direct).all()
    np.testing.assert_allclose(direct.sum(-1), 1.0, rtol=0, atol=1e-5)

    srv = Server()
    try:
        ep = srv.add_endpoint(
            "bert", frozen=frozen, executor=exe, scope=scope,
            config=EndpointConfig(buckets=(1, 2, 4), max_wait_ms=50.0),
        )
        assert srv.warmup() == 3
        futs = [srv.submit("bert", {k: v[i] for k, v in feed.items()})
                for i in range(5)]
        got = np.stack([f.result(timeout=60)[0] for f in futs])
    finally:
        assert srv.close(timeout=60)
    # every request was answered from a bucket that held it, padded rows
    # included: at most the largest bucket per run, all five served
    assert sum(n for _, n in ep.batches) == 5
    assert all(n <= b <= 4 for b, n in ep.batches)
    np.testing.assert_allclose(got, direct, rtol=0, atol=1e-5)


def test_composed_attention_path_is_not_in_this_slice():
    """The composed attention path (use_fused_attention=False) was left out
    of the serving slice and raised UnimplementedError; it came with GPT's
    dense branch (transpose2, matmul). It now builds, and gives the fused
    path's hidden states on one state (atol 1e-5)."""
    rng = np.random.RandomState(4)
    feed = {"ids": rng.randint(0, 1024, (3, S)),
            "types": np.zeros((3, S), np.int64),
            "mask": np.ones((3, S), np.float32)}
    feed["mask"][2, 10:] = 0.0
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    outs = {}
    for fused in (True, False):
        main, startup = tf.Program(), tf.Program()
        main.random_seed = startup.random_seed = 7
        cfg = TBertConfig.tiny()
        cfg.use_fused_attention = fused
        with tf.unique_name.guard(), tf.program_guard(main, startup):
            ids = tf.data("ids", [-1, S], "int64")
            types = tf.data("types", [-1, S], "int64")
            mask = tf.data("mask", [-1, S], "float32")
            seq = tbert_encoder(ids, types, mask, cfg, is_test=True)
        if fused:
            exe.run(startup, scope=scope)
        types_ = {op.type for op in main.global_block.ops}
        assert ("fused_qkv_attention" in types_) == fused
        outs[fused], = exe.run(main, feed=feed, fetch_list=[seq],
                               scope=scope)
    np.testing.assert_allclose(outs[False], outs[True], rtol=0, atol=1e-5)


def test_import_pulls_in_neither_jax_nor_paddle_tpu():
    code = textwrap.dedent("""
        import sys
        import paddle_tpu_torch
        import paddle_tpu_torch.convert, paddle_tpu_torch.models.bert
        import paddle_tpu_torch.serving, paddle_tpu_torch.optimizer
        import paddle_tpu_torch.framework.backward
        import paddle_tpu_torch.framework.state
        import paddle_tpu_torch.layers.control_flow
        import paddle_tpu_torch.layers.learning_rate_scheduler
        import paddle_tpu_torch.ops.optimizer_ops
        import paddle_tpu_torch.kernels.prng_mask
        import paddle_tpu_torch.kernels.sum_partials
        import paddle_tpu_torch.kernels.flash_tiled
        import paddle_tpu_torch.models.gpt
        import paddle_tpu_torch.ops.kv_cache
        import paddle_tpu_torch.serving.generate
        import paddle_tpu_torch.flags
        import paddle_tpu_torch.contrib.mixed_precision
        import paddle_tpu_torch.kernels.layer_norm
        import paddle_tpu_torch.kernels.ring_block
        import paddle_tpu_torch.parallel.mesh, paddle_tpu_torch.parallel.spmd
        import paddle_tpu_torch.parallel.transpiler
        import paddle_tpu_torch.parallel.ring_attention
        import paddle_tpu_torch.ops.collective
        import paddle_tpu_torch.models, paddle_tpu_torch.models.resnet
        import paddle_tpu_torch.ops.metrics, paddle_tpu_torch.ops.math_ext
        import paddle_tpu_torch.layers.functional_ext
        import paddle_tpu_torch.ops.detection, paddle_tpu_torch.models.yolov3
        import paddle_tpu_torch.layers.detection
        import paddle_tpu_torch.embedding, paddle_tpu_torch.models.deepfm
        import paddle_tpu_torch.ops.sparse, paddle_tpu_torch.observability
        import paddle_tpu_torch.parallel.sparse
        import paddle_tpu_torch.dygraph, paddle_tpu_torch.dygraph.tracer
        import paddle_tpu_torch.dygraph.varbase
        import paddle_tpu_torch.dygraph.layers, paddle_tpu_torch.dygraph.nn
        import paddle_tpu_torch.dygraph.parallel
        import paddle_tpu_torch.dygraph.checkpoint
        import paddle_tpu_torch.dygraph.learning_rate_scheduler
        import paddle_tpu_torch.analysis, paddle_tpu_torch.analysis.cost
        import paddle_tpu_torch.analysis.memory
        import paddle_tpu_torch.analysis.verify
        import paddle_tpu_torch.observability.export
        sys.path.insert(0, "tests")
        import torch_sp_worker  # the multi-rank tests' rank processes
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.")
               or m == "paddle_tpu" or m.startswith("paddle_tpu.")]
        print(bad)
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_entry_points_default_to_the_card():
    assert tf.default_place() == tf.CUDAPlace(0)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default place is usable")
    with pytest.raises(PreconditionNotMetError):
        tf.Executor()
    with pytest.raises(PreconditionNotMetError):
        convert.state_from_numpy({"w": np.zeros(2, np.float32)}, tf.Scope(),
                                 None)
