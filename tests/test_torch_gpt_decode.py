"""Port parity for GPT serving through the KV cache: the kv_cache_write and
kv_cache_attention ops on the JAX package's goldens
(tests/test_serving.py::test_kv_cache_op_goldens), the port's GPTGenerator
against the JAX package's from the same weights (carried as arrays, and
as the files of the JAX package's save_params), cached generation
against full recompute, a `generate` endpoint behind the port's Server,
and the v1 `lookup_table` op that [B, 1] ids build (the decode step's
token embedding), on the CPU.

Tolerances: the cache ops rtol 1e-5 + atol 1e-6 (as the goldens); greedy
tokens exactly; the embedding's output and W@GRAD exactly (a gather and
a scatter-add of the same fp32 values).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu import layers as jl
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.serving.generate import GPTGenerator as JGPTGenerator

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.errors import InvalidArgumentError
from paddle_tpu_torch.framework.registry import OpView
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.models.gpt import gpt_cache_names
from paddle_tpu_torch.ops.kv_cache import _kv_cache_attention, _kv_cache_write
from paddle_tpu_torch.serving import (
    EndpointConfig,
    GPTGenerateRunner,
    GPTGenerator,
    Server,
)

BATCH, CONTEXT, MAX_LEN, NEW = 2, 12, 24, 8


def _np_ref_cache_attention(q, k, v, pos, nh, scale, prob_scale=1.0):
    # the golden of tests/test_serving.py
    b, t, h = q.shape
    s = k.shape[1]
    dh = h // nh
    qh = q.reshape(b, t, nh, dh).transpose(0, 2, 1, 3)
    kh = k.reshape(b, s, nh, dh).transpose(0, 2, 3, 1)
    scores = (qh @ kh) * scale
    qpos = pos - (t - 1) + np.arange(t)
    mask = np.arange(s)[None, None, None, :] <= qpos[None, None, :, None]
    scores = np.where(mask, scores, -1e9)
    e = np.exp(scores - scores.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True) * prob_scale
    vh = v.reshape(b, s, nh, dh).transpose(0, 2, 1, 3)
    return (probs @ vh).transpose(0, 2, 1, 3).reshape(b, t, h)


def test_kv_cache_op_goldens():
    rng = np.random.RandomState(0)
    cache = rng.randn(2, 8, 12).astype(np.float32)
    rows = rng.randn(2, 1, 12).astype(np.float32)
    t_cache = torch.from_numpy(cache.copy())
    out = _kv_cache_write(
        None, OpView("kv_cache_write", {}),
        {"Cache": [t_cache], "X": [torch.from_numpy(rows)],
         "Pos": [torch.tensor([3])]},
    )["Out"][0]
    want = cache.copy()
    want[:, 3:4, :] = rows
    np.testing.assert_array_equal(out.numpy(), want)
    assert out is t_cache  # written in place: Out is the cache

    q = rng.randn(2, 1, 12).astype(np.float32)
    attn = _kv_cache_attention(
        None,
        OpView("kv_cache_attention",
               {"num_heads": 3, "scale": 0.5, "prob_scale": 0.9}),
        {"Q": [torch.from_numpy(q)], "CacheK": [torch.from_numpy(cache)],
         "CacheV": [torch.from_numpy(cache)], "Pos": [torch.tensor([5])]},
    )["Out"][0]
    ref = _np_ref_cache_attention(q, cache, cache, 5, 3, 0.5, 0.9)
    np.testing.assert_allclose(attn.numpy(), ref, rtol=1e-5, atol=1e-6)

    # a prefill window: T query rows end at Pos, causal within the window
    q3 = rng.randn(2, 4, 12).astype(np.float32)
    attn3 = _kv_cache_attention(
        None, OpView("kv_cache_attention", {"num_heads": 3, "scale": 0.5}),
        {"Q": [torch.from_numpy(q3)], "CacheK": [torch.from_numpy(cache)],
         "CacheV": [torch.from_numpy(cache)], "Pos": [torch.tensor([[6]])]},
    )["Out"][0]
    np.testing.assert_allclose(
        attn3.numpy(), _np_ref_cache_attention(q3, cache, cache, 6, 3, 0.5),
        rtol=1e-5, atol=1e-6)


def _jax_generator(seed=11):
    gen = JGPTGenerator(JGPTConfig.tiny(), batch=BATCH, context_len=CONTEXT,
                        max_len=MAX_LEN, scope=JScope(),
                        executor=jf.Executor(jf.CPUPlace()))
    gen.init_params(seed=seed)
    return gen


def _port_generator(state=None, seed=11):
    """A CPU GPTGenerator at GPT-tiny; with `state`, carrying the JAX
    package's parameters (its KV caches are not carried)."""
    cfg = TGPTConfig.tiny()
    gen = GPTGenerator(cfg, batch=BATCH, context_len=CONTEXT,
                       max_len=MAX_LEN, executor=tf.Executor(tf.CPUPlace()))
    if state is None:
        gen.init_params(seed=seed)
    else:
        convert.state_from_numpy(state, gen.scope, tf.CPUPlace(),
                                 program=gen.prefill_prog,
                                 exclude=gpt_cache_names(cfg))
    return gen


def _context():
    rng = np.random.RandomState(0)
    return rng.randint(0, 512, size=(BATCH, CONTEXT)).astype(np.int64)


def test_generator_gives_the_jax_packages_tokens_from_its_weights():
    jgen = _jax_generator()
    state = {n: np.asarray(jgen.scope.find_var(n))
             for n in jgen.scope.local_var_names()}
    assert set(gpt_cache_names(jgen.cfg)) <= set(state)
    gen = _port_generator(state)
    caches = set(gpt_cache_names(gen.cfg))
    # the parameters carry across; the caches come from reset()
    assert set(gen.scope.local_var_names()) == set(state) - caches
    ctx = _context()
    want = jgen.generate(ctx, NEW)
    got = gen.generate(ctx, NEW)
    assert got.shape == (BATCH, NEW) and got.dtype == np.int64
    np.testing.assert_array_equal(got, np.asarray(want))
    # fresh caches: a second generation repeats the first
    np.testing.assert_array_equal(gen.generate(ctx, NEW), got)


def test_load_params_reads_the_jax_packages_checkpoint(tmp_path):
    """GPTGenerator.save_params of the JAX package (io.save of its prefill
    program) -> the port's load_params (io.load, the KV caches left out)
    gives the JAX package's greedy tokens; the port's own save_params ->
    load_params gives them again."""
    jgen = _jax_generator(seed=13)
    path = str(tmp_path / "gpt")
    jgen.save_params(path)
    gen = _port_generator(seed=99)  # other weights, overwritten by the load
    gen.load_params(path)
    caches = set(gpt_cache_names(gen.cfg))
    params = {v.name for v in gen.prefill_prog.list_vars()
              if v.persistable and v.name not in caches}
    assert params <= set(gen.scope.local_var_names())
    ctx = _context()
    want = np.asarray(jgen.generate(ctx, NEW))
    np.testing.assert_array_equal(gen.generate(ctx, NEW), want)
    again = _port_generator(seed=98)
    gen.save_params(str(tmp_path / "port"))
    again.load_params(str(tmp_path / "port"))
    np.testing.assert_array_equal(again.generate(ctx, NEW), want)


def test_cached_generation_equals_full_recompute():
    gen = _port_generator(seed=5)
    ctx = _context()
    cached = gen.generate(ctx, NEW)
    full = gen.generate_full_recompute(ctx, NEW)
    np.testing.assert_array_equal(cached, full)
    ops = {op.type for op in gen.decode_prog.global_block.ops}
    assert {"kv_cache_write", "kv_cache_attention", "lookup_table"} <= ops
    with pytest.raises(InvalidArgumentError):
        gen.generate(ctx, MAX_LEN - CONTEXT + 1)
    with pytest.raises(FileNotFoundError):  # no checkpoint there
        gen.load_params("somewhere")


def test_generate_endpoint_serves_and_refuses_other_buckets():
    gen = _port_generator(seed=5)
    runner = GPTGenerateRunner(gen, max_new_tokens=4)
    srv = Server()
    try:
        with pytest.raises(InvalidArgumentError):
            srv.add_endpoint("bad", runner, EndpointConfig(buckets=(1, 2)))
        srv.add_endpoint("gen", runner,
                         EndpointConfig(buckets=(BATCH,), max_wait_ms=50.0))
        ctx = _context()
        futs = [srv.submit("gen", {"context_ids": row}) for row in ctx]
        served = np.stack([f.result(timeout=60)[0] for f in futs])
    finally:
        assert srv.close(timeout=60)
    np.testing.assert_array_equal(served, gen.generate(ctx, 4))


def _embedding_program(pkg, padding_idx):
    fluid, layers, unique_name = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("ids", [6, 1], "int64")
        w = fluid.data("w", [6, 16], "float32")
        emb = layers.embedding(ids, size=[10, 16], padding_idx=padding_idx,
                               param_attr=fluid.ParamAttr(name="emb_w"))
        loss = layers.reduce_sum(layers.elementwise_mul(emb, w))
        gw, = fluid.gradients(loss, [main.global_block.var("emb_w")])
    return main, startup, [emb.name, gw.name]


@pytest.mark.parametrize("padding_idx", [None, 4])
def test_embedding_of_b_by_1_ids_builds_lookup_table_v1(padding_idx):
    """[B, 1] ids build the v1 lookup_table op (trailing 1 dropped), as the
    decode step's token embedding does; its output and the W@GRAD of its
    __vjp__ match the JAX package's, padding_idx included."""
    jmain, jstartup, jfetch = _embedding_program((jf, jl, jun), padding_idx)
    tmain, _, tfetch = _embedding_program((tf, tl, tf.unique_name),
                                          padding_idx)
    assert "lookup_table" in {op.type for op in tmain.global_block.ops}
    assert tfetch == jfetch
    jscope = JScope()
    jexe = jf.Executor(jf.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    tscope = tf.Scope()
    convert.state_from_numpy({"emb_w": np.asarray(jscope.find_var("emb_w"))},
                             tscope, tf.CPUPlace())
    rng = np.random.RandomState(2)
    feed = {"ids": np.array([[1], [4], [4], [9], [0], [1]], np.int64),
            "w": rng.randn(6, 16).astype(np.float32)}
    want = jexe.run(jmain, feed=feed, fetch_list=jfetch, scope=jscope)
    got = tf.Executor(tf.CPUPlace()).run(tmain, feed=feed, fetch_list=tfetch,
                                         scope=tscope)
    assert got[0].shape == (6, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    if padding_idx is not None:
        assert not got[0][1].any() and not got[1][4].any()
