"""The port's inference predictor (paddle_tpu_torch.inference) against the
JAX package's: the same JAX-exported model (its pickled `__model__` and
`__params__.npz`) answered by both predictors, batch buckets that pad and
slice, run_zero_copy, enable_bf16's rewrite of fused_multihead_attention
to bf16, the place switches, and the JAX package's XLA-only knobs, which
raise.

The model is the ERNIE-layout classifier (tests/torch_mha_classifier.py)
at BertConfig.tiny() widths (2 layers, 4 heads), batch -1, S=32, random
weights from a seed, on the CPU. Tolerance: the probabilities of the two
predictors atol 1e-5 (fp32, sums in other orders); bf16 against fp32
atol 3e-2 (2-way softmax of bf16 activations).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu import inference as jinf
from paddle_tpu import io as jio
from paddle_tpu import layers as jl
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard
from paddle_tpu.models.bert import BertConfig as JBertConfig

import paddle_tpu_torch as tf
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.errors import (
    InvalidArgumentError,
    PreconditionNotMetError,
    UnimplementedError,
)
from torch_mha_classifier import build_mha_classifier, mha_feed

S = 32
FEEDS = ("ids", "types", "mask")


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """A JAX-exported inference model of the classifier (test-mode clone,
    pruned) and the JAX package's fp32 and bf16 predictors over it."""
    cfg = JBertConfig.tiny()
    with jun.guard():
        main, startup, _, prob = build_mha_classifier(jf, jl, cfg, -1, S,
                                                      False)
    main.random_seed = startup.random_seed = 11
    scope = JScope()
    jf.Executor(jf.CPUPlace()).run(startup, scope=scope)
    model = str(tmp_path_factory.mktemp("jax_model"))
    with jscope_guard(scope):
        jio.save_inference_model(model, list(FEEDS), [prob],
                                 main_program=main)
    preds = {}
    for mode in ("fp32", "bf16"):
        config = jinf.AnalysisConfig(model)
        if mode == "bf16":
            config.enable_bf16()
        preds[mode] = jinf.create_paddle_predictor(config)
    return dict(dir=model, cfg=cfg, jax=preds)


def _inputs(cfg, b, seed):
    feed = mha_feed(cfg, b, S, seed)
    return [feed[k] for k in FEEDS]


def _port(model, bf16=False, buckets=None):
    config = tinf.AnalysisConfig(model, place=tf.CPUPlace())
    if bf16:
        config.enable_bf16()
    if buckets:
        config.set_batch_buckets(buckets)
    return tinf.create_paddle_predictor(config)


def test_the_port_answers_a_jax_model_as_the_jax_package_does(jax_model):
    pred = _port(jax_model["dir"])
    assert pred.get_input_names() == list(FEEDS)
    assert pred.get_output_names() == \
        jax_model["jax"]["fp32"].get_output_names()
    for b, seed in ((1, 0), (3, 1)):
        inputs = _inputs(jax_model["cfg"], b, seed)
        got = pred.run([tinf.PaddleTensor(x) for x in inputs])
        want = jax_model["jax"]["fp32"].run(inputs)
        assert got[0].name == want[0].name
        assert got[0].as_ndarray().shape == (b, 2)
        np.testing.assert_allclose(got[0].as_ndarray(),
                                   np.asarray(want[0].as_ndarray()),
                                   atol=1e-5)


def test_batch_buckets_pad_and_slice(jax_model):
    """Batches 1, 3, 4 and 7 run at buckets 4 and 8 only, and each answer
    equals the unbucketed predictor's."""
    cfg = jax_model["cfg"]
    plain = _port(jax_model["dir"])
    pred = _port(jax_model["dir"], buckets=[8, 4])
    assert pred._config._batch_buckets == [4, 8]
    for b in (1, 3, 4, 7):
        inputs = _inputs(cfg, b, b)
        out = pred.run(inputs)[0].as_ndarray()
        assert out.shape == (b, 2)
        np.testing.assert_allclose(out, plain.run(inputs)[0].as_ndarray(),
                                   atol=1e-6)
    shapes = {dict((n, s) for n, s, _ in key[2])["ids"][0]
              for key in pred.executor._cache}
    assert shapes == {4, 8}, shapes
    with pytest.raises(PreconditionNotMetError,
                       match="largest configured bucket"):
        pred.run(_inputs(cfg, 9, 0))
    ids, types, mask = _inputs(cfg, 2, 0)
    with pytest.raises(InvalidArgumentError, match="shared leading batch"):
        pred.run([ids, types[:1], mask])
    with pytest.raises(InvalidArgumentError, match="positive"):
        tinf.AnalysisConfig(jax_model["dir"]).set_batch_buckets([0, 4])


def test_run_zero_copy(jax_model):
    pred = _port(jax_model["dir"], buckets=[4])
    inputs = _inputs(jax_model["cfg"], 3, 5)
    names, arrays = pred.run_zero_copy(inputs)
    assert names == pred.get_output_names()
    assert arrays[0].flags["C_CONTIGUOUS"] and arrays[0].shape == (3, 2)
    assert pred._last_outputs is arrays
    np.testing.assert_array_equal(arrays[0], pred.run(inputs)[0].as_ndarray())


def test_enable_bf16_runs_the_attention_on_bf16(jax_model):
    """The rewrite casts q, k, v of every fused_multihead_attention op to
    bf16, as the JAX package's predictor rewrites its program (op for op,
    dtype for dtype); the answers stay within bf16 reach of fp32."""
    pred = _port(jax_model["dir"], bf16=True)
    blk = pred.program.global_block
    jblk = jax_model["jax"]["bf16"]._program.global_block
    assert [op.type for op in blk.ops] == [op.type for op in jblk.ops]
    for op, jop in zip(blk.ops, jblk.ops):
        for n in op.input_names() + op.output_names():
            assert str(blk.var(n).dtype) == str(jblk.var(n).dtype), n
    attn = [op for op in blk.ops if op.type == "fused_multihead_attention"]
    assert len(attn) == 2 and all(
        blk.var(op.inputs[s][0]).dtype == "bfloat16"
        for op in attn for s in ("Q", "K", "V"))
    inputs = _inputs(jax_model["cfg"], 2, 6)
    got = pred.run(inputs)[0].as_ndarray()
    fp32 = _port(jax_model["dir"]).run(inputs)[0].as_ndarray()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, fp32, atol=3e-2)


def test_places_and_the_xla_only_knobs(jax_model):
    config = tinf.AnalysisConfig(jax_model["dir"])
    assert config._place is None  # the card, CUDAPlace(0)
    if not torch.cuda.is_available():
        with pytest.raises(PreconditionNotMetError):
            tinf.create_paddle_predictor(config)
    config.disable_gpu()
    assert config._place == tf.CPUPlace()
    pred = tinf.create_paddle_predictor(config)
    assert pred.executor.device == torch.device("cpu")
    config.enable_use_gpu(100, device_id=0)
    assert config._place == tf.CUDAPlace(0)
    for knob in (config.set_optim_cache_dir, config.set_aot_executable_path):
        with pytest.raises(UnimplementedError, match="operations planes"):
            knob("/nonexistent")
    with pytest.raises(UnimplementedError, match="operations planes"):
        pred.save_executable("/nonexistent", _inputs(jax_model["cfg"], 1, 0))
    with pytest.raises(InvalidArgumentError, match="model_dir"):
        tinf.create_paddle_predictor(tinf.AnalysisConfig())
