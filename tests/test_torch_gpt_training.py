"""Port parity for GPT training: bench.py's bench_gpt_longctx program
(gpt_lm_loss with Adam) built and trained by paddle_tpu_torch against the
same program in the JAX package, on the CPU; the dense attention branch
against the fused one; and the `mean` and `tril_triu` ops, forward and
`__vjp__`.

Two sizes: bench_gpt_longctx's own CPU program (GPTConfig.tiny(), B=2,
S=64: the whole-row attention path), and GPT-tiny with max_position=2048
at B=1, S=2048, which in the port takes the KV-tiled path (its forward
saves Out and Lse for the grad op) while the JAX package on the CPU runs
its jnp reference. Both programs are built from a fresh unique_name
state, so their variable names match; the JAX package's whole state is
carried across with convert.state_from_numpy. Dropout is 0: the two
packages draw their masks from different generators.

Tolerances, fp32 on both sides, sums in other orders (as
test_torch_bert_training.py): loss rtol 1e-5; every @GRAD atol 1e-5 +
rtol 1e-4; Adam moments atol 1e-7 + rtol 1e-4; beta powers rtol 1e-6;
each parameter's update over the two steps within 1e-3 of (|update| +
lr), but for elements whose two gradients differ by more than 1e-4 of the
JAX package's at a step (Adam's step follows that disagreement), which
stay under 5% (measured: 2.5% at S=64, 1.3% at S=2048; GPT's gradients
are sums over all positions with more cancellation than BERT's, whose
bound is 2%). Hidden states of the dense and fused branches: atol 1e-4 +
rtol 1e-4 (the JAX package's own test_gpt.py::test_fused_matches_dense).
The S=2048 case is in test_torch_gpt_training_s2048.py, so that each file
stays well under 20 s.
"""

import numpy as np
import pytest

import paddle_tpu as jf
from paddle_tpu import layers as jl
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import gpt_decoder as jgpt_decoder
from paddle_tpu.models.gpt import gpt_lm_loss as jgpt_lm_loss
from paddle_tpu.optimizer import Adam as JAdam

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.models.gpt import gpt_decoder as tgpt_decoder
from paddle_tpu_torch.models.gpt import gpt_lm_loss as tgpt_lm_loss
from paddle_tpu_torch.optimizer import Adam as TAdam
from test_torch_bert_training import _check_updates, _jax_state

LR = 1e-3
JAX = (jf, jl, jun, JGPTConfig, jgpt_lm_loss, JAdam)
PORT = (tf, tl, tf.unique_name, TGPTConfig, tgpt_lm_loss, TAdam)


def _bench_gpt(pkg, B, S, max_position):
    fluid, layers, unique_name, cfg_cls, lm_loss, adam = pkg
    cfg = cfg_cls.tiny()
    cfg.max_position = max_position
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("ids", [B, S], "int64")
        loss = lm_loss(ids, cfg)
        _, pg = adam(LR).minimize(loss, startup)
    return main, startup, loss, pg, cfg


def test_two_adam_steps_match_the_jax_package():
    """bench_gpt_longctx's CPU program: the whole-row attention path."""
    check_two_adam_steps(2, 64, 128, tiled=False)


def check_two_adam_steps(B, S, max_position, tiled):
    jmain, jstartup, jloss, jpg, cfg = _bench_gpt(JAX, B, S, max_position)
    tmain, _, tloss, tpg, _ = _bench_gpt(PORT, B, S, max_position)
    assert ([op.type for op in tmain.global_block.ops]
            == [op.type for op in jmain.global_block.ops])
    grad_ops = [op for op in tmain.global_block.ops
                if op.type == "fused_qkv_attention_grad"]
    assert len(grad_ops) == cfg.num_layers
    assert all(("Lse" in op.inputs) == tiled for op in grad_ops)
    jscope, jexe = JScope(), jf.Executor(jf.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    start = _jax_state(jscope)
    tscope = tf.Scope()
    convert.state_from_numpy(start, tscope, tf.CPUPlace(), program=tmain)

    rng = np.random.RandomState(0)  # bench_gpt_longctx's int32 batches
    feeds = [{"ids": rng.randint(0, cfg.vocab_size, (B, S)).astype("int32")}
             for _ in range(2)]
    grads = [g.name for _, g in jpg]
    assert grads == [g.name for _, g in tpg]
    want = [jexe.run(jmain, feed=f, fetch_list=[jloss.name] + grads,
                     scope=jscope) for f in feeds]
    texe = tf.Executor(tf.CPUPlace())
    got = [texe.run(tmain, feed=f, fetch_list=[tloss.name] + grads,
                    scope=tscope) for f in feeds]
    for step, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g[0], np.asarray(w[0]), rtol=1e-5,
                                   err_msg=f"loss, step {step}")
        for name, gv, wv in zip(grads, g[1:], w[1:]):
            np.testing.assert_allclose(gv, np.asarray(wv), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} {step}")

    jend, tend = _jax_state(jscope), convert.state_to_numpy(tscope)
    assert set(tend) == set(jend)
    pgrads = {p.name: [(g[1 + i], np.asarray(w[1 + i]))
                       for g, w in zip(got, want)]
              for i, (p, _) in enumerate(jpg)}
    exempt, total = _check_updates(start, tend, jend, pgrads, LR)
    print(f"updates: {exempt} of {total} elements exempt")
    assert exempt < 0.05 * total
    for name, w in jend.items():
        if name in pgrads:
            continue
        if name.endswith(("_moment1_0", "_moment2_0")):
            np.testing.assert_allclose(tend[name], w, rtol=1e-4, atol=1e-7,
                                       err_msg=name)
        else:  # beta powers
            np.testing.assert_allclose(tend[name], w, rtol=1e-6,
                                       err_msg=name)


def _decoder(pkg, fused, B, S, scope=None):
    fluid, _, unique_name, cfg_cls, decoder = pkg
    cfg = cfg_cls.tiny()
    cfg.use_fused_attention = fused
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("ids", [B, S], "int64")
        hidden = decoder(ids, cfg, is_test=True)
    return main, startup, hidden, cfg


def test_dense_branch_matches_the_fused_one_and_the_jax_package():
    """gpt_decoder with use_fused_attention=False (transpose2, matmul, the
    tril mask, softmax) against the fused kernel path on one state, and
    against the JAX package's dense branch."""
    B, S = 2, 16
    jpkg = (jf, jl, jun, JGPTConfig, jgpt_decoder)
    tpkg = (tf, tl, tf.unique_name, TGPTConfig, tgpt_decoder)
    jmain, jstartup, jh, cfg = _decoder(jpkg, False, B, S)
    jscope, jexe = JScope(), jf.Executor(jf.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, S))
    want, = jexe.run(jmain, feed={"ids": ids}, fetch_list=[jh.name],
                     scope=jscope)
    tscope, texe = tf.Scope(), tf.Executor(tf.CPUPlace())
    convert.state_from_numpy(_jax_state(jscope), tscope, tf.CPUPlace())
    outs = {}
    for fused in (True, False):
        main, _, h, _ = _decoder(tpkg, fused, B, S)
        types = {op.type for op in main.global_block.ops}
        assert ("fused_qkv_attention" in types) == fused
        assert ({"tril_triu", "matmul", "transpose2"} <= types) != fused
        outs[fused], = texe.run(main, feed={"ids": ids}, fetch_list=[h],
                                scope=tscope)
    np.testing.assert_allclose(outs[False], outs[True], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(outs[False], np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _tri_mean_program(pkg, lower, diagonal):
    fluid, layers, unique_name = pkg
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [5, 7], "float32")
        w = fluid.data("w", [5, 7], "float32")
        x.stop_gradient = False
        tri = (layers.tril if lower else layers.triu)(x, diagonal=diagonal)
        loss = layers.mean(layers.elementwise_mul(tri, w))
        gx, = fluid.gradients(loss, [x])
    return main, [tri.name, loss.name, gx.name]


@pytest.mark.parametrize("lower,diagonal", [(True, 0), (True, -1),
                                            (False, 0), (False, 2)])
def test_tril_triu_and_mean_forward_and_vjp_match_the_jax_package(lower,
                                                                  diagonal):
    """Forward and the __vjp__ replay of tril_triu and mean (tolerance:
    atol 1e-7, sums of 35 terms)."""
    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(5, 7).astype(np.float32),
            "w": rng.randn(5, 7).astype(np.float32)}
    jmain, jfetch = _tri_mean_program((jf, jl, jun), lower, diagonal)
    tmain, tfetch = _tri_mean_program((tf, tl, tf.unique_name), lower,
                                      diagonal)
    assert tfetch == jfetch
    assert "__vjp__" in {op.type for op in tmain.global_block.ops}
    want = jf.Executor(jf.CPUPlace()).run(jmain, feed=feed,
                                          fetch_list=jfetch, scope=JScope())
    got = tf.Executor(tf.CPUPlace()).run(tmain, feed=feed, fetch_list=tfetch,
                                         scope=tf.Scope())
    tri = (np.tril if lower else np.triu)(feed["x"], diagonal)
    np.testing.assert_array_equal(got[0], tri)
    assert got[1].shape == (1,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-7)
