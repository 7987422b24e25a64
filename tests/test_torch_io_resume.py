"""Checkpoints across the packages: a checkpoint of the ERNIE-layout
classifier written by the JAX package's io.save resumes in the port (its
pickled Program read by io.ProgramUnpickler, its arrays by io.load), and
the port's .pdparams and __params__.npz load into the JAX package and give
the port's predictions.

The classifier (tests/torch_mha_classifier.py) runs at BertConfig.tiny()
widths (hidden 128, 4 heads, 2 layers), B=2, S=32, CPU, dropout 0 (the
packages draw their masks from different generators). Tolerances, fp32
both sides, sums in other orders, as tests/test_torch_bert_training.py:
loss rtol 1e-5; @GRAD atol 1e-5 + rtol 1e-4; each parameter's update over
the two steps within 1e-3 of (|update| + lr), elements whose two
gradients disagree by more than 1e-4 exempt and counted (under 2%);
predictions atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jf
from paddle_tpu import io as jio
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard

import paddle_tpu_torch as tf
from paddle_tpu_torch import io as tio
from test_torch_bert_training import _check_updates
from test_torch_io import FEEDS, JAX, LR, PORT, B, S, _program, _train_port
from torch_mha_classifier import mha_feed


def _jax_state(scope):
    return {n: np.asarray(scope.find_var(n)) for n in scope.local_var_names()}


def _port_state(scope):
    return {n: scope.find_var(n).numpy() for n in scope.local_var_names()}


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """The JAX package trains one step and saves (io.save); then it takes
    two more steps: the losses, gradients and end state the port's resume
    must give."""
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "ernie")
    main, startup, loss, _, pg, cfg = _program(JAX)
    scope, exe = JScope(), jf.Executor(jf.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=mha_feed(cfg, B, S, 0), scope=scope)
    with jscope_guard(scope):
        jio.save(main, path)
    start = _jax_state(scope)
    fetch = [loss.name] + [g.name for _, g in pg]
    steps = [exe.run(main, feed=mha_feed(cfg, B, S, 1 + i), fetch_list=fetch,
                     scope=scope) for i in range(2)]
    return dict(path=path, start=start, steps=steps, end=_jax_state(scope),
                grads=[(p.name, g.name) for p, g in pg], cfg=cfg)


def test_a_jax_checkpoint_resumes_in_the_port(jax_checkpoint):
    """The JAX package's .pdmodel runs in the port as the Program it
    pickled, its .pdparams load through io.load, and two further Adam
    steps (dropout 0) agree with the JAX package's."""
    ck = jax_checkpoint
    prog = tio.load_program(ck["path"])
    built, *_ = _program(PORT)
    assert isinstance(prog, tf.Program)
    assert [(op.type, op.inputs, op.outputs) for op in prog.global_block.ops
            ] == [(op.type, op.inputs, op.outputs)
                  for op in built.global_block.ops]
    assert prog.random_seed == 7 and prog._rng_step == 1
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    with tf.scope_guard(scope):
        tio.load(prog, ck["path"], executor=exe)
    got = _port_state(scope)
    assert set(got) == set(ck["start"])
    for name, want in ck["start"].items():
        np.testing.assert_array_equal(got[name], want.astype(got[name].dtype),
                                      err_msg=name)
    fetch = [n for _, n in ck["grads"]]
    loss_name = next(op.outputs["Out"][0] for op in prog.global_block.ops
                     if op.type == "mean")
    steps = [exe.run(prog, feed=mha_feed(ck["cfg"], B, S, 1 + i),
                     fetch_list=[loss_name] + fetch, scope=scope)
             for i in range(2)]
    for i, (g, w) in enumerate(zip(steps, ck["steps"])):
        np.testing.assert_allclose(g[0], np.asarray(w[0]), rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        for name, gv, wv in zip(fetch, g[1:], w[1:]):
            np.testing.assert_allclose(gv, np.asarray(wv), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} {i}")
    grads = {p: [(g[1 + j], np.asarray(w[1 + j]))
                 for g, w in zip(steps, ck["steps"])]
             for j, (p, _) in enumerate(ck["grads"])}
    exempt, total = _check_updates(ck["start"], _port_state(scope),
                                   ck["end"], grads, LR)
    assert exempt < 0.02 * total


def _predict(io, exe, main, prob, scope, feed):
    """prob of main's test-mode feed -> prob slice (either package)."""
    test = io.prune(main.clone(for_test=True), [prob.name], feeds=FEEDS)
    return np.asarray(exe.run(test, feed={k: feed[k] for k in FEEDS},
                              fetch_list=[prob.name], scope=scope)[0])


def test_the_port_files_load_into_the_jax_package(tmp_path):
    """The port's .pdparams (io.load) and __params__.npz
    (_load_npz_verified) in the JAX package give the port's predictions."""
    main, _, prob, exe, scope, cfg = _train_port(0.0, steps=2)
    path = str(tmp_path / "ernie")
    with tf.scope_guard(scope):
        tio.save(main, path)
        tio.save_inference_model(str(tmp_path / "model"), list(FEEDS), [prob],
                                 exe, main_program=main)
    feed = mha_feed(cfg, B, S, 5)
    want = _predict(tio, exe, main, prob, scope, feed)

    jmain, _, _, jprob, _, _ = _program(JAX)
    jexe, jscope = jf.Executor(jf.CPUPlace()), JScope()
    with jscope_guard(jscope):
        jio.load(jmain, path)
    np.testing.assert_allclose(_predict(jio, jexe, jmain, jprob, jscope, feed),
                               want, atol=1e-5)

    arrays = jio._load_npz_verified(str(tmp_path / "model" /
                                        "__params__.npz"))
    jscope = JScope()
    for name, arr in arrays.items():
        jscope.set_var(name, jnp.asarray(arr))
    np.testing.assert_allclose(_predict(jio, jexe, jmain, jprob, jscope, feed),
                               want, atol=1e-5)


