"""The JAX package reads the port's program files: a `.pdmodel` written by
paddle_tpu_torch.io.save and a `__model__` written by
io.save_inference_model load with plain pickle and paddle_tpu.io.load /
paddle_tpu.io.load_inference_model (which import paddle_tpu's IR
classes), and run there with the same answers as in the port. The port's
pickler writes the JAX package's class paths and fields without
importing paddle_tpu, and refuses a program with a mesh by name.

The ERNIE-layout classifier of test_torch_io.py (BertConfig.tiny()
widths, B=2, S=32, dropout 0, Adam), on the CPU. Tolerances, fp32 on
both sides, sums in other orders: loss rtol 1e-5; parameters after a
step atol 1e-6 + rtol 1e-4; predicted probabilities atol 1e-5.
"""

import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import paddle_tpu as jf
from paddle_tpu import io as jio
from paddle_tpu.framework import program as jprogram
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard

import paddle_tpu_torch as tf
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.errors import UnimplementedError
from test_torch_io import B, FEEDS, REPO, S, _train_port
from torch_mha_classifier import mha_feed


def test_the_jax_package_reads_and_runs_the_ports_pdmodel(tmp_path):
    """io.save's .pdmodel unpickles in the JAX package as its own IR
    classes; paddle_tpu.io.load reads the .pdparams into its scope; one
    Adam step there and one in the port, on the program each read back,
    give the same loss and parameters."""
    main, loss, _, exe, scope, cfg = _train_port(0.0)
    path = str(tmp_path / "ernie")
    with tf.scope_guard(scope):
        tio.save(main, path)
    with open(path + ".pdmodel", "rb") as f:
        jprog = pickle.load(f)
    blocks = jprog.blocks
    kinds = {type(jprog), *map(type, blocks)}
    kinds |= {type(x) for b in blocks for x in (*b.vars.values(), *b.ops)}
    assert kinds == {jprogram.Program, jprogram.Block, jprogram.Variable,
                     jprogram.Parameter, jprogram.Operator}
    assert [op.type for op in jprog.global_block.ops] == [
        op.type for op in main.global_block.ops]
    jscope = JScope()
    with jscope_guard(jscope):
        jio.load(jprog, path)
    params = [p.name for p in main.all_parameters()]
    for n in params:
        np.testing.assert_array_equal(np.asarray(jscope.find_var(n)),
                                      scope.find_var(n).numpy())

    feed = mha_feed(cfg, B, S, 5)
    jexe = jf.Executor(jf.CPUPlace())
    (jl,) = jexe.run(jprog, feed=feed, fetch_list=[loss.name], scope=jscope)
    resumed = tio.load_program(path)
    (tl,) = exe.run(resumed, feed=feed, fetch_list=[loss.name], scope=scope)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5)
    for n in params:
        np.testing.assert_allclose(scope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


def test_the_jax_package_loads_and_runs_the_ports_inference_model(tmp_path):
    """save_inference_model's __model__ and __params__.npz load through
    paddle_tpu.io.load_inference_model and answer as the port's program
    does."""
    main, _, prob, exe, scope, cfg = _train_port(0.0)
    model = str(tmp_path / "model")
    with tf.scope_guard(scope):
        fetch = tio.save_inference_model(model, list(FEEDS), [prob], exe,
                                         main)
    feed = {k: v for k, v in mha_feed(cfg, B, S, 3).items() if k in FEEDS}
    jscope = JScope()
    jexe = jf.Executor(jf.CPUPlace())
    with jscope_guard(jscope):
        jprog, jfeeds, jfetch = jio.load_inference_model(model, jexe)
        (want,) = jexe.run(jprog, feed=feed, fetch_list=jfetch)
    assert (jfeeds, jfetch) == (list(FEEDS), fetch)
    assert isinstance(jprog, jprogram.Program)
    tscope = tf.Scope()
    with tf.scope_guard(tscope):
        tprog, _, tfetch = tio.load_inference_model(model, exe)
        (got,) = exe.run(tprog, feed=feed, fetch_list=tfetch, scope=tscope)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_a_program_with_a_mesh_is_refused_by_name(tmp_path):
    """A sharded program holds process groups: io.save refuses it, naming
    the mesh, and writes nothing under the model's name."""
    main, _, _, _, scope, _ = _train_port(0.0)
    main._mesh = object()  # what shard_program attaches
    path = str(tmp_path / "sharded")
    with tf.scope_guard(scope), pytest.raises(UnimplementedError,
                                              match="_mesh"):
        tio.save(main, path)
    assert not (tmp_path / "sharded.pdmodel").exists()


def test_writing_a_program_imports_neither_jax_nor_paddle_tpu(tmp_path):
    """In a fresh process the port writes a .pdmodel in the JAX package's
    form without importing jax or paddle_tpu."""
    code = textwrap.dedent(f"""
        import sys
        import paddle_tpu_torch as tf
        from paddle_tpu_torch import io, layers
        main, startup = tf.Program(), tf.Program()
        with tf.program_guard(main, startup):
            x = layers.data("x", [2, 4], "float32")
            layers.fc(x, size=3)
        io._atomic_write({str(tmp_path / "m.pdmodel")!r},
                         lambda f: io._dump(main, f))
        data = open({str(tmp_path / "m.pdmodel")!r}, "rb").read()
        assert b"paddle_tpu.framework.program" in data
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.")
               or m == "paddle_tpu" or m.startswith("paddle_tpu.")]
        print(bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
    with open(tmp_path / "m.pdmodel", "rb") as f:
        prog = pickle.load(f)
    assert isinstance(prog, jprogram.Program)
    assert [op.type for op in prog.global_block.ops] == ["mul",
                                                        "elementwise_add"]
