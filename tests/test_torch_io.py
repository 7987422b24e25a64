"""The port's checkpoint and model files (paddle_tpu_torch.io): its own
save -> load round trip is bit for bit, corrupt files raise
CheckpointCorruptionError, what the port lacks is refused by name,
reading the JAX package's files never imports jax, and the writers sweep
their stale temp files and refuse a full disk. The JAX package's
checkpoints in the port, and the port's in the JAX package:
tests/test_torch_io_resume.py.

The ERNIE-layout classifier (tests/torch_mha_classifier.py) runs at
BertConfig.tiny() widths (hidden 128, 4 heads, 2 layers), B=2, S=32, on
the CPU.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
from paddle_tpu import io as jio
from paddle_tpu import layers as jl
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard
from paddle_tpu.models.bert import BertConfig as JBertConfig

import paddle_tpu_torch as tf
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.errors import (
    CheckpointCorruptionError,
    StorageExhaustedError,
    UnimplementedError,
)
from paddle_tpu_torch.models.bert import BertConfig as TBertConfig
from torch_mha_classifier import build_mha_classifier, mha_feed

REPO = Path(__file__).resolve().parents[1]
B, S = 2, 32
LR = 1e-3
FEEDS = ("ids", "types", "mask")
JAX = (jf, jl, jun.guard, JBertConfig)
PORT = (tf, tl, tf.unique_name.guard, TBertConfig)


def _program(pkg, dropout=0.0, batch=B):
    fluid, layers, guard, cfg_cls = pkg
    cfg = cfg_cls.tiny()
    cfg.hidden_dropout = cfg.attention_dropout = dropout
    with guard():
        main, startup, loss, prob = build_mha_classifier(fluid, layers, cfg,
                                                         batch, S, False)
        with fluid.program_guard(main, startup):
            _, pg = fluid.optimizer.Adam(LR).minimize(loss, startup)
    main.random_seed = startup.random_seed = 7
    return main, startup, loss, prob, pg, cfg


def _train_port(dropout, steps=1):
    main, startup, loss, prob, pg, cfg = _program(PORT, dropout)
    exe, scope = tf.Executor(tf.CPUPlace()), tf.Scope()
    exe.run(startup, scope=scope)
    for i in range(steps):
        exe.run(main, feed=mha_feed(cfg, B, S, i), scope=scope)
    return main, loss, prob, exe, scope, cfg


def _bit_equal(a, b):
    assert set(a.local_var_names()) == set(b.local_var_names())
    return [n for n in a.local_var_names()
            if not torch.equal(a.find_var(n), b.find_var(n))]


def test_the_port_round_trip_is_bit_for_bit(tmp_path):
    """With dropout 0.1 in training: io.save -> io.load gives every
    persistable bit for bit; a step from the saved scope and one from the
    loaded scope on the program read back (the same seed state) agree bit
    for bit; save/load_persistables and save/load_params the same."""
    main, loss, _, exe, scope, cfg = _train_port(0.1)
    path = str(tmp_path / "ernie")
    with tf.scope_guard(scope):
        tio.save(main, path)
    assert sorted(os.listdir(tmp_path)) == [
        "ernie.manifest.json", "ernie.pdmodel", "ernie.pdparams"]
    loaded = tf.Scope()
    with tf.scope_guard(loaded):
        tio.load(main, path, executor=exe)
    assert _bit_equal(scope, loaded) == []
    resumed = tio.load_program(path)
    assert (resumed._rng_step, resumed._rng_nonce) == (main._rng_step,
                                                       main._rng_nonce)
    feed = mha_feed(cfg, B, S, 9)
    a = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    b = exe.run(resumed, feed=feed, fetch_list=[loss.name], scope=loaded)
    np.testing.assert_array_equal(a[0], b[0])
    assert _bit_equal(scope, loaded) == []

    for save, load, pred in ((tio.save_persistables, tio.load_persistables,
                              tio._is_persistable),
                             (tio.save_params, tio.load_params,
                              tio._is_parameter)):
        d = str(tmp_path / save.__name__)
        with tf.scope_guard(scope):
            save(exe, d, main)
        tio.verify_checkpoint_dir(d)
        again = tf.Scope()
        with tf.scope_guard(again):
            load(exe, d, main)
        names = [v.name for v in main.list_vars() if pred(v)]
        assert sorted(again.local_var_names()) == sorted(names)
        assert all(torch.equal(again.find_var(n), scope.find_var(n))
                   for n in names)


def _truncate(path):
    data = Path(path).read_bytes()
    Path(path).write_bytes(data[: len(data) // 2])


def test_corrupt_files_raise_and_leave_the_scope_alone(tmp_path):
    main, _, prob, exe, scope, _ = _train_port(0.0)
    path = str(tmp_path / "ernie")
    model = str(tmp_path / "model")
    with tf.scope_guard(scope):
        tio.save(main, path)
        tio.save_inference_model(model, list(FEEDS), [prob], exe,
                                 main_program=main)

    target = tf.Scope()
    # a flipped manifest CRC: the payload decodes but does not verify
    man = Path(path + ".manifest.json")
    good = man.read_text()
    entry = '"crc32": '
    i = good.index(entry) + len(entry)
    man.write_text(good[:i] + "1" + good[i:])
    with tf.scope_guard(target), pytest.raises(CheckpointCorruptionError):
        tio.load(main, path, executor=exe)
    man.write_text(good)
    # a truncated payload: undecodable
    _truncate(path + ".pdparams")
    with tf.scope_guard(target), pytest.raises(CheckpointCorruptionError):
        tio.load(main, path, executor=exe)
    assert target.local_var_names() == []
    # the payload gone, its manifest left: a torn publish
    os.unlink(path + ".pdparams")
    with tf.scope_guard(target), pytest.raises(CheckpointCorruptionError):
        tio.load(main, path, executor=exe)
    _truncate(path + ".pdmodel")
    with pytest.raises(CheckpointCorruptionError):
        tio.load_program(path)
    _truncate(os.path.join(model, "__params__.npz"))
    with pytest.raises(CheckpointCorruptionError):
        tio.verify_checkpoint_dir(model)
    with pytest.raises(CheckpointCorruptionError):
        tio.load_inference_model(model, exe)


def _refused(tmp_path, name, obj):
    path = str(tmp_path / name)
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump(obj, f, protocol=4)
    with pytest.raises(UnimplementedError) as e:
        tio.load_program(path)
    return str(e.value)


def test_what_the_port_lacks_is_refused_by_name(tmp_path):
    """A JAX package Program annotated for a mesh and any JAX object are
    refused, each by name; a parameter with a regularizer loads, as the
    port's regularizer of that class and coefficient (training it:
    tests/test_torch_clip_regularizer.py)."""
    jmain, *_ = _program(JAX)
    jmain._sharding = {"word_embedding": ("mp", None)}
    refusal = _refused(tmp_path, "sharded", jmain)
    assert "_sharding" in refusal and "item 1" in refusal
    jmain._sharding = {}
    param = jmain.all_parameters()[0]
    param.regularizer = jf.regularizer.L2Decay(1e-4)
    path = str(tmp_path / "reg")
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump(jmain, f, protocol=4)
    loaded = tio.load_program(path).global_block.var(param.name)
    assert type(loaded.regularizer) is tf.regularizer.L2Decay
    assert loaded.regularizer.coeff == 1e-4
    param.regularizer = None
    assert "jax" in _refused(tmp_path, "array", {"w": jnp.ones(2)})


def test_only_the_jax_packages_files_are_translated(tmp_path):
    """A port program whose Variable carries a field the JAX package never
    had clones (deepcopy) and round-trips through load_program with it:
    the translation of pickled fields applies to the JAX package's files
    alone. A JAX program read in the port is made of the port's own
    classes and clones the same way."""
    from paddle_tpu_torch.framework import program as tprog

    main, *_ = _program(PORT)
    param = main.all_parameters()[0]
    param.slice_note = "added after the port's IR was written"
    for copy in (main.clone(), main.clone(for_test=True)):
        assert copy.global_block.var(param.name).slice_note == param.slice_note
    path = str(tmp_path / "port")
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump(main, f, protocol=4)
    again = tio.load_program(path)
    assert again.global_block.var(param.name).slice_note == param.slice_note

    jmain, *_ = _program(JAX)
    path = str(tmp_path / "jax")
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump(jmain, f, protocol=4)
    prog = tio.load_program(path)
    blocks = prog.blocks
    kinds = {type(prog), *map(type, blocks)}
    kinds |= {type(x) for b in blocks for x in (*b.vars.values(), *b.ops)}
    assert kinds == {tprog.Program, tprog.Block, tprog.Variable,
                     tprog.Parameter, tprog.Operator}
    var = prog.all_parameters()[0]
    var.slice_note = 1
    clone = prog.clone(for_test=True)
    assert clone.global_block.var(var.name).slice_note == 1
    assert type(clone.global_block.var(var.name)) is tprog.Parameter


def test_reading_files_never_imports_jax(tmp_path):
    """In a fresh process: the JAX package's inference model (its pickled
    Program and its arrays) read and run by the port's predictor, and a
    pickled JAX array refused, leave jax and paddle_tpu out of
    sys.modules; so does importing every module of the port and
    chip_smoke.py."""
    jmain, jstartup, _, jprob, _, cfg = _program(JAX, batch=-1)
    jscope = JScope()
    jf.Executor(jf.CPUPlace()).run(jstartup, scope=jscope)
    model = str(tmp_path / "model")
    with jscope_guard(jscope):
        jio.save_inference_model(model, list(FEEDS), [jprob],
                                 main_program=jmain)
    with open(tmp_path / "array.pdmodel", "wb") as f:
        pickle.dump({"w": jnp.ones(2)}, f, protocol=4)
    feed = mha_feed(cfg, B, S, 3)
    np.savez(tmp_path / "feed.npz", **{k: feed[k] for k in FEEDS})
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import numpy as np
        import paddle_tpu_torch as tf
        from paddle_tpu_torch import inference, io
        from paddle_tpu_torch.errors import UnimplementedError
        for m in pkgutil.walk_packages(tf.__path__, "paddle_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        pred = inference.create_paddle_predictor(
            inference.AnalysisConfig({model!r}, place=tf.CPUPlace()))
        feed = np.load({str(tmp_path / "feed.npz")!r})
        out = pred.run([feed[k] for k in {FEEDS!r}])[0].as_ndarray()
        assert out.shape == ({B}, 2), out.shape
        try:
            io.load_program({str(tmp_path / "array")!r})
            raise SystemExit("a pickled JAX array was read")
        except UnimplementedError:
            pass
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


def test_stale_temp_files_are_swept_and_a_full_disk_refused(tmp_path,
                                                            monkeypatch):
    stale = tmp_path / "ernie.pdparams.tmp.abc123"
    stale.write_bytes(b"x" * 100)
    (tmp_path / "keep.npz").write_bytes(b"y")
    assert tio.sweep_stale_tmp(str(tmp_path)) == 100
    assert sorted(os.listdir(tmp_path)) == ["keep.npz"]
    monkeypatch.setenv(tio.PREFLIGHT_SLACK_ENV, str(1 << 62))
    with pytest.raises(StorageExhaustedError):
        tio.save_arrays(str(tmp_path), {"w": np.zeros(4, np.float32)})
    assert sorted(os.listdir(tmp_path)) == ["keep.npz"]


def test_bf16_state_round_trips_as_bf16(tmp_path):
    """numpy has no bfloat16: a bf16 persistable is written as float32
    (exact) and read back as the bf16 its program declares."""
    main = tf.Program()
    main.global_block.create_var(name="w16", shape=[5], dtype="bfloat16",
                                 persistable=True)
    w = torch.tensor([0.1, -2.5, 3.0, 1e-3, 7.0]).bfloat16()
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    scope.set_var("w16", w)
    with tf.scope_guard(scope):
        tio.save_persistables(exe, str(tmp_path), main)
    assert tio.read_persistables(str(tmp_path))["w16"].dtype == np.float32
    again = tf.Scope()
    with tf.scope_guard(again):
        tio.load_persistables(exe, str(tmp_path), main)
    got = again.find_var("w16")
    assert got.dtype == torch.bfloat16 and torch.equal(got, w)
