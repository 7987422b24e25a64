"""The optimizer's accumulator tags in the port: ``_accum_of`` (the
parameter an accumulator belongs to) and ``_accum_elementwise`` (whether
it is parameter-shaped), as the JAX package's Optimizer._add_accumulator
sets them. spmd.spec_for gives a parameter-shaped accumulator its
parameter's sharding spec through the tag, the embedding engine finds a
cached table's optimizer state by it, and both packages' program files
carry it in each direction.

The program is bench.py's deepfm at its CPU config with Adam (moments
and beta powers) and a Momentum program (velocities), from
test_torch_deepfm_training.py's build function.
"""

import pickle

import paddle_tpu as jf
from paddle_tpu import io as jio
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard

import paddle_tpu_torch as tf
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.parallel import spec_for

from test_torch_deepfm_training import JAX, PORT, build
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

TAGS = ("_accum_of", "_accum_elementwise")


def tags(program):
    """{var name: (_accum_of, _accum_elementwise)} of every variable that
    carries the tags."""
    return {v.name: tuple(getattr(v, t) for t in TAGS)
            for v in program.list_vars() if hasattr(v, "_accum_of")}


def test_accumulator_tags_equal_the_jax_packages():
    jmain, tmain = build(JAX, "plain")[0], build(PORT, "plain")[0]
    want = tags(jmain)
    params = [p.name for p in tmain.all_parameters() if p.trainable]
    # Adam: two moments and two beta powers a parameter
    assert len(want) == 4 * len(params)
    assert tags(tmain) == want
    for name, (parent, elementwise) in want.items():
        assert name.startswith(parent + "_"), name
        # the beta powers are [1] scalars, even of a [1] bias
        assert elementwise == ("_pow_" not in name), name
    # Momentum's velocities too
    with tf.unique_name.guard(), tf.program_guard(tmain, tf.Program()):
        tf.optimizer.Momentum(0.1, 0.9).apply_gradients(
            [(tmain.global_block.var("deepfm_out_w"),
              tmain.global_block.var("deepfm_out_w@GRAD"))])
    vel = [v for v in tmain.list_vars()
           if getattr(v, "_accum_of", None) == "deepfm_out_w"
           and "velocity" in v.name]
    assert len(vel) == 1 and vel[0]._accum_elementwise is True


def test_spec_for_gives_moments_their_parameters_spec():
    main = build(PORT, "plain")[0]
    main._sharding = {"deepfm_mlp0_w": ("mp", None), "deepfm_emb": ("ps",)}
    for name, (parent, elementwise) in tags(main).items():
        if parent not in main._sharding:
            assert spec_for(main, name) == (), name
        elif elementwise:
            assert spec_for(main, name) == spec_for(main, parent), name
        else:  # the beta powers ([1]) stay replicated
            assert spec_for(main, name) == (), name
    assert spec_for(main, "deepfm_emb_moment1_0") == ("ps",)


def test_tags_round_trip_through_program_files(tmp_path):
    """The port's .pdmodel unpickles in the JAX package with the tags;
    the JAX package's loads in the port with them; the port's own
    reloads with them."""
    tmain, tstartup, _, _ = build(PORT, "plain")
    scope = tf.Scope()
    tf.Executor(tf.CPUPlace()).run(tstartup, scope=scope)
    port_path = str(tmp_path / "port")
    with tf.scope_guard(scope):
        tio.save(tmain, port_path)
    with open(port_path + ".pdmodel", "rb") as f:
        read_by_jax = pickle.load(f)
    assert type(read_by_jax).__module__ == "paddle_tpu.framework.program"
    assert tags(read_by_jax) == tags(tmain)
    assert tags(tio.load_program(port_path)) == tags(tmain)

    jmain, jstartup, _, _ = build(JAX, "plain")
    jscope = JScope()
    jf.Executor(jf.CPUPlace()).run(jstartup, scope=jscope)
    jax_path = str(tmp_path / "jax")
    with jscope_guard(jscope):
        jio.save(jmain, jax_path)
    read_by_port = tio.load_program(jax_path)
    assert tags(read_by_port) == tags(jmain) == tags(tmain)
