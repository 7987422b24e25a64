"""Port parity for the sequence-parallel training program: the `sp_ring`
leg of __graft_entry__.py (build_sp_leg: fc projections into q, k, v,
causal ring attention over an "sp" mesh axis, a global loss through
mp_allreduce_sum, SGD, c_allreduce_sum on every gradient) run by
paddle_tpu_torch and by the JAX package on the CPU.

- sp=2: two gloo ranks (spawned children over a FileStore under
  tmp_path; they import neither jax nor paddle_tpu) against the JAX
  package's sp=2 mesh of its 8-device virtual CPU mesh, three SGD steps
  from the JAX package's startup state: every loss, every gradient and
  the final state; the replicated state bit-identical on both ranks.
- sp=1: a 1-rank gloo mesh in the test's process against the JAX
  package's sp=1 mesh, and the meshless program (dense attention through
  `_attention_fallback`) against the JAX package's meshless run.

Shapes: b=1, h=8, s=32, d=16. The JAX package runs its chunked-jnp
shard backend (`_FORCE_JNP`, set here by monkeypatch only): its Pallas
kernels in interpret mode take ~40 s for this program, and
test_torch_ring_attention*.py hold the port against both backends. The
sp=1 and meshless cases are in test_torch_sp_training_sp1.py (each file
stays under 20 s). Tolerances, fp32 on both sides, sums in other orders:
loss rtol 1e-5; gradients and weights atol 1e-6 + rtol 1e-4.
"""

import numpy as np
import pytest

import jax

import paddle_tpu as jf
from paddle_tpu import layers as jl
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import ring_attention as jra
from paddle_tpu.parallel import shard_program as jshard_program
from paddle_tpu.parallel.transpiler import insert_grad_allreduce as jinsert

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert
from paddle_tpu_torch import layers as tl
from paddle_tpu_torch.parallel import (
    insert_grad_allreduce,
    make_mesh,
    shard_program,
)
from test_torch_bert_training import _jax_state
from torch_sp_worker import Ranks, build_sp_leg, sp_leg_worker

SHAPE = (1, 8, 32, 16)
STEPS = 3


def _feed():
    return np.random.RandomState(0).randn(*SHAPE).astype(np.float32)


def _jax_run(world, op="ring_attention"):
    """(startup state, {step/name: value}, final state) of the JAX
    package's run, on an sp mesh of `world` devices (None: meshless)."""
    main, startup, loss, pg = build_sp_leg(jf, jl, jun, jinsert, SHAPE, op)
    scope, exe = JScope(), jf.Executor(jf.CPUPlace())
    exe.run(startup, scope=scope)
    start = _jax_state(scope)
    if world:
        jshard_program(main, jmake_mesh({"sp": world}, jax.devices()[:world]),
                       {"x": (None, None, "sp")})
    fetch = [loss.name] + [g.name for _, g in pg]
    res = {}
    for i in range(STEPS):
        vals = exe.run(main, feed={"x": _feed()}, fetch_list=fetch,
                       scope=scope)
        res.update({f"{i}/{n}": np.asarray(v) for n, v in zip(fetch, vals)})
    return start, res, _jax_state(scope)


def _check(got, want, end, loss_name):
    for key, w in want.items():
        if key.endswith("/" + loss_name):
            np.testing.assert_allclose(got[key], w, rtol=1e-5, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-6,
                                       err_msg=key)
    for name, w in end.items():
        np.testing.assert_allclose(got["state/" + name], w, rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.fixture(autouse=True)
def _jnp_backend(monkeypatch):
    monkeypatch.setattr(jra, "_FORCE_JNP", True)


def _start(tmp_path):
    """The JAX package's startup state, and the port's two ranks started
    from it (they run while the JAX package's side is computed)."""
    main, startup, _, _ = build_sp_leg(jf, jl, jun, jinsert, SHAPE)
    scope = JScope()
    jf.Executor(jf.CPUPlace()).run(startup, scope=scope)
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, x=_feed(), **_jax_state(scope))
    return Ranks(sp_leg_worker, 2, tmp_path, inputs, "ring_attention", STEPS)


def test_sp2_three_sgd_steps_match_the_jax_package(tmp_path):
    ranks = _start(tmp_path)
    start, want, end = _jax_run(2)
    res = ranks.results()
    loss_name = next(k for k in want if k.startswith("0/")).split("/", 1)[1]
    for r in res:
        assert not r.pop("imported_jax")
    _check(res[0], want, end, loss_name)
    # replicated state and fetches: the same bits on both ranks
    assert set(res[0]) == set(res[1])
    for key in res[0]:
        np.testing.assert_array_equal(res[0][key], res[1][key], err_msg=key)


def _port_run(world, start, op="ring_attention"):
    main, startup, loss, pg = build_sp_leg(tf, tl, tf.unique_name,
                                           insert_grad_allreduce, SHAPE, op)
    scope, exe = tf.Scope(), tf.Executor(tf.CPUPlace())
    convert.state_from_numpy(start, scope, tf.CPUPlace(), program=main)
    mesh = None
    if world:
        mesh = make_mesh({"sp": world}, place=tf.CPUPlace())
        shard_program(main, mesh, {"x": (None, None, "sp")})
    fetch = [loss] + [g for _, g in pg]
    res = {}
    try:
        for i in range(STEPS):
            vals = exe.run(main, feed={"x": _feed()}, fetch_list=fetch,
                           scope=scope)
            res.update({f"{i}/{v.name}": a for v, a in zip(fetch, vals)})
    finally:
        if mesh is not None:
            mesh.close()
    res.update({"state/" + n: a
                for n, a in convert.state_to_numpy(scope).items()})
    return res, loss.name
