"""Rank processes of the port's multi-rank CPU tests (test_torch_ring_
attention.py, test_torch_sp_training.py), and the sequence-parallel
program they share with the JAX package's side of those tests and with
chip_smoke.py.

Each child is one rank of a gloo process group over a FileStore in the
test's tmp_path (no TCP port, so parallel test workers cannot collide),
reads its inputs from an .npz, runs the port, and writes what it computed
to an .npz of its own. This module imports neither jax nor paddle_tpu:
the children record whether either got imported.
"""

from __future__ import annotations

import sys
import threading

import numpy as np


def build_sp_leg(fluid, layers, unique_name, insert_grad_allreduce, shape,
                 op="ring_attention", lr=0.1):
    """__graft_entry__.py's build_sp_leg for either package: fc
    projections of x [B, H, S, D] into q, k and v, causal sequence-
    parallel attention over "sp", the global loss reduce_sum(square) ->
    mp_allreduce_sum over sp -> scale by the global element count, SGD,
    and c_allreduce_sum over sp on every gradient. Returns (main,
    startup, loss, params_grads)."""
    b, h, s, d = shape
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1234
    with fluid.program_guard(main, startup), unique_name.guard():
        x = fluid.data("x", [b, h, s, d], "float32")
        q = layers.fc(x, size=d, num_flatten_dims=3)
        k = layers.fc(x, size=d, num_flatten_dims=3)
        v = layers.fc(x, size=d, num_flatten_dims=3)
        o = getattr(layers, op)(q, k, v, axis_name="sp", causal=True)
        ssum = layers.reduce_sum(layers.square(o))
        blk = main.global_block
        blk.append_op(
            "mp_allreduce_sum", {"X": [ssum.name]}, {"Out": [ssum.name]},
            {"axis_name": "sp"},
        )
        loss = layers.scale(ssum, scale=1.0 / (b * h * s * d))
        _, pg = fluid.optimizer.SGD(lr).minimize(loss, startup)
        for _, g in pg:
            insert_grad_allreduce(blk, g, "sp")
    return main, startup, loss, pg


def _init(rank, world, store):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # one core a rank: the ranks share the host
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)


def _imported_jax():
    return any(m == "jax" or m.startswith("jax.") or m == "paddle_tpu"
               or m.startswith("paddle_tpu.") for m in sys.modules)


def attention_worker(rank, world, store, inputs, out):
    """Ring and Ulysses attention of this rank's sequence shards of the
    global q, k, v [B, H, S, D] in `inputs`, causal and not: the local
    output and the local dq, dk, dv for the output gradient w (the
    gradient of sum(out * w))."""
    import torch

    from paddle_tpu_torch import CPUPlace
    from paddle_tpu_torch.parallel import make_mesh, ring_attention as ra
    from paddle_tpu_torch.parallel.spmd import local_slice

    _init(rank, world, store)
    mesh = make_mesh({"sp": world}, place=CPUPlace())
    data = np.load(inputs)
    spec = (None, None, "sp")
    q, k, v, w = (local_slice(mesh, torch.from_numpy(data[n]), spec, n)
                  for n in ("q", "k", "v", "w"))
    res = {}
    for name, fwd, grads in (
            ("ring", ra.ring_attention, ra.ring_attention_grads),
            ("ulysses", ra.ulysses_attention, ra.ulysses_attention_grads)):
        for causal in (False, True):
            tag = f"{name}_{int(causal)}"
            res[tag + "_out"] = fwd(q, k, v, mesh, "sp", causal).numpy()
            dq, dk, dv = grads(q, k, v, w, mesh, "sp", causal)
            for g, n in zip((dq, dk, dv), "qkv"):
                res[f"{tag}_d{n}"] = g.numpy()
    res["imported_jax"] = np.asarray(_imported_jax())
    np.savez(out, **res)
    import torch.distributed as dist

    dist.destroy_process_group()


def sp_leg_worker(rank, world, store, inputs, op, steps, out):
    """`steps` SGD steps of build_sp_leg's program on an sp mesh of
    `world` ranks, from the state in `inputs` (the JAX package's startup
    state) on its global feed x: per step the loss and every gradient,
    and every persistable after the last step."""
    import paddle_tpu_torch as tf
    from paddle_tpu_torch import convert, layers, unique_name
    from paddle_tpu_torch.parallel import (
        insert_grad_allreduce,
        make_mesh,
        shard_program,
    )

    _init(rank, world, store)
    data = np.load(inputs)
    x = data["x"]
    main, startup, loss, pg = build_sp_leg(
        tf, layers, unique_name, insert_grad_allreduce, x.shape, op)
    mesh = make_mesh({"sp": world}, place=tf.CPUPlace())
    shard_program(main, mesh, {"x": (None, None, "sp")})
    scope = tf.Scope()
    state = {n: data[n] for n in data.files if n != "x"}
    convert.state_from_numpy(state, scope, tf.CPUPlace(), program=main)
    exe = tf.Executor(tf.CPUPlace())
    res = {}
    fetch = [loss] + [g for _, g in pg]
    for i in range(steps):
        vals = exe.run(main, feed={"x": x}, fetch_list=fetch, scope=scope)
        for var, val in zip(fetch, vals):
            res[f"{i}/{var.name}"] = val
    for name, val in convert.state_to_numpy(scope).items():
        res["state/" + name] = val
    res["imported_jax"] = np.asarray(_imported_jax())
    np.savez(out, **res)
    import torch.distributed as dist

    dist.destroy_process_group()


def dygraph_dp_steps(tf, dg, state, x, y, steps, data_parallel):
    """`steps` eager Adam steps of a small tanh MLP from `state` on rows
    (x, y) with a mean squared loss, under DataParallel (scale_loss,
    backward, apply_collective_grads) or plainly: per step the loss and
    every gradient, and the parameters after the last step."""
    from paddle_tpu_torch import convert

    res = {}
    with dg.guard(tf.CPUPlace()):
        net = dg.Sequential(dg.Linear(6, 16, act="tanh"), dg.Linear(16, 3))
        convert.layer_state_from_numpy(net, state)
        model = dg.DataParallel(net) if data_parallel else net
        res["nranks"] = np.asarray(model.nranks if data_parallel else 1)
        opt = tf.optimizer.Adam(0.01, parameter_list=net.parameters())
        for i in range(steps):
            d = model(dg.to_variable(x)) - dg.to_variable(y)
            loss = tf.layers.reduce_mean(d * d)
            if data_parallel:
                model.scale_loss(loss).backward()
                model.apply_collective_grads()
            else:
                loss.backward()
            res[f"{i}/loss"] = loss.numpy()
            for n, p in net.named_parameters():
                res[f"{i}/grad/{n}"] = p.gradient()
            opt.minimize(loss)
            net.clear_gradients()
        for n, v in net.state_dict().items():
            res[f"state/{n}"] = v
    return res


def dygraph_dp_worker(rank, world, store, inputs, steps, out):
    """This rank's share of dygraph_dp_steps under DataParallel over the
    "dp" axis of a mesh of every rank: rows rank*n .. (rank+1)*n of the
    global batch in `inputs`, n = B / world."""
    import paddle_tpu_torch as tf
    from paddle_tpu_torch import dygraph as dg
    from paddle_tpu_torch.parallel import make_mesh, mesh_guard

    _init(rank, world, store)
    mesh = make_mesh({"dp": world}, place=tf.CPUPlace())
    data = np.load(inputs)
    n = len(data["x"]) // world
    rows = slice(rank * n, (rank + 1) * n)
    state = {k[len("state/"):]: data[k] for k in data.files
             if k.startswith("state/")}
    with mesh_guard(mesh):
        res = dygraph_dp_steps(tf, dg, state, data["x"][rows],
                               data["y"][rows], steps, True)
    res["imported_jax"] = np.asarray(_imported_jax())
    np.savez(out, **res)
    import torch.distributed as dist

    dist.destroy_process_group()


def stall_worker(rank, world, store, plan, out):
    """A rank that follows plan[rank]: sleep that many seconds (a
    positive float), exit with that code (a negative int, negated), or,
    absent, write an empty .npz and exit 0. No process group: it tests
    Ranks itself."""
    import os
    import time

    act = plan.get(rank)
    if act is None:
        np.savez(out, rank=np.asarray(rank))
    elif act > 0:
        time.sleep(act)
    else:
        os._exit(-act)


class Ranks:
    """target(rank, world, store, *args, out) started in `world` children
    (torch.multiprocessing), one gloo rank each, over a FileStore under
    tmp_path; results() waits for them and returns the .npz each rank
    wrote (`out`), loaded. The children fork from a forkserver process
    that has imported torch and the port (never jax), and they start at
    once: the caller computes the JAX package's side meanwhile."""

    def __init__(self, target, world, tmp_path, *args):
        import torch.multiprocessing as mp

        store = str(tmp_path / "store")
        self.outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(["torch", "torch.distributed",
                                    "paddle_tpu_torch", "torch_sp_worker"])
        self.procs = [ctx.Process(target=target,
                                  args=(r, world, store, *args, self.outs[r]))
                      for r in range(world)]
        # the first start waits for the forkserver to import torch: start
        # them from a thread, so the caller's work overlaps that wait;
        # results() sets _stop to keep it from starting more
        self._stop = threading.Event()
        self._starter = threading.Thread(target=self._start, daemon=True)
        self._starter.start()

    def _start(self):
        for p in self.procs:
            if self._stop.is_set():
                return
            p.start()

    def results(self, start_timeout=240, timeout=120):
        """Every rank's results. Each wait is bounded: the starts (the
        forkserver's imports) by start_timeout seconds, each child by
        timeout seconds. A rank that does not start, hangs or fails
        fails the caller with every rank's exit code, and no child is
        left running."""
        self._starter.join(timeout=start_timeout)
        if self._starter.is_alive():
            # no start after this one: the starter ends once the start
            # under way returns, and then every started child is killed
            self._stop.set()
            self._starter.join(timeout=60)
            started = [r for r, p in enumerate(self.procs)
                       if p.pid is not None]
            self._kill()
            raise RuntimeError(
                f"rank processes not all started after {start_timeout} s "
                f"(the forkserver's imports): started ranks {started} of "
                f"{len(self.procs)}, killed"
                + ("; a start still under way" if self._starter.is_alive()
                   else ""))
        for p in self.procs:
            p.join(timeout=timeout)
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        self._kill()
        codes = [(r, p.exitcode) for r, p in enumerate(self.procs)]
        if hung or any(code != 0 for _, code in codes):
            raise RuntimeError(
                f"rank processes failed: (rank, exit code) {codes}; ranks "
                f"{hung} still running after {timeout} s, killed")
        return [dict(np.load(o)) for o in self.outs]

    def _kill(self):
        for p in self.procs:
            if p.pid is not None and p.is_alive():
                p.kill()
                p.join(timeout=10)
