"""Executor: runs a block's ops in order on one device (counterpart of
paddle_tpu/framework/executor.py).

The JAX package traces a whole block into one XLA computation. Here the
block runs eagerly, op by op, each emitter calling torch (and, for the
fused ops, the hand-written kernels). What carries over is the
contract:

    feed tensors + persistable state  ->  emitters  ->  fetches + new state

with the block analysis cached per (program, program version, feed
shapes, fetch set), as the JAX package caches its jitted executables.
Mutated persistables (initializer outputs, optimizer updates) are written
back to the scope after the run.

A program with a mesh (parallel/spmd.py shard_program) runs SPMD: every
rank runs the block on its shard, as the JAX package's shard_map does on
every device. A feed or scope value whose variable has a sharding spec
is the global value, and the rank takes its slice; a sharded fetch or
written-back value is all-gathered into the global value on every rank;
replicated ones pass as they are. The collective ops run over the
mesh's process groups (EmitContext.mesh).
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..core.place import default_place
from ..errors import NotFoundError, PreconditionNotMetError
from ..parallel.spmd import gather_global, local_slice, spec_for
from .program import Variable, default_main_program
from .registry import EmitContext, run_op
from .scope import global_scope


def _analyze_block(block, feed_names, fetch_names):
    """(state read from the scope, persistables written back) for a run."""
    produced = set()
    from_scope = []
    seen = set()
    mutated = set()
    for op in block.ops:
        for n in op.input_names():
            if n and n not in produced and n not in feed_names and n not in seen:
                from_scope.append(n)
                seen.add(n)
        for n in op.output_names():
            if not n:
                continue
            produced.add(n)
            v = block._find_var_recursive(n)
            if v is not None and v.persistable:
                mutated.add(n)
    for n in fetch_names:
        if n not in produced and n not in feed_names and n not in seen:
            from_scope.append(n)
            seen.add(n)
    return tuple(from_scope), tuple(sorted(mutated))


class Executor:
    """fluid.Executor parity (python/paddle/fluid/executor.py:890)."""

    CACHE_CAPACITY = 128

    def __init__(self, place=None):
        self.place = place if place is not None else default_place()
        # raises here, at construction, when the place's device is absent
        self.device = self.place.torch_device()
        self._cache = OrderedDict()

    def close(self):
        self._cache.clear()

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        block = program.global_block
        fetch_names = tuple(
            v.name if isinstance(v, Variable) else str(v)
            for v in (fetch_list or [])
        )
        feeds = {k: self._to_device(k, v) for k, v in dict(feed or {}).items()}
        key = (
            program, program._version,
            tuple((k, tuple(t.shape), t.dtype) for k, t in sorted(feeds.items())),
            fetch_names,
        )
        plan = self._cache.get(key)
        first_run = plan is None
        if first_run:
            plan = _analyze_block(block, set(feeds), fetch_names)
            self._cache[key] = plan
            while len(self._cache) > self.CACHE_CAPACITY:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(key)
        from_scope, write_back = plan

        env = {n: self._from_scope(scope, n, block) for n in from_scope}
        env.update(feeds)
        mesh = program._mesh
        if mesh is not None:
            self._check_mesh(mesh)
            for n in env:
                sp = spec_for(program, n)
                if sp:
                    env[n] = local_slice(mesh, env[n], sp, n)
        # seed 0 = nondeterministic (fluid semantics): use the program's
        # own nonce. The run counter advances every call.
        seed = program.random_seed or program._rng_nonce
        step = program._rng_step
        program._rng_step += 1
        ctx = EmitContext(
            self.device, seed=seed, step=step,
            # frozen serving programs run in test mode even where an op
            # missed its is_test flip
            is_test=program._is_inference, mesh=mesh, first_run=first_run,
        )
        with torch.no_grad():
            for i, op in enumerate(block.ops):
                try:
                    run_op(ctx, op, env)
                except KeyError as e:
                    raise NotFoundError(
                        f"op #{i} references undefined variable {e}", op=op
                    ) from None
        if mesh is not None:
            # in one order on every rank: each gather is a collective
            for n in dict.fromkeys(write_back + fetch_names):
                sp = spec_for(program, n)
                if sp and n in env:
                    env[n] = gather_global(mesh, env[n], sp)
        for n in write_back:
            if n in env:
                scope.set_var(n, env[n])
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            return [_to_numpy(t) for t in fetches]
        return fetches

    def _check_mesh(self, mesh):
        if mesh.place.torch_device() != self.device:
            raise PreconditionNotMetError(
                f"the program's mesh runs on {mesh.place!r}, but this "
                f"executor runs on {self.device}")

    def _to_device(self, name, value):
        t = torch.as_tensor(value)
        if t.device != self.device:
            t = t.to(self.device)
        return t

    def _from_scope(self, scope, name, block):
        v = scope.find_var(name)
        if v is None:
            var = block._find_var_recursive(name)
            if var is not None and var.is_data:
                raise NotFoundError(
                    f"feed variable {name!r} was not provided in `feed`"
                )
            raise PreconditionNotMetError(
                f"variable {name!r} is not initialized in the scope; "
                "run the startup program first (exe.run(startup_program))"
            )
        if v.device != self.device:
            raise PreconditionNotMetError(
                f"variable {name!r} lives on {v.device}, but this executor "
                f"runs on {self.device}; load the state onto {self.place!r}"
            )
        return v


def _to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()

