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

Where the JAX package compiles (a plan-cache miss), the static verifier
runs behind ``PADDLE_TPU_VERIFY`` (analysis/verify.py), and each plan
gets one analytic cost estimate (``Program.estimate``) that feeds the
``perf.*`` telemetry: the ``perf.step_flops`` / ``perf.step_bytes``
counters on every run, and from the steady-state runs (not the one that
built the plan) the ``perf.step_seconds``, ``perf.mfu`` and
``perf.family_time.*`` gauges. A step's time is the wall time of `run`:
on the card the emitters enqueue their kernels and `run` returns without
a synchronize, so a steady run of steps times the card's pace once the
launch queue is full.

A program with a mesh (parallel/spmd.py shard_program) runs SPMD: every
rank runs the block on its shard, as the JAX package's shard_map does on
every device. A feed or scope value whose variable has a sharding spec
is the global value, and the rank takes its slice; a sharded fetch or
written-back value is all-gathered into the global value on every rank;
replicated ones pass as they are. The collective ops run over the
mesh's process groups (EmitContext.mesh).
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque

import torch

from .. import observability as _obs
from ..core.place import default_place
from ..errors import (
    NotFoundError,
    PreconditionNotMetError,
    UnimplementedError,
)
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


class _Plan:
    """One cached run plan: the state read from the scope, the
    persistables written back, and the perf telemetry of the plan (the
    analytic estimate: None until computed, False when it failed, never
    retried; the window of steady-state step times behind perf.mfu)."""

    __slots__ = ("from_scope", "write_back", "est", "recent_dts")

    def __init__(self, from_scope, write_back):
        self.from_scope = from_scope
        self.write_back = write_back
        self.est = None
        self.recent_dts = deque(maxlen=32)


class _PerfEstimate:
    """Digest of a CostTable cached per plan for the per-run perf.*
    updates (the full table is published once, as the "perf.cost_table"
    observability table)."""

    __slots__ = ("flops", "bytes", "peak", "family_shares")

    def __init__(self, table):
        self.flops = float(table.total_flops)
        self.bytes = float(table.total_bytes)
        self.peak = float(table.peak_flops)
        total_lat = table.total_latency
        self.family_shares = {
            fam: (agg["latency"] / total_lat if total_lat else 0.0)
            for fam, agg in table.by_family().items()
        }


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
        t0 = time.perf_counter()
        fetches, plan, fresh = self._run_body(program, feed, fetch_list,
                                              scope, return_numpy)
        self._note_perf(plan, fresh, time.perf_counter() - t0)
        return fetches

    def _run_body(self, program, feed, fetch_list, scope, return_numpy):
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
            # where the JAX package compiles: the static verifier
            # (PADDLE_TPU_VERIFY=strict refuses the run here)
            from ..analysis import check_before_compile

            check_before_compile(program, set(feeds), fetch_names)
            plan = _Plan(*_analyze_block(block, set(feeds), fetch_names))
            self._cache[key] = plan
            while len(self._cache) > self.CACHE_CAPACITY:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(key)
        if plan.est is None and _obs.enabled():
            plan.est = self._estimate(program, feeds)
        from_scope, write_back = plan.from_scope, plan.write_back

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
            fetches = [_to_numpy(t) for t in fetches]
        return fetches, plan, first_run

    # ------------------------------------------------------------------
    @staticmethod
    def _estimate(program, feeds):
        """Analytic cost digest of the plan about to run, pinned at the
        feed shapes; publishes the full per-op table as the
        "perf.cost_table" table and the static plan's peak and resident
        bytes as gauges. Returns False on failure, so that a plan is
        estimated once, never every step."""
        try:
            table = program.estimate(feed_shapes={
                k: tuple(t.shape) for k, t in feeds.items()
            })
            _obs.set_table("perf.cost_table", table.to_dict(top=50))
            if table.peak_bytes is not None:
                _obs.set_gauge("perf.peak_bytes_est",
                               float(table.peak_bytes))
                _obs.set_gauge("perf.resident_bytes_est",
                               float(table.resident_bytes))
            return _PerfEstimate(table)
        except Exception:  # the telemetry must not fail a run
            _obs.add("perf.estimate_failures")
            return False

    @staticmethod
    def _drop_perf_gauges():
        for prefix in ("perf.mfu", "perf.step_seconds",
                       "perf.family_time."):
            _obs.drop_gauges(prefix)

    def _note_perf(self, plan, fresh, dt):
        """Per-run perf.* telemetry from the plan's estimate: the step
        FLOP and byte counters always; the step-time, MFU and family-time
        gauges only from steady-state runs (the run that built the plan
        is not one, and the previous plan's gauges must not read as
        live for this one)."""
        if not _obs.enabled():
            return
        est = plan.est
        if not est:
            self._drop_perf_gauges()
            return
        _obs.add("perf.step_flops", int(est.flops))
        _obs.add("perf.step_bytes", int(est.bytes))
        if fresh or dt <= 0:
            self._drop_perf_gauges()
            return
        plan.recent_dts.append(dt)
        mean_dt = sum(plan.recent_dts) / len(plan.recent_dts)
        _obs.set_gauge("perf.step_seconds", mean_dt)
        if est.peak > 0 and est.flops > 0:
            _obs.set_gauge("perf.mfu", est.flops / mean_dt / est.peak)
        # the measured step time split over the op families by their
        # shares of the estimated roofline
        _obs.drop_gauges("perf.family_time.")
        for fam, share in est.family_shares.items():
            _obs.set_gauge(f"perf.family_time.{fam}", share * mean_dt)

    # ------------------------------------------------------------------
    def flops(self, program=None, feed=None, fetch_list=None, scope=None):
        """The JAX package's XLA count of a step's FLOPs (its compiled
        executable's cost_analysis) has no counterpart yet: the port's
        count is ``Program.estimate(feed_shapes).total_flops``, which the
        perf.* telemetry already uses."""
        raise UnimplementedError(
            "Executor.flops (a compiler's cost analysis of the step) is "
            "ROADMAP Queue 1 item 8 (the operations planes); "
            "Program.estimate(feed_shapes).total_flops counts the step's "
            "FLOPs")

    def memory_analysis(self, program=None, feed=None, fetch_list=None,
                        scope=None):
        """The card's peak memory over ONE step of `program` with this
        feed: ``{"peak_bytes": torch.cuda.max_memory_allocated()}`` after
        ``reset_peak_memory_stats``, so it counts the state the scope
        already holds as well as what the step allocates. The step runs
        (a training program takes its update). The measured side of the
        static plan (``Program.estimate().peak_bytes``). On the CPU it
        returns None, with the ``perf.memory_analysis_unavailable``
        counter bumped."""
        if self.device.type != "cuda":
            _obs.add("perf.memory_analysis_unavailable")
            return None
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        self.run(program, feed=feed, fetch_list=fetch_list, scope=scope,
                 return_numpy=False)
        torch.cuda.synchronize(self.device)
        return {"peak_bytes":
                float(torch.cuda.max_memory_allocated(self.device))}

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

