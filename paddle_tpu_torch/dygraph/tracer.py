"""Eager-mode tracer: runs each op as it is called, with torch autograd
as the tape (counterpart of paddle_tpu/dygraph/tracer.py; reference
imperative/tracer.cc:45 TraceOp, basic_engine.cc:159).

* Ops run through the SAME emitters as the static Executor (the
  registry), through a `registry.EmitContext` on the guard's device: no
  second op set.
* The JAX package records a tape of `jax.vjp` closures and sweeps it in
  reverse. Here torch autograd records the graph: an op's emitter runs on
  tensors that require grad, `VarBase.backward()` is
  `torch.autograd.backward` and a leaf's gradient is its `.grad`.
* An op whose static backward is a dedicated grad op (the fused kernels'
  ops, `framework.backward.dedicated_grad_maker`) runs as one
  `autograd.Function` whose backward runs that grad op's emitter with
  the forward's seed words, so the backward kernels run (and regenerate
  the forward's dropout mask). A kernel launch is invisible to autograd:
  run as a plain emitter, its output would carry no `grad_fn` and the
  gradient would stop there.
* There is no per-op compile cache: the JAX package jit-compiles each
  op's forward and vjp once per signature, while torch runs the emitters
  as they are, eagerly, in both modes.

Random streams: each traced op gets a fresh uid (the tracer's sequence
number), and its context seed is the op's `seed` attr or that uid, as the
JAX package's `seed or seq`; so a training dropout draws a distinct
Philox stream at each occurrence, the same on every run of the same
sequence of ops.
"""

from __future__ import annotations

import torch

from ..errors import InvalidArgumentError
from ..framework.program import Variable
from ..framework.registry import EmitContext, OpView, get_op_def
from .varbase import VarBase

_tracer = None


def _current():
    return _tracer


def _require_tracer():
    if _tracer is None:
        raise RuntimeError(
            "not in dygraph mode; use `with fluid.dygraph.guard():`")
    return _tracer


class Tracer:
    """The eager state of one `dygraph.guard()`: its device, the grad
    switch (`no_grad`), the mode of the Layer called last (`train_mode`,
    set by Layer.__call__) and the op sequence number."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.enable_grad = True
        self.train_mode = True
        self._op_seq = 0

    def trace_op(self, op_type, ins, attrs=None):
        """ins: {slot: [VarBase | None]}. Returns {slot: [VarBase]}."""
        op_def = get_op_def(op_type)
        self._op_seq += 1
        attrs = dict(attrs or {})
        attrs.setdefault("__uid__", self._op_seq)
        uid = int(attrs["__uid__"])
        ctx = EmitContext(self.device, seed=attrs.get("seed", 0) or uid,
                          is_test=not self.train_mode)
        raw = {slot: [None if v is None else _as_tensor(v, self.device)
                      for v in vs]
               for slot, vs in ins.items()}
        grad_on = (self.enable_grad and op_def.differentiable
                   and torch.is_grad_enabled())
        diff = [(slot, i) for slot, vs in raw.items()
                for i, t in enumerate(vs)
                if t is not None and t.requires_grad
                and t.is_floating_point()] if grad_on else []
        dedicated = getattr(op_def.grad_maker, "dedicated", None)
        view = OpView(op_type, attrs,
                      {slot: ["out"] for slot in op_def.output_slots})
        if diff and dedicated is not None:
            outs = _run_dedicated(op_def, view, ctx, raw, diff, dedicated)
        elif diff:
            outs = op_def.emit(ctx, view, raw)
        else:
            with torch.no_grad():
                outs = op_def.emit(ctx, view, raw)
        return {slot: [None if t is None
                       else VarBase(t, stop_gradient=not t.requires_grad)
                       for t in vals]
                for slot, vals in outs.items()}


def _as_tensor(v, device):
    if isinstance(v, VarBase):
        return v.value
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, Variable):
        raise InvalidArgumentError(
            f"eager op input {v.name!r} is a static-graph Variable: under "
            "dygraph.guard() the layers that create parameters (fc, "
            "embedding, layer_norm, ...) are dygraph.nn's Layers")
    return torch.as_tensor(v, device=device)


class _Dedicated(torch.autograd.Function):
    """One traced op whose backward is its dedicated grad op. forward
    runs the op's emitter (autograd off) on the merged inputs; backward
    runs the grad op's emitter under the forward's uid as `__fwd_uid__`
    and its context, on the forward's inputs, the gradient of its Out
    and, where the forward produced every one of them, the outputs the
    grad op declares as inputs (the KV-tiled path's saved Out and Lse;
    elsewhere Lse is empty and the grad op reads the inputs alone, as the
    static grad maker's `saved` rule gives), and returns the gradients of
    the differentiable inputs."""

    @staticmethod
    def forward(fctx, call, *diff_vals):
        merged = {s: list(v) for s, v in call.raw.items()}
        for (slot, i), t in zip(call.diff, diff_vals):
            merged[slot][i] = t
        outs = call.op_def.emit(call.ctx, call.view, merged)
        call.out_keys = [(slot, i) for slot in sorted(outs)
                         for i, t in enumerate(outs[slot]) if t is not None]
        flat = [outs[slot][i] for slot, i in call.out_keys]
        grad_def = get_op_def(call.dedicated[0])
        read = [s for s in grad_def.input_slots
                if s in call.op_def.output_slots]
        if not all(outs.get(s) for s in read):
            read = []
        call.in_keys = [(slot, i) for slot, vs in merged.items()
                        for i, t in enumerate(vs) if t is not None]
        call.saved_keys = [(s, 0) for s in read]
        fctx.save_for_backward(
            *[merged[s][i] for s, i in call.in_keys],
            *[outs[s][i] for s, i in call.saved_keys])
        fctx.mark_non_differentiable(
            *[t for t in flat if not t.is_floating_point()])
        fctx.call = call
        return tuple(flat)

    @staticmethod
    def backward(fctx, *grads):
        call = fctx.call
        grad_type, slots, optional = call.dedicated
        saved = fctx.saved_tensors
        n_in = len(call.in_keys)
        ins = {}
        for (slot, i), t in zip(call.in_keys, saved[:n_in]):
            ins.setdefault(slot, {})[i] = t
        gins = {slot: [ins[slot][0]] for slot in slots}
        gins.update((slot, [ins[slot][0]]) for slot in optional
                    if slot in ins)
        gins["OutGrad"] = [grads[call.out_keys.index(("Out", 0))]
                           .contiguous()]
        for (slot, _), t in zip(call.saved_keys, saved[n_in:]):
            gins[slot] = [t]
        attrs = {k: v for k, v in call.view.attrs.items()
                 if k not in ("__uid__", "__loc__")}
        attrs["__fwd_uid__"] = call.view.uid
        wanted = {slot for slot, _ in call.diff}
        view = OpView(grad_type, attrs,
                      {slot + "Grad": ["grad"] for slot in wanted})
        res = get_op_def(grad_type).emit(call.ctx, view, gins)
        return (None,) + tuple(res[slot + "Grad"][0] for slot, _ in call.diff)


class _Call:
    """What one traced op's _Dedicated node needs besides its tensors."""

    def __init__(self, op_def, view, ctx, raw, diff, dedicated):
        self.op_def, self.view, self.ctx = op_def, view, ctx
        self.raw, self.diff, self.dedicated = raw, diff, dedicated


def _run_dedicated(op_def, view, ctx, raw, diff, dedicated):
    call = _Call(op_def, view, ctx, raw, diff, dedicated)
    flat = _Dedicated.apply(call, *[raw[slot][i] for slot, i in diff])
    call.raw = None  # the node keeps its inputs as saved tensors
    outs = {slot: [] for slot in op_def.output_slots}
    for (slot, i), t in zip(call.out_keys, flat):
        vals = outs.setdefault(slot, [])
        vals.extend([None] * (i + 1 - len(vals)))
        vals[i] = t
    return outs


def trace_op(op_type, ins, attrs=None, out_slot="Out"):
    """Module-level helper: trace and return the first output of
    `out_slot`."""
    return _require_tracer().trace_op(op_type, ins, attrs)[out_slot][0]


def trace_op_multi(op_type, ins, attrs=None):
    return _require_tracer().trace_op(op_type, ins, attrs)


def _set_tracer(tr):
    global _tracer
    _tracer = tr
    from ..framework import program as _prog

    _prog._set_dygraph_tracer(tr)
