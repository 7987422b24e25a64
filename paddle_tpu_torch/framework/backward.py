"""Static-graph autodiff: append_backward and gradients (counterpart of
paddle_tpu/framework/backward.py; reference python/paddle/fluid/
backward.py: append_backward :1193, gradients :1727).

The transform walks a block's ops in reverse from the loss, appends one
grad op per differentiable op, sums the gradients of a variable that
several ops read (a `sum` op), and returns (param, grad) pairs for the
optimizer. Ops whose backward is a hand-written kernel register a
grad_maker that appends a dedicated grad op (dedicated_grad_maker,
used by ops/fused.py); every other
op gets the generic `__vjp__` op, which replays the forward emitter under
`torch.func.vjp` and pulls the output gradients back through it. The
replay runs under the forward op's attrs and uid, so a dropout op draws
the forward's mask again.

Unlike the JAX package, the replay runs once: JAX traced the forward a
second time to learn which outputs are floating and let XLA's CSE merge
the copies; here eager execution would pay for it, so the one run under
`torch.func.vjp` both computes the outputs and records which of them
carry gradients. What remains is the replay itself: the forward op runs
again inside its grad op (for `mul`, a second X·W).
"""

from __future__ import annotations

import copy

import torch

from ..core.dtypes import is_float
from ..errors import UnimplementedError
from . import unique_name
from .program import Parameter, grad_var_name
from .registry import OpView, get_op_def, register_op


def _slots(items, prefix):
    return {slot[len(prefix):]: vals for slot, vals in items
            if slot.startswith(prefix)}


@register_op("__vjp__", inputs=[], outputs=[], differentiable=False)
def _vjp_emit(ctx, op, ins):
    if ctx.first_run:
        # the replay re-runs a forward op that counted its own first run
        ctx = copy.copy(ctx)
        ctx.first_run = False
    fwd_def = get_op_def(op.attr("fwd_type"))
    fwd_op = OpView(op.attr("fwd_type"), op.attr("fwd_attrs"))
    fwd_ins = _slots(ins.items(), "FwdIn:")
    out_grads = _slots(ins.items(), "OutGrad:")
    # positions (slot, idx) of the inputs whose gradients are wanted
    want = [
        (slot[len("InGrad:"):], i)
        for slot, names in op.outputs.items()
        if slot.startswith("InGrad:")
        for i, n in enumerate(names)
        if n
    ]
    # the outputs pulled back: floating outputs that carry a gradient (an
    # output without one would get a zero cotangent and add nothing)
    keys = []

    def fwd_flat(*diff_vals):
        merged = {s: list(v) for s, v in fwd_ins.items()}
        for (slot, idx), val in zip(want, diff_vals):
            merged[slot][idx] = val
        outs = fwd_def.emit(ctx, fwd_op, merged)
        keys[:] = [
            (slot, i)
            for slot in sorted(outs)
            for i, v in enumerate(outs[slot])
            if v is not None and v.is_floating_point()
            and i < len(out_grads.get(slot, ()))
            and out_grads[slot][i] is not None
        ]
        return tuple(outs[slot][i] for slot, i in keys)

    diff_vals = [fwd_ins[slot][idx] for slot, idx in want]
    primals, vjp_fn = torch.func.vjp(fwd_flat, *diff_vals)
    in_grads = vjp_fn(tuple(out_grads[slot][i].to(p.dtype)
                            for (slot, i), p in zip(keys, primals)))

    result = {}
    for (slot, idx), g in zip(want, in_grads):
        result.setdefault("InGrad:" + slot, {})[idx] = g
    return {
        slot: [result.get(slot, {}).get(i) for i in range(len(names))]
        for slot, names in op.outputs.items()
        if slot.startswith("InGrad:")
    }


def _ensure_var(block, name, like_name):
    if not block.has_var(name):
        src = block.var(like_name)
        block.create_var(name=name, shape=src.shape, dtype=src.dtype)
    return block.var(name)


def append_grad_op(op, block, contribs, needs_grad, grad_type, inputs,
                   slots):
    """Append the dedicated grad op `grad_type` of `op` with `inputs` and
    an `<slot>Grad` output for each input slot in `slots` whose variable
    needs a gradient. The grad op keeps the forward's attrs but its uid,
    which becomes `__fwd_uid__` (a dropout mask regenerates from it)."""
    outs = {}
    for slot in slots:
        if not op.inputs.get(slot):
            continue
        n = op.inputs[slot][0]
        if needs_grad is not None and n not in needs_grad:
            continue
        gname = unique_name.generate(grad_var_name(n) + "@RENAME")
        _ensure_var(block, gname, n)
        outs[slot + "Grad"] = [gname]
        contribs.setdefault(n, []).append(gname)
    if not outs:
        return
    attrs = {k: v for k, v in op.attrs.items() if k not in ("__uid__",
                                                            "__loc__")}
    attrs["__fwd_uid__"] = op.uid
    block.append_op(grad_type, inputs, outs, attrs)


def dedicated_grad_maker(grad_type, slots, optional=(), saved=None):
    """The grad_maker of an op whose backward is the op `grad_type`: it
    reads the op's inputs in `slots`, the gradient of its Out as
    `OutGrad`, those of the `optional` slots the op has, and
    `saved(op, block)`, a dict of forward outputs to read as well; it
    gives a gradient for each of those slots that needs one."""

    def maker(op, block, contribs, finalize, needs_grad=None):
        g_out = finalize(op.outputs["Out"][0])
        if g_out is None:
            return
        inputs = {slot: op.inputs[slot] for slot in slots}
        inputs["OutGrad"] = [g_out]
        inputs.update((slot, op.inputs[slot]) for slot in optional
                      if op.inputs.get(slot))
        if saved is not None:
            inputs.update(saved(op, block))
        append_grad_op(op, block, contribs, needs_grad, grad_type, inputs,
                       tuple(slots) + tuple(optional))

    # what the eager tracer reads to run the same grad op under autograd
    # (dygraph/tracer.py); in place of `saved` it passes the forward
    # outputs the grad op declares as inputs, where the forward made all
    maker.dedicated = (grad_type, tuple(slots), tuple(optional))
    return maker


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Append grad ops for `loss` into its block; return [(param, grad)]."""
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())

    # 1. which vars can carry grads: forward reachability from trainable
    # parameters and differentiable (stop_gradient=False) data vars
    needs_grad = set()
    for v in block.vars.values():
        trainable_param = isinstance(v, Parameter) and v.trainable
        diff_input = not v.stop_gradient and v.is_data
        if (trainable_param or diff_input) and is_float(v.dtype):
            needs_grad.add(v.name)
    needs_grad -= no_grad
    fwd_ops = list(block.ops)  # snapshot before appending backward ops
    for op in fwd_ops:
        if not get_op_def(op.type).differentiable:
            continue
        if any(n in needs_grad for n in op.input_names()):
            for n in op.output_names():
                if (
                    n
                    and block.has_var(n)
                    and is_float(block.var(n).dtype)
                    and not block.var(n).stop_gradient
                    and n not in no_grad
                ):
                    needs_grad.add(n)

    # 2. seed the loss gradient with 1.0
    loss_grad = grad_var_name(loss.name)
    block.create_var(name=loss_grad, shape=loss.shape, dtype=loss.dtype)
    block.append_op(
        "fill_constant",
        {},
        {"Out": [loss_grad]},
        {"shape": list(loss.shape or (1,)), "dtype": loss.dtype, "value": 1.0},
    )

    # var name -> names of its gradient contributions
    contribs = {loss.name: [loss_grad]}

    def finalize(name):
        """Collapse contributions into the canonical @GRAD var, summing."""
        c = contribs.get(name)
        if not c:
            return None
        canonical = grad_var_name(name)
        if len(c) == 1:
            if c[0] != canonical:
                _ensure_var(block, canonical, name)
                block.append_op("assign", {"X": [c[0]]}, {"Out": [canonical]})
        else:
            _ensure_var(block, canonical, name)
            block.append_op("sum", {"X": list(c)}, {"Out": [canonical]})
        contribs[name] = [canonical]
        return canonical

    # 3. reverse walk over the forward snapshot
    for op in reversed(fwd_ops):
        op_def = get_op_def(op.type)
        if not op_def.differentiable:
            continue
        if not any(n in contribs for n in op.output_names()):
            continue
        diff_inputs = {
            (slot, i, n)
            for slot, names in op.inputs.items()
            for i, n in enumerate(names)
            if n and n in needs_grad
        }
        if not diff_inputs:
            continue
        if op_def.grad_maker is not None:
            # a maker may decline (return False): the generic path runs
            if op_def.grad_maker(op, block, contribs, finalize,
                                 needs_grad=needs_grad) is not False:
                continue

        grad_ins = {
            "OutGrad:" + slot: [
                (finalize(n) or "") if n in contribs else "" for n in names
            ]
            for slot, names in op.outputs.items()
        }
        fwd_in_slots = {"FwdIn:" + s: list(v) for s, v in op.inputs.items()}
        grad_outs, new_contribs = {}, []
        for slot, names in op.inputs.items():
            outs = []
            for i, n in enumerate(names):
                if (slot, i, n) in diff_inputs:
                    gname = unique_name.generate(grad_var_name(n) + "@RENAME")
                    _ensure_var(block, gname, n)
                    outs.append(gname)
                    new_contribs.append((n, gname))
                else:
                    outs.append("")
            grad_outs["InGrad:" + slot] = outs
        block.append_op(
            "__vjp__",
            {**fwd_in_slots, **grad_ins},
            grad_outs,
            {"fwd_type": op.type, "fwd_attrs": dict(op.attrs)},
        )
        for n, gname in new_contribs:
            contribs.setdefault(n, []).append(gname)

    # 4. finalize the parameter grads
    if parameter_list is not None:
        params = [
            block.var(p) if isinstance(p, str) else p for p in parameter_list
        ]
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    result = []
    for p in params:
        if p.name in no_grad:
            continue
        g = finalize(p.name)
        if g is not None:
            result.append((p, block.var(g)))
    return result


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """fluid.gradients parity: grads of one target w.r.t. `inputs`."""
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if len(targets) != 1:
        raise UnimplementedError("gradients: sum several targets first")
    if target_gradients is not None:
        raise UnimplementedError(
            "gradients: target_gradients is not in this slice of the port"
        )
    pairs = append_backward(
        targets[0], parameter_list=[v.name for v in inputs],
        no_grad_set=no_grad_set,
    )
    by_name = {p.name: g for p, g in pairs}
    return [by_name.get(v.name) for v in inputs]
