"""LayerHelper: shared machinery for functional layers (counterpart of
paddle_tpu/layers/helper.py; reference python/paddle/fluid/layer_helper.py).
Creates parameters in both the main and the startup program (init ops go
to startup), creates inferred output vars, appends the op to main."""

from __future__ import annotations

from ..errors import InvalidArgumentError
from ..framework import unique_name
from ..framework.program import (
    _current_tracer,
    default_main_program,
    default_startup_program,
)
from ..framework.registry import infer_shapes
from ..initializer import Constant, Xavier
from ..param_attr import ParamAttr


def main_block():
    return default_main_program().current_block()


def startup_block():
    return default_startup_program().global_block


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs

    def create_parameter(
        self, attr, shape, dtype, is_bias=False, default_initializer=None
    ):
        attr = ParamAttr.to_attr(attr)
        if attr is False:
            return None
        init = attr.initializer or default_initializer or (
            Constant(0.0) if is_bias else Xavier()
        )
        name = attr.name or unique_name.generate(
            f"{self.layer_type}_{'b' if is_bias else 'w'}"
        )
        # parameters always live in the global block
        mb, sb = default_main_program().global_block, startup_block()
        existing = mb.vars.get(name)
        if existing is not None:
            # weight sharing by name
            if tuple(existing.shape or ()) != tuple(shape):
                raise InvalidArgumentError(
                    f"parameter {name!r} reused with shape {shape}, but it "
                    f"was created with shape {existing.shape}"
                )
            return existing
        p = mb.create_parameter(name, shape, dtype, trainable=attr.trainable)
        # the optimizer appends the regularizer to this parameter's
        # gradient; optimize_attr is kept as the JAX package keeps it (no
        # optimizer reads it there either)
        p.regularizer = attr.regularizer
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        if not sb.has_var(name):
            sb.create_parameter(name, shape, dtype, trainable=attr.trainable)
            init(sb, name, shape, dtype)
        return p

    def create_and_append(
        self, inputs, attrs, op_type=None, out_slots=("Out",),
        stop_gradient=False,
    ):
        """Append an op, creating one output var per inferred output of
        each slot. inputs: {slot: [Variable]}. Returns var or tuple.

        Under `dygraph.guard()` the op runs eagerly through the tracer
        instead, on VarBase inputs (the JAX package's branch, reference
        framework.py:180), so parameter-free layers run in both modes."""
        op_type = op_type or self.layer_type
        tracer = _current_tracer()
        if tracer is not None:
            outs = tracer.trace_op(op_type, inputs, attrs or {})
            vals = [(vs[0] if len(vs) == 1 else vs)
                    for vs in (outs.get(s, []) for s in out_slots)]
            return vals[0] if len(vals) == 1 else tuple(vals)
        blk = main_block()
        in_names = {
            slot: [v.name if v is not None else "" for v in vs]
            for slot, vs in inputs.items()
        }
        specs = infer_shapes(op_type, blk, in_names, attrs or {})
        outs = []
        out_names = {}
        for slot in out_slots:
            names, vars_ = [], []
            for shape, dtype in specs.get(slot, []):
                v = blk.create_var(
                    name=unique_name.generate(f"{op_type}.{slot.lower()}"),
                    shape=shape,
                    dtype=dtype,
                    stop_gradient=stop_gradient,
                )
                names.append(v.name)
                vars_.append(v)
            out_names[slot] = names
            outs.append(vars_[0] if len(vars_) == 1 else vars_)
        blk.append_op(op_type, in_names, out_names, attrs or {})
        return outs[0] if len(outs) == 1 else tuple(outs)
