"""dygraph.Layer: the eager module base class (counterpart of
paddle_tpu/dygraph/layers.py; reference dygraph/layers.py: Layer.__call__
:449 with pre/post hooks, sublayers, state_dict).

A parameter is drawn at creation by the port's initializers: each one
names its init op (fill_constant, uniform_random or gaussian_random),
and that op's emitter runs on the guard's device with its own
torch.Generator (registry.EmitContext.key_for), seeded as the static
path seeds the same op in the startup program: from
`default_startup_program().random_seed` (its nonce when 0) and a uid the
program hands out. The JAX package draws in numpy
(`Initializer.numpy_init`); the two streams differ, and weights cross
between the packages by `convert.layer_state_from_numpy`."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..framework import unique_name
from ..framework.program import default_startup_program
from ..framework.registry import EmitContext, OpView, get_op_def
from .base import current_device
from .varbase import ParamBase, VarBase


class _InitOp:
    """A block stand-in that records the one op an initializer appends."""

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        self.op = (type, dict(attrs or {}))


def init_value(initializer, shape, dtype):
    """The tensor `initializer` gives a parameter of `shape` and `dtype`
    on the guard's device (see the module docstring)."""
    rec = _InitOp()
    initializer(rec, "param", list(shape), dtype)
    op_type, attrs = rec.op
    prog = default_startup_program()
    attrs["__uid__"] = prog._next_uid()
    ctx = EmitContext(current_device(),
                      seed=prog.random_seed or prog._rng_nonce)
    with torch.no_grad():
        return get_op_def(op_type).emit(ctx, OpView(op_type, attrs), {})[
            "Out"][0]


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self._full_name = unique_name.generate(
            name_scope or type(self).__name__.lower()
        )
        self._dtype = dtype
        self._parameters = OrderedDict()
        self._sub_layers = OrderedDict()
        self._buffers = OrderedDict()
        self._forward_pre_hooks = OrderedDict()
        self._forward_post_hooks = OrderedDict()
        self.training = True

    def full_name(self):
        return self._full_name

    # -- parameter management ----------------------------------------------
    def create_parameter(self, shape, dtype=None, initializer=None,
                         attr=None, is_bias=False, name=None):
        from ..initializer import Constant, Xavier

        dtype = dtype or self._dtype
        init = initializer
        if attr is not None and getattr(attr, "initializer", None) is not None:
            init = attr.initializer
        if init is None:
            init = Constant(0.0) if is_bias else Xavier()
        pname = name or (getattr(attr, "name", None) if attr is not None
                         else None)
        pname = pname or unique_name.generate(self._full_name + ".w")
        return ParamBase(init_value(init, shape, dtype), name=pname)

    def add_parameter(self, name, parameter):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        return sublayer

    def register_buffer(self, name, value, persistable=True):
        if not isinstance(value, VarBase):
            t = value if isinstance(value, torch.Tensor) else torch.as_tensor(
                np.asarray(value))
            value = VarBase(t.to(current_device()))
        vb = value
        vb.persistable = persistable
        vb.stop_gradient = True
        self._buffers[name] = vb
        return vb

    def parameters(self, include_sublayers=True):
        out = list(self._parameters.values())
        if include_sublayers:
            for sl in self._sub_layers.values():
                out.extend(sl.parameters())
        return out

    def sublayers(self, include_self=False):
        out = [self] if include_self else []
        for sl in self._sub_layers.values():
            out.extend(sl.sublayers(include_self=True))
        return out

    def named_parameters(self, prefix=""):
        for name, p in self._parameters.items():
            yield (f"{prefix}{name}", p)
        for lname, sl in self._sub_layers.items():
            yield from sl.named_parameters(prefix=f"{prefix}{lname}.")

    def named_state(self, prefix=""):
        """(structured name, VarBase) of every parameter and buffer, in
        state_dict's order."""
        for name, p in self._parameters.items():
            yield f"{prefix}{name}", p
        for name, b in self._buffers.items():
            yield f"{prefix}{name}", b
        for lname, sl in self._sub_layers.items():
            yield from sl.named_state(prefix=f"{prefix}{lname}.")

    # -- train/eval ---------------------------------------------------------
    def train(self):
        self.training = True
        for sl in self._sub_layers.values():
            sl.train()
        return self

    def eval(self):
        self.training = False
        for sl in self._sub_layers.values():
            sl.eval()
        return self

    # -- state dict ---------------------------------------------------------
    def state_dict(self, prefix=""):
        return OrderedDict((k, v.numpy()) for k, v in self.named_state(prefix))

    def set_dict(self, state, use_structured_name=True):
        for name, v in self.named_state():
            if name in state:
                v.set_value(state[name])

    load_dict = set_dict

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    # -- hooks + call --------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        key = len(self._forward_pre_hooks)
        self._forward_pre_hooks[key] = hook
        return key

    def register_forward_post_hook(self, hook):
        key = len(self._forward_post_hooks)
        self._forward_post_hooks[key] = hook
        return key

    def __call__(self, *args, **kwargs):
        from .tracer import _current

        tr = _current()
        if tr is not None:
            tr.train_mode = self.training
        for hook in self._forward_pre_hooks.values():
            res = hook(self, args)
            if res is not None:
                args = res
        out = self.forward(*args, **kwargs)
        for hook in self._forward_post_hooks.values():
            res = hook(self, args, out)
            if res is not None:
                out = res
        return out

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    # -- attribute sugar: assignment auto-registers --------------------------
    def __setattr__(self, name, value):
        if isinstance(value, ParamBase):
            self.__dict__.setdefault("_parameters", OrderedDict())[name] = value
        elif isinstance(value, Layer):
            self.__dict__.setdefault("_sub_layers", OrderedDict())[name] = value
        object.__setattr__(self, name, value)

    def __getattr__(self, name):
        # only called when normal lookup fails
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d and name in d:
                return d[name]
        raise AttributeError(
            f"{type(self).__name__} has no attribute {name!r}")


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and (
            not isinstance(layers[0][0], Layer)
        ):
            layers = layers[0]
        for i, item in enumerate(layers):
            if isinstance(item, (list, tuple)):
                name, layer = item
            else:
                name, layer = str(i), item
            self.add_sublayer(name, layer)

    def forward(self, x):
        for sl in self._sub_layers.values():
            x = sl(x)
        return x

    def __getitem__(self, idx):
        return list(self._sub_layers.values())[idx]

    def __len__(self):
        return len(self._sub_layers)


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, sl in enumerate(sublayers or []):
            self.add_sublayer(str(i), sl)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._sub_layers)), sublayer)
        return self

    def __getitem__(self, idx):
        return list(self._sub_layers.values())[idx]

    def __iter__(self):
        return iter(self._sub_layers.values())

    def __len__(self):
        return len(self._sub_layers)


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or []):
            self.add_parameter(str(i), p)

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __iter__(self):
        return iter(self._parameters.values())

    def __len__(self):
        return len(self._parameters)
