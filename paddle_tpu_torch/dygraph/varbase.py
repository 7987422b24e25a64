"""VarBase: the eager-mode tensor (counterpart of
paddle_tpu/dygraph/varbase.py; reference imperative/layer.h VarBase,
python varbase_patch_methods.py).

A VarBase wraps a torch tensor on the guard's device. Autograd is torch
autograd (tracer.py): a VarBase with stop_gradient=False that no op made
(a parameter, or an input the user marks) is a leaf tensor that requires
grad, and its gradient accumulates in `.grad` across backward() calls by
addition, as the JAX package's tape does; an op's output carries its
`grad_fn`. `numpy()` is the only read to the host, and `__bool__` reads
one only when Python asks for a truth value.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from ..core.dtypes import convert_dtype
from ..framework import unique_name


def _host(t):
    """A numpy copy of t (bfloat16 as float32): never a view of a CPU
    tensor that an in-place update would change under the caller."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    a = t.cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a


class VarBase:
    def __init__(self, value, name=None, persistable=False,
                 stop_gradient=True):
        self._value = (value if isinstance(value, torch.Tensor)
                       else torch.as_tensor(np.asarray(value)))
        self.name = name or unique_name.generate("eager_tmp")
        self.persistable = persistable
        self.stop_gradient = stop_gradient

    # -- value access -------------------------------------------------------
    @property
    def value(self):
        return self._value

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self):
        return convert_dtype(self._value.dtype)

    @property
    def stop_gradient(self):
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, flag):
        """On a tensor no op made, stop_gradient=False makes it a leaf
        that requires grad; on an op's output, True detaches it."""
        self._stop_gradient = bool(flag)
        t = self._value
        if t.grad_fn is None:
            if t.is_floating_point() and t.requires_grad == bool(flag):
                self._value = t.detach().requires_grad_(not flag)
        elif flag:
            self._value = t.detach()

    def numpy(self):
        return _host(self._value)

    def set_value(self, v):
        """Write v (a VarBase, tensor or array) into this variable outside
        autograd, in its dtype; in place where the shape matches, so a
        parameter stays the leaf its optimizer and hooks hold."""
        if isinstance(v, VarBase):
            v = v.value
        t = self._value
        src = v if isinstance(v, torch.Tensor) else torch.tensor(
            np.asarray(v))
        with torch.no_grad():
            if tuple(src.shape) == tuple(t.shape) and t.grad_fn is None:
                t.copy_(src)
                return
            new = src.to(device=t.device, dtype=t.dtype).clone()
        self._value = new
        self.stop_gradient = self._stop_gradient

    def detach(self):
        return VarBase(self._value.detach(), stop_gradient=True)

    def astype(self, dtype):
        from .tracer import trace_op

        return trace_op("cast", {"X": [self]}, {"in_dtype": self.dtype,
                                                "out_dtype": dtype})

    # -- autograd -----------------------------------------------------------
    def backward(self, retain_graph=False):
        from .tracer import _require_tracer

        _require_tracer()
        if not self._value.is_floating_point():
            raise ValueError("backward() root must be floating point")
        torch.autograd.backward(self._value, torch.ones_like(self._value),
                                retain_graph=retain_graph)

    def gradient(self):
        g = self._value.grad
        return None if g is None else _host(g)

    def clear_gradient(self):
        self._value.grad = None

    @property
    def grad(self):
        return self._value.grad

    # -- operator sugar (mirrors static Variable) ----------------------------
    def _binary(self, other, op_type, reverse=False):
        from .tracer import trace_op

        if not isinstance(other, VarBase):
            other = VarBase(torch.as_tensor(
                other, dtype=self._value.dtype, device=self._value.device))
        x, y = (other, self) if reverse else (self, other)
        return trace_op(op_type, {"X": [x], "Y": [y]}, {"axis": -1})

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    def __floordiv__(self, o):
        return self._binary(o, "elementwise_floordiv")

    def __mod__(self, o):
        return self._binary(o, "elementwise_mod")

    def __neg__(self):
        from .tracer import trace_op

        return trace_op("scale", {"X": [self]}, {"scale": -1.0, "bias": 0.0})

    # comparisons build compare ops (fluid math_op_patch parity); __eq__
    # is elementwise like fluid's patched ==, with identity hashing kept
    # (torch.Tensor makes the same trade). Operands that are not numbers
    # or tensors return NotImplemented, so `vb == None` is False
    def _coercible(self, o):
        return isinstance(o, (VarBase, numbers.Number, bool, np.ndarray,
                              torch.Tensor))

    def __eq__(self, o):
        if not self._coercible(o):
            return NotImplemented
        return self._binary(o, "equal")

    def __ne__(self, o):
        if not self._coercible(o):
            return NotImplemented
        return self._binary(o, "not_equal")

    __hash__ = object.__hash__

    def __lt__(self, o):
        return self._binary(o, "less_than")

    def __le__(self, o):
        return self._binary(o, "less_equal")

    def __gt__(self, o):
        return self._binary(o, "greater_than")

    def __ge__(self, o):
        return self._binary(o, "greater_equal")

    def __matmul__(self, o):
        from .tracer import trace_op

        return trace_op("matmul", {"X": [self], "Y": [o]}, {})

    def __getitem__(self, idx):
        """Indexing: torch's, recorded by autograd where the tracer takes
        gradients."""
        from .tracer import _current

        if isinstance(idx, VarBase):
            idx = idx.value
        tr = _current()
        if tr is not None and tr.enable_grad and not self.stop_gradient:
            return VarBase(self._value[idx], stop_gradient=False)
        with torch.no_grad():
            return VarBase(self._value[idx])

    def __len__(self):
        return int(self._value.shape[0])

    def __bool__(self):
        # eager `if tensor_cond:` reads the VALUE (reference eager
        # semantics); a multi-element VarBase raises like numpy
        if self._value.numel() != 1:
            raise ValueError(
                "The truth value of a multi-element VarBase is ambiguous; "
                "use reductions (any/all)"
            )
        return bool(self._value.detach().reshape(()).item())

    def __repr__(self):
        return (f"VarBase(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype})\n{self._value}")


class ParamBase(VarBase):
    """Trainable eager parameter (reference framework.py:5064)."""

    def __init__(self, value, name=None, trainable=True):
        super().__init__(value, name=name, persistable=True,
                         stop_gradient=not trainable)
        self.trainable = trainable
        self.regularizer = None
        self.need_clip = True

