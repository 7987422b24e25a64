"""dygraph.base: guard / to_variable / no_grad (counterpart of
paddle_tpu/dygraph/base.py; reference dygraph/base.py).

`guard()` runs on the card (`CUDAPlace(0)`) and raises where there is
none; the CPU runs only under `guard(fluid.CPUPlace())`."""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..core.place import default_place
from .tracer import Tracer, _current, _set_tracer
from .varbase import VarBase


@contextlib.contextmanager
def guard(place=None):
    """Enter eager mode on `place` (default `CUDAPlace(0)`)."""
    device = (place if place is not None else default_place()).torch_device()
    old = _current()
    _set_tracer(Tracer(device))
    try:
        yield
    finally:
        _set_tracer(old)


def enabled():
    return _current() is not None


def current_device():
    """The guard's device; the default place's outside a guard (raises
    where it has no card)."""
    tr = _current()
    return tr.device if tr is not None else default_place().torch_device()


def to_variable(value, name=None, zero_copy=None):
    """An array (or VarBase) as a VarBase on the guard's device, in the
    array's dtype, with stop_gradient=True."""
    if isinstance(value, VarBase):
        return value
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))
    return VarBase(t.to(current_device()), name=name, stop_gradient=True)


@contextlib.contextmanager
def no_grad_ctx():
    """torch.no_grad together with the tracer's enable_grad flag."""
    tr = _current()
    with torch.no_grad():
        if tr is None:
            yield
            return
        old = tr.enable_grad
        tr.enable_grad = False
        try:
            yield
        finally:
            tr.enable_grad = old


def no_grad(fn=None):
    """Usable as a decorator or a context manager (fluid parity)."""
    if fn is None:
        return no_grad_ctx()

    @functools.wraps(fn)
    def wrapper(*a, **k):
        with no_grad_ctx():
            return fn(*a, **k)

    return wrapper
