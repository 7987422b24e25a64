"""Op-emitting optimizers, fluid-style (counterpart of
paddle_tpu/optimizer.py; reference python/paddle/fluid/optimizer.py:
Optimizer.minimize :796, apply_gradients :683, Momentum :936, Adam :1716).

minimize() = append_backward + one update op per parameter into the main
program; the learning rate is a [1] persistable (or a schedule's
Variable) and each accumulator a persistable created in main and startup.
SGD, Momentum and Adam are in the port's slices; gradient clipping and
regularization come with a later one.

Eager mode (dygraph): `minimize` on a VarBase loss, after
`loss.backward()` filled the parameters' `.grad`, updates each
parameter in place on its device (the JAX package's `_eager_minimize`,
paddle_tpu/optimizer.py:130-193): the learning rate is a Python float
(a dygraph schedule advances once per minimize), the accumulators are
fp32 tensors per parameter (`_eager_accs`), and nothing is read back
to the host.
"""

from __future__ import annotations

import torch

from .errors import UnimplementedError
from .framework import unique_name
from .framework.backward import append_backward
from .framework.program import (
    Variable,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .initializer import Constant


class Optimizer:
    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        if regularization is not None or grad_clip is not None:
            raise UnimplementedError(
                "optimizer regularization and grad_clip are not in this "
                "slice of the port"
            )
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self._lr_var = None
        self._accumulators = {}  # (acc_name, param_name) -> Variable

    # -- learning rate ----------------------------------------------------
    def _create_lr(self, block):
        if isinstance(self._learning_rate, Variable):
            return self._learning_rate
        if self._lr_var is not None:
            return self._lr_var
        name = unique_name.generate("learning_rate")
        main = block.program.global_block
        startup = default_startup_program().global_block
        self._lr_var = main.create_parameter(name, [1], "float32",
                                             trainable=False)
        self._lr_var.stop_gradient = True
        startup.create_parameter(name, [1], "float32", trainable=False)
        Constant(float(self._learning_rate))(startup, name, [1], "float32")
        return self._lr_var

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None):
        """An fp32 persistable (param-shaped unless `shape`) created in
        main and startup, filled with fill_value."""
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        param_shaped = shape is None
        shape = list(shape if shape is not None else param.shape)
        dtype = "float32"
        vname = unique_name.generate(f"{param.name}_{name}")
        main = param.block.program.global_block
        startup = default_startup_program().global_block
        v = main.create_parameter(vname, shape, dtype, trainable=False)
        v.stop_gradient = True
        # the JAX package's tags: spmd.spec_for gives a param-shaped
        # accumulator its parameter's spec, and the embedding engine
        # finds a cached table's optimizer state by _accum_of
        v._accum_of = param.name
        # elementwise (param-shaped) state, not the beta-pow scalars
        v._accum_elementwise = param_shaped
        startup.create_parameter(vname, shape, dtype, trainable=False)
        Constant(fill_value)(startup, vname, shape, dtype)
        self._accumulators[key] = v
        return v

    def _get_accumulator(self, name, param):
        return self._accumulators[(name, param.name)]

    # -- pipeline ----------------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(
            loss, parameter_list or self._parameter_list, no_grad_set
        )

    def apply_gradients(self, params_grads):
        if params_grads:
            # anchor to the params' own program, not the ambient default
            block = params_grads[0][0].block.program.global_block
        else:
            block = default_main_program().global_block
        self._create_accumulators(block, [p for p, _ in params_grads])
        return [self._append_optimize_op(block, pg) for pg in params_grads]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .dygraph.varbase import VarBase

        if isinstance(loss, VarBase):
            # eager mode: loss.backward() has filled the parameters'
            # gradients; update them in place (reference dygraph minimize)
            return self._eager_minimize(parameter_list), []
        # the ops land in the loss's program even when minimize() is called
        # outside its program_guard (fluid wraps minimize the same way)
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            ops = self.apply_gradients(params_grads)
        return ops, params_grads

    # -- eager (dygraph) path ---------------------------------------------
    def _eager_lr(self):
        """The learning rate of this minimize, a Python float: a schedule
        advances its step on every call, so it is called once per
        minimize (cached in _eager_lr_value), not once per parameter."""
        cached = getattr(self, "_eager_lr_value", None)
        if cached is not None:
            return cached
        lr = self._learning_rate
        if isinstance(lr, Variable):
            raise UnimplementedError(
                "an eager optimizer takes a float or a dygraph LR schedule "
                "as its learning rate, not a static-graph Variable")
        return float(lr() if callable(lr) else lr)

    def _eager_acc(self, name, p, fill=0.0, shape=None):
        """The fp32 accumulator `name` of parameter p (param-shaped
        unless `shape`), filled with `fill` on first use."""
        store = self.__dict__.setdefault("_eager_accs", {})
        key = (name, p.name)
        if key not in store:
            store[key] = torch.full(
                list(shape if shape is not None else p.shape), float(fill),
                dtype=torch.float32, device=p.value.device)
        return store[key]

    def _eager_minimize(self, parameter_list=None):
        params = parameter_list or self._parameter_list or []
        updated = []
        self._eager_lr_value = None
        self._eager_lr_value = self._eager_lr()  # advance the schedule once
        try:
            with torch.no_grad():
                for p in params:
                    g = p.value.grad
                    if not getattr(p, "trainable", True) or g is None:
                        continue
                    if getattr(p, "regularizer", None) is not None:
                        raise UnimplementedError(
                            f"parameter {p.name!r} has a regularizer: "
                            "regularization is not in the port yet "
                            "(ROADMAP Queue 1, item 4 — training breadth)")
                    self._eager_update(p, g)
                    updated.append(p)
        finally:
            self._eager_lr_value = None
        return updated

    def _eager_update(self, p, g):
        raise UnimplementedError(
            f"{type(self).__name__} has no eager-mode update in the port")

    # -- per-optimizer hooks ----------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, pg):
        p, g = pg
        lr = self._create_lr(block)
        return block.append_op(
            "sgd",
            {"Param": [p.name], "Grad": [g.name], "LearningRate": [lr.name]},
            {"ParamOut": [p.name]},
            {},
        )

    def _eager_update(self, p, g):
        p.value.sub_(self._eager_lr() * g)


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        lr = self._create_lr(block)
        return block.append_op(
            "momentum",
            {
                "Param": [p.name],
                "Grad": [g.name],
                "Velocity": [v.name],
                "LearningRate": [lr.name],
            },
            {"ParamOut": [p.name], "VelocityOut": [v.name]},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )

    def _eager_update(self, p, g):
        lr = self._eager_lr()
        v = self._eager_acc("velocity", p)
        v.mul_(self._momentum).add_(g)
        if self._use_nesterov:
            p.value.sub_(lr * (g + self._momentum * v))
        else:
            p.value.sub_(lr * v)


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, self._beta1, shape=[1])
            self._add_accumulator("beta2_pow", p, self._beta2, shape=[1])

    def _append_optimize_op(self, block, pg):
        p, g = pg
        lr = self._create_lr(block)
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow", p)
        b2p = self._get_accumulator("beta2_pow", p)
        return block.append_op(
            "adam",
            {
                "Param": [p.name],
                "Grad": [g.name],
                "LearningRate": [lr.name],
                "Moment1": [m1.name],
                "Moment2": [m2.name],
                "Beta1Pow": [b1p.name],
                "Beta2Pow": [b2p.name],
            },
            {
                "ParamOut": [p.name],
                "Moment1Out": [m1.name],
                "Moment2Out": [m2.name],
                "Beta1PowOut": [b1p.name],
                "Beta2PowOut": [b2p.name],
            },
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon},
        )

    def _eager_update(self, p, g):
        """The JAX package's `_adam_eager` (paddle_tpu/optimizer.py:375),
        in its order of operations, on the accumulators in place."""
        lr = self._eager_lr()
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m1 = self._eager_acc("moment1", p)
        m2 = self._eager_acc("moment2", p)
        b1p = self._eager_acc("beta1_pow", p, b1, shape=[1])
        b2p = self._eager_acc("beta2_pow", p, b2, shape=[1])
        m1.mul_(b1).add_((1 - b1) * g)
        m2.mul_(b2).add_((1 - b2) * g * g)
        lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
        p.value.sub_((lr_t * m1 / (torch.sqrt(m2) + eps)).reshape(p.shape))
        b1p.mul_(b1)
        b2p.mul_(b2)


Adam = AdamOptimizer
Momentum = MomentumOptimizer
SGD = SGDOptimizer
