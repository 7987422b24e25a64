"""Op-emitting optimizers, fluid-style (counterpart of
paddle_tpu/optimizer.py; reference python/paddle/fluid/optimizer.py:
Optimizer.minimize :796, apply_gradients :683, Momentum :936, Adam :1716).

minimize() = append_backward + one update op per parameter into the main
program; the learning rate is a [1] persistable (or a schedule's
Variable) and each accumulator a persistable created in main and startup.
SGD, Momentum and Adam are in the port's slices; gradient clipping and
regularization come with a later one.
"""

from __future__ import annotations

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
        # the ops land in the loss's program even when minimize() is called
        # outside its program_guard (fluid wraps minimize the same way)
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            ops = self.apply_gradients(params_grads)
        return ops, params_grads

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


Adam = AdamOptimizer
Momentum = MomentumOptimizer
SGD = SGDOptimizer
