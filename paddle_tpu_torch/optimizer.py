"""Op-emitting optimizers, fluid-style (counterpart of
paddle_tpu/optimizer.py; reference python/paddle/fluid/optimizer.py:
Optimizer.minimize :796, apply_gradients :683, SGD :842, Momentum :936,
LarsMomentum :1486, Adagrad :1600, Adam :1716, Adamax :1982, Dpsgd
:2154, DecayedAdagrad :2249, Adadelta :2359, RMSProp :2478, Ftrl :2666,
Lamb :2825, ModelAverage :2997, ExponentialMovingAverage :3306,
LookaheadOptimizer :4150).

minimize() = append_backward, then apply_gradients: the optimizer's
`grad_clip` (clip.py) over every gradient, each parameter's own
regularizer (ParamAttr(regularizer=...)) or else the optimizer's
`regularization` (regularizer.py), and one update op per parameter
(ops/optimizer_ops.py). The learning rate is a [1] persistable (or a
schedule's Variable) and each accumulator a persistable created in main
and startup. `DGCMomentumOptimizer` raises: its sparse exchange over the
dp axis comes with ROADMAP Queue 1, item 1.

The averagers (ExponentialMovingAverage, ModelAverage) append their
update ops to the main program and swap the averaged values into the
scope in `apply()` (a host read of a [1] counter, between steps);
LookaheadOptimizer wraps an inner optimizer and syncs its slow weights
every k steps with in-graph selects.

Eager mode (dygraph): `minimize` on a VarBase loss, after
`loss.backward()` filled the parameters' `.grad`, updates each
parameter in place on its device (the JAX package's `_eager_minimize`,
paddle_tpu/optimizer.py:130-193): the learning rate is a Python float
(a dygraph schedule advances once per minimize), the accumulators are
fp32 tensors per parameter (`_eager_accs`), and nothing is read back
to the host. SGD, Momentum and the Adam family (Adam, AdamW, Lamb) have
an eager update. As in the JAX package, eager Lamb takes AdamW's update
(no trust ratio), eager mode applies no grad_clip, and a regularizer is
applied only where it has a `_coeff` field, which L2Decay and L1Decay
(`coeff`) lack: an eager regularizer changes nothing.
"""

from __future__ import annotations

import contextlib

import torch

from .core.place import default_place
from .errors import UnimplementedError
from .framework import unique_name
from .framework.backward import append_backward
from .framework.program import (
    Variable,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .framework.state import create_persistable_var, create_step_counter
from .initializer import Constant


class Optimizer:
    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name
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

    def set_lr(self, value, scope=None):
        """Sets the learning rate to `value` at run time: the [1]
        persistable in the scope (the global one unless given), on the
        device it lives on."""
        from .framework.scope import global_scope

        self._learning_rate = float(value)
        if self._lr_var is not None:
            scope = scope or global_scope()
            old = scope.find_var(self._lr_var.name)
            device = (old.device if old is not None
                      else default_place().torch_device())
            scope.set_var(self._lr_var.name, torch.full(
                [1], float(value), dtype=torch.float32, device=device))

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
        if self._grad_clip is not None:
            params_grads = self._grad_clip.apply(params_grads, block)
        processed = []
        for p, g in params_grads:
            # the parameter's own regularizer wins over the optimizer's
            reg = getattr(p, "regularizer", None) or self.regularization
            if reg is not None:
                g = reg.append_regularization_op(p, g, block)
            processed.append((p, g))
        self._create_accumulators(block, [p for p, _ in processed])
        return [self._append_optimize_op(block, pg) for pg in processed]

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
                    # the JAX package's read: `_coeff`, a field neither
                    # L2Decay nor L1Decay has, so no regularizer applies
                    reg = getattr(p, "regularizer", None) \
                        or self.regularization
                    if reg is not None and getattr(reg, "_coeff", 0.0):
                        g = g + reg._coeff * p.value
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


class _AdamBase(Optimizer):
    """Adam's accumulators and op for Adam, AdamW and Lamb, which differ
    in the op type and its weight_decay attr."""

    op_type = "adam"
    _weight_decay = 0.0

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

    def _extra_attrs(self):
        return {}

    def _append_optimize_op(self, block, pg):
        p, g = pg
        lr = self._create_lr(block)
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow", p)
        b2p = self._get_accumulator("beta2_pow", p)
        return block.append_op(
            self.op_type,
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
             "epsilon": self._epsilon, **self._extra_attrs()},
        )

    def _eager_update(self, p, g):
        """The JAX package's `_adam_eager` (paddle_tpu/optimizer.py:353),
        in its order of operations, on the accumulators in place; AdamW
        and Lamb add lr * weight_decay * p (Lamb: no trust ratio, as
        there)."""
        lr = self._eager_lr()
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m1 = self._eager_acc("moment1", p)
        m2 = self._eager_acc("moment2", p)
        b1p = self._eager_acc("beta1_pow", p, b1, shape=[1])
        b2p = self._eager_acc("beta2_pow", p, b2, shape=[1])
        m1.mul_(b1).add_((1 - b1) * g)
        m2.mul_(b2).add_((1 - b2) * g * g)
        lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
        upd = lr_t * m1 / (torch.sqrt(m2) + eps)
        if self._weight_decay:
            upd = upd + lr * self._weight_decay * p.value
        p.value.sub_(upd.reshape(p.shape))
        b1p.mul_(b1)
        b2p.mul_(b2)


class AdamOptimizer(_AdamBase):
    op_type = "adam"


class AdamWOptimizer(_AdamBase):
    op_type = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._weight_decay = weight_decay

    def _extra_attrs(self):
        return {"weight_decay": self._weight_decay}


class LambOptimizer(_AdamBase):
    op_type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._weight_decay = lamb_weight_decay

    def _extra_attrs(self):
        return {"weight_decay": self._weight_decay}


class _OneOpOptimizer(Optimizer):
    """An optimizer of one update op whose accumulators are param-shaped
    and fp32 (created in `_accums` order, each filled with its value):
    op_type, `_accums` ((name, in slot, out slot, fill attribute or
    None)), whether the op reads the learning rate, and `_attrs()`."""

    op_type = None
    _accums = ()
    _reads_lr = True

    def _fill(self, attr):
        return getattr(self, attr) if attr else 0.0

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            for name, _, _, fill in self._accums:
                self._add_accumulator(name, p, self._fill(fill))

    def _attrs(self):
        return {}

    def _append_optimize_op(self, block, pg):
        p, g = pg
        ins = {"Param": [p.name], "Grad": [g.name]}
        outs = {"ParamOut": [p.name]}
        for name, in_slot, out_slot, _ in self._accums:
            acc = self._get_accumulator(name, p).name
            ins[in_slot], outs[out_slot] = [acc], [acc]
        if self._reads_lr:
            ins["LearningRate"] = [self._create_lr(block).name]
        return block.append_op(self.op_type, ins, outs, self._attrs())


class LarsMomentumOptimizer(_OneOpOptimizer):
    op_type = "lars_momentum"
    _accums = (("velocity", "Velocity", "VelocityOut", None),)

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _attrs(self):
        return {"mu": self._momentum, "lars_coeff": self._lars_coeff,
                "lars_weight_decay": self._lars_weight_decay}


class AdagradOptimizer(_OneOpOptimizer):
    op_type = "adagrad"
    _accums = (("moment", "Moment", "MomentOut", "_init_acc"),)

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _attrs(self):
        return {"epsilon": self._epsilon}


class DecayedAdagradOptimizer(_OneOpOptimizer):
    op_type = "decayed_adagrad"
    _accums = (("moment", "Moment", "MomentOut", None),)

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _attrs(self):
        return {"decay": self._decay, "epsilon": self._epsilon}


class RMSPropOptimizer(_OneOpOptimizer):
    op_type = "rmsprop"
    _accums = (("momentum_acc", "Moment", "MomentOut", None),
               ("mean_square", "MeanSquare", "MeanSquareOut", None),
               ("mean_grad", "MeanGrad", "MeanGradOut", None))

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _attrs(self):
        return {"decay": self._rho, "epsilon": self._epsilon,
                "momentum": self._momentum, "centered": self._centered}


class AdadeltaOptimizer(_OneOpOptimizer):
    op_type = "adadelta"
    _accums = (("avg_squared_grad", "AvgSquaredGrad", "AvgSquaredGradOut",
                None),
               ("avg_squared_update", "AvgSquaredUpdate",
                "AvgSquaredUpdateOut", None))
    _reads_lr = False  # adadelta's step has no learning rate

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _attrs(self):
        return {"rho": self._rho, "epsilon": self._epsilon}


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow", p, self._beta1, shape=[1])

    def _append_optimize_op(self, block, pg):
        p, g = pg
        lr = self._create_lr(block)
        m, inf, b1p = (self._get_accumulator(n, p).name
                       for n in ("moment", "inf_norm", "beta1_pow"))
        return block.append_op(
            "adamax",
            {"Param": [p.name], "Grad": [g.name], "LearningRate": [lr.name],
             "Moment": [m], "InfNorm": [inf], "Beta1Pow": [b1p]},
            {"ParamOut": [p.name], "MomentOut": [m], "InfNormOut": [inf],
             "Beta1PowOut": [b1p]},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon},
        )


class FtrlOptimizer(_OneOpOptimizer):
    op_type = "ftrl"
    _accums = (("squared", "SquaredAccumulator", "SquaredAccumOut", None),
               ("linear", "LinearAccumulator", "LinearAccumOut", None))

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _attrs(self):
        return {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power}


class DpsgdOptimizer(_OneOpOptimizer):
    op_type = "dpsgd"

    def __init__(self, learning_rate, clip=10.0, batch_size=16.0, sigma=1.0,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _attrs(self):
        return {"clip": self._clip, "batch_size": self._batch_size,
                "sigma": self._sigma}


class ProximalGDOptimizer(_OneOpOptimizer):
    """proximal_gd_op.cc: an SGD step, L1 soft-threshold, L2 shrink."""

    op_type = "proximal_gd"

    def __init__(self, learning_rate, l1_regularization_strength=0.0,
                 l2_regularization_strength=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1 = l1_regularization_strength
        self._l2 = l2_regularization_strength

    def _attrs(self):
        return {"l1": self._l1, "l2": self._l2}


class ProximalAdagradOptimizer(ProximalGDOptimizer):
    """proximal_adagrad_op.cc: proximal_gd at Adagrad's rate."""

    op_type = "proximal_adagrad"
    _accums = (("moment", "Moment", "MomentOut", None),)


class DGCMomentumOptimizer(Optimizer):
    """Deep Gradient Compression momentum: its top-k sparse exchange over
    the dp axis is not in the port."""

    def __init__(self, *args, **kw):
        raise UnimplementedError(
            "DGCMomentumOptimizer exchanges sparse gradients over the "
            "data-parallel axis, which the port does not run yet (ROADMAP "
            "Queue 1, item 1 — data-parallel distribution)")


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
Dpsgd = DpsgdOptimizer
ProximalGD = ProximalGDOptimizer
ProximalAdagrad = ProximalAdagradOptimizer
DGCMomentum = DGCMomentumOptimizer


# ---------------------------------------------------------------------------
# the averagers and Lookahead (reference optimizer.py: ModelAverage :2997,
# ExponentialMovingAverage :3306, LookaheadOptimizer :4150)
# ---------------------------------------------------------------------------


def _make_counter(name_hint, init=0.0, dtype="float32"):
    return create_persistable_var(name_hint, [1], dtype, init)


def _make_state_like(param, name_hint, init=0.0, dtype=None):
    return create_persistable_var(name_hint, list(param.shape),
                                  dtype or param.dtype, init)


def _first(t):
    """The first element of a [1] scope tensor, on the host."""
    return t.reshape(-1)[0].item()


class _SwappingAverager:
    """apply()/restore(): swap the averaged values into the global scope
    and back. They run between steps, off the step's path, so each reads
    its [1] counters back to the host."""

    def __init__(self):
        self._backup = {}

    def _averaged_value(self, scope, pname):
        raise NotImplementedError

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        from .framework.scope import global_scope

        scope = global_scope()
        self._backup = {}
        for pname in self._param_names():
            self._backup[pname] = scope.find_var(pname)
            scope.set_var(pname, self._averaged_value(scope, pname))
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    def restore(self, executor=None):
        from .framework.scope import global_scope

        scope = global_scope()
        for pname, val in self._backup.items():
            scope.set_var(pname, val)
        self._backup = {}


class ExponentialMovingAverage(_SwappingAverager):
    """EMA of the trainable parameters, updated in the main program each
    step: ema = decay_t * ema + (1 - decay_t) * param, where decay_t =
    min(decay, (1 + t) / (10 + t)) with thres_steps (the caller's step
    Variable, or an internal counter clamped at a number). apply() swaps
    in the bias-corrected ema / (1 - prod(decay_t))."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        super().__init__()
        self._decay = float(decay)
        self._thres_steps = thres_steps
        self._name = name or "ema"
        self._pairs = {}  # param name -> ema name
        self._decay_pow_name = None

    def _param_names(self):
        return list(self._pairs)

    def update(self):
        from . import layers

        main = default_main_program()
        params = [p for p in main.all_parameters() if p.trainable]
        blk = main.global_block
        if self._thres_steps is not None:
            if isinstance(self._thres_steps, Variable):
                t = layers.cast(self._thres_steps, "float32")
            else:
                step_v = create_step_counter(self._name + "_step")
                t = layers.elementwise_min(
                    layers.cast(step_v, "float32"),
                    layers.fill_constant([1], "float32",
                                         float(self._thres_steps)))
            decay_t = layers.elementwise_min(
                layers.fill_constant([1], "float32", self._decay),
                (t + 1.0) / (t + 10.0))
        else:
            decay_t = layers.fill_constant([1], "float32", self._decay)
        # the running product of decay_t, for the bias correction
        pow_v = _make_counter(self._name + "_decay_pow", init=1.0)
        prod = layers.elementwise_mul(pow_v, decay_t)
        blk.append_op("assign", {"X": [prod.name]}, {"Out": [pow_v.name]}, {})
        self._decay_pow_name = pow_v.name
        for p in params:
            ema = _make_state_like(p, p.name + "_" + self._name)
            new = layers.elementwise_add(
                layers.elementwise_mul(ema, decay_t),
                layers.elementwise_mul(p, 1.0 - decay_t))
            blk.append_op("assign", {"X": [new.name]}, {"Out": [ema.name]},
                          {})
            self._pairs[p.name] = ema.name

    def _averaged_value(self, scope, pname):
        pow_t = _first(scope.find_var(self._decay_pow_name))
        debias = max(1.0 - float(pow_t), 1e-12)
        ema_val = scope.find_var(self._pairs[pname])
        return (ema_val / debias).to(ema_val.dtype)


class ModelAverage(_SwappingAverager):
    """The windowed average of the trainable parameters, in two tiers:
    (sum_cur, cnt_cur) accumulate every step; when cnt_cur reaches the
    window clip(average_window_rate * num_updates, min_average_window,
    max_average_window) the tier shifts to (sum_old, cnt_old) and
    restarts, so apply() averages over at least one full window once warm.
    In-graph selects; the counters int32. apply() swaps in (sum_cur +
    sum_old) / (cnt_cur + cnt_old)."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, name=None):
        super().__init__()
        self.average_window = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        self._name = name or "model_avg"
        self._state = {}  # param name -> (sum_cur, cnt_cur, sum_old, cnt_old)
        self._build()

    def _param_names(self):
        return list(self._state)

    def _build(self):
        from . import layers

        main = default_main_program()
        blk = main.global_block
        g = create_step_counter(self._name + "_num_updates")
        eff_window = layers.elementwise_min(
            layers.fill_constant([1], "float32",
                                 float(self.max_average_window)),
            layers.elementwise_max(
                layers.fill_constant([1], "float32",
                                     float(self.min_average_window)),
                layers.cast(g, "float32") * self.average_window))
        one = layers.fill_constant([1], "int32", 1)
        for p in [q for q in main.all_parameters() if q.trainable]:
            sum_cur = _make_state_like(p, p.name + "_avg_sum",
                                       dtype="float32")
            cnt_cur = _make_counter(p.name + "_avg_cnt", dtype="int32")
            sum_old = _make_state_like(p, p.name + "_avg_sum_old",
                                       dtype="float32")
            cnt_old = _make_counter(p.name + "_avg_cnt_old", dtype="int32")
            cond = layers.greater_equal(layers.cast(cnt_cur, "float32"),
                                        eff_window)
            shift = layers.cast(cond, "float32")
            keep = 1.0 - shift
            new_sum_old = layers.elementwise_add(
                layers.elementwise_mul(sum_cur, shift, axis=0),
                layers.elementwise_mul(sum_old, keep, axis=0))
            new_cnt_old = layers.where(cond, cnt_cur, cnt_old)
            new_sum_cur = layers.elementwise_add(
                layers.elementwise_mul(sum_cur, keep, axis=0),
                layers.cast(p, "float32"))
            zero = layers.fill_constant([1], "int32", 0)
            new_cnt_cur = layers.elementwise_add(
                layers.where(cond, zero, cnt_cur), one)
            for new, tgt in ((new_sum_old, sum_old), (new_cnt_old, cnt_old),
                             (new_sum_cur, sum_cur), (new_cnt_cur, cnt_cur)):
                blk.append_op("assign", {"X": [new.name]},
                              {"Out": [tgt.name]}, {})
            self._state[p.name] = (sum_cur.name, cnt_cur.name, sum_old.name,
                                   cnt_old.name)

    def _averaged_value(self, scope, pname):
        sc, cc, so, co = self._state[pname]
        s = scope.find_var(sc) + scope.find_var(so)
        c = max(int(_first(scope.find_var(cc)))
                + int(_first(scope.find_var(co))), 1.0)
        orig = self._backup[pname]
        return (s / c).to(orig.dtype).reshape(orig.shape)


class LookaheadOptimizer:
    """Lookahead: wraps an inner optimizer; every k steps slow += alpha
    (fast - slow) and fast = slow, the k-step condition an in-graph
    select on an int32 step counter."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        assert inner_optimizer is not None
        assert 0.0 <= alpha <= 1.0
        assert k >= 1 and isinstance(k, int)
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from . import layers

        ops, params_grads = self.inner_optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        main = loss.block.program
        blk = main.global_block
        startup_program = startup_program or default_startup_program()
        startup = startup_program.global_block
        with program_guard(main, startup_program):
            step_v = create_step_counter("lookahead_step")
            kf = layers.fill_constant([1], "int32", self.k)
            rem = layers.elementwise_mod(step_v, kf)
            sync = layers.cast(
                layers.equal(rem, layers.fill_constant([1], "int32", 0)),
                "float32")
            for p, _ in params_grads:
                slow = blk.create_parameter(
                    unique_name.generate(p.name + "_slow"), p.shape, p.dtype,
                    trainable=False)
                slow.stop_gradient = True
                startup.create_parameter(slow.name, p.shape, p.dtype,
                                         trainable=False)
                # slow starts as the initialised fast weight
                startup.append_op("assign", {"X": [p.name]},
                                  {"Out": [slow.name]}, {})
                merged = p * self.alpha + slow * (1.0 - self.alpha)
                new_slow = layers.elementwise_add(
                    layers.elementwise_mul(merged, sync, axis=0),
                    layers.elementwise_mul(slow, 1.0 - sync, axis=0))
                new_fast = layers.elementwise_add(
                    layers.elementwise_mul(new_slow, sync, axis=0),
                    layers.elementwise_mul(p, 1.0 - sync, axis=0))
                blk.append_op("assign", {"X": [new_slow.name]},
                              {"Out": [slow.name]}, {})
                blk.append_op("assign", {"X": [new_fast.name]},
                              {"Out": [p.name]}, {})
        return ops, params_grads
