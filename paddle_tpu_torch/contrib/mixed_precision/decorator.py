"""AMP optimizer decorator (counterpart of paddle_tpu/contrib/
mixed_precision/decorator.py; reference contrib/mixed_precision/
decorator.py: decorate :218, OptimizerWithMixedPrecision :27).

Pipeline, as the reference's: rewrite the forward program with casts →
scale the loss → backward → check the grads finite → unscale / zero the
grads → update the loss scale → the inner optimizer's update.

The default is bfloat16 compute, where loss scaling is optional (fp32's
exponent range); bench.py's configuration runs a static scale of 1.0.
"""

from __future__ import annotations

import torch

from ...framework import unique_name
from ...framework.program import default_startup_program, program_guard
from ...framework.scope import global_scope
from ...framework.state import create_persistable_var
from .fp16_lists import AutoMixedPrecisionLists
from .fp16_utils import rewrite_program


class OptimizerWithMixedPrecision:
    def __init__(
        self,
        optimizer,
        amp_lists=None,
        init_loss_scaling=2.0**15,
        use_dynamic_loss_scaling=True,
        incr_every_n_steps=1000,
        decr_every_n_nan_or_inf=2,
        incr_ratio=2.0,
        decr_ratio=0.5,
        dest_dtype="bfloat16",
    ):
        self._inner = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = init_loss_scaling
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._dest_dtype = dest_dtype
        self._loss_scaling = None

    def _make_state(self, main, startup):
        def persist(name, shape, dtype, value):
            return create_persistable_var(
                name, shape, dtype, value, unique=False,
                main=main, startup=startup,
            )

        self._loss_scaling = persist(
            unique_name.generate("loss_scaling"), [1], "float32",
            self._init_loss_scaling,
        )
        self._good_steps = persist(
            unique_name.generate("good_steps"), [1], "int32", 0
        )
        self._bad_steps = persist(
            unique_name.generate("bad_steps"), [1], "int32", 0
        )

    def get_loss_scaling(self):
        return self._loss_scaling

    def _state_vals(self, scope=None):
        """(names, tensors) of the loss-scale state in `scope`, or (None,
        None) before minimize() built it or while the scope lacks it."""
        if self._loss_scaling is None:
            return None, None
        scope = scope or global_scope()
        names = (
            self._loss_scaling.name,
            self._good_steps.name,
            self._bad_steps.name,
        )
        vals = [scope.find_var(n) for n in names]
        if any(v is None for v in vals):
            return None, None
        return names, vals

    def state_dict(self, scope=None):
        """The loss-scale automaton's state (scale and good/bad step
        counters) as plain floats and ints, read from the card. Empty
        before `minimize` built the state vars."""
        names, vals = self._state_vals(scope)
        if names is None:
            return {}
        return {
            "loss_scaling": float(vals[0].reshape(-1)[0].item()),
            "good_steps": int(vals[1].reshape(-1)[0].item()),
            "bad_steps": int(vals[2].reshape(-1)[0].item()),
        }

    def _write(self, scope, names, vals, scale, good_n, bad_n):
        """Store the state as [1] tensors on the device the scope's
        tensors live on."""
        dev = vals[0].device
        scope.set_var(names[0], torch.tensor([scale], dtype=torch.float32,
                                             device=dev))
        scope.set_var(names[1], torch.tensor([good_n], dtype=torch.int32,
                                             device=dev))
        scope.set_var(names[2], torch.tensor([bad_n], dtype=torch.int32,
                                             device=dev))

    def load_state_dict(self, state, scope=None):
        """Restore :meth:`state_dict` into the scope vars. A no-op when the
        state vars are not built or not in the scope yet, or `state` is
        empty; missing keys take their initial values."""
        if not state:
            return
        names, vals = self._state_vals(scope)
        if names is None:
            return
        self._write(scope or global_scope(), names, vals,
                    state.get("loss_scaling", self._init_loss_scaling),
                    state.get("good_steps", 0), state.get("bad_steps", 0))

    def note_step(self, good, scope=None):
        """Host-side loss-scale feedback for a good or bad step detected
        outside the program (a finite check on the fetches). Runs the
        in-program `update_loss_scaling` automaton on the state vars: a bad
        step zeroes good_steps and decays the scale after
        `decr_every_n_nan_or_inf` bad ones in a row; a good step grows it
        after `incr_every_n_steps`. Returns the new scale, or None before
        `minimize` built the state or while the scope lacks it."""
        names, vals = self._state_vals(scope)
        if names is None:
            return None
        scale = float(vals[0].reshape(-1)[0].item())
        good_n = int(vals[1].reshape(-1)[0].item())
        bad_n = int(vals[2].reshape(-1)[0].item())
        if good:
            good_n, bad_n = good_n + 1, 0
            if self._use_dynamic and good_n >= self._incr_every:
                scale, good_n = scale * self._incr_ratio, 0
        else:
            good_n, bad_n = 0, bad_n + 1
            if self._use_dynamic and bad_n >= self._decr_every:
                scale, bad_n = scale * self._decr_ratio, 0
        self._write(scope or global_scope(), names, vals, scale, good_n,
                    bad_n)
        return scale

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        main = loss.block.program
        startup = startup_program or default_startup_program()
        rewrite_program(main, self._amp_lists, self._dest_dtype)
        with program_guard(main, startup):
            self._make_state(main, startup)
            scaled = loss * self._loss_scaling
            params_grads = self._inner.backward(
                scaled, startup, parameter_list, no_grad_set
            )
            blk = main.global_block
            gnames = [g.name for _, g in params_grads]
            found = blk.create_var(
                name=unique_name.generate("found_inf"), shape=(1,),
                dtype="bool",
            )
            # FoundInfinite only; the unscaled outputs land in fresh names
            # nothing reads (update_loss_scaling unscales X itself). The
            # eager executor computes them all the same: the op's
            # semantics are kept
            blk.append_op(
                "check_finite_and_unscale",
                {"X": gnames, "Scale": [self._loss_scaling.name]},
                {
                    "Out": [
                        blk.create_var(
                            name=unique_name.generate(n + "@UNS")
                        ).name
                        for n in gnames
                    ],
                    "FoundInfinite": [found.name],
                },
                {},
            )
            # static scaling reuses the same op with ratios pinned to 1.0:
            # the scale never moves, but non-finite grads are still zeroed
            # so the optimizer update is a no-op on overflow steps
            incr_ratio = self._incr_ratio if self._use_dynamic else 1.0
            decr_ratio = self._decr_ratio if self._use_dynamic else 1.0
            blk.append_op(
                "update_loss_scaling",
                {
                    "X": gnames,
                    "FoundInfinite": [found.name],
                    "PrevLossScaling": [self._loss_scaling.name],
                    "InGoodSteps": [self._good_steps.name],
                    "InBadSteps": [self._bad_steps.name],
                },
                {
                    "Out": gnames,
                    "LossScaling": [self._loss_scaling.name],
                    "OutGoodSteps": [self._good_steps.name],
                    "OutBadSteps": [self._bad_steps.name],
                },
                {
                    "incr_every_n_steps": self._incr_every,
                    "decr_every_n_nan_or_inf": self._decr_every,
                    "incr_ratio": incr_ratio,
                    "decr_ratio": decr_ratio,
                },
            )
        return params_grads

    def apply_gradients(self, params_grads):
        # the inner optimizer's clip and regularizers then see the
        # unscaled fp32 gradients update_loss_scaling wrote back
        return self._inner.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        main = loss.block.program
        with program_guard(main, startup_program or default_startup_program()):
            params_grads = self.backward(
                loss, startup_program, parameter_list, no_grad_set
            )
            ops = self.apply_gradients(params_grads)
        return ops, params_grads


def decorate(
    optimizer,
    amp_lists=None,
    init_loss_scaling=2.0**15,
    use_dynamic_loss_scaling=True,
    incr_every_n_steps=1000,
    decr_every_n_nan_or_inf=2,
    incr_ratio=2.0,
    decr_ratio=0.5,
    dest_dtype="bfloat16",
):
    """fluid.contrib.mixed_precision.decorate parity (decorator.py:218)."""
    return OptimizerWithMixedPrecision(
        optimizer,
        amp_lists=amp_lists,
        init_loss_scaling=init_loss_scaling,
        use_dynamic_loss_scaling=use_dynamic_loss_scaling,
        incr_every_n_steps=incr_every_n_steps,
        decr_every_n_nan_or_inf=decr_every_n_nan_or_inf,
        incr_ratio=incr_ratio,
        decr_ratio=decr_ratio,
        dest_dtype=dest_dtype,
    )
