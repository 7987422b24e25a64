"""Eager-mode LR schedules (counterpart of
paddle_tpu/dygraph/learning_rate_scheduler.py; reference
python/paddle/fluid/dygraph/learning_rate_scheduler.py: NoamDecay,
PiecewiseDecay, NaturalExpDecay, ExponentialDecay, InverseTimeDecay,
PolynomialDecay, CosineDecay, LinearLrWarmup, ReduceLROnPlateau).

Each instance is a callable the eager optimizers accept as learning_rate
(Optimizer._eager_lr calls it once per minimize); __call__ returns the
current LR and advances the internal step, mirroring the reference's
LearningRateDecay.__call__ semantics. Plain host-side Python floats: the
eager update takes the value as a scalar, and no tensor is read back.
"""

from __future__ import annotations

import math


class LearningRateDecay:
    def __init__(self, begin=0, step=1):
        self.step_num = int(begin)
        self.step_size = int(step)

    def __call__(self):
        lr = self.step()
        self.step_num += self.step_size
        return float(lr)

    def step(self):
        raise NotImplementedError


class NoamDecay(LearningRateDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1, learning_rate=1.0):
        super().__init__(begin, step)
        self.d_model = float(d_model)
        self.warmup_steps = float(warmup_steps)
        self.learning_rate = float(learning_rate)

    def step(self):
        s = max(self.step_num, 1)
        a = s ** -0.5
        b = s * self.warmup_steps ** -1.5
        return self.learning_rate * self.d_model ** -0.5 * min(a, b)


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin=0, step=1):
        super().__init__(begin, step)
        self.boundaries = list(boundaries)
        self.values = list(values)

    def step(self):
        for b, v in zip(self.boundaries, self.values[:-1]):
            if self.step_num < b:
                return v
        return self.values[-1]


class ExponentialDecay(LearningRateDecay):
    def __init__(
        self, learning_rate, decay_steps, decay_rate, staircase=False,
        begin=0, step=1,
    ):
        super().__init__(begin, step)
        self.learning_rate = float(learning_rate)
        self.decay_steps = float(decay_steps)
        self.decay_rate = float(decay_rate)
        self.staircase = staircase

    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate * self.decay_rate ** div


class NaturalExpDecay(ExponentialDecay):
    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate * math.exp(-self.decay_rate * div)


class InverseTimeDecay(ExponentialDecay):
    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate / (1.0 + self.decay_rate * div)


class PolynomialDecay(LearningRateDecay):
    def __init__(
        self, learning_rate, decay_steps, end_learning_rate=0.0001, power=1.0,
        cycle=False, begin=0, step=1,
    ):
        super().__init__(begin, step)
        self.learning_rate = float(learning_rate)
        self.decay_steps = float(decay_steps)
        self.end_learning_rate = float(end_learning_rate)
        self.power = float(power)
        self.cycle = cycle

    def step(self):
        s = float(self.step_num)
        if self.cycle:
            ratio = math.ceil(s / self.decay_steps)
            if s == 0:
                ratio = 1.0
            steps = self.decay_steps * ratio
        else:
            steps = self.decay_steps
            s = min(s, steps)
        frac = (1.0 - s / steps) ** self.power
        return (self.learning_rate - self.end_learning_rate) * frac + (
            self.end_learning_rate
        )


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0, step=1):
        super().__init__(begin, step)
        self.learning_rate = float(learning_rate)
        self.step_each_epoch = float(step_each_epoch)
        self.epochs = float(epochs)

    def step(self):
        epoch = math.floor(self.step_num / self.step_each_epoch)
        return (
            0.5
            * self.learning_rate
            * (math.cos(epoch * math.pi / self.epochs) + 1.0)
        )


class LinearLrWarmup(LearningRateDecay):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, begin=0, step=1):
        super().__init__(begin, step)
        self.learning_rate = learning_rate  # float or LearningRateDecay
        self.warmup_steps = float(warmup_steps)
        self.start_lr = float(start_lr)
        self.end_lr = float(end_lr)

    def step(self):
        if self.step_num < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * (
                self.step_num / self.warmup_steps
            )
        base = self.learning_rate
        if isinstance(base, LearningRateDecay):
            base.step_num = self.step_num
            return base.step()
        return float(base)


class ReduceLROnPlateau:
    """Metric-driven decay (reference :?): call .step(metric) per eval."""

    def __init__(
        self, learning_rate, mode="min", decay_rate=0.1, patience=10,
        threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0.0,
    ):
        self.lr = float(learning_rate)
        self.mode = mode
        self.decay_rate = float(decay_rate)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.threshold_mode = threshold_mode  # "rel" (reference default) | "abs"
        self.cooldown = int(cooldown)
        self.min_lr = float(min_lr)
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0

    def __call__(self):
        return self.lr

    def _is_better(self, cur):
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            if self.mode == "min":
                return cur < self.best * (1.0 - self.threshold)
            return cur > self.best * (1.0 + self.threshold)
        if self.mode == "min":
            return cur < self.best - self.threshold
        return cur > self.best + self.threshold

    def step(self, metric):
        m = float(metric)
        if self._is_better(m):
            self.best = m
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        elif self.num_bad > self.patience:
            self.lr = max(self.lr * self.decay_rate, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.lr
