"""Weight-decay regularizers (counterpart of paddle_tpu/regularizer.py;
reference python/paddle/fluid/regularizer.py).

Optimizer.apply_gradients appends a regularizer's ops to a gradient, after
the clip: L2Decay adds coeff * param (`scale`, `sum`), L1Decay coeff *
sign(param) (`sign`, `scale`, `sum`). A regularizer pickles as the JAX
package's class with its one field, `coeff` (io.py), so a program file
with per-parameter regularizers crosses between the packages."""

from __future__ import annotations

from .framework import unique_name


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad, block):
        raise NotImplementedError


def _tmp(block, key, like):
    return block.create_var(name=unique_name.generate(key), shape=like.shape,
                            dtype=like.dtype)


def _add_to_grad(block, grad, term):
    out = _tmp(block, grad.name + "@REG", grad)
    block.append_op("sum", {"X": [grad.name, term.name]}, {"Out": [out.name]},
                    {})
    return out


class L2Decay(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        scaled = _tmp(block, param.name + "@L2", param)
        block.append_op("scale", {"X": [param.name]}, {"Out": [scaled.name]},
                        {"scale": self.coeff})
        return _add_to_grad(block, grad, scaled)


class L1Decay(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        sign = _tmp(block, param.name + "@SIGN", param)
        block.append_op("sign", {"X": [param.name]}, {"Out": [sign.name]}, {})
        scaled = _tmp(block, param.name + "@L1", param)
        block.append_op("scale", {"X": [sign.name]}, {"Out": [scaled.name]},
                        {"scale": self.coeff})
        return _add_to_grad(block, grad, scaled)


L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay
