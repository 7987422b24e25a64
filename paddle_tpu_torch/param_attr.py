"""ParamAttr (counterpart of paddle_tpu/param_attr.py; reference
python/paddle/fluid/param_attr.py).

`regularizer` is appended to the parameter's gradient by the optimizer
(it wins over the optimizer's own `regularization`). `learning_rate`
lands in the parameter's `optimize_attr` and, as in the JAX package, no
optimizer reads it; `do_model_average` is kept and read by nothing."""

from __future__ import annotations


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            return False
        from .initializer import Initializer

        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")
